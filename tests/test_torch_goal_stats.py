"""The bounded path's stats snapshot of the port
(``analyzer/chain.py::chain_all_goal_stats``) against the JAX package's,
goal by goal and bit for bit, on the CPU.

The snapshot's violations feed the violation fingerprint and each goal's
entry stats. XLA:CPU compiles the reference's snapshot with some goals'
violation reduce vectorized at 16-32 brokers, with and without a
replica-move exclusion (``chain.STATS_VECTOR_REDUCE``), and under the
exclusion also the average utilization's column sums from 25 brokers on
(``chain.STATS_VECTOR_AVG_LENGTHS``). The fixture is the sparse one of
``tests/test_torch_direct.py`` (24 brokers, 48 topics, 640 partitions,
RF 2, 4 racks) at each broker count; the default goal chain. Tolerance:
none.
"""

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import chain as jchain
from cruise_control_tpu.analyzer import goals as jgoals
from cruise_control_tpu.analyzer.constraint import BalancingConstraint as JBC
from cruise_control_tpu.analyzer.search import ExclusionMasks as JMasks
from cruise_control_tpu.model.fixtures import random_cluster as jrc
from cruise_control_tpu_torch.analyzer import chain as tchain
from cruise_control_tpu_torch.analyzer import goals as tgoals
from cruise_control_tpu_torch.analyzer.constraint import (
    BalancingConstraint as TBC,
)
from cruise_control_tpu_torch.analyzer.optimizer import violation_fingerprint
from cruise_control_tpu_torch.analyzer.search import ExclusionMasks as TMasks
from cruise_control_tpu_torch.config import DEFAULT_GOALS
from cruise_control_tpu_torch.model.fixtures import random_cluster as trc
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)

import jax.numpy as jnp

GOALS = tuple(g.rsplit(".", 1)[-1] for g in DEFAULT_GOALS)

# (brokers, replica-move exclusion): 24 without it is the fixture whose
# fingerprint forked; the others cover each form the dump showed (the
# CPU column left scalar at 18, 4 lanes at 20-23, 8 lanes with and
# without the gap, the capacity goals from 25 and 28, the average's lanes
# at 25 and 32 under the exclusion).
CASES = [(24, False), (18, False), (20, False), (23, False), (26, False),
         (28, False), (32, False), (16, True), (21, True), (24, True),
         (25, True), (32, True)]


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("num_brokers,excluded", CASES)
def test_stats_snapshot_matches_jax_goal_by_goal(num_brokers, excluded):
    fx = dict(num_brokers=num_brokers, num_topics=48, num_partitions=640,
              rf=2, num_racks=4, seed=5, skew_to_first=2.0)
    js, jm = jrc(**fx)
    ts, tm = trc(**fx, device="cpu")
    jg = tuple(getattr(jgoals, n)() for n in GOALS)
    tg = tuple(getattr(tgoals, n)() for n in GOALS)
    if excluded:
        mask = np.zeros(num_brokers, bool)
        mask[[1, 4, num_brokers - 2]] = True
        jmask = JMasks(excluded_replica_move_brokers=jnp.asarray(mask))
        tmask = TMasks(excluded_replica_move_brokers=torch.from_numpy(mask))
    else:
        jmask, tmask = JMasks(), TMasks()
    jv, jo, joff = jchain.chain_all_goal_stats(js, jg, JBC(), jm.num_topics,
                                               jmask)
    tv, to, toff = tchain.chain_all_goal_stats(ts, tg, TBC(), tm.num_topics,
                                               tmask)
    for i, name in enumerate(GOALS):
        assert _bits(tv[i]) == _bits(jv[i]), \
            f"{name}: violation {tv[i]!r} against {float(jv[i])!r}"
        assert _bits(to[i]) == _bits(jo[i]), \
            f"{name}: objective {to[i]!r} against {float(jo[i])!r}"
    assert toff == int(joff)
    assert violation_fingerprint(tv) == violation_fingerprint(np.asarray(jv))

"""The resource goals' per-broker scores and the variance gain, bit for bit
against the JAX package's jitted code.

XLA:CPU contracts a multiply that feeds an add or a subtraction in one
fused loop into a fused multiply-add, which rounds once. The reference's
per-broker loops do so for every band and capacity difference of the
scores (``threshold * capacity - load`` and the like) and for the
distribution goals' ``headroom + 10 * under`` bonus; its per-candidate
improvement reads the band from memory, unfused, but contracts the
variance gain's ``gap * gap - rest * rest``. The port rounds exactly
those once (``utils/numerics.py::fma_f32``). Rounded twice, the scores
differ in the last bit at many brokers, which at 7,000 brokers reordered
the top-512 destinations and forked the 7k/1M solve from the reference's
(ROADMAP Queue C). A fixture with 1,000 brokers has such brokers for
every goal checked here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import candidates as jc
from cruise_control_tpu.analyzer import derived as jderived
from cruise_control_tpu.analyzer import goals as jgoals
from cruise_control_tpu.analyzer import search as jsearch
from cruise_control_tpu.analyzer.constraint import BalancingConstraint as JBC
from cruise_control_tpu.model.fixtures import Dist as JDist
from cruise_control_tpu.model.fixtures import random_cluster as j_random_cluster
from cruise_control_tpu_torch.analyzer import candidates as tc
from cruise_control_tpu_torch.analyzer import derived as tderived
from cruise_control_tpu_torch.analyzer import goals as tgoals
from cruise_control_tpu_torch.analyzer import search as tsearch
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint as TBC
from cruise_control_tpu_torch.model.fixtures import Dist as TDist
from cruise_control_tpu_torch.model.fixtures import random_cluster as t_random_cluster
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)

FIXTURE = dict(num_brokers=1000, num_topics=50, num_partitions=20_000,
               rf=3, num_racks=8, seed=42, skew_to_first=2.0,
               target_utilization=0.55)
# The goals whose per-broker scores multiply a capacity by a threshold or
# band factor. (Whether XLA contracts depends on what it fuses, so each
# form was also held against the reference's whole round, on the 7k/1M
# trajectory.)
RESOURCE_GOALS = ["DiskCapacityGoal", "NetworkInboundCapacityGoal",
                  "NetworkOutboundCapacityGoal", "CpuCapacityGoal",
                  "DiskUsageDistributionGoal",
                  "NetworkInboundUsageDistributionGoal",
                  "NetworkOutboundUsageDistributionGoal",
                  "CpuUsageDistributionGoal"]
SCORES = ("source_score", "dest_score", "replica_weight", "swap_dest_score")


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.fixture(scope="module")
def world():
    js, jm = j_random_cluster(**FIXTURE, dist=JDist.EXPONENTIAL)
    ts, _tm = t_random_cluster(**FIXTURE, dist=TDist.EXPONENTIAL,
                               device="cpu")
    return js, ts, jm.num_topics


def _jax_scores(goal, state, num_topics, names):
    """The scores ``names`` of ``goal``, jitted together as a round
    computes them (whether XLA contracts depends on what it fuses)."""
    @jax.jit
    def scores(s):
        d = jderived.compute_derived(s)
        aux = jsearch.goal_aux(goal, s, d, JBC(), num_topics)
        return [getattr(goal, name)(s, d, JBC(), aux) for name in names]
    return [np.asarray(x) for x in scores(state)]


@pytest.mark.parametrize("name", RESOURCE_GOALS)
def test_per_broker_scores_are_the_jitted_references(world, name):
    """The scores of the move round (one program) and, for a swap goal,
    of the swap round (another)."""
    js, ts, topics = world
    jgoal = jgoals.ALL_GOALS[name]()
    want = _jax_scores(jgoal, js, topics, SCORES[:3])
    if jgoal.supports_swap:
        want += _jax_scores(jgoal, js, topics, SCORES[3:])
    goal = tgoals.ALL_GOALS[name]()
    d = tderived.compute_derived(ts)
    aux = tsearch.goal_aux(goal, ts, d, TBC(), topics)
    for score, w in zip(SCORES, want):
        got = getattr(goal, score)(ts, d, TBC(), aux).to(torch.float32)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(w),
                                      err_msg=f"{name}.{score}")


def test_twice_rounded_dest_score_would_differ(world):
    """The check above can see the rounding: the dest score with its
    differences rounded twice differs from the reference's."""
    js, ts, topics = world
    name = "DiskUsageDistributionGoal"
    want = _jax_scores(jgoals.ALL_GOALS[name](), js, topics, SCORES[:3])[1]
    d = tderived.compute_derived(ts)
    lower, upper, _cap = tderived.resource_limits(
        ts, d, TBC(), tgoals.ALL_GOALS[name]().resource)
    load = d.broker_load[:, 3]
    twice = (upper - load) + torch.clamp(lower - load, min=0.0) * 10.0
    finite = np.isfinite(want)
    assert (_bits(twice.numpy())[finite] != _bits(want)[finite]).any()


@pytest.mark.parametrize("name", ["DiskUsageDistributionGoal",
                                  "CpuUsageDistributionGoal",
                                  "LeaderBytesInDistributionGoal"])
def test_improvement_with_variance_gain_is_the_jitted_reference(world, name):
    """The improvement on 4,096 seeded moves between random brokers (the
    variance gain is added where the band improvement is positive)."""
    js, ts, topics = world
    rng = np.random.default_rng(7)
    n, b = 4096, FIXTURE["num_brokers"]
    src = rng.integers(0, b, n).astype(np.int32)
    dst = ((src + rng.integers(1, b, n)) % b).astype(np.int32)
    load = (rng.exponential(1.0, (n, 4)) * np.array([0.5, 5, 5, 50])
            ).astype(np.float32)
    lead = rng.integers(0, 2, n).astype(np.int32)
    arrays = dict(src_broker=src, dst_broker=dst, load_delta=load,
                  replica_delta=np.ones(n, np.int32), leader_delta=lead,
                  partition=rng.integers(0, FIXTURE["num_partitions"], n)
                  .astype(np.int32),
                  topic=rng.integers(0, topics, n).astype(np.int32),
                  src_slot=np.zeros(n, np.int32),
                  dst_slot=np.zeros(n, np.int32), valid=np.ones(n, bool))
    jdeltas = jc.CandidateDeltas(**{k: jnp.asarray(v)
                                    for k, v in arrays.items()})
    tdeltas = tc.CandidateDeltas(**{k: torch.as_tensor(v)
                                    for k, v in arrays.items()})
    jgoal = jgoals.ALL_GOALS[name]()

    @jax.jit
    def improvement(s, deltas):
        d = jderived.compute_derived(s)
        aux = jsearch.goal_aux(jgoal, s, d, JBC(), topics)
        return jgoal.improvement(s, d, JBC(), aux, deltas)

    want = np.asarray(improvement(js, jdeltas))
    goal = tgoals.ALL_GOALS[name]()
    d = tderived.compute_derived(ts)
    aux = tsearch.goal_aux(goal, ts, d, TBC(), topics)
    got = goal.improvement(ts, d, TBC(), aux, tdeltas).to(torch.float32)
    assert (want > 0).sum() > 100
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))

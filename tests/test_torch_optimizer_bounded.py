"""``GoalOptimizer.optimizations`` on the bounded per-goal path, the port
against the JAX package on the same fixture.

The gates are lowered (``solver.fused.chain.max.brokers=8``,
``solver.wide.batch.min.brokers=8``) so the bounded branch, its wide grid
and deficit sizing all engage at 16 brokers / 512 partitions, and
``solver.dispatch.target.seconds=0`` pins the dispatch boundaries (with
the default wall-clock target they would depend on each host's speed).
Parametrised over ``solver.dispatch.max.rounds`` ∈ {1, 16} and async
readback on and off; with a budget of one round a dispatch never sees its
pass converge, so each pass runs to ``max.solver.rounds``, which every
case lowers to 32 to stay short. The replica-move exclusion and fast mode
(under a timeout large enough that nothing is cut) are in
test_torch_optimizer_bounded_cases.py; the 100/10k fixture, with and
without 5 DEAD brokers, in test_torch_optimizer_bounded_large*.py.

Equal: ``assignment``, ``leader_slot``, every ``GoalResult`` field but
``duration_s``, the violated sets, balancedness, the proposals and
``last_dispatch_stats()``, the violation fingerprint (a crc32 of the
entry violations) included. The entry violations the fingerprint hashes
are held bit for bit against the reference's too: the port rounds the
band and capacity differences once, as XLA:CPU's fused multiply-adds do
(``utils/numerics.py::fma_f32``), and with a replica-move exclusion
(``excluded``) it sums the resource distribution goals' 16-broker
violation vectors in the 8-lane vector order that XLA:CPU's vectorized
fused reduce uses there (``utils/numerics.py::xla_vector_sum``).
"""

import dataclasses

import numpy as np
import pytest

from cruise_control_tpu.analyzer.constraint import OptimizationOptions as JOptions
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.common.broker_state import BrokerState as JBrokerState
from cruise_control_tpu.config.cruise_control_config import CruiseControlConfig as JConfig
from cruise_control_tpu.model.fixtures import Dist as JDist
from cruise_control_tpu.model.fixtures import random_cluster as j_random_cluster
from cruise_control_tpu.model.tensors import set_broker_state as j_set_broker_state
from cruise_control_tpu_torch.analyzer import chain as tchain
from cruise_control_tpu_torch.analyzer.constraint import OptimizationOptions as TOptions
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer as TOptimizer
from cruise_control_tpu_torch.analyzer.optimizer import goals_by_priority
from cruise_control_tpu_torch.analyzer.search import ExclusionMasks as TMasks
from cruise_control_tpu_torch.config import CruiseControlConfig as TConfig
from cruise_control_tpu_torch.model.fixtures import Dist as TDist
from cruise_control_tpu_torch.model.fixtures import random_cluster as t_random_cluster
from cruise_control_tpu_torch.model.tensors import set_broker_state as t_set_broker_state
from cruise_control_tpu_torch.warmstart import violation_fingerprint
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)

FIXTURES = {
    "16_512": dict(num_brokers=16, num_topics=8, num_partitions=512, rf=3,
                   num_racks=8, seed=42, skew_to_first=2.0,
                   target_utilization=0.55),
    "100_10k": dict(num_brokers=100, num_topics=10, num_partitions=10_000,
                    rf=3, num_racks=8, seed=42, skew_to_first=2.0,
                    target_utilization=0.55),
}
GATES = {"solver.fused.chain.max.brokers": 8,
         "solver.wide.batch.min.brokers": 8,
         "solver.dispatch.target.seconds": 0}


def bounded_config(rounds: int, async_rb: bool) -> dict:
    return dict(GATES, **{"solver.dispatch.max.rounds": rounds,
                          "solver.dispatch.async.readback": async_rb,
                          "max.solver.rounds": 32})


def _states(fixture: str, dead: int):
    fx = FIXTURES[fixture]
    js, jm = j_random_cluster(**fx, dist=JDist.EXPONENTIAL)
    ts, tm = t_random_cluster(**fx, dist=TDist.EXPONENTIAL, device="cpu")
    if dead:
        b = fx["num_brokers"]
        js = j_set_broker_state(js, np.arange(b - dead, b),
                                JBrokerState.DEAD)
        ts = t_set_broker_state(ts, np.arange(b - dead, b), 1)
    return js, jm, ts, tm


def solve_both(fixture: str, conf: dict, dead: int = 0, excluded=(),
               fast: bool = False):
    js, jm, ts, tm = _states(fixture, dead)
    jopt, topt = JOptimizer(JConfig(conf)), TOptimizer(TConfig(conf),
                                                       device="cpu")
    opts = dict(excluded_brokers_for_replica_move=tuple(excluded),
                fast_mode=fast)
    jf, jr = jopt.optimizations(js, jm, options=JOptions(**opts))
    tf, tr = topt.optimizations(ts, tm, options=TOptions(**opts))
    return (js, jm, jf, jr, jopt), (ts, tm, tf, tr, topt)


def assert_same_solve(j, t, conf: dict, excluded=()):
    js, jm, jf, jr, jopt = j
    ts, _tm, tf, tr, topt = t
    np.testing.assert_array_equal(tf.assignment.numpy(),
                                  np.asarray(jf.assignment))
    np.testing.assert_array_equal(tf.leader_slot.numpy(),
                                  np.asarray(jf.leader_slot))
    assert len(tr.goal_results) == len(jr.goal_results)
    for a, b in zip(jr.goal_results, tr.goal_results):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        da.pop("duration_s"), db.pop("duration_s")
        assert db == da
    assert tr.violated_goals_before == jr.violated_goals_before
    assert tr.violated_goals_after == jr.violated_goals_after
    assert tr.balancedness_before == jr.balancedness_before
    assert tr.balancedness_after == jr.balancedness_after
    assert [(p.topic, p.partition, p.old_replicas, p.new_replicas,
             p.old_leader, p.new_leader) for p in tr.proposals] == \
        [(p.topic, p.partition, tuple(p.old_replicas), tuple(p.new_replicas),
          p.old_leader, p.new_leader) for p in jr.proposals]
    jd, td = jopt.last_dispatch_stats(), topt.last_dispatch_stats()
    tfp = td.get("violation_fingerprint")
    assert td == jd
    if tfp is not None:
        # the snapshot the fingerprint hashes, taken on the input states
        _chain, jv, _jo, _off = jopt.goal_entry_stats(
            js, jm, options=JOptions(
                excluded_brokers_for_replica_move=tuple(excluded)))
        mask = np.isin(np.arange(ts.num_brokers), excluded) \
            if excluded else None
        tv = tchain.chain_all_goal_stats(
            ts, tuple(goals_by_priority(TConfig(conf))), topt.constraint,
            jm.num_topics,
            TMasks.from_numpy("cpu", excluded_replica_move_brokers=mask))[0]
        assert tfp == violation_fingerprint(tv)
        np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("async_rb", [True, False])
@pytest.mark.parametrize("rounds", [1, 16])
def test_bounded_optimizations_match(rounds, async_rb):
    conf = bounded_config(rounds, async_rb)
    j, t = solve_both("16_512", conf)
    assert any(g.rounds for g in t[3].goal_results)
    assert_same_solve(j, t, conf)

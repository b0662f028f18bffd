"""The direct-assignment transport of the port (``analyzer/direct.py``,
``analyzer/direct_kernels.py``, ``fill.direct_fill_dests``) against the
JAX package's ``analyzer/direct.py`` on the CPU.

The same seeded inputs go through both. Tolerances: none. Integer outputs
(permutations, ranks, destinations, moves, sweeps, assignments and leader
slots) are compared exactly and every f32 output bit for bit: the twins
reproduce XLA:CPU's association of the reference's f32 sums and cumsums
(``utils/numerics.py``), and its uint32 hash.

The fixtures are ``tests/test_direct.py``'s: 12 brokers / 96 partitions
(6 topics, RF 2, 3 racks) and the sparse 24 brokers / 48 topics / 640
partitions, its rack, exclusion-mask and leadership-only chains, and
whole solves through both ``GoalOptimizer``s with the transport on
(``solver.wide.batch.min.brokers`` and ``solver.fused.chain.max.brokers``
at 8, ``solver.dispatch.target.seconds=0``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import direct as jd
from cruise_control_tpu.analyzer import fill as jfill
from cruise_control_tpu.analyzer import goals as jgoals
from cruise_control_tpu.analyzer import optimizer as jopt_mod
from cruise_control_tpu.analyzer.chain import MegastepConfig as JMega
from cruise_control_tpu.analyzer.chain import direct_path_chosen as j_chosen
from cruise_control_tpu.analyzer.constraint import BalancingConstraint as JBC
from cruise_control_tpu.analyzer.search import ExclusionMasks as JMasks
from cruise_control_tpu.config.cruise_control_config import (
    CruiseControlConfig as JConfig,
)
from cruise_control_tpu.model.fixtures import random_cluster as jrc
from cruise_control_tpu_torch.analyzer import direct as td
from cruise_control_tpu_torch.analyzer import direct_kernels as dk
from cruise_control_tpu_torch.analyzer import fill as tfill
from cruise_control_tpu_torch.analyzer import goals as tgoals
from cruise_control_tpu_torch.analyzer import optimizer as topt_mod
from cruise_control_tpu_torch.analyzer.chain import MegastepConfig as TMega
from cruise_control_tpu_torch.analyzer.chain import direct_path_chosen as t_chosen
from cruise_control_tpu_torch.analyzer.constraint import (
    BalancingConstraint as TBC, OptimizationOptions as TOptions,
)
from cruise_control_tpu_torch.analyzer.search import ExclusionMasks as TMasks
from cruise_control_tpu_torch.config import CruiseControlConfig as TConfig
from cruise_control_tpu_torch.model.fixtures import random_cluster as trc
from cruise_control_tpu_torch.testing import digest
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)

DENSE = dict(num_brokers=12, num_topics=6, num_partitions=96, rf=2,
             num_racks=3, seed=3, skew_to_first=2.0)
SPARSE = dict(num_brokers=24, num_topics=48, num_partitions=640, rf=2,
              num_racks=4, seed=5, skew_to_first=2.0)
# tests/test_direct.py's CHAIN: the rack goal, the replica cap and a
# resource band before the three count goals.
CHAIN = ("RackAwareGoal", "ReplicaCapacityGoal",
         "NetworkOutboundUsageDistributionGoal", "ReplicaDistributionGoal",
         "TopicReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
         "PreferredLeaderElectionGoal")
SOLVE_PROPS = {"solver.direct.assignment.enabled": True,
               "solver.wide.batch.min.brokers": 8,
               "solver.fused.chain.max.brokers": 8,
               "solver.dispatch.target.seconds": 0}


def _chains(names):
    return (tuple(getattr(jgoals, n)() for n in names),
            tuple(getattr(tgoals, n)() for n in names))


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(j, t, what=""):
    np.testing.assert_array_equal(_bits(t.numpy() if isinstance(
        t, torch.Tensor) else t), _bits(j), err_msg=what)


# ---------------------------------------------------------------------------
# Seeds, uniforms and rounding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("salt", ["", "fleet-a", "ünïcode"])
def test_sparse_rounding_seed_and_salts_match(salt):
    assert td.sparse_rounding_seed(salt) == jd.sparse_rounding_seed(salt)
    assert td.SPARSE_ROUNDING_SEED == jd.SPARSE_ROUNDING_SEED
    assert (dk.SALT_SURPLUS, dk.SALT_HEADROOM) == \
        (jd._SALT_SURPLUS, jd._SALT_HEADROOM)


@pytest.mark.parametrize("sweep", [0, 1, 7, 15])
@pytest.mark.parametrize("salt", ["", "fleet-a"])
def test_hash_uniform_is_bit_exact(sweep, salt):
    rng = np.random.default_rng(sweep)
    idx = np.concatenate([np.arange(0, 4096), [2 ** 31 - 1, 2 ** 31 - 2,
                                               2 ** 30, 700, 6999],
                          rng.integers(0, 2 ** 31 - 1, 4096)]).astype(np.int32)
    seed = jd.sparse_rounding_seed(salt)
    for plane in (jd._SALT_SURPLUS, jd._SALT_HEADROOM):
        want = jax.jit(lambda i: jd._hash_uniform(i, sweep, seed ^ plane))(
            jnp.asarray(idx))
        got = dk.hash_uniform(torch.as_tensor(idx), sweep, seed ^ plane)
        _assert_same(want, got, f"sweep {sweep} salt {salt!r}")


def _plane(kind: str, g: int, b: int, seed: int):
    """A count plane, its band (the reference's floor/ceil of the group
    average), alive and destination-eligible brokers."""
    rng = np.random.default_rng(seed)
    lam = 30.0 if kind == "dense" else 0.6
    cnt = rng.poisson(lam, (g, b)).astype(np.float32)
    cnt[:, : max(1, b // 8)] += rng.poisson(lam, (g, max(1, b // 8)))
    avg = cnt.mean(axis=1, keepdims=True)
    upper = np.ceil(avg * 1.1).astype(np.float32)
    lower = np.floor(avg / 1.1).astype(np.float32)
    alive = rng.random(b) > 0.05
    elig = alive & (rng.random(b) > 0.1)
    return cnt, lower, upper, alive, elig


@pytest.mark.parametrize("kind,g,b", [("dense", 1, 1000), ("dense", 6, 77),
                                      ("sparse", 48, 700),
                                      ("sparse", 3, 17)])
def test_round_systematic_is_bitwise(kind, g, b):
    rng = np.random.default_rng(g + b)
    x = (rng.exponential(0.7, (g, b)) * (rng.random((g, b)) < 0.6)) \
        .astype(np.float32)
    u = rng.random(g).astype(np.float32)
    want = jax.jit(jd._round_systematic)(jnp.asarray(x), jnp.asarray(u))
    got = dk.round_systematic(torch.as_tensor(x), torch.as_tensor(u))
    _assert_same(want, got)


@pytest.mark.parametrize("kind,g,b", [("dense", 1, 1000), ("dense", 6, 77),
                                      ("sparse", 48, 700),
                                      ("sparse", 100, 1000)])
@pytest.mark.parametrize("sweep", [0, 3])
def test_surplus_deficit_is_bitwise(kind, g, b, sweep):
    cnt, lower, upper, alive, elig = _plane(kind, g, b, g * b + sweep)
    seed = jd.sparse_rounding_seed("" if sweep == 0 else "fleet-a")
    fn = jax.jit(lambda *a: jd._surplus_deficit(
        *a, sweep=sweep, margin_frac=0.25, seed=seed))
    want = fn(*(jnp.asarray(a) for a in (cnt, lower, upper, alive, elig)))
    got = dk.direct_plan(*(torch.as_tensor(a) for a in (
        cnt, lower, upper, alive, elig)), sweep, 0.25, seed)
    for name, w, t in zip(("surplus", "defi", "headr"), want, got):
        _assert_same(w, t, name)
    # The profiles KD4 searches: the row cumsums of the deficit and
    # headroom planes, integral and so exact in any order.
    _assert_same(np.cumsum(np.asarray(want[1]), 1), got[3], "cum_d")
    _assert_same(np.cumsum(np.asarray(want[2]), 1), got[4], "cum_h")


# ---------------------------------------------------------------------------
# Segmented helpers and the sorts
# ---------------------------------------------------------------------------

def _sorted_keys(n: int, segments: int, rng) -> np.ndarray:
    return np.sort(rng.integers(0, segments, n)).astype(np.int32)


@pytest.mark.parametrize("n,segments", [(1, 1), (17, 1), (1000, 37),
                                        (100_003, 5000)])
def test_segment_helpers_match(n, segments):
    rng = np.random.default_rng(n)
    keys = _sorted_keys(n, segments, rng)
    jk, tk = jnp.asarray(keys), torch.as_tensor(keys)
    # KD2's int mode gives the rank as the exclusive count of ones, and a
    # segment starts where that rank is 0.
    rank = dk.segment_scan(tk, torch.ones(n, dtype=torch.int32))[0]
    _assert_same(jax.jit(jd._segment_rank)(jk), rank)
    _assert_same(jax.jit(jd._segment_starts)(jk), rank == 0)
    ints = rng.integers(0, 2, n).astype(np.int32)
    _assert_same(jax.jit(jd._segment_exclusive)(jk, jnp.asarray(ints)),
                 dk.segment_scan(tk, torch.as_tensor(ints))[0], "int32")
    for shape in ((n,), (n, 4)):
        vals = (rng.exponential(3.0, shape)
                * (rng.random(shape) < 0.7)).astype(np.float32)
        want = jax.jit(jd._segment_exclusive)(jk, jnp.asarray(vals))
        _assert_same(want, dk.segment_scan(tk, torch.as_tensor(vals))[0],
                     f"f32 {shape}")
        _assert_same(want, dk.segment_exclusive_plain(
            tk, torch.as_tensor(vals)), f"f32 {shape}, plain")


@pytest.mark.parametrize("n,key_max", [(1, 0), (5000, 0), (30_000, 4),
                                       (300_000, 700 * 13)])
def test_sort_permutation_matches_lax_sort(n, key_max):
    """Heavy ties, ±0.0 and infinities in the second key: KD1's twin gives
    ``lax.sort((key, weight, iota), num_keys=2)``'s permutation, and the
    position-keyed sort's."""
    rng = np.random.default_rng(n)
    key = rng.integers(0, key_max + 1, n).astype(np.int32)
    w = rng.choice(np.array([0.0, -0.0, 1.5, -2.0, np.inf, -np.inf, 0.25],
                            np.float32), n)
    sort2 = jax.jit(lambda k, x: jax.lax.sort(
        (k, x, jnp.arange(k.shape[0], dtype=jnp.int32)), num_keys=2))
    sk, _sw, si = sort2(jnp.asarray(key), jnp.asarray(w))
    tk, ti = dk.sort_pairs(torch.as_tensor(key), key_max, torch.as_tensor(w))
    _assert_same(si, ti, "perm")
    _assert_same(sk, tk, "keys")
    pos = jnp.arange(n, dtype=jnp.int32)
    sk, _sp, si = jax.jit(lambda k: jax.lax.sort((k, pos, pos), num_keys=2))(
        jnp.asarray(key))
    tk, ti = dk.sort_pairs(torch.as_tensor(key), key_max)
    _assert_same(si, ti, "position-keyed perm")
    _assert_same(sk, tk, "position-keyed keys")


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_direct_fill_matches_deficit_fill_dests(kind):
    cnt, lower, upper, alive, elig = _plane(kind, 9, 300, 11)
    plan = dk.direct_plan(*(torch.as_tensor(a) for a in (
        cnt, lower, upper, alive, elig)))
    rng = np.random.default_rng(5)
    grp = rng.integers(0, 9, 4000).astype(np.int32)
    rank = rng.integers(0, 400, 4000).astype(np.float32)
    want = jax.jit(jfill.deficit_fill_dests)(
        jnp.asarray(grp), jnp.asarray(rank), jnp.asarray(plan[1].numpy()),
        jnp.asarray(plan[2].numpy()), jnp.asarray(elig))
    got = tfill.direct_fill_dests(torch.as_tensor(grp), torch.as_tensor(rank),
                                  plan[3], plan[4])
    _assert_same(want[0], got[0], "dst")
    _assert_same(want[1], got[1], "ok")


# ---------------------------------------------------------------------------
# Eligibility, guards and the path choice
# ---------------------------------------------------------------------------

def test_eligibility_guards_and_path_choice_match():
    jc, tc = _chains(CHAIN)
    for i in range(len(CHAIN)):
        assert td.direct_eligible(tc, i) == jd.direct_eligible(jc, i)
        assert dataclasses.asdict(td._guards_for(tc, i)) == \
            dataclasses.asdict(jd._guards_for(jc, i))
        assert (td._stall_limit(tc, i) if td.direct_eligible(tc, i)
                else None) == (jd._stall_limit(jc, i)
                               if jd.direct_eligible(jc, i) else None)
    tainted = ("LeaderBytesInDistributionGoal", "ReplicaDistributionGoal",
               "TopicReplicaDistributionGoal")
    jt, tt = _chains(tainted)
    assert [td.direct_eligible(tt, i) for i in range(3)] == \
        [jd.direct_eligible(jt, i) for i in range(3)] == [False] * 3
    for kw in (DENSE, SPARSE):
        js, jm = jrc(**kw)
        ts, tm = trc(**kw, device="cpu")
        assert topt_mod.replica_density(ts, tm.num_topics) == \
            jopt_mod.replica_density(js, jm.num_topics)
    for density in (0.5, 1.5, 2.0, 4.0):
        for threshold in (-1.0, 0.0, 2.0):
            assert topt_mod.direct_goal_choice(density, threshold) == \
                jopt_mod.direct_goal_choice(density, threshold)
    for goals in (None, ("TopicReplicaDistributionGoal",)):
        for name in ("ReplicaDistributionGoal",
                     "TopicReplicaDistributionGoal",
                     "LeaderReplicaDistributionGoal"):
            assert t_chosen(TMega(direct_assignment=True, direct_goals=goals),
                            name) == \
                j_chosen(JMega(direct_assignment=True, direct_goals=goals),
                         name)
    props = {"solver.direct.assignment.enabled": True,
             "solver.wide.batch.min.brokers": 8,
             "solver.direct.max.sweeps": 5,
             "solver.direct.sparse.margin.frac": 0.4,
             "solver.direct.sparse.rounding.salt": "fleet-a"}
    jo = jopt_mod.GoalOptimizer(JConfig(props))
    to = topt_mod.GoalOptimizer(TConfig(props), device="cpu")
    for b, density in ((4, None), (12, 3.0), (12, 1.5), (24, 0.5)):
        j, t = jo._megastep_config(b, density), to._megastep_config(b,
                                                                   density)
        for f in ("deficit_moves_cap", "direct_assignment",
                  "direct_max_sweeps", "direct_sparse_margin",
                  "direct_sparse_salt", "direct_goals"):
            assert getattr(t, f) == getattr(j, f), (b, density, f)


def test_direct_config_keys_match_the_reference():
    keys = ("solver.direct.max.sweeps", "solver.direct.sparse.margin.frac",
            "solver.direct.sparse.rounding.salt",
            "solver.direct.density.sparse.threshold")
    for key in keys:
        assert TConfig().get(key) == JConfig().get(key), key
    for key, bad in (("solver.direct.max.sweeps", 0),
                     ("solver.direct.sparse.margin.frac", 0.6),
                     ("solver.direct.density.sparse.threshold", -0.5)):
        with pytest.raises(ValueError):
            JConfig({key: bad})
        with pytest.raises(ValueError, match=key.replace(".", r"\.")):
            TConfig({key: bad})


# ---------------------------------------------------------------------------
# The sweeps and the sweep loop
# ---------------------------------------------------------------------------

def _masks(kind: str, js):
    """(JAX masks, port masks): none, or test_direct.py's exclusion case
    (brokers 7 and 11 excluded for replica moves, topic 0's partitions
    excluded)."""
    if kind == "none":
        return JMasks(), TMasks()
    b = js.num_brokers
    excluded = np.zeros(b, bool)
    excluded[[7, 11]] = True
    topic_mask = np.asarray(js.topic) == 0
    return (JMasks(excluded_topics=jnp.asarray(topic_mask),
                   excluded_replica_move_brokers=jnp.asarray(excluded)),
            TMasks.from_numpy("cpu", excluded_topics=topic_mask,
                              excluded_replica_move_brokers=excluded))


def _assert_states_equal(js, ts, what):
    _assert_same(js.assignment, ts.assignment, f"{what}: assignment")
    _assert_same(js.leader_slot, ts.leader_slot, f"{what}: leader slots")


@pytest.mark.parametrize("index,sweep", [(3, 0), (4, 2), (5, 1)])
def test_one_sweep_is_bitwise(index, sweep):
    """One ``_direct_sweep`` (ReplicaDistributionGoal, then
    TopicReplicaDistributionGoal at a rotated sweep) and one
    ``_leadership_sweep`` (LeaderReplicaDistributionGoal), under the rack,
    replica-cap and NW-out band guards: the state bit for bit, applied and
    planned exact."""
    jc, tc = _chains(CHAIN)
    js, jm = jrc(**DENSE)
    ts, _tm = trc(**DENSE, device="cpu")
    fn = jd._sweep_fn(jc, index)
    assert td._sweep_fn(tc, index).__name__ == fn.__name__
    jn, ja, jp = jax.jit(lambda s: fn(s, jc, index, JBC(), jm.num_topics,
                                      JMasks(), sweep=sweep))(js)
    tn, ta, tp = td._sweep_fn(tc, index)(ts, tc, index, TBC(), jm.num_topics,
                                         TMasks(), sweep=sweep)
    _assert_states_equal(jn, tn, fn.__name__)
    assert (int(ta), int(tp)) == (int(ja), int(jp))
    assert int(ta) > 0


CASES = {
    # (fixture, chain, goal indices run in turn, masks, salt)
    "dense": (DENSE, CHAIN, (3, 4, 5), "none", ""),
    "sparse": (SPARSE, ("RackAwareGoal", "ReplicaCapacityGoal",
                        "ReplicaDistributionGoal",
                        "TopicReplicaDistributionGoal"), (2, 3), "none", ""),
    "sparse_salted": (SPARSE, ("RackAwareGoal", "ReplicaCapacityGoal",
                               "ReplicaDistributionGoal",
                               "TopicReplicaDistributionGoal"), (3,), "none",
                      "fleet-a"),
    "exclusion_masks": (DENSE, ("RackAwareGoal", "ReplicaCapacityGoal",
                                "ReplicaDistributionGoal"), (2,), "masks",
                        ""),
    "leadership_only": (dict(DENSE, seed=42), (
        "RackAwareGoal", "ReplicaCapacityGoal",
        "NetworkOutboundUsageDistributionGoal",
        "LeaderReplicaDistributionGoal"), (3,), "none", ""),
    # Every guard family: a prior topic band (the replica goal after
    # TopicReplicaDistributionGoal), then the replica and leader bands,
    # the potential NW-out limit, a capacity threshold and a resource band
    # before the leadership sweep and a second topic goal.
    "every_guard": (DENSE, ("RackAwareGoal", "ReplicaCapacityGoal",
                            "DiskCapacityGoal",
                            "TopicReplicaDistributionGoal",
                            "ReplicaDistributionGoal", "PotentialNwOutGoal",
                            "DiskUsageDistributionGoal",
                            "LeaderReplicaDistributionGoal",
                            "TopicReplicaDistributionGoal"),
                    (3, 4, 7, 8), "none", ""),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_direct_transport_rounds_match(case):
    """``direct_transport_rounds`` of each goal in turn: the state bit for
    bit and (moves, sweeps, planned) exact."""
    kw, names, indices, mask_kind, salt = CASES[case]
    jc, tc = _chains(names)
    js, jm = jrc(**kw)
    ts, _tm = trc(**kw, device="cpu")
    jmasks, tmasks = _masks(mask_kind, js)
    seed = jd.sparse_rounding_seed(salt)
    for index in indices:
        js, jmv, jsw, jpl = jd.direct_transport_rounds(
            js, jc, index, JBC(), jm.num_topics, jmasks, 16, seed=seed)
        ts, tmv, tsw, tpl = td.direct_transport_rounds(
            ts, tc, index, TBC(), jm.num_topics, tmasks, 16, seed=seed)
        _assert_states_equal(js, ts, f"{case} goal {names[index]}")
        assert (tmv, tsw, tpl) == (int(jmv), int(jsw), int(jpl)), \
            names[index]
    if case == "leadership_only":
        # Leadership moves only: the assignment is the fixture's.
        _assert_same(jrc(**kw)[0].assignment, ts.assignment)


def test_donated_twin_and_direct_pass_match_the_plain_call():
    """PyTorch has no donation: the reference's donated arm is the plain
    call, and ``run_direct_pass`` records it as one undonated dispatch of
    kind "direct" with the sweeps as rounds. The reference's donated twin
    returns the same state and counts as its plain call."""
    from cruise_control_tpu_torch.analyzer.chain import DispatchStats
    jc, tc = _chains(CHAIN)
    js, jm = jrc(**DENSE)
    ts, tm = trc(**DENSE, device="cpu")
    ja, jl, *jcounts = jd.direct_transport_rounds_donated(
        jnp.array(js.assignment, copy=True),
        jnp.array(js.leader_slot, copy=True), js, jc, 3, JBC(),
        jm.num_topics, JMasks(), 16)
    want, moves, sweeps, planned = td.direct_transport_rounds(
        ts, tc, 3, TBC(), tm.num_topics, TMasks(), 16)
    _assert_same(ja, want.assignment, "assignment")
    _assert_same(jl, want.leader_slot, "leader slots")
    assert [int(c) for c in jcounts] == [moves, sweeps, planned]
    stats = DispatchStats()
    got, m2, s2, p2 = td.run_direct_pass(
        ts, tc, 3, TBC(), tm.num_topics, TMasks(),
        TMega(direct_assignment=True), 16, stats=stats)
    assert torch.equal(got.assignment, want.assignment)
    assert (m2, s2, p2) == (moves, sweeps, planned)
    assert stats.as_dict()["direct_dispatches"] == 1
    assert stats.rounds_per_dispatch == [sweeps] and stats.donated == 0


# ---------------------------------------------------------------------------
# Whole solves
# ---------------------------------------------------------------------------

def _jax_solve(kw, props, options):
    infos = []
    orig = jopt_mod.optimize_goal_in_chain

    def recorded(*args, **kwargs):
        out = orig(*args, **kwargs)
        infos.append(out[1])
        return out

    jopt_mod.optimize_goal_in_chain = recorded
    try:
        js, jm = jrc(**kw)
        opt = jopt_mod.GoalOptimizer(JConfig(props))
        final, result = opt.optimizations(js, jm, options=options)
    finally:
        jopt_mod.optimize_goal_in_chain = orig
    return final, result, infos, opt.last_dispatch_stats()


@pytest.mark.parametrize("name", ["dense", "sparse"])
def test_direct_solve_matches_jax(name):
    """Both optimizers with the transport on: per goal the direct pass's
    moves and sweeps, rounds and moves; the violated sets, balancedness,
    dispatch statistics (the violation fingerprint among them) and the
    assignment and leader digests, exact."""
    from cruise_control_tpu.analyzer.constraint import (
        OptimizationOptions as JOptions,
    )
    kw = DENSE if name == "dense" else SPARSE
    jf, jr, infos, jstats = _jax_solve(kw, SOLVE_PROPS, JOptions())
    ts, tm = trc(**kw, device="cpu")
    opt = topt_mod.GoalOptimizer(TConfig(SOLVE_PROPS), device="cpu")
    tf, tr = opt.optimizations(ts, tm, options=TOptions())
    want = [(g.name, g.rounds, g.moves_applied, g.swaps_applied,
             i.get("direct_moves", 0), i.get("direct_sweeps", 0))
            for g, i in zip(jr.goal_results, infos)]
    got = [(g.name, g.rounds, g.moves_applied, g.swaps_applied,
            d["direct_moves"], d["direct_sweeps"])
           for g, d in zip(tr.goal_results, opt.last_direct_stats(),
                           strict=True)]
    assert got == want
    assert sum(w[5] for w in want) > 0
    assert tr.violated_goals_before == jr.violated_goals_before
    assert tr.violated_goals_after == jr.violated_goals_after
    assert tr.balancedness_after == jr.balancedness_after
    assert len(tr.proposals) == len(jr.proposals)
    tstats = opt.last_dispatch_stats()
    assert tstats["violation_fingerprint"] is not None
    assert tstats == jstats
    assert digest(tf.assignment.numpy()) == digest(np.asarray(jf.assignment))
    assert digest(tf.leader_slot.numpy()) == \
        digest(np.asarray(jf.leader_slot))
    loop = opt.last_loop_stats()
    assert loop["direct_reads"] == loop["direct_sweeps"] \
        == sum(w[5] for w in want)

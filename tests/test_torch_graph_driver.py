"""The round loop's block loop on the CPU: the code that the card
captures as CUDA graphs, run eagerly.

- A dispatch run K rounds a block (``chain.chain_optimize_rounds`` /
  ``chain_swap_rounds``) equals the per-round loop it replaced
  (``chain._carry_loop``) and, at 16/512, the JAX package's dispatch, in
  assignment, leader slots, moves and rounds; the fused path equals a
  per-round fused loop written out here. (The whole solves through the
  block loop are held against the JAX package by test_torch_chain*.py
  and test_torch_optimizer_bounded*.py.)
- A pass that converges mid-block leaves state, aggregate carry, rounds
  and total bitwise unchanged through its frozen rounds.
- A cap that is not a multiple of K stops there exactly.
- The aggregate refresh lands on the rounds ``maybe_refresh`` picks, with
  the port's ``REFRESH_EVERY`` lowered for both loops: the host's choice
  of each block's refresh rounds (``chain.refresh_rounds``).
- Only the last shape's static buffers and graphs stay cached, and they
  keep no caller's tensor alive.
- No host sync in a block: a block runs under a dispatch mode that fails
  on ``_local_scalar_dense``, ``nonzero``, ``masked_select``, ``unique``,
  a repeat_interleave by a tensor and boolean-mask indexing.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cruise_control_tpu.analyzer import chain as jchain
from cruise_control_tpu.analyzer.constraint import BalancingConstraint as JBC
from cruise_control_tpu.analyzer.goals import ALL_GOALS as J_GOALS
from cruise_control_tpu.analyzer.search import ExclusionMasks as JMasks
from cruise_control_tpu.analyzer.search import SearchConfig as JCfg
from cruise_control_tpu.config.cruise_control_config import DEFAULT_GOALS
from cruise_control_tpu.model.fixtures import Dist as JDist
from cruise_control_tpu.model.fixtures import random_cluster as j_random_cluster
from cruise_control_tpu_torch.analyzer import agg as tagg
from cruise_control_tpu_torch.analyzer import chain as tchain
from cruise_control_tpu_torch.analyzer import fill as tfill
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint as TBC
from cruise_control_tpu_torch.analyzer.goals import ALL_GOALS as T_GOALS
from cruise_control_tpu_torch.analyzer.search import ExclusionMasks as TMasks
from cruise_control_tpu_torch.analyzer.search import SearchConfig as TCfg
from cruise_control_tpu_torch.model.fixtures import Dist as TDist
from cruise_control_tpu_torch.model.fixtures import random_cluster as t_random_cluster
from cruise_control_tpu_torch.model.tensors import set_broker_state
from cruise_control_tpu_torch.testing import digest
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)

NAMES = [g.rsplit(".", 1)[-1] for g in DEFAULT_GOALS]
J_CHAIN = tuple(J_GOALS[n]() for n in NAMES)
T_CHAIN = tuple(T_GOALS[n]() for n in NAMES)
STAGE = dict(rf=3, num_racks=8, seed=42, skew_to_first=2.0,
             target_utilization=0.55)
FIXTURES = {"16_512": dict(num_brokers=16, num_topics=8, num_partitions=512,
                           **STAGE),
            "100_10k": dict(num_brokers=100, num_topics=10,
                            num_partitions=10_000, **STAGE)}
CFG = dict(num_sources=64, num_dests=16, moves_per_round=32, max_rounds=40)
K = tchain.ROUNDS_PER_BLOCK
DISK = NAMES.index("DiskUsageDistributionGoal")
REPLICAS = NAMES.index("ReplicaDistributionGoal")
TOPICS = NAMES.index("TopicReplicaDistributionGoal")
CPU = NAMES.index("CpuUsageDistributionGoal")


def _state(fixture: str):
    return t_random_cluster(**FIXTURES[fixture], dist=TDist.EXPONENTIAL,
                            device="cpu")


def _digests(state) -> tuple[str, str]:
    return (digest(np.asarray(state.assignment, dtype=np.int32)),
            digest(np.asarray(state.leader_slot, dtype=np.int32)))


def _round_fn(phase, i, num_topics, cfg=TCfg(**CFG)):
    """The dispatch's round as ``_carry_loop`` takes it: (state, agg)."""
    prior = [j < i for j in range(len(NAMES))]
    if phase == "move":
        return lambda s, a: tchain._chain_round_body(
            s, a, i, prior, T_CHAIN, TBC(), cfg, num_topics, TMasks())
    return lambda s, a: tchain._chain_swap_body(
        s, a, i, prior, T_CHAIN, TBC(), num_topics, TMasks())


def _block_fn(phase, i, num_topics, cfg=TCfg(**CFG)):
    """The dispatch's round as the block loop takes it."""
    prior = [j < i for j in range(len(NAMES))]
    if phase == "move":
        return lambda s, a, m, live: tchain._chain_round_body(
            s, a, i, prior, T_CHAIN, TBC(), cfg, num_topics, m, live)
    return lambda s, a, m, live: tchain._chain_swap_body(
        s, a, i, prior, T_CHAIN, TBC(), num_topics, m, 8, live)


def _dispatch(phase, state, i, num_topics, budget):
    prior = [j < i for j in range(len(NAMES))]
    if phase == "move":
        return tchain.chain_optimize_rounds(
            state, i, prior, T_CHAIN, TBC(), TCfg(**CFG), num_topics,
            TMasks(), budget=budget)
    return tchain.chain_swap_rounds(state, i, prior, T_CHAIN, TBC(),
                                    num_topics, TMasks(), budget=budget)


def _carry(state, agg, cap) -> tchain.LoopCarry:
    one = torch.ones((), dtype=torch.int32)
    return tchain.LoopCarry(state, agg, torch.ones((), dtype=torch.bool),
                            0 * one, 0 * one, cap * one)


def _agg_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


@pytest.mark.parametrize("fixture,phase,goal,budget", [
    ("16_512", "move", REPLICAS, None), ("16_512", "move", TOPICS, 9),
    ("16_512", "swap", DISK, None), ("16_512", "swap", CPU, 5),
    ("100_10k", "move", TOPICS, 7), ("100_10k", "move", DISK, 2 * K + 1)])
def test_block_loop_equals_per_round_loop(fixture, phase, goal, budget):
    state, meta = _state(fixture)
    t = meta.num_topics
    cap = (CFG["max_rounds"] if phase == "move" else 64) \
        if budget is None else budget
    got, applied, rounds = _dispatch(phase, state, goal, t, budget)
    want, want_applied, want_rounds = tchain._carry_loop(
        _round_fn(phase, goal, t), state, t, cap)
    assert (applied, rounds) == (want_applied, want_rounds)
    assert rounds > 1
    assert _digests(got) == _digests(want)
    if fixture != "16_512":
        return
    js, jm = j_random_cluster(**FIXTURES[fixture], dist=JDist.EXPONENTIAL)
    prior = jnp.asarray([j < goal for j in range(len(NAMES))])
    jbudget = None if budget is None else jnp.int32(budget)
    if phase == "move":
        jst, jn, jr = jchain.chain_optimize_rounds(
            js, jnp.int32(goal), prior, J_CHAIN, JBC(), JCfg(**CFG),
            jm.num_topics, JMasks(), budget=jbudget)
    else:
        jst, jn, jr = jchain.chain_swap_rounds(
            js, jnp.int32(goal), prior, J_CHAIN, JBC(), jm.num_topics,
            JMasks(), budget=jbudget)
    assert (applied, rounds) == (int(jn), int(jr))
    assert _digests(got) == _digests(jst)


def _fused_per_round(state, num_topics, goals, swap_moves=8,
                     swap_max_rounds=64):
    """The fused path's move and swap segments as the port ran them
    before the block loop: one host read a round, the refresh counted
    from each goal's entry across its segments."""
    cfg = TCfg(**CFG)
    masks = TMasks()
    out = []
    for g, goal in enumerate(goals):
        prior = [j < g for j in range(len(goals))]
        viol0, _obj, offline0 = tchain.chain_goal_stats(
            state, g, goals, TBC(), num_topics, masks)
        moves = swaps = rounds = 0
        if viol0 > 0 or offline0 > 0:
            agg = tagg.compute_agg(state, num_topics)
            first, last_swapped = True, 0
            while (first or last_swapped > 0) and rounds < cfg.max_rounds:
                r, applied = 0, 1
                while applied > 0 and r < cfg.max_rounds:
                    agg = tagg.maybe_refresh(agg, state, num_topics,
                                             rounds + r)
                    state, agg, n = tchain._chain_round_body(
                        state, agg, g, prior, goals, TBC(), cfg, num_topics,
                        masks)
                    applied = int(n)
                    moves += applied
                    r += 1
                sw = sr = 0
                if goal.supports_swap:
                    applied = 1
                    while applied > 0 and sr < swap_max_rounds:
                        agg = tagg.maybe_refresh(agg, state, num_topics,
                                                 rounds + r + sr)
                        state, agg, n = tchain._chain_swap_body(
                            state, agg, g, prior, goals, TBC(), num_topics,
                            masks, swap_moves)
                        applied = int(n)
                        sw += applied
                        sr += 1
                swaps += sw
                rounds += r + sr
                last_swapped = sw
                first = False
        out.append((moves, swaps, rounds))
    return state, out


@pytest.mark.parametrize("refresh_every", [64, 3])
def test_fused_block_loop_equals_per_round_fused_loop(monkeypatch,
                                                        refresh_every):
    """The fused path through the block loop equals the per-round
    fused loop; with REFRESH_EVERY lowered to 3 the refresh falls inside
    blocks and across a goal's move and swap segments."""
    monkeypatch.setattr(tagg, "REFRESH_EVERY", refresh_every)
    state, meta = _state("16_512")
    want, want_stats = _fused_per_round(state, meta.num_topics, T_CHAIN)
    got, stats = tchain.chain_optimize_full(
        state, T_CHAIN, TBC(), TCfg(**CFG), meta.num_topics, TMasks())
    assert _digests(got) == _digests(want)
    assert list(zip(stats["moves"], stats["swaps"], stats["rounds"])) \
        == want_stats
    # Some goal runs past two refreshes of the lowered cadence.
    assert max(stats["rounds"]) > 2 * 3


def test_frozen_rounds_leave_the_carry_bitwise_unchanged():
    state, meta = _state("16_512")
    t = meta.num_topics
    fn = _block_fn("move", REPLICAS, t)
    c = _carry(state, tagg.compute_agg(state, t), 100)
    seen = []
    for _ in range(30):
        c = tchain.run_block(fn, c, TMasks(), t, k=1)
        seen.append(c)
        if len(seen) > 3 and not bool(seen[-4].live):
            break
    frozen = [i for i, x in enumerate(seen) if not bool(x.live)]
    assert frozen and frozen[0] >= 2, "the pass must converge mid-run"
    ref = seen[frozen[0]]
    for later in seen[frozen[0] + 1:]:
        assert torch.equal(later.state.assignment, ref.state.assignment)
        assert torch.equal(later.state.leader_slot, ref.state.leader_slot)
        assert _agg_equal(later.agg, ref.agg)
        for name in ("rounds", "total", "live"):
            assert torch.equal(getattr(later, name), getattr(ref, name))
    # Frozen rounds inside a block: the same pass run K rounds a block to
    # well past its fixed point ends where the one-round blocks did.
    c = _carry(state, tagg.compute_agg(state, t), 100)
    c = tchain.run_block(fn, c, TMasks(), t, k=len(seen) + K)
    assert torch.equal(c.state.assignment, ref.state.assignment)
    assert _agg_equal(c.agg, ref.agg)
    assert (int(c.rounds), int(c.total)) == (int(ref.rounds),
                                             int(ref.total))


@pytest.mark.parametrize("budget", [1, K + 1, 3 * K - 1])
def test_cap_not_a_multiple_of_k_stops_there(budget):
    state, meta = _state("16_512")
    tchain.LOOP_STATS.clear()
    _st, applied, rounds = _dispatch("move", state, TOPICS, meta.num_topics,
                                     budget)
    assert rounds == budget and applied > 0
    stats = tchain.LOOP_STATS
    assert stats["blocks"] == -(-budget // K)
    assert stats["device_rounds"] == K * stats["blocks"]
    assert stats["frozen_rounds"] == K * stats["blocks"] - budget
    assert stats["dispatch_reads"] == 1


def _per_round_with_agg(fn, state, agg, num_topics, cap, age):
    """``_carry_loop``'s rounds, returning the aggregate carry too."""
    rounds, applied = 0, 1
    while applied > 0 and rounds < cap:
        agg = tagg.maybe_refresh(agg, state, num_topics, age + rounds)
        state, agg, n = fn(state, agg, TMasks(), None)
        applied = int(n)
        rounds += 1
    return state, agg, rounds


@pytest.mark.parametrize("age", [0, 2])
def test_refresh_lands_where_maybe_refresh_does(monkeypatch, age):
    state, meta = _state("100_10k")
    t = meta.num_topics
    fn = _block_fn("move", DISK, t)
    agg0 = tagg.compute_agg(state, t)
    cap = 7
    outs = {}
    for every in (3, 10 ** 6):
        monkeypatch.setattr(tagg, "REFRESH_EVERY", every)
        want_state, want_agg, rounds = _per_round_with_agg(
            fn, state, agg0, t, cap, age)
        # The dispatch's blocks, each with the refresh rounds the host
        # picks for it.
        got_state, got_agg, read = tchain.run_rounds(
            None, fn, state, agg0, TMasks(), t, cap, age)
        assert read.values()[1] == rounds == cap
        assert torch.equal(got_state.assignment, want_state.assignment)
        assert _agg_equal(got_agg, want_agg), every
        outs[every] = got_agg
    # The refreshed carry differs from the never-refreshed one, so a
    # refresh on another round would show.
    assert not _agg_equal(outs[3], outs[10 ** 6])


class NoHostSync(TorchDispatchMode):
    """Fails on every op that reads device data back to the host or sizes
    its output from the data."""

    BANNED = {"_local_scalar_dense", "nonzero", "masked_select",
              "unique_consecutive", "unique_dim", "_unique", "_unique2",
              "unique_dim_consecutive"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.BANNED or (
                name == "repeat_interleave"
                and func._overloadname in ("Tensor", "self_Tensor")):
            raise AssertionError(f"host sync in a round: {func}")
        if name in ("index", "index_put", "index_put_"):
            indices = args[1] if len(args) > 1 else kwargs["indices"]
            if any(i is not None and i.dtype == torch.bool for i in indices):
                raise AssertionError(f"boolean-mask indexing: {func}")
        return func(*args, **(kwargs or {}))


def test_the_guard_catches_a_host_sync():
    x = torch.arange(6)
    for bad in (lambda: x.sum().item(), lambda: bool(x.any()),
                lambda: torch.nonzero(x), lambda: x[x > 2],
                lambda: x.repeat_interleave(x), lambda: torch.unique(x)):
        with pytest.raises(AssertionError, match="host sync|boolean-mask"):
            with NoHostSync():
                bad()


@pytest.mark.parametrize("case", ["targets_on", "targets_off", "dead"])
def test_a_block_has_no_host_sync(monkeypatch, case):
    """One block of every goal's move round (and of each swap goal's swap
    round) of the default chain, with the targeted column on and off and
    with DEAD brokers (the offline path), under the guard."""
    if case == "targets_off":
        monkeypatch.setattr(tfill, "TARGET_DESTS_MAX_P", 100)
    state, meta = _state("16_512")
    if case == "dead":
        state = set_broker_state(state, torch.tensor([3, 11]), 1)
    t = meta.num_topics
    agg = tagg.compute_agg(state, t)
    for i, goal in enumerate(T_CHAIN):
        phases = ("move", "swap") if goal.supports_swap else ("move",)
        for phase in phases:
            with NoHostSync():
                c = tchain.run_block(_block_fn(phase, i, t),
                                     _carry(state, agg, 10), TMasks(), t)
            assert c.state.assignment.shape == state.assignment.shape


def test_the_graph_cache_keeps_one_shape_and_no_caller_tensor():
    """The static loop of a new shape replaces the old one, and loading a
    state keeps no reference to the caller's tensors."""
    import gc
    import weakref
    tchain.clear_graphs()
    loops = []
    for fixture in ("16_512", "100_10k", "16_512"):
        state, meta = _state(fixture)
        agg = tagg.compute_agg(state, meta.num_topics)
        loop = tchain._static_loop(state, agg, TMasks())
        loop.load(state, agg, TMasks(), cap=4)
        assert len(tchain._LOOPS) == 1
        assert torch.equal(loop.state.assignment, state.assignment)
        loops.append(loop)
        held = weakref.ref(state.assignment)
        del state, agg
        gc.collect()
        assert held() is None, "the static loop kept the caller's state"
    # A shape seen again gets new buffers: the first was dropped.
    assert loops[2] is not loops[0]
    last = loops[2]
    assert tchain._static_loop(last.state, last.agg, last.masks) is last
    tchain.clear_graphs()
    assert not tchain._LOOPS

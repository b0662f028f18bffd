"""The port's bounded per-goal drivers against the JAX package's.

- ``deficit_sized_config`` over a table of (cfg, entry violation, cap);
- ``AdaptiveDispatch`` budget sequences under scripted observations;
- ``run_bounded_pass`` with a scripted dispatch, async readback on and
  off: the one-behind order, the speculative drain, never overshooting
  ``pass_cap``, and the ``DispatchStats`` it records;
- ``chain_optimize_rounds`` / ``chain_swap_rounds`` at budgets 1, 4 and 64
  on the 12-broker / 96-partition fixture, compared by state digest;
- the megastep contracts of tests/test_megastep.py with default-chain
  goals: a bounded run at any dispatch budget equals the per-round run,
  the fused run and the JAX package's bounded run.

Integers and bools are compared exactly and states by digest.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from cruise_control_tpu.analyzer import chain as jchain
from cruise_control_tpu.analyzer.constraint import BalancingConstraint as JBC
from cruise_control_tpu.analyzer.goals import ALL_GOALS as J_GOALS
from cruise_control_tpu.analyzer.search import ExclusionMasks as JMasks
from cruise_control_tpu.analyzer.search import SearchConfig as JCfg
from cruise_control_tpu.config.cruise_control_config import DEFAULT_GOALS
from cruise_control_tpu.model.fixtures import random_cluster as j_random_cluster
from cruise_control_tpu_torch.analyzer import chain as tchain
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint as TBC
from cruise_control_tpu_torch.analyzer.goals import ALL_GOALS as T_GOALS
from cruise_control_tpu_torch.analyzer.search import ExclusionMasks as TMasks
from cruise_control_tpu_torch.analyzer.search import SearchConfig as TCfg
from cruise_control_tpu_torch.model.fixtures import random_cluster as t_random_cluster
from cruise_control_tpu_torch.testing import digest
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)

NAMES = [g.rsplit(".", 1)[-1] for g in DEFAULT_GOALS]
SMALL = dict(num_brokers=12, num_topics=6, num_partitions=96, rf=2,
             num_racks=3, seed=3, skew_to_first=2.0)
# A short chain of default goals: a hard structural goal, a hard capacity
# goal, a swap-capable resource goal and two count goals.
CHAIN = ("RackAwareGoal", "ReplicaCapacityGoal",
         "NetworkOutboundUsageDistributionGoal", "ReplicaDistributionGoal",
         "TopicReplicaDistributionGoal")
CFG = dict(num_sources=32, num_dests=8, moves_per_round=32, max_rounds=60)


def _pair():
    js, jm = j_random_cluster(**SMALL)
    ts, _tm = t_random_cluster(**SMALL, device="cpu")
    return js, jm, ts


def _state_digest(state) -> tuple[str, str]:
    return (digest(np.asarray(state.assignment, dtype=np.int32)),
            digest(np.asarray(state.leader_slot, dtype=np.int32)))


def test_goal_flags_match_the_jax_goals():
    for name in NAMES:
        j, t = J_GOALS[name](), T_GOALS[name]()
        for flag in ("prefers_wide_batches", "count_based", "is_hard",
                     "include_leadership", "leadership_only",
                     "supports_swap", "independent_per_broker"):
            assert getattr(t, flag) == getattr(j, flag), (name, flag)


@pytest.mark.parametrize("cfg,viol0,cap", [
    ((64, 16, 32), 40.0, 2048), ((64, 16, 32), 100.0, 2048),
    ((64, 16, 32), 1_000_000.0, 2048), ((64, 16, 32), 10.0, 2048),
    ((256, 250, 500), 78_962.0, 2048), ((256, 250, 500), 1_500.0, 2048),
    ((1000, 250, 1000), 80_710.0, 2048), ((16, 8, 64), 600.0, 0),
    ((16, 8, 64), 600.0, 128), ((2048, 16, 64), 5_000.0, 1024),
    ((64, 16, 32), 129.0, 2048), ((64, 16, 32), 131.0, 64)])
def test_deficit_sized_config_matches(cfg, viol0, cap):
    sources, dests, moves = cfg
    kw = dict(num_sources=sources, num_dests=dests, moves_per_round=moves,
              max_rounds=100)
    want = jchain.deficit_sized_config(JCfg(**kw), viol0, cap)
    got = tchain.deficit_sized_config(TCfg(**kw), viol0, cap)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# (rounds_run, budget, elapsed_s) observations fed to both controllers
_OBSERVATIONS = [(16, 16, 0.1), (32, 32, 0.2), (64, 64, 9.0), (5, 32, 0.1),
                 (32, 32, 1.2), (32, 32, 0.3), (10, 10, 0.01),
                 (64, 64, 0.01), (128, 128, 6.0), (64, 64, 2.0)]


@pytest.mark.parametrize("initial,target", [(16, 2.5), (1, 2.5), (16, 0.0),
                                            (4, 0.5)])
def test_adaptive_dispatch_budget_sequences_match(initial, target):
    j = jchain.AdaptiveDispatch(initial, target)
    t = tchain.AdaptiveDispatch(initial, target)
    seq_j, seq_t = [], []
    for rounds, budget, elapsed in _OBSERVATIONS:
        seq_j.append(j.budget(100))
        seq_t.append(t.budget(100))
        j.observe(rounds, budget, elapsed)
        t.observe(rounds, budget, elapsed)
        seq_j.append(j.k)
        seq_t.append(t.k)
    assert seq_t == seq_j


class _Script:
    """Fake dispatch: a pass that applies one move per round for ``work``
    rounds, then reaches its fixed point (every later round applies 0)."""

    def __init__(self, work: int, ring: bool):
        self.work = work
        self.done = 0
        self.enqueued: list[int] = []
        self.ring = ring

    def __call__(self, st, budget: int):
        self.enqueued.append(budget)
        remaining = max(0, self.work - self.done)
        if remaining == 0:
            rounds, applied = 1, 0
        else:
            rounds = min(budget, remaining)
            applied = rounds
            self.done += rounds
            if rounds < budget:
                rounds += 1
        out = (st + applied, applied, rounds, False)
        return out + (None,) if self.ring else out


class _Read:
    """A dispatch's (applied, rounds) as the port's pump reads them."""

    def __init__(self, applied: int, rounds: int):
        self._values = (applied, rounds)

    def values(self) -> tuple[int, int]:
        return self._values


def _port_enqueue(script):
    """``script`` under the port's enqueue contract: (st, read, donated)."""
    def enqueue(st, budget: int):
        st, applied, rounds, donated = script(st, budget)
        return st, _Read(applied, rounds), donated
    return enqueue


def _spy(mod, k):
    class Spy(mod.AdaptiveDispatch):
        def __init__(self):
            super().__init__(k, target_s=0.0)
            self.events = []

        def budget(self, remaining):
            b = super().budget(remaining)
            self.events.append(("budget", b))
            return b

        def observe(self, rounds_run, budget, elapsed_s):
            self.events.append(("observe", rounds_run, budget))
            super().observe(rounds_run, budget, elapsed_s)
    return Spy()


@pytest.mark.parametrize("async_rb", [True, False])
@pytest.mark.parametrize("work,cap,k", [(5, 100, 2), (1000, 20, 8),
                                        (0, 100, 4), (16, 16, 16),
                                        (37, 64, 1), (64, 64, 16)])
def test_run_bounded_pass_matches(async_rb, work, cap, k):
    results = []
    for mod, ring in ((jchain, True), (tchain, False)):
        script, ctl, stats = _Script(work, ring), _spy(mod, k), \
            mod.DispatchStats()
        enqueue = script if mod is jchain else _port_enqueue(script)
        out = mod.run_bounded_pass(enqueue, 0, cap, ctl,
                                   async_readback=async_rb, stats=stats)
        results.append((out, script.enqueued, ctl.events, stats.as_dict()))
        assert sum(script.enqueued) <= cap + k
    assert results[1] == results[0]
    (_st, applied, rounds), enqueued, events, _stats = results[1]
    assert applied == min(work, cap) and rounds <= cap
    if async_rb and len(enqueued) > 1:
        assert [e[0] for e in events[:3]] == ["budget", "budget", "observe"]
    elif len(enqueued) > 1:
        assert [e[0] for e in events[:3]] == ["budget", "observe", "budget"]


@pytest.mark.parametrize("budget", [1, 4, 64])
@pytest.mark.parametrize("i", [0, 2, 3, 4])
def test_bounded_dispatches_match(budget, i):
    js, jm, ts = _pair()
    jgoals = tuple(J_GOALS[n]() for n in CHAIN)
    tgoals = tuple(T_GOALS[n]() for n in CHAIN)
    prior = [j < i for j in range(len(CHAIN))]
    want, jmoves, jrounds = jchain.chain_optimize_rounds(
        js, jnp.int32(i), jnp.asarray(prior), jgoals, JBC(), JCfg(**CFG),
        jm.num_topics, JMasks(), budget=jnp.int32(budget))
    got, tmoves, trounds = tchain.chain_optimize_rounds(
        ts, i, prior, tgoals, TBC(), TCfg(**CFG), jm.num_topics, TMasks(),
        budget=budget)
    assert (tmoves, trounds) == (int(jmoves), int(jrounds))
    assert _state_digest(got) == _state_digest(want)
    if not tgoals[i].supports_swap:
        return
    want, jsw, jsr = jchain.chain_swap_rounds(
        want, jnp.int32(i), jnp.asarray(prior), jgoals, JBC(), jm.num_topics,
        JMasks(), budget=jnp.int32(budget))
    got, tsw, tsr = tchain.chain_swap_rounds(
        got, i, prior, tgoals, TBC(), jm.num_topics, TMasks(),
        budget=budget)
    assert (tsw, tsr) == (int(jsw), int(jsr))
    assert _state_digest(got) == _state_digest(want)


def _run_chain(mod, state, num_topics, megastep, dispatch_rounds, goals,
               cfg_cls, bc, masks):
    infos = []
    stats = mod.DispatchStats()
    for i in range(len(goals)):
        state, info = mod.optimize_goal_in_chain(
            state, goals, i, bc, cfg_cls(**CFG), num_topics, masks,
            dispatch_rounds=dispatch_rounds, megastep=megastep, stats=stats)
        infos.append(info)
    return state, infos, stats.as_dict()


def test_megastep_parity_per_round_vs_k_vs_fused_vs_jax():
    """The bounded run at any dispatch budget, async readback on or off,
    walks the per-round run's trajectory, which is the fused run's and the
    JAX package's bounded run's."""
    js, jm, ts = _pair()
    jgoals = tuple(J_GOALS[n]() for n in CHAIN)
    tgoals = tuple(T_GOALS[n]() for n in CHAIN)
    ref, ref_infos, _ = _run_chain(
        tchain, ts, jm.num_topics,
        tchain.MegastepConfig(donate=False, async_readback=False), 1, tgoals,
        TCfg, TBC(), TMasks())
    fused, _ = tchain.optimize_chain(ts, tgoals, TBC(), TCfg(**CFG),
                                     jm.num_topics, TMasks())
    assert _state_digest(fused) == _state_digest(ref)
    for k in (4, 64):
        for async_rb in (True, False):
            mega = dict(donate=True, async_readback=async_rb)
            st, infos, stats = _run_chain(
                tchain, ts, jm.num_topics, tchain.MegastepConfig(**mega), k,
                tgoals, TCfg, TBC(), TMasks())
            assert _state_digest(st) == _state_digest(ref)
            for a, b in zip(ref_infos, infos):
                assert a["moves_applied"] == b["moves_applied"], a["goal"]
                assert a["succeeded"] == b["succeeded"], a["goal"]
            jst, jinfos, jstats = _run_chain(
                jchain, js, jm.num_topics, jchain.MegastepConfig(**mega), k,
                jgoals, JCfg, JBC(), JMasks())
            assert _state_digest(jst) == _state_digest(st)
            assert stats == jstats
            for a, b in zip(jinfos, infos):
                for key in ("rounds", "moves_applied", "swaps_applied",
                            "succeeded", "violated_on_entry",
                            "offline_remaining"):
                    assert a[key] == b[key], (a["goal"], key)


def test_deficit_sizing_invariant_across_dispatch_budgets():
    _js, jm, ts = _pair()
    tgoals = tuple(T_GOALS[n]() for n in CHAIN)
    mega = tchain.MegastepConfig(async_readback=True, deficit_moves_cap=256)
    st1, infos1, _ = _run_chain(tchain, ts, jm.num_topics, mega, 1, tgoals,
                                TCfg, TBC(), TMasks())
    st2, infos2, _ = _run_chain(tchain, ts, jm.num_topics, mega, 16, tgoals,
                                TCfg, TBC(), TMasks())
    assert _state_digest(st1) == _state_digest(st2)
    for a, b in zip(infos1, infos2):
        assert a["moves_applied"] == b["moves_applied"], a["goal"]


def test_early_exit_freezes_a_converged_state():
    """A dispatch on a converged state runs one zero-apply round and
    leaves the state as it was: what the speculative dispatch relies on."""
    _js, jm, ts = _pair()
    tgoals = tuple(T_GOALS[n]() for n in CHAIN)
    st, _infos, _ = _run_chain(tchain, ts, jm.num_topics, None, 0, tgoals,
                               TCfg, TBC(), TMasks())
    before = _state_digest(st)
    for i in range(len(tgoals)):
        new_st, moves, rounds = tchain.chain_optimize_rounds(
            st, i, [j < i for j in range(len(tgoals))], tgoals, TBC(),
            TCfg(**CFG), jm.num_topics, TMasks(), budget=50)
        assert (moves, rounds) == (0, 1), tgoals[i].name
        assert _state_digest(new_st) == before


def test_donation_is_off_and_dispatch_stats_account_like_jax():
    assert not tchain.donation_enabled(tchain.MegastepConfig(donate=True))
    assert not tchain.donation_enabled(None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tchain.MegastepConfig(direct_assignment=True)
    dicts = []
    for mod in (jchain, tchain):
        s = mod.DispatchStats()
        for r in (16, 2, 8):
            s.record("move", r)
        s.record("swap", 1, donated=True, speculative=True)
        s.goals_skipped = 3
        s.fingerprint = 1234
        dicts.append(s.as_dict())
    assert dicts[1] == dicts[0]


def test_kernel_argument_errors_name_the_kernels_limits():
    import torch

    from cruise_control_tpu_torch import kernels
    t = torch.zeros(3, dtype=torch.float32)
    with pytest.raises(ValueError, match=r"select_batch kernel: score: "
                       r"shape \(3,\), expected \(4,\).*4096 reduced rows"):
        kernels.require(t, t.device, torch.float32, (4,), "score",
                        "select_batch")
    with pytest.raises(ValueError, match="B <= 16384"):
        raise kernels.limit_error("select_sources", "B=20000")
    assert kernels.requirer("apply_deltas")(
        t, t.device, torch.float32, (3,), "x") is t

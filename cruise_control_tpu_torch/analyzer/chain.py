"""The goal chain on one device: the fused whole-chain driver and the
bounded per-goal drivers.

Port of the single-device parts of ``cruise_control_tpu/analyzer/chain.py``:
``_chain_round_body``, ``_chain_swap_body``, the goal-stats bodies,
``chain_optimize_full`` and the bounded path (``chain_optimize_rounds``,
``chain_swap_rounds``, ``AdaptiveDispatch``, ``run_bounded_pass``,
``deficit_sized_config`` and ``optimize_goal_in_chain``).

JAX traces the chain once and switches on a traced goal index; here the
active goal index and the prior-goal set are host values of a Python loop
over the chain, so the reference's ``lax.switch`` over goals is plain
indexing, its gated aux ``lax.cond`` is an ``if``, and its on-device
``while_loop`` to the fixed point is a Python loop that reads one scalar
(the round's applied count) back per round. In the fused driver the
aggregate carry is computed at each goal's entry and refreshed every
``REFRESH_EVERY`` rounds counted since the goal's entry, across its move
and swap segments; a bounded dispatch computes it at its own entry and
counts the refresh cadence from there, as the reference's megastep does.

Reference semantics preserved: the lexicographic acceptance stack of
AbstractGoal.maybeApplyBalancingAction:230-272 (every candidate must be
accepted by every previously-optimized goal).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..model.tensors import (
    ClusterTensors, alive_mask, broker_segments, offline_replicas,
)
from ..utils.numerics import VECTOR_SUM_LENGTHS, xla_sum, xla_vector_sum
from .agg import (
    AggCarry, apply_deltas_to_agg, compute_agg, maybe_refresh,
    offline_per_broker, pot_lbi_deltas,
)
from .candidates import compute_deltas, generate_candidates, select_sources
from .constraint import BalancingConstraint
from .derived import compute_derived
from .fill import pow2_width, targets_enabled
from .goals.base import Goal
from .goals.distribution import ResourceDistributionGoal
from .search import (
    _OFFLINE_BONUS, ExclusionMasks, OptimizationFailureError, SearchConfig,
    apply_selected, apply_swap_selection, cumulative_select, goal_aux,
    swap_grid,
)


class StatsRegressionError(RuntimeError):
    """A goal's own objective regressed during its own optimization
    (AbstractGoal.java:111-119)."""


def _derived(state, masks: ExclusionMasks, agg=None):
    return compute_derived(state, masks.excluded_topics,
                           masks.excluded_replica_move_brokers,
                           masks.excluded_leadership_brokers, agg=agg)


def _aux(goal: Goal, state, derived, constraint, num_topics: int,
         agg: AggCarry | None):
    """The goal's aux, read from the aggregate carry where the goal is
    agg-backed."""
    if agg is not None:
        partial = goal.partial_from_agg(agg)
        if partial is not None:
            return goal.finalize_aux(partial, state, derived, constraint)
    return goal_aux(goal, state, derived, constraint, num_topics)


def _aux_list(goals, active: int, prior, state, derived, constraint,
              num_topics, agg):
    """Aux of the active and prior goals; None for the rest (never read)."""
    return [_aux(g, state, derived, constraint, num_topics, agg)
            if (prior[i] or i == active) else None
            for i, g in enumerate(goals)]


def excluded_hosting_replicas(state: ClusterTensors,
                              excluded_replica_move_brokers: torch.Tensor,
                              ) -> torch.Tensor:
    """[P, S] bool: replica sits on an ALIVE excluded-for-replica-move
    broker (a drain is pending while any is true)."""
    excl_alive = excluded_replica_move_brokers & alive_mask(state)
    pad = torch.cat([excl_alive, torch.zeros(1, dtype=torch.bool,
                                             device=state.device)])
    return pad[broker_segments(state)]


def _chain_round_body(state: ClusterTensors, agg: AggCarry | None,
                      active: int, prior: Sequence[bool],
                      goals: tuple[Goal, ...],
                      constraint: BalancingConstraint, cfg: SearchConfig,
                      num_topics: int, masks: ExclusionMasks,
                      ) -> tuple[ClusterTensors, AggCarry | None,
                                 torch.Tensor]:
    """One search round for goal ``goals[active]`` under the acceptance of
    every goal with ``prior[i]``. Returns (new_state, new_agg, applied)."""
    goal = goals[active]
    dev = state.device
    derived = _derived(state, masks, agg)
    aux_list = _aux_list(goals, active, prior, state, derived, constraint,
                         num_topics, agg)
    aux = aux_list[active]
    src_score = goal.source_score(state, derived, constraint, aux) \
        .to(torch.float32)
    dst_score = goal.dest_score(state, derived, constraint, aux) \
        .to(torch.float32)
    weight = goal.replica_weight(state, derived, constraint, aux) \
        .to(torch.float32)

    # Self-healing priority: offline replicas are always sources with
    # maximal weight for non-leadership goals (the bonus is added as a
    # zero vector for leadership-only goals, as the reference does).
    off = offline_replicas(state)
    off_pb = offline_per_broker(state)
    src_score = src_score + (torch.zeros_like(off_pb)
                             if goal.leadership_only else off_pb)
    if not goal.leadership_only:
        weight = torch.where(off, torch.full((), 1e30, device=dev), weight)

    # One select_sources per round, shared by the targeted column and the
    # candidate grid.
    sources = None
    extra = None
    targets = targets_enabled(state.num_partitions)
    if targets:
        sources = select_sources(state, src_score, weight, cfg.num_sources)
        cand_p, cand_s, src_valid = sources
        td = goal.target_dests(state, derived, constraint, aux, cand_p,
                               cand_s, src_valid)
        if td is None:
            extra = (torch.zeros_like(cand_p),
                     torch.zeros(cand_p.shape, dtype=torch.bool, device=dev))
        else:
            # Targets pause while any offline replica exists.
            extra = (td[0].to(torch.int32), td[1] & ~off.any())
    cand, layout = generate_candidates(
        state, derived, src_score, dst_score, weight, cfg.num_sources,
        cfg.num_dests, include_leadership=True, leadership_only=False,
        extra_dst=extra, sources=sources)
    (r0, c0), (r1, c1) = layout
    has_leadership = goal.include_leadership or goal.leadership_only
    block_ok = torch.cat([
        torch.full((r0 * c0,), not goal.leadership_only, dtype=torch.bool,
                   device=dev),
        torch.full((r1 * c1,), has_leadership, dtype=torch.bool, device=dev)])
    cand = dataclasses.replace(cand, valid=cand.valid & block_ok)
    deltas = compute_deltas(state, derived, cand)

    accept = deltas.valid
    for i, g in enumerate(goals):
        if prior[i]:
            accept = accept & g.acceptance(state, derived, constraint,
                                           aux_list[i], deltas)
    moving_offline = off[deltas.partition.long(), deltas.src_slot.long()] \
        & (deltas.replica_delta > 0)
    imp = goal.improvement(state, derived, constraint, aux, deltas) \
        .to(torch.float32)
    imp = torch.where(moving_offline & torch.isfinite(imp) & deltas.valid,
                      torch.clamp(imp, min=0.0) + _OFFLINE_BONUS, imp)
    score = torch.where(accept, imp,
                        torch.full((), float("-inf"), device=dev))

    independent = goal.independent_per_broker and not any(prior)
    m = max(cfg.moves_per_round, cfg.num_sources)

    def recheck(sub, has_earlier):
        """Joint acceptance with cumulative pre-deltas: every prior goal,
        plus the ACTIVE goal's own acceptance for rows that interact with
        an earlier one."""
        a = torch.ones(sub.valid.shape[0], dtype=torch.bool, device=dev)
        for i, g in enumerate(goals):
            if prior[i] or i == active:
                g_acc = g.acceptance(state, derived, constraint, aux_list[i],
                                     sub)
                if prior[i]:
                    a = a & g_acc
                if i == active:
                    a = a & ((~has_earlier) | g_acc)
        return a

    top_idx, sel, sub, pot_d, lbi_d = cumulative_select(
        state, deltas, score, layout, m, cfg.moves_per_round, independent,
        recheck, extra_last_col=targets)
    if agg is not None:
        agg = apply_deltas_to_agg(agg, sub, sel, pot_d, lbi_d)
    ti = top_idx.long()
    new_state = apply_selected(
        state, sel, deltas.partition[ti], deltas.src_slot[ti],
        deltas.dst_broker[ti], cand.kind[ti], cand.dst_slot[ti])
    return new_state, agg, sel.sum()


def _chain_swap_body(state: ClusterTensors, agg: AggCarry | None,
                     active: int, prior: Sequence[bool],
                     goals: tuple[Goal, ...],
                     constraint: BalancingConstraint, num_topics: int,
                     masks: ExclusionMasks, moves: int = 8,
                     ) -> tuple[ClusterTensors, AggCarry | None,
                                torch.Tensor]:
    """One swap round for goal ``goals[active]``."""
    goal = goals[active]
    derived = _derived(state, masks, agg)
    aux_list = _aux_list(goals, active, prior, state, derived, constraint,
                         num_topics, agg)
    aux = aux_list[active]
    src_score = goal.source_score(state, derived, constraint, aux) \
        .to(torch.float32)
    weight = goal.replica_weight(state, derived, constraint, aux) \
        .to(torch.float32)
    dst_score = goal.swap_dest_score(state, derived, constraint, aux) \
        .to(torch.float32)

    fwd, rev, net, p1, s1, p2, s2, src_b, dst_b, base_valid = swap_grid(
        state, derived, src_score, dst_score, weight)
    accept = base_valid
    for i, g in enumerate(goals):
        if prior[i]:
            accept = accept & g.swap_acceptance(state, derived, constraint,
                                                aux_list[i], fwd, rev, net)
    imp = goal.swap_improvement(state, derived, constraint, aux, fwd, rev,
                                net).to(torch.float32)
    score = torch.where(accept, imp,
                        torch.full((), float("-inf"), device=state.device))
    new_state, applied, top_idx, sel = apply_swap_selection(
        state, score, p1, s1, p2, s2, src_b, dst_b, moves)
    if agg is not None:
        for leg in (fwd, rev):
            leg_sub = leg.take(top_idx)
            pot_d, lbi_d = pot_lbi_deltas(state, leg_sub)
            agg = apply_deltas_to_agg(agg, leg_sub, sel, pot_d, lbi_d)
    return new_state, agg, applied


def chain_goal_stats(state: ClusterTensors, active: int,
                           goals: tuple[Goal, ...],
                           constraint: BalancingConstraint, num_topics: int,
                           masks: ExclusionMasks,
                           ) -> tuple[float, float, int]:
    """(total violation, objective, offline replicas) of one goal — one
    host read of three scalars."""
    derived = _derived(state, masks)
    g = goals[active]
    aux = goal_aux(g, state, derived, constraint, num_topics)
    viol = xla_sum(g.broker_violations(state, derived, constraint, aux)
                   .to(torch.float32), 0)
    obj = g.objective(state, derived, constraint, aux).to(torch.float32)
    offline = offline_replicas(state).sum()
    host = torch.stack([viol, obj, offline.to(torch.float32)]).cpu()
    return float(host[0]), float(host[1]), int(offline.item())


def chain_all_violations(state: ClusterTensors, goals: tuple[Goal, ...],
                         constraint: BalancingConstraint, num_topics: int,
                         masks: ExclusionMasks) -> torch.Tensor:
    """[G] total violation per goal on ``state`` (derived state shared)."""
    derived = _derived(state, masks)
    totals = []
    for g in goals:
        aux = goal_aux(g, state, derived, constraint, num_topics)
        totals.append(xla_sum(g.broker_violations(state, derived, constraint,
                                                  aux).to(torch.float32), 0))
    return torch.stack(totals)


def chain_all_goal_stats(state: ClusterTensors, goals: tuple[Goal, ...],
                         constraint: BalancingConstraint, num_topics: int,
                         masks: ExclusionMasks,
                         ) -> tuple[np.ndarray, np.ndarray, int]:
    """([G] violation, [G] objective, offline replicas) of every goal on
    ``state`` (derived state shared), in one host read: the bounded
    path's fingerprint-skip snapshot."""
    derived = _derived(state, masks)
    # With a replica-move exclusion mask in the program, XLA:CPU
    # vectorizes the resource distribution goals' violation reduce at some
    # broker counts (``xla_vector_sum``).
    vectorized = masks.excluded_replica_move_brokers is not None \
        and state.num_brokers in VECTOR_SUM_LENGTHS
    viols, objs = [], []
    for g in goals:
        aux = goal_aux(g, state, derived, constraint, num_topics)
        per_broker = g.broker_violations(state, derived, constraint,
                                         aux).to(torch.float32)
        viols.append(xla_vector_sum(per_broker)
                     if vectorized and isinstance(g, ResourceDistributionGoal)
                     else xla_sum(per_broker, 0))
        objs.append(g.objective(state, derived, constraint, aux)
                    .to(torch.float32))
    host = torch.stack(viols + objs).cpu().numpy()
    g_count = len(goals)
    return (host[:g_count], host[g_count:],
            int(offline_replicas(state).sum().item()))


def chain_optimize_full(state: ClusterTensors, goals: tuple[Goal, ...],
                        constraint: BalancingConstraint, cfg: SearchConfig,
                        num_topics: int, masks: ExclusionMasks,
                        swap_moves: int = 8, swap_max_rounds: int = 64):
    """The whole goal chain: each goal runs its move loop to the fixed
    point and, for swap-capable goals, its swap loop, interleaved until a
    swap pass applies nothing, all under the acceptance of every earlier
    goal. A goal with no violation, no offline replica and no pending
    drain is skipped. Returns (final_state, per-goal stats of host
    numbers)."""
    stats = {k: [] for k in ("viol_before", "obj_before", "offline_before",
                             "viol_after", "obj_after", "offline_after",
                             "moves", "swaps", "rounds")}

    def drain_pending(s: ClusterTensors) -> bool:
        if masks.excluded_replica_move_brokers is None:
            return False
        return bool(excluded_hosting_replicas(
            s, masks.excluded_replica_move_brokers).any())

    for g, goal in enumerate(goals):
        prior = [j < g for j in range(len(goals))]
        viol0, obj0, offline0 = chain_goal_stats(
            state, g, goals, constraint, num_topics, masks)
        moves = swaps = rounds = 0
        if viol0 > 0 or offline0 > 0 or drain_pending(state):
            agg = compute_agg(state, num_topics)
            first, last_swapped = True, 0
            while (first or last_swapped > 0) and rounds < cfg.max_rounds:
                r, applied = 0, 1
                while applied > 0 and r < cfg.max_rounds:
                    agg = maybe_refresh(agg, state, num_topics, rounds + r)
                    state, agg, n = _chain_round_body(
                        state, agg, g, prior, goals, constraint, cfg,
                        num_topics, masks)
                    applied = int(n)
                    moves += applied
                    r += 1
                sw = sr = 0
                if goal.supports_swap:
                    applied = 1
                    while applied > 0 and sr < swap_max_rounds:
                        agg = maybe_refresh(agg, state, num_topics,
                                            rounds + r + sr)
                        state, agg, n = _chain_swap_body(
                            state, agg, g, prior, goals, constraint,
                            num_topics, masks, swap_moves)
                        applied = int(n)
                        sw += applied
                        sr += 1
                swaps += sw
                rounds += r + sr
                last_swapped = sw
                first = False
        viol1, obj1, offline1 = chain_goal_stats(
            state, g, goals, constraint, num_topics, masks)
        for key, value in (("viol_before", viol0), ("obj_before", obj0),
                           ("offline_before", offline0),
                           ("viol_after", viol1), ("obj_after", obj1),
                           ("offline_after", offline1), ("moves", moves),
                           ("swaps", swaps), ("rounds", rounds)):
            stats[key].append(value)
    return state, stats


def optimize_chain(state: ClusterTensors, chain: Sequence[Goal],
                   constraint: BalancingConstraint, cfg: SearchConfig,
                   num_topics: int, masks: ExclusionMasks | None = None,
                   ) -> tuple[ClusterTensors, list[dict]]:
    """Run the whole goal chain; returns (final_state, [per-goal info dict
    in chain order]). Raises on a goal regressing its own objective and on
    an unsatisfied hard goal, in chain order."""
    masks = masks or ExclusionMasks()
    goals = tuple(chain)
    if not goals:
        return state, []
    state, stats = chain_optimize_full(state, goals, constraint, cfg,
                                       num_topics, masks)
    return state, _chain_infos_from_stats(goals, stats)


def _chain_infos_from_stats(goals: tuple[Goal, ...], stats: dict,
                            ) -> list[dict]:
    """Per-goal info dicts from the chain stats; raises the per-goal errors
    in chain order."""
    infos: list[dict] = []
    for i, goal in enumerate(goals):
        obj0, obj1 = float(stats["obj_before"][i]), float(stats["obj_after"][i])
        if int(stats["offline_before"][i]) == 0:
            if obj1 > obj0 + 1e-4 * max(1.0, abs(obj0)):
                raise StatsRegressionError(
                    f"goal {goal.name} regressed its own objective during "
                    f"its optimization: {obj0:.6g} -> {obj1:.6g}")
        total_violation = float(stats["viol_after"][i])
        succeeded = total_violation <= 1e-6
        rounds = int(stats["rounds"][i])
        if goal.is_hard and not succeeded:
            raise OptimizationFailureError(
                f"hard goal {goal.name} unsatisfied: residual violation "
                f"{total_violation:.4f} after {rounds} rounds")
        swaps = int(stats["swaps"][i])
        infos.append({
            "goal": goal.name,
            "rounds": rounds,
            "moves_applied": int(stats["moves"][i]) + swaps,
            "swaps_applied": swaps,
            "residual_violation": total_violation,
            "succeeded": succeeded,
            "objective": obj1,
            "violation_before": float(stats["viol_before"][i]),
            "violated_on_entry": float(stats["viol_before"][i]) > 1e-6,
            "offline_before": int(stats["offline_before"][i]),
            "offline_remaining": int(stats["offline_after"][i]),
        })
    return infos


# ---------------------------------------------------------------------------
# The bounded per-goal path: each goal's move and swap passes run as a
# sequence of dispatches of at most ``budget`` rounds each.
# ---------------------------------------------------------------------------


def _carry_loop(round_fn, state: ClusterTensors, num_topics: int, cap: int,
                ) -> tuple[ClusterTensors, int, int]:
    """Rounds of ``round_fn(state, agg) -> (state, agg, applied)`` until
    one applies nothing or ``cap`` rounds ran, with the aggregate carry
    computed at entry and refreshed every ``REFRESH_EVERY`` rounds of this
    call (the reference's ``run_carry_loop`` under one dispatch). Returns
    (state, total applied, rounds run)."""
    agg = compute_agg(state, num_topics)
    total = rounds = 0
    applied = 1
    while applied > 0 and rounds < cap:
        agg = maybe_refresh(agg, state, num_topics, rounds)
        state, agg, n = round_fn(state, agg)
        applied = int(n)
        total += applied
        rounds += 1
    return state, total, rounds


def chain_optimize_rounds(state: ClusterTensors, active: int,
                          prior: Sequence[bool], goals: tuple[Goal, ...],
                          constraint: BalancingConstraint, cfg: SearchConfig,
                          num_topics: int, masks: ExclusionMasks,
                          budget: int | None = None,
                          ) -> tuple[ClusterTensors, int, int]:
    """One move dispatch for goal ``goals[active]``: rounds to the fixed
    point, at most ``cfg.max_rounds`` and ``budget``. Returns
    (state, moves, rounds)."""
    cap = cfg.max_rounds if budget is None else min(cfg.max_rounds,
                                                    int(budget))
    return _carry_loop(
        lambda s, a: _chain_round_body(s, a, active, prior, goals,
                                       constraint, cfg, num_topics, masks),
        state, num_topics, cap)


def chain_swap_rounds(state: ClusterTensors, active: int,
                      prior: Sequence[bool], goals: tuple[Goal, ...],
                      constraint: BalancingConstraint, num_topics: int,
                      masks: ExclusionMasks, moves: int = 8,
                      max_rounds: int = 64, budget: int | None = None,
                      ) -> tuple[ClusterTensors, int, int]:
    """One swap dispatch for goal ``goals[active]`` (see
    chain_optimize_rounds). Returns (state, swaps, rounds)."""
    cap = max_rounds if budget is None else min(max_rounds, int(budget))
    return _carry_loop(
        lambda s, a: _chain_swap_body(s, a, active, prior, goals, constraint,
                                      num_topics, masks, moves),
        state, num_topics, cap)


class AdaptiveDispatch:
    """Sizes bounded dispatches by wall-clock: the per-dispatch round
    budget doubles after a full dispatch that took under half of
    ``target_s`` and halves after one over twice it (never below the
    initial budget, never above MAX_ROUNDS). ``target_s`` = 0 keeps the
    budget fixed. The trajectory does not depend on the budget sequence;
    only the dispatch boundaries move."""

    MAX_ROUNDS = 1024

    def __init__(self, initial_rounds: int, target_s: float):
        self.k = max(1, initial_rounds)
        self._min = max(1, initial_rounds)
        self._target_s = target_s

    def budget(self, remaining: int) -> int:
        return min(self.k, remaining)

    def observe(self, rounds_run: int, budget: int, elapsed_s: float) -> None:
        if self._target_s <= 0 or rounds_run < budget:
            # A partial dispatch reached the pass's fixed point: its
            # duration says nothing about a full budget's cost.
            return
        if elapsed_s > 2 * self._target_s:
            self.k = max(self._min, self.k // 2)
        elif elapsed_s < self._target_s / 2 and budget == self.k:
            # Grow only on a full k-round dispatch, not on a tail dispatch
            # capped by the pass's remaining rounds.
            self.k = min(self.k * 2, self.MAX_ROUNDS)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to cruise_control_tpu_torch yet "
        f"(ROADMAP.md: {item})")


@dataclasses.dataclass(frozen=True)
class MegastepConfig:
    """Knobs of the bounded path, resolved by the optimizer.

    - ``donate``: the reference donates the mutable state tensors to XLA;
      PyTorch has no donation, so the port records every dispatch as not
      donated (``donation_enabled`` is always false).
    - ``async_readback``: enqueue dispatch N+1 before reading dispatch N's
      scalars (the one-behind pump of ``run_bounded_pass``).
    - ``deficit_moves_cap``: > 0 sizes the count goals' moves per round and
      source width from their entry violation (``deficit_sized_config``).
    - ``direct_*``: the direct-assignment transport of the reference
      (``analyzer/direct.py``), not ported: ``direct_assignment=True``
      raises.
    """

    donate: bool = True
    async_readback: bool = True
    deficit_moves_cap: int = 0
    direct_assignment: bool = False
    direct_max_sweeps: int = 16
    direct_sparse_margin: float = 0.25
    direct_sparse_salt: str = ""
    direct_goals: "tuple[str, ...] | None" = None

    def __post_init__(self):
        if self.direct_assignment:
            raise _not_ported("The direct-assignment transport "
                              "(solver.direct.assignment.enabled)",
                              "Queue A item 11, analyzer/direct.py")


def donation_enabled(megastep: MegastepConfig | None) -> bool:
    """Always false: PyTorch has no buffer donation (each dispatch's
    state is a new tensor generation, as with an undonated XLA call)."""
    return False


class DispatchStats:
    """Per-pass dispatch accounting: how many dispatches the solve cost,
    how many rounds each carried, and how many were donated (none here)
    or speculative (the async pump's post-convergence re-run)."""

    def __init__(self):
        self.rounds_per_dispatch: list[int] = []
        self.donated = 0
        self.speculative = 0
        # Goals that took no dispatch thanks to the fingerprint snapshot.
        self.goals_skipped = 0
        # crc32 of the pass's entry-violation vector (None without it).
        self.fingerprint = None

    def record(self, kind: str, rounds: int, donated: bool = False,
               speculative: bool = False) -> None:
        self.rounds_per_dispatch.append(int(rounds))
        if donated:
            self.donated += 1
        if speculative:
            self.speculative += 1

    @property
    def dispatch_count(self) -> int:
        return len(self.rounds_per_dispatch)

    def rounds_p50(self) -> float:
        if not self.rounds_per_dispatch:
            return 0.0
        ordered = sorted(self.rounds_per_dispatch)
        return float(ordered[(len(ordered) - 1) // 2])

    def as_dict(self) -> dict:
        out = {"dispatch_count": self.dispatch_count,
               "rounds_per_dispatch_p50": self.rounds_p50(),
               "donated_dispatches": self.donated,
               "speculative_dispatches": self.speculative}
        if self.goals_skipped:
            out["goals_skipped"] = self.goals_skipped
        if self.fingerprint is not None:
            out["violation_fingerprint"] = self.fingerprint
        return out


def deficit_sized_config(cfg: SearchConfig, viol0: float,
                         cap: int) -> SearchConfig:
    """Deficit-aware sizing for the count goals: each move fixes up to 2
    units of total band violation, so the move target is ``viol0 / 2``,
    rounded up to a power of two and clamped to [cfg values, cap]; the
    source width (one move per source row) follows it."""
    target = int(viol0) // 2
    if target <= cfg.moves_per_round:
        return cfg
    q = min(pow2_width(target), max(cap, cfg.moves_per_round))
    if q <= cfg.moves_per_round and q <= cfg.num_sources:
        return cfg
    return dataclasses.replace(
        cfg, moves_per_round=max(cfg.moves_per_round, q),
        num_sources=max(cfg.num_sources, q))


def run_bounded_pass(enqueue: Callable, st, pass_cap: int,
                     controller: AdaptiveDispatch,
                     out_of_time: Callable[[], bool] | None = None,
                     async_readback: bool = True,
                     stats: DispatchStats | None = None,
                     kind: str = "move"):
    """One logical pass (a fixed-point loop of at most ``pass_cap`` rounds)
    as a sequence of bounded dispatches.

    ``enqueue(st, budget) -> (st, applied, rounds, donated)`` runs one
    dispatch. With ``async_readback`` the pump keeps one dispatch ahead:
    dispatch N+1 is enqueued, budgeted as if N ran its whole budget (so it
    can never overshoot ``pass_cap``), before N's scalars are read and the
    controller observes N. A dispatch that ran fewer rounds than its
    budget reached the fixed point; the successor already enqueued then
    re-runs one zero-apply round: it is recorded as speculative and adds
    neither moves nor rounds to the pass. Returns
    (st, applied_total, pass_rounds)."""
    applied_total = 0
    pass_rounds = 0
    est_rounds = 0
    prev = None    # (applied, rounds, budget, t0, donated), not yet read
    last_read_t = None
    converged = False
    while True:
        cur = None
        may_enqueue = prev is None or async_readback
        if may_enqueue and not converged and est_rounds < pass_cap \
                and not (out_of_time is not None and out_of_time()):
            budget = controller.budget(pass_cap - est_rounds)
            t0 = time.monotonic()
            st, applied, r, donated = enqueue(st, budget)
            cur = (applied, r, budget, t0, donated)
            est_rounds += budget
        if prev is not None:
            applied_p, r_p, budget_p, t0_p, donated_p = prev
            r_read = int(r_p)
            now = time.monotonic()
            start = t0_p if last_read_t is None else max(t0_p, last_read_t)
            applied_total += int(applied_p)
            controller.observe(r_read, budget_p, now - start)
            last_read_t = now
            if stats is not None:
                stats.record(kind, r_read, donated=donated_p)
            pass_rounds += r_read
            est_rounds -= budget_p - r_read
            if r_read < budget_p:
                converged = True
        if converged and cur is not None:
            if stats is not None:
                stats.record(kind, int(cur[1]), donated=cur[4],
                             speculative=True)
            cur = None
        prev = cur
        if prev is None and (converged or est_rounds >= pass_cap
                             or (out_of_time is not None and out_of_time())):
            break
    return st, applied_total, pass_rounds


def optimize_goal_in_chain(state: ClusterTensors, chain: Sequence[Goal],
                           index: int, constraint: BalancingConstraint,
                           cfg: SearchConfig, num_topics: int,
                           masks: ExclusionMasks | None = None,
                           dispatch_rounds: int = 0,
                           dispatch: AdaptiveDispatch | None = None,
                           wall_budget_s: float = 0.0,
                           megastep: MegastepConfig | None = None,
                           stats: DispatchStats | None = None,
                           entry_stats: tuple | None = None,
                           drain_hint: bool | None = None,
                           ) -> tuple[ClusterTensors, dict]:
    """Run goal ``chain[index]`` to convergence under the acceptance of
    ``chain[:index]``.

    ``dispatch_rounds`` > 0 runs each move and swap pass as dispatches of
    at most that many rounds, sized by ``dispatch`` and pumped by
    ``run_bounded_pass`` (the same trajectory, other boundaries); 0 runs
    each pass as one dispatch. ``wall_budget_s`` > 0 (fast mode) stops
    dispatching once the goal's wall-clock exceeds it. ``entry_stats`` and
    ``drain_hint`` are the goal's entry (violation, objective, offline)
    and drain flag from the chain's snapshot, valid while no earlier goal
    has changed the state; a goal they show idle takes no dispatch.

    Raises StatsRegressionError when the goal's objective regressed
    (unless offline replicas existed at entry) and
    OptimizationFailureError when a hard goal stays violated."""
    goal_t0 = time.monotonic()

    def out_of_time() -> bool:
        return wall_budget_s > 0 \
            and time.monotonic() - goal_t0 > wall_budget_s

    masks = masks or ExclusionMasks()
    goals = tuple(chain)
    goal = goals[index]
    prior = [j < index for j in range(len(goals))]

    if entry_stats is not None:
        viol0, obj0, offline0 = entry_stats
    else:
        viol0, obj0, offline0 = chain_goal_stats(state, index, goals,
                                                 constraint, num_topics,
                                                 masks)
    total_applied = 0
    total_swaps = 0
    rounds = 0
    bounded = dispatch_rounds > 0
    if bounded and dispatch is None:
        dispatch = AdaptiveDispatch(dispatch_rounds, target_s=0.0)
    async_rb = bool(megastep.async_readback) if megastep is not None \
        else False
    drain = False
    if masks.excluded_replica_move_brokers is not None:
        drain = bool(drain_hint) if drain_hint is not None \
            else bool(excluded_hosting_replicas(
                state, masks.excluded_replica_move_brokers).any())
    if bounded and megastep is not None and megastep.deficit_moves_cap > 0 \
            and goal.count_based:
        cfg = deficit_sized_config(cfg, float(viol0),
                                   megastep.deficit_moves_cap)

    def run_pass(phase: str, st, pass_cap: int):
        if not bounded:
            if phase == "move":
                st, applied, r = chain_optimize_rounds(
                    st, index, prior, goals, constraint, cfg, num_topics,
                    masks)
            else:
                st, applied, r = chain_swap_rounds(
                    st, index, prior, goals, constraint, num_topics, masks)
            if stats is not None:
                stats.record(phase, r)
            return st, applied, r

        def enqueue(st, budget: int):
            if phase == "move":
                st, applied, r = chain_optimize_rounds(
                    st, index, prior, goals, constraint, cfg, num_topics,
                    masks, budget=budget)
            else:
                st, applied, r = chain_swap_rounds(
                    st, index, prior, goals, constraint, num_topics, masks,
                    budget=budget)
            return st, applied, r, donation_enabled(megastep)

        return run_bounded_pass(
            enqueue, st, pass_cap, dispatch,
            out_of_time=out_of_time if wall_budget_s > 0 else None,
            async_readback=async_rb, stats=stats, kind=phase)

    # Nothing violated, nothing offline and no drain pending: the fixed
    # point is immediate, so no pass runs.
    ran = float(viol0) > 0 or int(offline0) > 0 or drain
    if not ran and entry_stats is not None and stats is not None:
        stats.goals_skipped += 1
    if ran:
        while rounds < cfg.max_rounds and not out_of_time():
            state, moves, r = run_pass("move", state, cfg.max_rounds)
            total_applied += moves
            rounds += r
            if not goal.supports_swap:
                break
            state, swapped, sr = run_pass("swap", state, 64)
            total_swaps += swapped
            total_applied += swapped
            rounds += sr
            if swapped == 0:
                break
        viol, obj, offline = chain_goal_stats(state, index, goals,
                                              constraint, num_topics, masks)
    else:
        viol, obj, offline = viol0, obj0, offline0
    if int(offline0) == 0:
        before, after = float(obj0), float(obj)
        if after > before + 1e-4 * max(1.0, abs(before)):
            raise StatsRegressionError(
                f"goal {goal.name} regressed its own objective during its "
                f"optimization: {before:.6g} -> {after:.6g}")
    total_violation = float(viol)
    succeeded = total_violation <= 1e-6
    if goal.is_hard and not succeeded:
        raise OptimizationFailureError(
            f"hard goal {goal.name} unsatisfied: residual violation "
            f"{total_violation:.4f} after {rounds} rounds")
    return state, {
        "goal": goal.name,
        "rounds": rounds,
        "moves_applied": total_applied,
        "swaps_applied": total_swaps,
        "residual_violation": total_violation,
        "succeeded": succeeded,
        "objective": float(obj),
        "violated_on_entry": float(viol0) > 1e-6,
        "offline_remaining": int(offline),
    }

"""The goal chain on one device: the fused whole-chain driver and the
bounded per-goal drivers.

Port of the single-device parts of ``cruise_control_tpu/analyzer/chain.py``:
``_chain_round_body``, ``_chain_swap_body``, the goal-stats bodies,
``chain_optimize_full`` and the bounded path (``chain_optimize_rounds``,
``chain_swap_rounds``, ``AdaptiveDispatch``, ``run_bounded_pass``,
``deficit_sized_config``, ``direct_path_chosen`` and
``optimize_goal_in_chain`` with its direct-assignment pre-pass).

JAX traces the chain once and switches on a traced goal index; here the
active goal index and the prior-goal set are host values of a Python loop
over the chain, so the reference's ``lax.switch`` over goals is plain
indexing and its gated aux ``lax.cond`` is an ``if``. Its on-device
``while_loop`` to the fixed point (``run_carry_loop``) is the round loop
below: blocks of ``ROUNDS_PER_BLOCK`` rounds carrying the early-exit flag
on the device, captured as CUDA graphs on the card and run eagerly on
the CPU, with one host read of (applied, rounds) a dispatch. On the fused
path the aggregate carry is computed at each goal's entry and refreshed
every ``REFRESH_EVERY`` rounds counted since the goal's entry, across its
move and swap segments; a bounded dispatch computes it at its own entry
and counts the refresh cadence from there, as the reference's megastep
does.

Reference semantics preserved: the lexicographic acceptance stack of
AbstractGoal.maybeApplyBalancingAction:230-272 (every candidate must be
accepted by every previously-optimized goal).
"""

from __future__ import annotations

import collections
import dataclasses
import time
import weakref
from typing import Callable, Sequence

import numpy as np
import torch

from ..model.tensors import (
    FIELDS, ClusterTensors, alive_mask, broker_segments, offline_replicas,
)
from ..utils import graphs
from ..utils.numerics import xla_sum, xla_vector_sum
from . import agg as agg_mod
from .agg import (
    AggCarry, apply_deltas_to_agg, compute_agg, maybe_refresh,
    pot_lbi_deltas,
)
from .candidates import grid_spec, select_sources
from .constraint import BalancingConstraint
from .derived import compute_derived
from .fill import pow2_width, targets_enabled
from .goals.base import Goal
from .score_grid import goal_table, recheck, score_grid
from .search import (
    ExclusionMasks, OptimizationFailureError, SearchConfig,
    apply_selected, apply_swap_selection, cumulative_select, goal_aux,
    swap_grid,
)
from .slot_pass import slot_weights


# A swap pass's round cap (the reference's ``chain_swap_rounds``
# default).
SWAP_MAX_ROUNDS = 64


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
                      live: torch.Tensor | None = None,
                      ) -> tuple[ClusterTensors, AggCarry | None,
                                 torch.Tensor]:
    """One search round for goal ``goals[active]`` under the acceptance of
    every goal with ``prior[i]``. ``live`` (a bool scalar) gates the
    selected batch: a frozen round of the round loop applies nothing.
    Returns (new_state, new_agg, applied)."""
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
    # Self-healing priority: offline replicas are always sources with
    # maximal weight (1e30, K7's override) for non-leadership goals, and
    # each broker's source score gains its offline replicas (K7's int32
    # count, exact in f32; the bonus is added as a zero vector for
    # leadership-only goals, as the reference does).
    weight, off, off_any, off_pb = slot_weights(
        goal, state, derived, constraint, aux, num_topics,
        not goal.leadership_only)
    src_score = src_score + (torch.zeros_like(off_pb)
                             if goal.leadership_only else off_pb)

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
            extra = (td[0].to(torch.int32), td[1] & ~off_any)
    spec = grid_spec(state, src_score, dst_score, weight, cfg.num_sources,
                     cfg.num_dests, include_leadership=True,
                     leadership_only=False, extra_dst=extra, sources=sources)
    layout = spec.layout
    has_leadership = goal.include_leadership or goal.leadership_only
    # On the card K6 reads the goals through one table a round, shared by
    # the grid and the recheck.
    table = goal_table(goals, aux_list, active, prior, state, derived,
                       constraint) if dev.type == "cuda" else None
    deltas, kind, _accept, score = score_grid(
        state, derived, constraint, goals, aux_list, active, prior, off,
        spec, not goal.leadership_only, has_leadership, num_topics, table)

    independent = goal.independent_per_broker and not any(prior)
    m = max(cfg.moves_per_round, cfg.num_sources)

    def joint_recheck(sub, has_earlier):
        return recheck(state, derived, constraint, goals, aux_list, active,
                       prior, sub, has_earlier, num_topics, table)

    top_idx, sel, sub, pot_d, lbi_d = cumulative_select(
        state, deltas, score, layout, m, cfg.moves_per_round, independent,
        joint_recheck, extra_last_col=targets)
    if live is not None:
        sel = sel & live
    if agg is not None:
        agg = apply_deltas_to_agg(agg, sub, sel, pot_d, lbi_d)
    ti = top_idx.long()
    new_state = apply_selected(
        state, sel, deltas.partition[ti], deltas.src_slot[ti],
        deltas.dst_broker[ti], kind[ti], deltas.dst_slot[ti])
    return new_state, agg, sel.sum()


def _chain_swap_body(state: ClusterTensors, agg: AggCarry | None,
                     active: int, prior: Sequence[bool],
                     goals: tuple[Goal, ...],
                     constraint: BalancingConstraint, num_topics: int,
                     masks: ExclusionMasks, moves: int = 8,
                     live: torch.Tensor | None = None,
                     ) -> tuple[ClusterTensors, AggCarry | None,
                                torch.Tensor]:
    """One swap round for goal ``goals[active]`` (``live`` as in
    _chain_round_body)."""
    goal = goals[active]
    derived = _derived(state, masks, agg)
    aux_list = _aux_list(goals, active, prior, state, derived, constraint,
                         num_topics, agg)
    aux = aux_list[active]
    src_score = goal.source_score(state, derived, constraint, aux) \
        .to(torch.float32)
    weight, *_offline = slot_weights(goal, state, derived, constraint, aux,
                                     num_topics, False)
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
        state, score, p1, s1, p2, s2, src_b, dst_b, moves, live)
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
    LOOP_STATS["stats_reads"] += 1
    return float(host[0]), float(host[1]), int(host[2])


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


# How XLA:CPU compiles the reference's ``chain_all_goal_stats`` at 16-32
# brokers (its optimized HLO and LLVM IR, ``XLA_FLAGS=--xla_dump_to``, for
# the default goal chain on ``random_cluster(B, 48, 640, rf=2,
# num_racks=4)``, with and without a replica-move exclusion): each goal's
# violation reduce over the brokers is its own fusion, scalar and
# sequential (``xla_sum``) except where LLVM's loop vectorizer took it
# (``xla_vector_sum``). Goal: (broker counts without the exclusion, with
# it, whether the operand is a strided column whose load group leaves a
# gap). The four resource distribution goals read a column of the [B, 4]
# load (at 18 brokers without the exclusion the CPU column stayed scalar),
# the capacity goals and PotentialNwOutGoal too; the replica and leader
# count goals a contiguous [B] (XLA emitted one kernel for both). Every
# other goal of the chain (rack, replica capacity, topic replica, leader
# bytes-in) stayed sequential at every length, or sums exact integers.
STATS_VECTOR_REDUCE = {
    "CpuUsageDistributionGoal": (range(19, 33), range(16, 33), True),
    "DiskUsageDistributionGoal": (range(18, 33), range(16, 33), True),
    "NetworkInboundUsageDistributionGoal": (range(18, 33), range(16, 33),
                                            True),
    "NetworkOutboundUsageDistributionGoal": (range(18, 33), range(16, 33),
                                             True),
    "CpuCapacityGoal": (range(28, 33), range(28, 33), True),
    "DiskCapacityGoal": (range(25, 33), range(25, 33), True),
    "NetworkInboundCapacityGoal": (range(25, 33), range(25, 33), True),
    "NetworkOutboundCapacityGoal": (range(25, 33), range(25, 33), True),
    "PotentialNwOutGoal": (range(28, 33), range(28, 33), True),
    "ReplicaDistributionGoal": (range(23, 33), range(23, 33), False),
    "LeaderReplicaDistributionGoal": (range(23, 33), range(23, 33), False),
}
# With the exclusion, the same program also vectorizes the two column sums
# of the average utilization (``compute_derived``) from 25 brokers on: 8
# lanes over the first 24 brokers of each strided column at 25-27 and 32,
# two interleaved 4-lane accumulators at 28-31 (added lane by lane and
# reduced by halves: the same bits as the 8 lanes, as the IR reads). At
# 28-31 the compiled program's bits still differ from that form in some
# cases (ROADMAP, Queue C).
STATS_VECTOR_AVG_LENGTHS = range(25, 33)


def _stats_derived(state: ClusterTensors, masks: ExclusionMasks):
    """``_derived`` with the average utilization summed as the stats
    snapshot's program sums it (``STATS_VECTOR_AVG_LENGTHS``)."""
    derived = _derived(state, masks)
    excluded = masks.excluded_replica_move_brokers
    if excluded is None or state.num_brokers not in STATS_VECTOR_AVG_LENGTHS:
        return derived
    allowed = derived.allowed_replica_move[:, None]
    cols = range(state.capacity.shape[1])
    cap = torch.clamp(torch.stack([xla_vector_sum(
        (state.capacity * allowed)[:, r].contiguous()) for r in cols]),
        min=1e-9)
    load = torch.stack([xla_vector_sum(
        (derived.broker_load * allowed)[:, r].contiguous()) for r in cols])
    return dataclasses.replace(derived, avg_util=load / cap)


def chain_all_goal_stats(state: ClusterTensors, goals: tuple[Goal, ...],
                         constraint: BalancingConstraint, num_topics: int,
                         masks: ExclusionMasks,
                         ) -> tuple[np.ndarray, np.ndarray, int]:
    """([G] violation, [G] objective, offline replicas) of every goal on
    ``state`` (derived state shared), in one host read: the bounded
    path's fingerprint-skip snapshot. Each goal's violation is reduced as
    the reference's compiled snapshot reduces it
    (``STATS_VECTOR_REDUCE``), and a goal whose objective is its total
    violation reports that same value (XLA computes it once)."""
    derived = _stats_derived(state, masks)
    column = 1 if masks.excluded_replica_move_brokers is not None else 0
    viols, objs = [], []
    for g in goals:
        aux = goal_aux(g, state, derived, constraint, num_topics)
        per_broker = g.broker_violations(state, derived, constraint,
                                         aux).to(torch.float32)
        form = STATS_VECTOR_REDUCE.get(g.name)
        viol = xla_vector_sum(per_broker, gap=form[2]) \
            if form is not None and state.num_brokers in form[column] \
            else xla_sum(per_broker, 0)
        viols.append(viol)
        objs.append(viol if type(g).objective is Goal.objective
                    else g.objective(state, derived, constraint, aux)
                    .to(torch.float32))
    offline = offline_replicas(state).sum().to(torch.float32)
    host = torch.stack(viols + objs + [offline]).cpu().numpy()
    LOOP_STATS["stats_reads"] += 1
    g_count = len(goals)
    return host[:g_count], host[g_count:2 * g_count], int(host[-1])


def chain_optimize_full(state: ClusterTensors, goals: tuple[Goal, ...],
                        constraint: BalancingConstraint, cfg: SearchConfig,
                        num_topics: int, masks: ExclusionMasks,
                        swap_moves: int = 8,
                        swap_max_rounds: int = SWAP_MAX_ROUNDS):
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
            # The carry is computed at the goal's entry; the refresh counts
            # rounds from there across the goal's move and swap segments.
            agg = compute_agg(state, num_topics)
            first, last_swapped = True, 0
            while (first or last_swapped > 0) and rounds < cfg.max_rounds:
                state, agg, read = _dispatch(
                    "move", state, g, prior, goals, constraint, num_topics,
                    masks, cfg=cfg, agg=agg, age=rounds)
                applied, r = read.values()
                moves += applied
                sw = sr = 0
                if goal.supports_swap:
                    state, agg, read = _dispatch(
                        "swap", state, g, prior, goals, constraint,
                        num_topics, masks, moves=swap_moves,
                        max_rounds=swap_max_rounds, agg=agg, age=rounds + r)
                    sw, sr = read.values()
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


# ---------------------------------------------------------------------------
# The round loop: the reference's ``run_carry_loop`` (search.py), its
# early-exit flag kept on the device. A dispatch of budget b runs
# ceil(b / K) blocks of K rounds and reads (applied, rounds) back once; on
# the card each block is a captured CUDA graph replayed over static
# buffers, on the CPU the same block runs eagerly.
# ---------------------------------------------------------------------------

# Rounds per block (K). A block runs all its rounds; once its pass has
# converged the rest run frozen (they change nothing but cost their
# device time), and on the card a dispatch stops at most one block after
# the block in which it froze (one replay stays in flight). A small K
# keeps that waste to a few rounds a dispatch; each replay still carries
# thousands of device ops.
ROUNDS_PER_BLOCK = 2

# Round-loop accounting of the current solve (the optimizer resets it):
# ``captures`` and ``capture_s`` (graphs captured, seconds including each
# one's eager warm-up round), ``replays`` (card) or ``blocks`` (CPU),
# ``dispatch_reads`` (one host read of (applied, rounds) a dispatch),
# ``live_polls`` (host reads of the freeze flag between replays),
# ``stats_reads`` (host reads of goal statistics), ``device_rounds`` (rounds
# the blocks ran) and ``frozen_rounds`` (those of them that ran frozen).
LOOP_STATS: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class LoopCarry:
    """The round loop's carry, the reference's ``(carry, total, rounds,
    last_applied)``: ``state`` and ``agg``; ``live`` (bool), no round of
    the dispatch has applied nothing yet (ANDed with ``rounds < cap`` at
    each round's start); ``rounds`` and ``total`` (int32), the rounds run
    and moves applied in the dispatch, which frozen rounds leave as they
    are; ``cap`` (int32), the dispatch's round budget."""

    state: ClusterTensors
    agg: AggCarry
    live: torch.Tensor
    rounds: torch.Tensor
    total: torch.Tensor
    cap: torch.Tensor


def _agg_fields(agg: AggCarry) -> list[torch.Tensor]:
    return [getattr(agg, f.name) for f in dataclasses.fields(agg)]


def carry_round(round_fn, c: LoopCarry, masks: ExclusionMasks,
                num_topics: int, refresh: bool = False) -> LoopCarry:
    """One round of the loop, in effect only while ``live``: the body runs
    on every call, but a frozen round applies nothing (``round_fn`` gates
    its batch with ``live``), skips the refresh and counts nothing, so it
    leaves the carry bitwise as it was. ``refresh`` (chosen by the host,
    see ``refresh_rounds``) recomputes the aggregate carry before the
    body, as ``maybe_refresh`` does. No host sync, and every shape fixed
    by the inputs' shapes."""
    live = c.live & (c.rounds < c.cap)
    agg = c.agg
    if refresh:
        agg = AggCarry(*(torch.where(live, f, a) for f, a in zip(
            _agg_fields(compute_agg(c.state, num_topics)),
            _agg_fields(agg))))
    state, agg, applied = round_fn(c.state, agg, masks, live)
    applied = applied.to(torch.int32)
    return LoopCarry(state, agg, live & (applied > 0),
                     c.rounds + live.to(torch.int32), c.total + applied,
                     c.cap)


def refresh_rounds(age: int, first: int, k: int) -> tuple[int, ...]:
    """The rounds of a block of ``k`` whose first round is the dispatch's
    round ``first`` that refresh the aggregate carry: those where
    ``age + round`` is ``REFRESH_EVERY - 1`` modulo ``REFRESH_EVERY``
    (``age``, rounds counted toward the refresh before the dispatch; the
    fused path counts from the goal's entry). While a block is live its
    rounds are the dispatch's rounds ``first`` to ``first + k - 1``, and
    a frozen round refreshes nothing, so the host knows these rounds
    without reading the device."""
    every = agg_mod.REFRESH_EVERY
    return tuple(r for r in range(k)
                 if (age + first + r) % every == every - 1)


def run_block(round_fn, c: LoopCarry, masks: ExclusionMasks,
              num_topics: int, k: int | None = None,
              refresh: tuple[int, ...] = ()) -> LoopCarry:
    """``k`` (default ``ROUNDS_PER_BLOCK``) rounds of ``carry_round``,
    those in ``refresh`` with the aggregate refresh: what one CUDA graph
    captures, and what the CPU runs eagerly."""
    for r in range(ROUNDS_PER_BLOCK if k is None else k):
        c = carry_round(round_fn, c, masks, num_topics, r in refresh)
    return c


class LoopRead:
    """A dispatch's (applied, rounds), read from the host once, when first
    asked for; the read also books the dispatch's device and frozen
    rounds into LOOP_STATS (a swap dispatch's also under
    ``swap_device_rounds`` and ``swap_rounds``)."""

    def __init__(self, total: torch.Tensor, rounds: torch.Tensor,
                 device_rounds: int, swap: bool = False):
        self._read = graphs.HostRead(total, rounds)
        self._device_rounds = device_rounds
        self._swap = swap
        self._values = None

    def values(self) -> tuple[int, int]:
        if self._values is None:
            total, rounds = self._read.values()
            LOOP_STATS["dispatch_reads"] += 1
            LOOP_STATS["device_rounds"] += self._device_rounds
            LOOP_STATS["frozen_rounds"] += self._device_rounds - rounds
            if self._swap:
                LOOP_STATS["swap_device_rounds"] += self._device_rounds
                LOOP_STATS["swap_rounds"] += rounds
            self._values = (total, rounds)
        return self._values


class _StaticLoop:
    """The static buffers of one shape (device, P, S, B, topics, masks)
    and the block graphs captured over them, keyed by everything that
    fixes a block's shapes and Python control flow. A dispatch copies its
    state, aggregate carry and masks in (skipping a tensor it copied last
    time and that is still alive, or one that is already the static
    buffer), sets the scalars, replays, and hands back fresh copies of
    the assignment and leader slots: a state a caller holds never aliases
    a buffer that a later replay overwrites."""

    def __init__(self, state: ClusterTensors, agg: AggCarry,
                 masks: ExclusionMasks):
        dev = state.device
        self.state = ClusterTensors(**{f: torch.empty_like(getattr(state, f))
                                       for f in FIELDS})
        self.agg = AggCarry(*(torch.empty_like(x) for x in _agg_fields(agg)))
        self.masks = ExclusionMasks(**{
            f.name: None if getattr(masks, f.name) is None
            else torch.empty_like(getattr(masks, f.name))
            for f in dataclasses.fields(masks)})
        self.live = torch.ones((), dtype=torch.bool, device=dev)
        self.rounds, self.total, self.cap = (
            torch.zeros((), dtype=torch.int32, device=dev) for _ in range(3))
        self.graphs: dict = {}
        # Buffer name -> weak reference to the tensor last copied in: the
        # loop never keeps a caller's tensor alive.
        self._loaded: dict = {}

    def _buffers(self, state, agg, masks):
        yield from ((f, getattr(state, f), getattr(self.state, f))
                    for f in FIELDS)
        yield from ((f"agg.{i}", a, b) for i, (a, b) in enumerate(
            zip(_agg_fields(agg), _agg_fields(self.agg))))
        yield from ((f"masks.{f.name}", getattr(masks, f.name),
                     getattr(self.masks, f.name))
                    for f in dataclasses.fields(masks))

    def load(self, state: ClusterTensors, agg: AggCarry,
             masks: ExclusionMasks, cap: int) -> None:
        for name, src, dst in self._buffers(state, agg, masks):
            last = self._loaded.get(name)
            if src is None or src is dst or (last is not None
                                             and last() is src):
                continue
            dst.copy_(src)
            self._loaded[name] = weakref.ref(src)
        self.live.fill_(True)
        self.rounds.zero_()
        self.total.zero_()
        self.cap.fill_(cap)

    def carry(self) -> LoopCarry:
        return LoopCarry(self.state, self.agg, self.live, self.rounds,
                         self.total, self.cap)

    def store(self, out: LoopCarry) -> None:
        self.state.assignment.copy_(out.state.assignment)
        self.state.leader_slot.copy_(out.state.leader_slot)
        for dst, src in zip(_agg_fields(self.agg), _agg_fields(out.agg)):
            dst.copy_(src)
        for dst, src in ((self.live, out.live), (self.rounds, out.rounds),
                         (self.total, out.total)):
            dst.copy_(src)

    def graph(self, key, round_fn, num_topics: int,
              refresh: tuple[int, ...] = ()) -> graphs.Graph:
        """The block graph of ``key`` with the aggregate refresh on the
        block's rounds ``refresh``, captured on first use after one round
        run eagerly on the static carry, its result discarded (it loads
        the kernels' libraries and PyTorch's lazily built state outside
        the capture)."""
        g = self.graphs.get((key, refresh))
        if g is None:
            t0 = time.perf_counter()
            carry_round(round_fn, self.carry(), self.masks, num_topics,
                        bool(refresh))

            def block():
                self.store(run_block(round_fn, self.carry(), self.masks,
                                     num_topics, refresh=refresh))

            g = graphs.capture(block, self.state.device)
            self.graphs[key, refresh] = g
            LOOP_STATS["captures"] += 1
            LOOP_STATS["capture_s"] += time.perf_counter() - t0
        return g

    def result(self, state: ClusterTensors) -> ClusterTensors:
        out = dataclasses.replace(
            state, assignment=self.state.assignment.clone(),
            leader_slot=self.state.leader_slot.clone())
        self._loaded["assignment"] = weakref.ref(out.assignment)
        self._loaded["leader_slot"] = weakref.ref(out.leader_slot)
        return out


# The static loop of the last shape solved, under its key. A new shape
# drops the old one with its graphs: a cluster whose partition or topic
# count changes between solves keeps one shape's buffers on the card,
# not one per shape it ever had.
_LOOPS: dict = {}


def _static_loop(state: ClusterTensors, agg: AggCarry,
                 masks: ExclusionMasks) -> _StaticLoop:
    key = (state.device, tuple(state.assignment.shape), state.num_brokers,
           tuple(agg.topic_counts.shape),
           tuple(None if getattr(masks, f.name) is None
                 else tuple(getattr(masks, f.name).shape)
                 for f in dataclasses.fields(masks)))
    loop = _LOOPS.get(key)
    if loop is None:
        _LOOPS.clear()
        loop = _LOOPS[key] = _StaticLoop(state, agg, masks)
    return loop


def clear_graphs() -> None:
    """Drop the captured block graphs and their static buffers (they are
    kept across solves of one shape, so a steady solve captures
    nothing)."""
    _LOOPS.clear()


def run_rounds(key, round_fn, state: ClusterTensors, agg: AggCarry,
               masks: ExclusionMasks, num_topics: int, cap: int,
               age: int = 0, reach: int | None = None, swap: bool = False,
               ) -> tuple[ClusterTensors, AggCarry, LoopRead]:
    """Rounds of ``round_fn(state, agg, masks, live) -> (state, agg,
    applied)`` from (``state``, ``agg``) until one applies nothing or
    ``cap`` rounds ran: ceil(cap / K) blocks at most, then one host read.
    ``age`` counts rounds toward the aggregate refresh before the
    dispatch (``refresh_rounds``); ``swap`` books the rounds as swap
    rounds too (``LoopRead``).

    On a CUDA device each block is a graph of ``key`` (``key`` must name
    everything that fixes ``round_fn``'s shapes and control flow; the
    block's refresh rounds pick the variant), replayed over static
    buffers. The variants that a dispatch of ``key`` at this ``age`` and
    up to ``reach`` rounds (default ``cap``) could replay are captured
    together when the first of them is missing, so a later dispatch
    given a larger budget (the adaptive dispatch grows) captures
    nothing. Between replays of a dispatch of three or more blocks the
    host polls ``live`` one block behind, keeping one replay in flight,
    and stops once a block ended frozen. A capture or replay failure
    raises; nothing runs the rounds eagerly on the card. On the CPU the
    blocks run eagerly, and the host reads ``live`` after each. Returns
    (state, agg, the dispatch's LoopRead)."""
    k = ROUNDS_PER_BLOCK
    blocks = max(0, -(-int(cap) // k))
    dev = state.device
    if dev.type == "cpu":
        zero = torch.zeros((), dtype=torch.int32)
        c = LoopCarry(state, agg, torch.ones((), dtype=torch.bool), zero,
                      zero, zero + int(cap))
        ran = 0
        while ran < blocks:
            c = run_block(round_fn, c, masks, num_topics,
                          refresh=refresh_rounds(age, k * ran, k))
            ran += 1
            if not bool(c.live):
                break
        LOOP_STATS["blocks"] += ran
        return c.state, c.agg, LoopRead(c.total, c.rounds, ran * k, swap)
    if dev.type != "cuda":
        raise ValueError(f"run_rounds: unsupported device {dev}")
    loop = _static_loop(state, agg, masks)
    loop.load(state, agg, masks, int(cap))
    # (age + k*j) % REFRESH_EVERY repeats within REFRESH_EVERY blocks.
    reach_blocks = -(-max(int(cap), int(reach or 0)) // k)
    for refresh in sorted({refresh_rounds(age, k * j, k) for j in range(
            min(reach_blocks, agg_mod.REFRESH_EVERY))}):
        loop.graph(key, round_fn, num_topics, refresh)
    flags = {}
    ran = 0
    while ran < blocks:
        loop.graph(key, round_fn, num_topics,
                   refresh_rounds(age, k * ran, k)).replay()
        ran += 1
        j = ran - 1
        if j + 2 < blocks:
            flags[j] = graphs.HostRead(loop.live)
        if j >= 1 and j + 1 < blocks:
            LOOP_STATS["live_polls"] += 1
            if not flags.pop(j - 1).values()[0]:
                break
    LOOP_STATS["replays"] += ran
    read = LoopRead(loop.total, loop.rounds, ran * k, swap)
    return loop.result(state), loop.agg, read


def _dispatch(phase: str, state: ClusterTensors, active: int,
              prior: Sequence[bool], goals: tuple[Goal, ...],
              constraint: BalancingConstraint, num_topics: int,
              masks: ExclusionMasks, budget: int | None = None,
              cfg: SearchConfig | None = None, moves: int = 8,
              max_rounds: int = SWAP_MAX_ROUNDS,
              agg: AggCarry | None = None, age: int = 0,
              reach: int | None = None,
              ) -> tuple[ClusterTensors, AggCarry, LoopRead]:
    """One dispatch of goal ``goals[active]``'s move or swap rounds
    (``phase``): at most ``budget`` rounds and the phase's cap
    (``cfg.max_rounds`` for moves, ``max_rounds`` for swaps). ``reach``
    is the largest budget a dispatch of this pass may be given
    (``run_rounds``). The aggregate carry is computed at entry unless
    given."""
    prior = tuple(bool(p) for p in prior)
    if phase == "move":
        def round_fn(s, a, m, live):
            return _chain_round_body(s, a, active, prior, goals, constraint,
                                     cfg, num_topics, m, live)
        key = ("move", active, prior, goals, constraint, cfg, num_topics,
               targets_enabled(state.num_partitions))
        cap = cfg.max_rounds
    else:
        def round_fn(s, a, m, live):
            return _chain_swap_body(s, a, active, prior, goals, constraint,
                                    num_topics, m, moves, live)
        key = ("swap", active, prior, goals, constraint, num_topics, moves)
        cap = max_rounds
    if reach is not None:
        reach = min(cap, int(reach))
    if budget is not None:
        cap = min(cap, int(budget))
    if agg is None:
        agg = compute_agg(state, num_topics)
    return run_rounds(key, round_fn, state, agg, masks, num_topics, cap, age,
                      reach, swap=phase == "swap")


def _carry_loop(round_fn, state: ClusterTensors, num_topics: int, cap: int,
                ) -> tuple[ClusterTensors, int, int]:
    """The per-round loop the block loop replaced, kept as its
    reference in the tests: rounds of ``round_fn(state, agg) -> (state,
    agg, applied)`` read back one at a time, until one applies nothing or
    ``cap`` rounds ran, the aggregate carry computed at entry and
    refreshed by ``maybe_refresh``. Returns (state, total applied,
    rounds run)."""
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
    state, _agg, read = _dispatch(
        "move", state, active, prior, goals, constraint, num_topics, masks,
        budget, cfg=cfg)
    return (state, *read.values())


def chain_swap_rounds(state: ClusterTensors, active: int,
                      prior: Sequence[bool], goals: tuple[Goal, ...],
                      constraint: BalancingConstraint, num_topics: int,
                      masks: ExclusionMasks, moves: int = 8,
                      max_rounds: int = SWAP_MAX_ROUNDS,
                      budget: int | None = None,
                      ) -> tuple[ClusterTensors, int, int]:
    """One swap dispatch for goal ``goals[active]`` (see
    chain_optimize_rounds). Returns (state, swaps, rounds)."""
    state, _agg, read = _dispatch(
        "swap", state, active, prior, goals, constraint, num_topics, masks,
        budget, moves=moves, max_rounds=max_rounds)
    return (state, *read.values())


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

    def ceiling(self) -> int:
        """The largest budget this controller can ever give."""
        return self.k if self._target_s <= 0 else self.MAX_ROUNDS

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
    - ``direct_assignment``: run the direct-assignment transport
      (``analyzer/direct.py``) as a pre-pass of each count goal whose chain
      prefix its guards model (``direct.direct_eligible``); the greedy
      rounds then polish the residue. The optimizer sets it from
      ``solver.direct.assignment.enabled`` and the wide-regime gate.
    - ``direct_max_sweeps``: the sweep budget of one direct pass
      (``solver.direct.max.sweeps``).
    - ``direct_sparse_margin`` / ``direct_sparse_salt``: the plan's
      band-edge margin and the rounding seed's salt
      (``solver.direct.sparse.margin.frac``,
      ``solver.direct.sparse.rounding.salt``).
    - ``direct_goals``: the goals that keep the direct arm (None: every
      eligible goal); below ``solver.direct.density.sparse.threshold``
      only TopicReplicaDistributionGoal does.
    """

    donate: bool = True
    async_readback: bool = True
    deficit_moves_cap: int = 0
    direct_assignment: bool = False
    direct_max_sweeps: int = 16
    direct_sparse_margin: float = 0.25
    direct_sparse_salt: str = ""
    direct_goals: "tuple[str, ...] | None" = None


def direct_path_chosen(megastep: MegastepConfig, goal_name: str) -> bool:
    """Whether the density-aware choice keeps the direct arm for this goal
    (``direct_goals`` None: every eligible goal)."""
    return (megastep.direct_goals is None
            or goal_name in megastep.direct_goals)


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
        # Dispatches per kind ("move", "swap", "direct", "chain").
        self.by_kind: dict[str, int] = {}
        self.donated = 0
        self.speculative = 0
        # Goals that took no dispatch thanks to the fingerprint snapshot.
        self.goals_skipped = 0
        # crc32 of the pass's entry-violation vector (None without it).
        self.fingerprint = None

    def record(self, kind: str, rounds: int, donated: bool = False,
               speculative: bool = False) -> None:
        self.rounds_per_dispatch.append(int(rounds))
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
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
        if self.by_kind.get("direct"):
            # Only when a direct pass ran, as the reference reports it.
            out["direct_dispatches"] = self.by_kind["direct"]
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

    ``enqueue(st, budget) -> (st, read, donated)`` runs one dispatch;
    ``read.values()`` gives its (applied, rounds), waiting for the device
    (a ``LoopRead``). With ``async_readback`` the pump keeps one dispatch
    ahead:
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
    prev = None    # (read, budget, t0, donated), not yet read
    last_read_t = None
    converged = False
    while True:
        cur = None
        may_enqueue = prev is None or async_readback
        if may_enqueue and not converged and est_rounds < pass_cap \
                and not (out_of_time is not None and out_of_time()):
            budget = controller.budget(pass_cap - est_rounds)
            t0 = time.monotonic()
            st, read, donated = enqueue(st, budget)
            cur = (read, budget, t0, donated)
            est_rounds += budget
        if prev is not None:
            read_p, budget_p, t0_p, donated_p = prev
            applied_p, r_read = read_p.values()
            now = time.monotonic()
            start = t0_p if last_read_t is None else max(t0_p, last_read_t)
            applied_total += applied_p
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
                stats.record(kind, cur[0].values()[1], donated=cur[3],
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
    # The direct pre-pass: bounded path, enabled for this pass (the flag
    # and the wide-regime gate), chosen for this goal, a prefix its guards
    # model, and a clean model: offline replicas and drains keep the full
    # greedy semantics.
    use_direct = False
    if bounded and megastep is not None and megastep.direct_assignment \
            and direct_path_chosen(megastep, goal.name) \
            and int(offline0) == 0 and not drain:
        from .direct import direct_eligible
        use_direct = direct_eligible(goals, index)
    if bounded and megastep is not None and megastep.deficit_moves_cap > 0 \
            and goal.count_based and not use_direct:
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
            # The pump reads the dispatch's (applied, rounds) one behind.
            st, _agg, read = _dispatch(phase, st, index, prior, goals,
                                       constraint, num_topics, masks, budget,
                                       cfg=cfg, reach=dispatch.ceiling())
            return st, read, donation_enabled(megastep)

        return run_bounded_pass(
            enqueue, st, pass_cap, dispatch,
            out_of_time=out_of_time if wall_budget_s > 0 else None,
            async_readback=async_rb, stats=stats, kind=phase)

    # Nothing violated, nothing offline and no drain pending: the fixed
    # point is immediate, so no pass runs.
    ran = float(viol0) > 0 or int(offline0) > 0 or drain
    if not ran and entry_stats is not None and stats is not None:
        stats.goals_skipped += 1
    direct_moves = 0
    direct_sweeps = 0
    if ran and use_direct and float(viol0) > 0:
        # The bulk transport in one pass (kind "direct"); the greedy loop
        # below polishes what the feasibility masks vetoed.
        from .direct import run_direct_pass
        state, direct_moves, direct_sweeps, stranded = run_direct_pass(
            state, goals, index, constraint, num_topics, masks, megastep,
            megastep.direct_max_sweeps, stats=stats)
        total_applied += direct_moves
        if megastep.deficit_moves_cap > 0 and goal.count_based:
            # Size the polish from the larger of two residue estimates:
            # the entry violation less the transport's moves, and twice
            # the movers it could not place.
            cfg = deficit_sized_config(
                cfg, max(float(viol0) - float(direct_moves),
                         2.0 * float(stranded)),
                megastep.deficit_moves_cap)
    if ran:
        while rounds < cfg.max_rounds and not out_of_time():
            state, moves, r = run_pass("move", state, cfg.max_rounds)
            total_applied += moves
            rounds += r
            if not goal.supports_swap:
                break
            state, swapped, sr = run_pass("swap", state, SWAP_MAX_ROUNDS)
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
    info = {
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
    if use_direct:
        # Present only where the direct mode was in force, as in the
        # reference.
        info["direct_moves"] = direct_moves
        info["direct_sweeps"] = direct_sweeps
    return state, info

"""The batched rebalance search: one round's selection and apply, and
kernel K3 (``select_batch``).

Port of the move-round and swap-round pieces of
``cruise_control_tpu/analyzer/search.py`` (the reference's greedy inner
loop, AbstractGoal.java:82-135, batched). Each round scores a grid of
candidates, keeps per source row its best destination, takes the top-m
rows, dedupes partitions, attaches the cumulative pre-deltas of earlier
rows, rechecks every stacked goal jointly, caps the batch and applies it.

K3 ``select_batch`` runs that selection up to the recheck in five
launches: per-row best column inside the 1% tie window with the rotation
rule (a warp per row), top-m of the reduced scores, partition dedupe by
first rank, the exclusive cumulative pre-deltas and ``has_earlier``. On a CUDA
tensor the wrapper launches ``csrc/select_batch.cu``; on a CPU tensor it
runs the plain twin (the reference's ops, association included).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from ..model.tensors import ClusterTensors, broker_segments, replica_exists
from .agg import pot_lbi_deltas
from .candidates import (
    KIND_MOVE, PRE_FIELDS, CandidateDeltas, attach_cumulative_plain,
)
from .constraint import BalancingConstraint
from .derived import DerivedState
from .goals.base import Goal
from ..utils.numerics import stable_topk

_EPS_IMPROVEMENT = 1e-9
# K3's limits (csrc/select_batch.cu): the bounded path's deficit-sized
# grids reach 2,048 move + 2,048 leadership rows and m = 2,048.
SELECT_BATCH_MAX_ROWS = 4096
SELECT_BATCH_MAX_M = 2048
_OFFLINE_BONUS = 1e12
# Relative width of the "effectively tied" window of reduce_per_source.
_TIE_WINDOW = 0.01


class OptimizationFailureError(RuntimeError):
    """A hard goal could not be satisfied."""


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    num_sources: int = 64
    num_dests: int = 32
    moves_per_round: int = 32
    max_rounds: int = 200


@dataclasses.dataclass(frozen=True)
class ExclusionMasks:
    """Boolean masks built from OptimizationOptions by the optimizer."""

    excluded_topics: torch.Tensor | None = None            # [T] bool
    excluded_replica_move_brokers: torch.Tensor | None = None  # [B] bool
    excluded_leadership_brokers: torch.Tensor | None = None    # [B] bool

    @classmethod
    def from_numpy(cls, device, **arrays) -> "ExclusionMasks":
        """Masks from numpy bool arrays named like the fields (the JAX
        package's ``ExclusionMasks``, ``np.asarray``-ed); absent or None
        fields stay None."""
        return cls(**{name: None if value is None else torch.as_tensor(
            np.array(value, dtype=bool), device=device)
            for name, value in arrays.items()})


def goal_aux(goal: Goal, state: ClusterTensors, derived: DerivedState,
             constraint: BalancingConstraint, num_topics: int):
    """Per-goal aux tensors (prepare_partial, then finalize_aux)."""
    return goal.finalize_aux(goal.prepare_partial(state, num_topics), state,
                             derived, constraint)


def reduce_per_source(score: torch.Tensor,
                      layout: tuple[tuple[int, int], ...],
                      extra_last_col: bool = False) -> torch.Tensor:
    """Per-source best-destination reduction: each [rows × cols] grid
    block collapses to one candidate per row. Among the columns within
    the relative tie window of the row's best, prefer column (row mod
    cols), then the next; the targeted extra column (first block's last,
    when ``extra_last_col``) ranks last among ties. Rows without a finite
    column keep plain argmax."""
    red_parts = []
    offset = 0
    dev = score.device
    for block_i, (rows, cols) in enumerate(layout):
        block = score[offset:offset + rows * cols].reshape(rows, cols)
        finite = torch.isfinite(block)
        safe = torch.where(finite, block,
                           torch.full((), float("-inf"), device=dev))
        row_max = safe.amax(dim=1, keepdim=True)
        window = _TIE_WINDOW * torch.clamp(torch.abs(row_max), min=1e-6)
        tied = finite & (safe >= row_max - window)
        rot_cols = cols - 1 if (extra_last_col and block_i == 0) else cols
        col_ids = torch.arange(cols, device=dev)[None, :]
        row_ids = torch.arange(rows, device=dev)[:, None]
        rot = torch.where(col_ids < rot_cols,
                          (col_ids - row_ids) % max(rot_cols, 1),
                          torch.full((), cols, device=dev))
        best_col = torch.argmin(torch.where(
            tied, rot, torch.full((), cols + 1, device=dev)), dim=1)
        best_col = torch.where(tied.any(dim=1), best_col,
                               torch.argmax(safe, dim=1))
        red_parts.append(offset + torch.arange(rows, device=dev) * cols
                         + best_col)
        offset += rows * cols
    return torch.cat(red_parts).to(torch.int32)


def select_batch_plain(state: ClusterTensors, deltas: CandidateDeltas,
                       score: torch.Tensor, layout, m: int,
                       extra_last_col: bool = False):
    """K3's twin: reduce per source, top-m, partition dedupe by first
    rank, cumulative pre-deltas. Returns (idx [k], part_ok [k], sub with
    pre fields, has_earlier [k], pot [k], lbi [k])."""
    red_idx = reduce_per_source(score, layout, extra_last_col)
    red_score = score[red_idx.long()]
    k = min(m, red_score.shape[0])
    top_score, top_i = stable_topk(red_score, k)
    idx = red_idx[top_i.long()]
    ok = top_score > _EPS_IMPROVEMENT
    dev = score.device
    rank = torch.arange(k, dtype=torch.int32, device=dev)
    rank_eff = torch.where(ok, rank, torch.full((), k + 1, dtype=torch.int32,
                                                device=dev))
    sel_p = deltas.partition[idx.long()].long()
    first_p = torch.full((state.num_partitions,), k + 1, dtype=torch.int32,
                         device=dev).scatter_reduce(0, sel_p, rank_eff, "amin")
    part_ok = ok & (first_p[sel_p] == rank)
    sub = deltas.take(idx)
    pot, lbi = pot_lbi_deltas(state, sub)
    sub, has_earlier = attach_cumulative_plain(sub, part_ok, pot, lbi)
    return idx, part_ok, sub, has_earlier, pot, lbi


def select_batch(state: ClusterTensors, deltas: CandidateDeltas,
                 score: torch.Tensor, layout, m: int,
                 extra_last_col: bool = False):
    """K3 on the card, its twin on the CPU (see select_batch_plain)."""
    dev = score.device
    if dev.type == "cpu":
        return select_batch_plain(state, deltas, score, layout, m,
                                  extra_last_col)
    if dev.type != "cuda":
        raise ValueError(f"select_batch: unsupported device {dev}")
    if len(layout) != 2:
        raise ValueError("select_batch kernel: expects the move and the "
                         "leadership block")
    (r0, c0), (r1, c1) = layout
    n = r0 + r1
    k = min(m, n)
    if n > SELECT_BATCH_MAX_ROWS or k > SELECT_BATCH_MAX_M or k < 1:
        raise kernels.limit_error("select_batch",
                                  f"{n} reduced rows, m={k}")
    req = kernels.requirer("select_batch")
    p = state.num_partitions
    i32, f32 = torch.int32, torch.float32
    n_cand = r0 * c0 + r1 * c1
    args = (req(score, dev, f32, (n_cand,), "score"),
            req(deltas.partition, dev, i32, (n_cand,), "partition"),
            req(deltas.src_broker, dev, i32, (n_cand,), "src_broker"),
            req(deltas.dst_broker, dev, i32, (n_cand,), "dst_broker"),
            req(deltas.topic, dev, i32, (n_cand,), "topic"),
            req(deltas.replica_delta, dev, i32, (n_cand,), "replica_delta"),
            req(deltas.leader_delta, dev, i32, (n_cand,), "leader_delta"),
            req(deltas.load_delta, dev, f32, (n_cand, 4), "load_delta"),
            req(state.leader_load, dev, f32, (p, 4), "leader_load"))
    idx = torch.empty(k, dtype=i32, device=dev)
    part_ok = torch.empty(k, dtype=torch.bool, device=dev)
    has_earlier = torch.empty(k, dtype=torch.bool, device=dev)
    pre_load = torch.empty((2, k, 4), dtype=f32, device=dev)
    pre_scalars = torch.empty((len(PRE_FIELDS), k), dtype=f32, device=dev)
    lib = kernels.library("select_batch")
    scratch_bytes = lib.cc_select_batch_scratch_bytes(n, k)
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev)
    code = lib.cc_select_batch(
        *[a.data_ptr() for a in args], r0, c0, r1, c1, int(extra_last_col),
        k, idx.data_ptr(), part_ok.data_ptr(), has_earlier.data_ptr(),
        pre_load.data_ptr(), pre_scalars.data_ptr(), scratch.data_ptr(),
        scratch_bytes, kernels.stream_ptr(dev))
    kernels.check(code, "select_batch")
    kernels.LAUNCHES["select_batch"] += 1
    sub = deltas.take(idx)
    pot, lbi = pot_lbi_deltas(state, sub)
    sub = dataclasses.replace(
        sub, pre_src_load=pre_load[0], pre_dst_load=pre_load[1],
        **{name: pre_scalars[i] for i, name in enumerate(PRE_FIELDS)})
    return idx, part_ok, sub, has_earlier, pot, lbi


def cumulative_select(state: ClusterTensors, deltas: CandidateDeltas,
                      score: torch.Tensor, layout, m: int, moves_cap: int,
                      independent: bool, recheck,
                      extra_last_col: bool = False):
    """Conflict selection with JOINT acceptance: the top-m rows (one per
    partition) carry the cumulative pre-deltas of earlier rows, and
    ``recheck(sub, has_earlier)`` re-evaluates every stacked goal with
    them. Returns (idx into the grid, sel mask, selected sub-batch,
    pot_delta, lbi_delta)."""
    idx, part_ok, sub, has_earlier, pot, lbi = select_batch(
        state, deltas, score, layout, m, extra_last_col)
    sel = part_ok & recheck(sub, has_earlier)
    if not independent:
        sel = sel & (torch.cumsum(sel.to(torch.int32), 0) <= moves_cap)
    return idx, sel, sub, pot, lbi


def _padded(x: torch.Tensor) -> torch.Tensor:
    """``x`` with one pad row after its last: the target of every
    unselected row of a fixed-shape scatter, dropped by the caller's
    ``[:n]`` view."""
    return torch.cat([x, x.new_full((1,) + tuple(x.shape[1:]), -1)])


def apply_selected(state: ClusterTensors, sel: torch.Tensor,
                   sel_p: torch.Tensor, sel_slot: torch.Tensor,
                   sel_dst_b: torch.Tensor, sel_kind: torch.Tensor,
                   sel_dst_slot: torch.Tensor) -> ClusterTensors:
    """Apply a selected batch. The reference routes unselected rows out
    of bounds, where its scatter drops them; here they land in a pad row
    (partition P) of a [P+1, S] buffer whose [:P] view is the new state,
    so the scatter's shape does not depend on the selection. Selected
    rows name distinct partitions (the batch is deduped by partition), so
    no two writes meet outside the pad row."""
    p = state.num_partitions
    pad = torch.full((), p, dtype=torch.int64, device=state.device)
    is_move = sel_kind == KIND_MOVE
    assignment = _padded(state.assignment)
    assignment.index_put_(
        (torch.where(sel & is_move, sel_p.long(), pad), sel_slot.long()),
        sel_dst_b.to(assignment.dtype))
    leader = _padded(state.leader_slot)
    leader.index_put_((torch.where(sel & ~is_move, sel_p.long(), pad),),
                      sel_dst_slot.to(leader.dtype))
    return dataclasses.replace(state, assignment=assignment[:p],
                               leader_slot=leader[:p])


def _per_broker_top_replicas(state: ClusterTensors, weight: torch.Tensor,
                             brokers: torch.Tensor, j: int, largest: bool):
    """For each broker of ``brokers[K]``: the j best replicas it hosts by
    ``weight[P, S]`` (largest or smallest). Returns (flat_idx [K, j],
    valid [K, j]) into the flat [P·S] replica axis."""
    seg = broker_segments(state).reshape(-1)
    flat_w = torch.where(replica_exists(state), weight,
                         torch.full((), float("nan"), device=weight.device)
                         ).reshape(-1)
    on_b = (seg[None, :] == brokers.long()[:, None]) \
        & torch.isfinite(flat_w)[None, :]
    key = torch.where(on_b, (flat_w if largest else -flat_w)[None, :],
                      torch.full((), float("-inf"), device=weight.device))
    vals, idx = stable_topk(key, j)
    return idx, torch.isfinite(vals)


def swap_grid(state: ClusterTensors, derived: DerivedState,
              src_score: torch.Tensor, dst_score: torch.Tensor,
              weight: torch.Tensor, k_brokers: int = 8, j_replicas: int = 4):
    """The swap candidate grid: top-k overloaded brokers × top-k
    counterparties × (j heaviest source replicas × j lightest destination
    replicas). Returns (fwd, rev, net, p1, s1, p2, s2, src_b, dst_b,
    base_valid): the two directional legs and the net transfer."""
    dev = state.device
    neg_inf = torch.full((), float("-inf"), device=dev)
    k = min(k_brokers, state.num_brokers)
    src_vals, src_brokers = stable_topk(
        torch.where(src_score > 0, src_score, neg_inf), k)
    dst_vals, dst_brokers = stable_topk(dst_score, k)
    src_b_ok = torch.isfinite(src_vals)
    dst_b_ok = torch.isfinite(dst_vals)
    heavy_idx, heavy_ok = _per_broker_top_replicas(
        state, weight, src_brokers, j_replicas, largest=True)
    light_idx, light_ok = _per_broker_top_replicas(
        state, weight, dst_brokers, j_replicas, largest=False)

    s_dim = state.max_replication_factor
    n = k * k * j_replicas * j_replicas
    si, di, ai, bi = (x.reshape(-1) for x in torch.meshgrid(
        torch.arange(k, device=dev), torch.arange(k, device=dev),
        torch.arange(j_replicas, device=dev),
        torch.arange(j_replicas, device=dev), indexing="ij"))
    src_b = src_brokers[si]
    dst_b = dst_brokers[di]
    a_flat = heavy_idx[si, ai]
    b_flat = light_idx[di, bi]
    p1, s1 = a_flat // s_dim, a_flat % s_dim
    p2, s2 = b_flat // s_dim, b_flat % s_dim
    p1l, p2l, s1l, s2l = p1.long(), p2.long(), s1.long(), s2.long()
    src_l, dst_l = src_b.long(), dst_b.long()

    base_valid = src_b_ok[si] & dst_b_ok[di] & heavy_ok[si, ai] \
        & light_ok[di, bi] & (src_b != dst_b) \
        & derived.movable_partition[p1l] & derived.movable_partition[p2l] \
        & derived.allowed_replica_move[dst_l] \
        & derived.allowed_replica_move[src_l]
    base_valid &= p1 != p2
    base_valid &= ~(state.assignment[p1l] == dst_b[:, None]).any(dim=1)
    base_valid &= ~(state.assignment[p2l] == src_b[:, None]).any(dim=1)
    base_valid &= weight[p1l, s1l] > weight[p2l, s2l]

    lead1 = state.leader_slot[p1l] == s1
    lead2 = state.leader_slot[p2l] == s2
    base_valid &= (~lead1) | derived.allowed_leadership[dst_l]
    base_valid &= (~lead2) | derived.allowed_leadership[src_l]
    load_a = torch.where(lead1[:, None], state.leader_load[p1l],
                         state.follower_load[p1l])
    load_b = torch.where(lead2[:, None], state.leader_load[p2l],
                         state.follower_load[p2l])
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    zero_f = torch.zeros((), device=dev)
    zeros_n = torch.zeros(n, dtype=torch.int32, device=dev)

    def leg(partition, slot, load_vec, lead, src, dst, valid):
        return CandidateDeltas(
            src_broker=torch.where(valid, src, zero_i),
            dst_broker=torch.where(valid, dst, zero_i),
            load_delta=torch.where(valid[:, None], load_vec, zero_f),
            replica_delta=valid.to(torch.int32),
            leader_delta=(valid & lead).to(torch.int32),
            partition=partition, topic=state.topic[partition.long()],
            src_slot=torch.where(valid, slot, zero_i),
            dst_slot=zeros_n, valid=valid)

    fwd = leg(p1, s1, load_a, lead1, src_b, dst_b, base_valid)
    rev = leg(p2, s2, load_b, lead2, dst_b, src_b, base_valid)
    net = CandidateDeltas(
        src_broker=fwd.src_broker, dst_broker=fwd.dst_broker,
        load_delta=torch.where(base_valid[:, None], load_a - load_b, zero_f),
        replica_delta=zeros_n,
        leader_delta=torch.where(base_valid, lead1.to(torch.int32)
                                 - lead2.to(torch.int32), zero_i),
        partition=p1, topic=state.topic[p1l],
        src_slot=fwd.src_slot, dst_slot=zeros_n, valid=base_valid)
    return fwd, rev, net, p1, s1, p2, s2, src_b, dst_b, base_valid


def apply_swap_selection(state: ClusterTensors, score: torch.Tensor,
                         p1: torch.Tensor, s1: torch.Tensor,
                         p2: torch.Tensor, s2: torch.Tensor,
                         src_b: torch.Tensor, dst_b: torch.Tensor,
                         moves: int = 8, live: torch.Tensor | None = None):
    """Select and apply a conflict-free batch of scored swaps: no two
    accepted swaps share any partition or any broker, across roles.
    ``live`` (a bool scalar) gates the whole batch: a frozen round of the
    round loop selects nothing. Unselected rows write the pad row, as in
    apply_selected. Returns (new_state, num_applied, top_idx, sel)."""
    dev = state.device
    k = min(moves, score.shape[0])
    top_score, top_idx = stable_topk(score, k)
    ti = top_idx.long()
    ok = top_score > _EPS_IMPROVEMENT
    rank = torch.arange(k, dtype=torch.int32, device=dev)
    big = torch.full((), k + 1, dtype=torch.int32, device=dev)
    rank_eff = torch.where(ok, rank, big)
    sel_p1, sel_p2 = p1[ti].long(), p2[ti].long()
    sel_src, sel_dst = src_b[ti].long(), dst_b[ti].long()
    first_part = torch.full((state.num_partitions,), k + 1, dtype=torch.int32,
                            device=dev) \
        .scatter_reduce(0, sel_p1, rank_eff, "amin") \
        .scatter_reduce(0, sel_p2, rank_eff, "amin")
    first_broker = torch.full((state.num_brokers,), k + 1, dtype=torch.int32,
                              device=dev) \
        .scatter_reduce(0, sel_src, rank_eff, "amin") \
        .scatter_reduce(0, sel_dst, rank_eff, "amin")
    sel = ok & (first_part[sel_p1] == rank) & (first_part[sel_p2] == rank) \
        & (first_broker[sel_src] == rank) & (first_broker[sel_dst] == rank)
    if live is not None:
        sel = sel & live

    p = state.num_partitions
    pad = torch.full((), p, dtype=torch.int64, device=dev)
    assignment = _padded(state.assignment)
    assignment.index_put_((torch.where(sel, sel_p1, pad), s1[ti].long()),
                          dst_b[ti].to(assignment.dtype))
    assignment.index_put_((torch.where(sel, sel_p2, pad), s2[ti].long()),
                          src_b[ti].to(assignment.dtype))
    return (dataclasses.replace(state, assignment=assignment[:p]), sel.sum(),
            top_idx, sel)

"""Candidate actions: batched generation and delta evaluation, and kernel
K2 (``select_sources``).

Port of ``cruise_control_tpu/analyzer/candidates.py``. A candidate is
(kind, partition, src_slot, dst_broker, dst_slot): kind 0 moves the replica
at (partition, src_slot) to dst_broker, kind 1 moves leadership to
dst_slot.

K2 ``select_sources`` picks the move grid's broker-diverse source rows,
and its leadership mode (``leadership_sources``) the leadership block's
partitions. On a CUDA tensor each wrapper launches
``csrc/select_sources.cu``; on a CPU tensor it runs the plain twin, which
repeats the reference step by step (every top-k value-descending in IEEE
total order, ties lower index first).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..model.tensors import (
    ClusterTensors, broker_segments, is_leader_slot, replica_exists,
)
from ..utils.numerics import stable_topk, xla_cumsum
from .derived import DerivedState

KIND_MOVE = 0
KIND_LEADERSHIP = 1

_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class Candidates:
    kind: torch.Tensor        # [N] int8
    partition: torch.Tensor   # [N] int32
    src_slot: torch.Tensor    # [N] int32
    dst_broker: torch.Tensor  # [N] int32
    dst_slot: torch.Tensor    # [N] int32 (leadership only)
    valid: torch.Tensor       # [N] bool

    @property
    def n(self) -> int:
        return self.kind.shape[0]


@dataclasses.dataclass(frozen=True)
class CandidateDeltas:
    """Per-candidate effect: src loses, dst gains. The optional ``pre_*``
    fields carry the cumulative effect of higher-ranked candidates of the
    same round on this candidate's src/dst brokers (attach_cumulative);
    ``None`` = single-candidate semantics."""

    src_broker: torch.Tensor    # [N] int32
    dst_broker: torch.Tensor    # [N] int32
    load_delta: torch.Tensor    # [N, R]
    replica_delta: torch.Tensor  # [N] int32
    leader_delta: torch.Tensor   # [N] int32
    partition: torch.Tensor     # [N] int32
    topic: torch.Tensor         # [N] int32
    src_slot: torch.Tensor      # [N] int32
    dst_slot: torch.Tensor      # [N] int32
    valid: torch.Tensor         # [N] bool
    pre_src_load: torch.Tensor | None = None
    pre_dst_load: torch.Tensor | None = None
    pre_src_count: torch.Tensor | None = None
    pre_dst_count: torch.Tensor | None = None
    pre_src_leaders: torch.Tensor | None = None
    pre_dst_leaders: torch.Tensor | None = None
    pre_src_topic_count: torch.Tensor | None = None
    pre_dst_topic_count: torch.Tensor | None = None
    pre_src_topic_leaders: torch.Tensor | None = None
    pre_dst_pot: torch.Tensor | None = None
    pre_dst_lbi: torch.Tensor | None = None

    def pre0(self, name: str):
        """Pre-term or 0.0 (single-candidate semantics when absent)."""
        value = getattr(self, name)
        return 0.0 if value is None else value

    def pre_load(self, name: str, r: int):
        value = getattr(self, name)
        return 0.0 if value is None else value[:, r]

    def take(self, idx: torch.Tensor) -> "CandidateDeltas":
        """Rows ``idx`` of every field (the reference's tree-map gather)."""
        idx = idx.long()
        return CandidateDeltas(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name)[idx]
            for f in dataclasses.fields(self)})


PRE_FIELDS = ("pre_src_count", "pre_dst_count", "pre_src_leaders",
              "pre_dst_leaders", "pre_src_topic_count",
              "pre_dst_topic_count", "pre_src_topic_leaders", "pre_dst_pot",
              "pre_dst_lbi")


def _gather_slot(assign_p: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    return torch.gather(assign_p, 1,
                        torch.clamp(slot, min=0).long()[:, None])[:, 0]


def compute_deltas(state: ClusterTensors, derived: DerivedState,
                   cand: Candidates) -> CandidateDeltas:
    """Gather the (src, dst, Δload) tuple for every candidate, folding in
    the structural legitimacy checks (GoalUtils.legitMove)."""
    p = cand.partition.long()
    b = state.num_brokers
    assign_p = state.assignment[p]
    leader_slot_p = state.leader_slot[p]

    is_move = cand.kind == KIND_MOVE
    src_slot = torch.where(is_move, cand.src_slot, leader_slot_p)
    src_broker = _gather_slot(assign_p, src_slot)
    dst_broker = torch.where(is_move, cand.dst_broker,
                             _gather_slot(assign_p, cand.dst_slot))

    moving_is_leader = src_slot == leader_slot_p
    lead = state.leader_load[p]
    foll = state.follower_load[p]
    move_vec = torch.where(moving_is_leader[:, None], lead, foll)
    leadership_vec = lead - foll
    load_delta = torch.where(is_move[:, None], move_vec, leadership_vec)

    replica_delta = is_move.to(torch.int32)
    leader_delta = (moving_is_leader | ~is_move).to(torch.int32)

    src_exists = (src_slot >= 0) & (src_broker >= 0)
    dst_in_range = (dst_broker >= 0) & (dst_broker < b)
    dst_safe = torch.clamp(dst_broker, 0, b - 1)
    dst_l = dst_safe.long()
    dst_alive = derived.alive[dst_l] & dst_in_range

    already_hosts = (assign_p == dst_broker[:, None]).any(dim=1)
    src_offline = ~derived.alive[torch.clamp(src_broker, 0, b - 1).long()]
    lead_dst_ok = (~moving_is_leader) | src_offline \
        | derived.allowed_leadership[dst_l]
    move_ok = (~already_hosts) & derived.allowed_replica_move[dst_l] \
        & (src_broker != dst_broker) & lead_dst_ok
    dst_slot_live = _gather_slot(assign_p, cand.dst_slot) >= 0
    lead_ok = dst_slot_live & (cand.dst_slot != leader_slot_p) \
        & (cand.dst_slot >= 0) & derived.allowed_leadership[dst_l] \
        & (leader_slot_p >= 0)

    valid = cand.valid & derived.movable_partition[p] & src_exists \
        & dst_alive & torch.where(is_move, move_ok, lead_ok)

    zero_i = torch.zeros((), dtype=torch.int32, device=state.device)
    return CandidateDeltas(
        src_broker=torch.where(valid, src_broker, zero_i),
        dst_broker=torch.where(valid, dst_safe, zero_i),
        load_delta=torch.where(valid[:, None], load_delta,
                               torch.zeros((), device=state.device)),
        replica_delta=torch.where(valid, replica_delta, zero_i),
        leader_delta=torch.where(valid, leader_delta, zero_i),
        partition=cand.partition,
        topic=state.topic[p],
        src_slot=torch.where(valid, src_slot, zero_i),
        dst_slot=torch.where(valid & ~is_move, cand.dst_slot, zero_i),
        valid=valid,
    )


def on_source(state: ClusterTensors, source_score: torch.Tensor,
              ) -> torch.Tensor:
    """[P, S] bool — slot holds a replica on a positive-score broker."""
    score_pad = torch.cat([source_score, source_score.new_full((1,), -1.0)])
    return (score_pad[broker_segments(state)] > 0.0) & replica_exists(state)


def select_sources_plain(state: ClusterTensors, source_score: torch.Tensor,
                         replica_weight: torch.Tensor, num_sources: int,
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's twin: the reference's broker-diverse source selection. Half
    the rows are the global top of the flat [P·S] weights; the rest are
    the best and second-best replica (after the global rows) of each of
    the top source brokers."""
    b = state.num_brokers
    s_dim = state.max_replication_factor
    dev = state.device
    neg_inf = torch.full((), float("-inf"), device=dev)
    flat_weight = torch.where(on_source(state, source_score),
                              replica_weight, neg_inf).reshape(-1)
    n_flat = flat_weight.shape[0]
    k_src = min(num_sources, n_flat)
    quarter = min(k_src // 4, b)
    half = k_src - 2 * quarter
    seg_flat = broker_segments(state).reshape(-1)
    idxs = torch.arange(n_flat, dtype=torch.int32, device=dev)

    g_w, g_idx = stable_topk(flat_weight, half)
    in_global = torch.zeros(n_flat + 1, dtype=torch.bool, device=dev)
    in_global[torch.where(torch.isfinite(g_w), g_idx, n_flat).long()] = True
    flat_weight_rest = torch.where(in_global[:n_flat], neg_inf, flat_weight)

    def per_broker_best(fw):
        smax = torch.full((b + 1,), float("-inf"), device=dev) \
            .scatter_reduce(0, seg_flat, fw, "amax", include_self=True)
        is_best = torch.isfinite(fw) & (fw == smax[seg_flat])
        best = torch.full((b + 1,), _INT32_MAX, dtype=torch.int32,
                          device=dev).scatter_reduce(
            0, seg_flat, torch.where(is_best, idxs, n_flat).to(torch.int32),
            "amin", include_self=True)
        return smax[:b], best[:b]

    w1, best1 = per_broker_best(flat_weight_rest)
    best1_pad = torch.cat([best1, best1.new_full((1,), n_flat)])
    w2, best2 = per_broker_best(torch.where(
        idxs == best1_pad[seg_flat], neg_inf, flat_weight_rest))
    b_score = torch.where(torch.isfinite(w1), source_score, neg_inf)
    tb_score, top_brokers = stable_topk(b_score, quarter)
    top_brokers = top_brokers.long()
    broker_ok = torch.isfinite(tb_score)
    n_pad = torch.full((), n_flat, dtype=torch.int32, device=dev)
    rows_b1 = torch.where(broker_ok, best1[top_brokers], n_pad)
    ok_b2 = broker_ok & torch.isfinite(w2[top_brokers])
    rows_b2 = torch.where(ok_b2, best2[top_brokers], n_pad)

    top_idx = torch.cat([g_idx, rows_b1, rows_b2])[:k_src]
    src_valid = torch.cat([torch.isfinite(g_w), broker_ok, ok_b2])[:k_src]
    src_valid = src_valid & (top_idx < n_flat)
    top_idx = torch.clamp(top_idx, max=n_flat - 1)
    return ((top_idx // s_dim).to(torch.int32),
            (top_idx % s_dim).to(torch.int32), src_valid)


# The most global rows (``half``) and brokers the kernel takes
# (csrc/select_sources.cu): half <= 2048 covers k_src = 2048 at any broker
# count; the broker ranks and best slots are sized for 16,384 brokers.
# Row indices are 32-bit: P*S < 2**31.
SELECT_MAX_HALF = 2048
SELECT_MAX_BROKERS = 16384
# K2's leadership mode's limit (csrc/select_leadership.cu).
LEAD_MAX_K = 2048


def select_sources(state: ClusterTensors, source_score: torch.Tensor,
                   replica_weight: torch.Tensor, num_sources: int,
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The move grid's source rows ``(cand_p [k], cand_s [k],
    src_valid [k])``: K2 on the card, its twin on the CPU."""
    dev = state.device
    if dev.type == "cpu":
        return select_sources_plain(state, source_score, replica_weight,
                                    num_sources)
    if dev.type != "cuda":
        raise ValueError(f"select_sources: unsupported device {dev}")
    p, s = state.assignment.shape
    b = state.num_brokers
    n_flat = p * s
    k_src = min(num_sources, n_flat)
    quarter = min(k_src // 4, b)
    half = k_src - 2 * quarter
    if half > SELECT_MAX_HALF or b > SELECT_MAX_BROKERS \
            or not 0 < n_flat < 2 ** 31:
        raise kernels.limit_error("select_sources",
                                  f"half={half}, B={b}, P*S={n_flat}")
    req = kernels.requirer("select_sources")
    weight = req(replica_weight, dev, torch.float32, (p, s), "replica_weight")
    score = req(source_score, dev, torch.float32, (b,), "source_score")
    assignment = req(state.assignment, dev, torch.int32, (p, s), "assignment")
    pmask = req(state.partition_mask, dev, torch.bool, (p,), "partition_mask")
    cand_p = torch.empty(k_src, dtype=torch.int32, device=dev)
    cand_s = torch.empty(k_src, dtype=torch.int32, device=dev)
    src_valid = torch.empty(k_src, dtype=torch.bool, device=dev)
    lib = kernels.library("select_sources")
    scratch = torch.empty(lib.cc_select_sources_scratch_bytes(b, half),
                          dtype=torch.uint8, device=dev)
    code = lib.cc_select_sources(
        weight.data_ptr(), score.data_ptr(), assignment.data_ptr(),
        pmask.data_ptr(), p, s, b, half, quarter, cand_p.data_ptr(),
        cand_s.data_ptr(), src_valid.data_ptr(), scratch.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.check(code, "select_sources")
    kernels.LAUNCHES["select_sources"] += 1
    return cand_p, cand_s, src_valid


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """What the candidate grid is expanded from: the move block's source
    rows (``cand_p``, ``cand_s``, ``src_valid`` [k_src]), its destination
    columns (``dst_val``, ``dst_idx`` [k_dst]) and optional targeted
    column (``t_dst``, ``t_ok`` [k_src]), and the leadership block's
    partitions (``top_lw``, ``lp`` [k_l]), each block None when absent.
    Row i of the grid finds its (partition, slot, destination) from i and
    :attr:`layout` alone."""

    cand_p: torch.Tensor | None
    cand_s: torch.Tensor | None
    src_valid: torch.Tensor | None
    dst_val: torch.Tensor | None
    dst_idx: torch.Tensor | None
    t_dst: torch.Tensor | None
    t_ok: torch.Tensor | None
    top_lw: torch.Tensor | None
    lp: torch.Tensor | None
    s_dim: int

    @property
    def layout(self) -> tuple[tuple[int, int], ...]:
        blocks = []
        if self.dst_idx is not None:
            blocks.append((self.cand_p.shape[0], self.dst_idx.shape[0]
                           + (self.t_dst is not None)))
        if self.lp is not None:
            blocks.append((self.lp.shape[0], self.s_dim))
        return tuple(blocks)


def leadership_sources_plain(state: ClusterTensors,
                             source_score: torch.Tensor,
                             replica_weight: torch.Tensor, num_sources: int,
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 leadership mode's twin: the stable top-k of the leader slots'
    weights on positive-score brokers over P*S keys (every other slot
    -inf, so with fewer than k finite keys the padding is the lowest flat
    indices of -inf keys). Returns (top_lw [k_l], lp [k_l] int32)."""
    lead_weight = torch.where(
        on_source(state, source_score) & is_leader_slot(state),
        replica_weight, torch.full((), float("-inf"), device=state.device))
    flat_lw = lead_weight.reshape(-1)
    k_l = min(num_sources, flat_lw.shape[0])
    top_lw, top_lidx = stable_topk(flat_lw, k_l)
    return top_lw, (top_lidx // state.max_replication_factor).to(torch.int32)


def leadership_sources(state: ClusterTensors, source_score: torch.Tensor,
                       replica_weight: torch.Tensor, num_sources: int,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The leadership block's partitions ``(top_lw [k_l], lp [k_l])``: K2's
    leadership mode (``csrc/select_leadership.cu``, one cooperative launch)
    on the card, its twin on the CPU."""
    dev = state.device
    if dev.type == "cpu":
        return leadership_sources_plain(state, source_score, replica_weight,
                                        num_sources)
    if dev.type != "cuda":
        raise ValueError(f"leadership_sources: unsupported device {dev}")
    p, s = state.assignment.shape
    b = state.num_brokers
    n_flat = p * s
    k_l = min(num_sources, n_flat)
    if k_l > LEAD_MAX_K or not 0 < n_flat < 2 ** 31:
        raise kernels.limit_error("select_leadership",
                                  f"k_l={k_l}, P*S={n_flat}")
    req = kernels.requirer("select_leadership")
    weight = req(replica_weight, dev, torch.float32, (p, s), "replica_weight")
    score = req(source_score, dev, torch.float32, (b,), "source_score")
    assignment = req(state.assignment, dev, torch.int32, (p, s), "assignment")
    pmask = req(state.partition_mask, dev, torch.bool, (p,), "partition_mask")
    leader = req(state.leader_slot, dev, torch.int32, (p,), "leader_slot")
    top_lw = torch.empty(k_l, dtype=torch.float32, device=dev)
    lp = torch.empty(k_l, dtype=torch.int32, device=dev)
    lib = kernels.library("select_leadership")
    nbytes = lib.cc_select_leadership_scratch_bytes(p, k_l)
    if nbytes <= 0:
        raise RuntimeError("select_leadership: no scratch size for "
                           f"P={p}, k_l={k_l}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    code = lib.cc_select_leadership(
        weight.data_ptr(), score.data_ptr(), assignment.data_ptr(),
        pmask.data_ptr(), leader.data_ptr(), p, s, b, k_l, top_lw.data_ptr(),
        lp.data_ptr(), scratch.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(code, "select_leadership")
    kernels.LAUNCHES["select_leadership"] += 1
    return top_lw, lp


def grid_spec(state: ClusterTensors, source_score: torch.Tensor,
              dest_score: torch.Tensor, replica_weight: torch.Tensor,
              num_sources: int, num_dests: int, include_leadership: bool,
              leadership_only: bool = False,
              extra_dst: "tuple[torch.Tensor, torch.Tensor] | None" = None,
              sources: "tuple[torch.Tensor, ...] | None" = None,
              ) -> GridSpec:
    """The grid's inputs (see :func:`generate_candidates`)."""
    b = state.num_brokers
    cand_p = cand_s = src_valid = dst_val = dst_idx = None
    t_dst = t_ok = top_lw = lp = None
    if not leadership_only:
        if sources is None:
            sources = select_sources(state, source_score, replica_weight,
                                     num_sources)
        cand_p, cand_s, src_valid = sources
        dst_val, dst_idx = stable_topk(dest_score, min(num_dests, b))
        if extra_dst is not None:
            t_dst, t_ok = extra_dst[0].to(torch.int32), extra_dst[1]
    if include_leadership or leadership_only:
        top_lw, lp = leadership_sources(state, source_score, replica_weight,
                                        num_sources)
    return GridSpec(cand_p, cand_s, src_valid, dst_val, dst_idx, t_dst, t_ok,
                    top_lw, lp, state.max_replication_factor)


def expand_grid(spec: GridSpec) -> Candidates:
    """The grid's candidates, materialized: the move block [k_src x
    (k_dst + extra)] row-major, then the leadership block [k_l x S]."""
    parts: list[Candidates] = []
    if spec.dst_idx is not None:
        dev = spec.cand_p.device
        k_src, k_dst = spec.cand_p.shape[0], spec.dst_idx.shape[0]
        cols_dst = spec.dst_idx[None, :].expand(k_src, k_dst)
        cols_ok = torch.isfinite(spec.dst_val)[None, :].expand(k_src, k_dst)
        if spec.t_dst is not None:
            cols_dst = torch.cat([cols_dst, spec.t_dst[:, None]], 1)
            cols_ok = torch.cat([cols_ok, spec.t_ok[:, None]], 1)
        k_cols = cols_dst.shape[1]
        n = k_src * k_cols
        parts.append(Candidates(
            kind=torch.zeros(n, dtype=torch.int8, device=dev),
            partition=spec.cand_p.repeat_interleave(k_cols),
            src_slot=spec.cand_s.repeat_interleave(k_cols),
            dst_broker=cols_dst.reshape(-1),
            dst_slot=torch.zeros(n, dtype=torch.int32, device=dev),
            valid=spec.src_valid.repeat_interleave(k_cols)
            & cols_ok.reshape(-1)))
    if spec.lp is not None:
        dev = spec.lp.device
        s_dim = spec.s_dim
        n = spec.lp.shape[0] * s_dim
        parts.append(Candidates(
            kind=torch.ones(n, dtype=torch.int8, device=dev),
            partition=spec.lp.repeat_interleave(s_dim),
            src_slot=torch.zeros(n, dtype=torch.int32, device=dev),
            dst_broker=torch.zeros(n, dtype=torch.int32, device=dev),
            dst_slot=torch.arange(s_dim, dtype=torch.int32,
                                  device=dev).repeat(spec.lp.shape[0]),
            valid=torch.isfinite(spec.top_lw).repeat_interleave(s_dim)))
    return Candidates(*[torch.cat([getattr(c, f.name) for c in parts])
                        for f in dataclasses.fields(Candidates)])


def generate_candidates(state: ClusterTensors, derived: DerivedState,
                        source_score: torch.Tensor, dest_score: torch.Tensor,
                        replica_weight: torch.Tensor, num_sources: int,
                        num_dests: int, include_leadership: bool,
                        leadership_only: bool = False,
                        extra_dst: "tuple[torch.Tensor, torch.Tensor] | None" = None,
                        sources: "tuple[torch.Tensor, ...] | None" = None,
                        ) -> "tuple[Candidates, tuple[tuple[int, int], ...]]":
    """Top-k × top-k candidate grid: the move block [k_src × (k_dst +
    extra)] then the leadership block [k_l × S]. ``sources`` is this
    round's ``select_sources`` result when the caller already has it
    (the targeted column needs it first); it is computed here otherwise.
    Returns (candidates, layout)."""
    spec = grid_spec(state, source_score, dest_score, replica_weight,
                     num_sources, num_dests, include_leadership,
                     leadership_only, extra_dst, sources)
    return expand_grid(spec), spec.layout


def _lexsort_perm(keys: "tuple[torch.Tensor, ...]") -> torch.Tensor:
    """Permutation sorting rows by (keys[0], keys[1], ..., row index)."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        order = torch.sort(k[perm], stable=True).indices
        perm = perm[order]
    return perm


def _exclusive_group_prefix(keys: "tuple[torch.Tensor, ...]",
                            values: torch.Tensor) -> torch.Tensor:
    """For each row i: sum of ``values[j]`` over EARLIER rows j < i whose
    key tuple equals row i's, by one lexicographic sort, a cumsum in the
    reference's association and a group-base gather."""
    m = values.shape[0]
    dev = values.device
    perm = _lexsort_perm(keys)
    v_sorted = values[perm]
    cs_prev = torch.cat([values.new_zeros((1, values.shape[1])),
                         xla_cumsum(v_sorted, 0)[:-1]])
    is_start = torch.zeros(m, dtype=torch.bool, device=dev)
    is_start[0] = True
    for k in keys:
        ks = k[perm]
        is_start = is_start | torch.cat(
            [torch.ones(1, dtype=torch.bool, device=dev), ks[1:] != ks[:-1]])
    ar = torch.arange(m, device=dev)
    start_pos = torch.cummax(torch.where(is_start, ar, 0), 0).values
    excl = cs_prev - cs_prev[start_pos]
    out = torch.zeros_like(values)
    out[perm] = excl
    return out


def attach_cumulative_plain(sub: CandidateDeltas, considered: torch.Tensor,
                            pot_delta: torch.Tensor, lbi_delta: torch.Tensor,
                            ) -> tuple[CandidateDeltas, torch.Tensor]:
    """Fill the ``pre_*`` fields of a RANK-ORDERED batch: for each row i,
    the summed effect of every considered row j < i on i's src/dst brokers
    (and their (broker, topic) cells), plus ``has_earlier`` — some earlier
    considered row touches either of i's brokers in either role. The
    reference's sort-segment form, association included."""
    f32 = torch.float32
    m = sub.partition.shape[0]
    dev = sub.partition.device
    rep = sub.replica_delta.to(f32)
    lead = sub.leader_delta.to(f32)
    r = sub.load_delta.shape[1]
    src_vals = torch.cat([sub.load_delta, rep[:, None], lead[:, None]], 1)
    dst_vals = torch.cat([sub.load_delta, rep[:, None], lead[:, None],
                          pot_delta[:, None], lbi_delta[:, None]], 1)
    cons = considered.to(f32)[:, None]
    src_out = _exclusive_group_prefix((sub.src_broker,), src_vals * cons)
    dst_out = _exclusive_group_prefix((sub.dst_broker,), dst_vals * cons)
    topic_vals = torch.stack([rep, lead], 1) * cons
    st_out = _exclusive_group_prefix((sub.src_broker, sub.topic), topic_vals)
    dt_out = _exclusive_group_prefix((sub.dst_broker, sub.topic), topic_vals)

    idx = torch.arange(m, dtype=torch.int32, device=dev)
    rank_eff = torch.where(considered, idx, m)
    keys2 = torch.cat([sub.src_broker, sub.dst_broker])
    ranks2 = torch.cat([rank_eff, rank_eff])
    perm2 = _lexsort_perm((keys2, ranks2))
    k_sorted = keys2[perm2]
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          k_sorted[1:] != k_sorted[:-1]])
    ar = torch.arange(2 * m, device=dev)
    start_pos = torch.cummax(torch.where(is_start, ar, 0), 0).values
    entry_min = torch.zeros(2 * m, dtype=torch.int32, device=dev)
    entry_min[perm2] = ranks2[perm2][start_pos].to(torch.int32)
    has_earlier = (entry_min[:m] < idx) | (entry_min[m:] < idx)

    return dataclasses.replace(
        sub,
        pre_src_load=src_out[:, :r],
        pre_dst_load=dst_out[:, :r],
        pre_src_count=src_out[:, r],
        pre_dst_count=dst_out[:, r],
        pre_src_leaders=src_out[:, r + 1],
        pre_dst_leaders=dst_out[:, r + 1],
        pre_src_topic_count=st_out[:, 0],
        pre_dst_topic_count=dt_out[:, 0],
        pre_src_topic_leaders=st_out[:, 1],
        pre_dst_pot=dst_out[:, r + 2],
        pre_dst_lbi=dst_out[:, r + 3],
    ), has_earlier

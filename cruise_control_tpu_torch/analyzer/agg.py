"""Incrementally-maintained per-broker aggregates for the search loop,
and kernel K1 (``segment_reduce``).

Port of ``cruise_control_tpu/analyzer/agg.py``. Every round needs the
per-broker aggregates (load [B, R], replica/leader counts, potential
NW-out, leader bytes-in, per-(topic, broker) replica counts). They are
computed in full at each goal's entry and every REFRESH_EVERY rounds, and
updated in between by the selected batch's exact deltas.

K1 ``segment_reduce`` computes the full aggregates in one pass over the
[P, S] slots (``compute_agg``) and, in its offline mode, the per-round
count of offline replicas per broker (``offline_per_broker``). On a CUDA
tensor the wrapper launches ``csrc/segment_reduce.cu``; on a CPU tensor it
runs the plain twin, which repeats the reference's segment sums
(sequential ``index_add_`` over the flat slots — the reference's order).

K4 ``apply_deltas`` scatters a selected batch onto the carry
(``apply_deltas_to_agg``): ``csrc/apply_deltas.cu`` on the card, the
plain twin on the CPU, both adding rows in the reference's order.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..common.resources import Resource
from ..model.tensors import (
    ClusterTensors, broker_leader_counts, broker_load, broker_replica_counts,
    leader_bytes_in, offline_replicas, potential_nw_out, scatter_to_brokers,
    topic_broker_replica_counts,
)

# Full-recompute cadence inside a goal's loop (bounds f32 drift; counts are
# exact regardless).
REFRESH_EVERY = 64
# K1's full mode keeps a per-broker histogram of its tile in one block's
# shared memory (csrc/segment_reduce.cu).
SEGMENT_REDUCE_MAX_BROKERS = 16384
# K4 sorts the batch's 2m events in one block (1,024 threads x 4 radix
# sort items) and stages their deltas in 96 KB of shared memory
# (csrc/apply_deltas.cu): m <= 2048, the bounded path's cap.
APPLY_DELTAS_MAX_M = 2048
APPLY_DELTAS_MAX_BROKERS = 2 ** 19  # the broker field of its 32-bit keys


@dataclasses.dataclass(frozen=True)
class AggCarry:
    broker_load: torch.Tensor      # [B, R] f32
    broker_replicas: torch.Tensor  # [B] i32
    broker_leaders: torch.Tensor   # [B] i32
    pot_nw_out: torch.Tensor       # [B] f32
    lbi: torch.Tensor              # [B] f32 (leader NW_IN per broker)
    topic_counts: torch.Tensor     # [T, B] i32


def compute_agg_plain(state: ClusterTensors, num_topics: int) -> AggCarry:
    """K1's twin, full mode: the reference's six segment sums."""
    return AggCarry(
        broker_load=broker_load(state),
        broker_replicas=broker_replica_counts(state),
        broker_leaders=broker_leader_counts(state),
        pot_nw_out=potential_nw_out(state),
        lbi=leader_bytes_in(state),
        topic_counts=topic_broker_replica_counts(state, num_topics),
    )


def offline_per_broker_plain(state: ClusterTensors) -> torch.Tensor:
    """K1's twin, offline mode: [B] f32 offline replicas per broker."""
    return scatter_to_brokers(state,
                              offline_replicas(state).to(torch.float32))


def _kernel_inputs(state: ClusterTensors):
    dev = state.device
    p, s = state.assignment.shape
    b = state.num_brokers
    req = kernels.requirer("segment_reduce")
    return (req(state.assignment, dev, torch.int32, (p, s), "assignment"),
            req(state.leader_slot, dev, torch.int32, (p,), "leader_slot"),
            req(state.partition_mask, dev, torch.bool, (p,),
                "partition_mask"),
            req(state.leader_load, dev, torch.float32, (p, 4), "leader_load"),
            req(state.follower_load, dev, torch.float32, (p, 4),
                "follower_load"),
            req(state.topic, dev, torch.int32, (p,), "topic"),
            req(state.broker_state, dev, torch.int8, (b,), "broker_state"),
            req(state.broker_mask, dev, torch.bool, (b,), "broker_mask"))


def compute_agg(state: ClusterTensors, num_topics: int) -> AggCarry:
    """Full aggregate recompute: K1 on the card, its twin on the CPU."""
    if state.device.type == "cpu":
        return compute_agg_plain(state, num_topics)
    if state.device.type != "cuda":
        raise ValueError(f"segment_reduce: unsupported device {state.device}")
    (assignment, leader_slot, pmask, ll, fl, topic, _bs,
     _bm) = _kernel_inputs(state)
    p, s = assignment.shape
    b = state.num_brokers
    if b > SEGMENT_REDUCE_MAX_BROKERS:
        raise kernels.limit_error("segment_reduce", f"B={b}")
    dev = state.device
    out = AggCarry(
        broker_load=torch.empty((b, 4), dtype=torch.float32, device=dev),
        broker_replicas=torch.empty(b, dtype=torch.int32, device=dev),
        broker_leaders=torch.empty(b, dtype=torch.int32, device=dev),
        pot_nw_out=torch.empty(b, dtype=torch.float32, device=dev),
        lbi=torch.empty(b, dtype=torch.float32, device=dev),
        topic_counts=torch.empty((num_topics, b), dtype=torch.int32,
                                 device=dev))
    lib = kernels.library("segment_reduce")
    words = lib.cc_segment_reduce_scratch_words(p * s, b)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    code = lib.cc_segment_reduce_full(
        assignment.data_ptr(), leader_slot.data_ptr(), pmask.data_ptr(),
        ll.data_ptr(), fl.data_ptr(), topic.data_ptr(), p, s, b,
        num_topics, out.broker_load.data_ptr(),
        out.broker_replicas.data_ptr(), out.broker_leaders.data_ptr(),
        out.pot_nw_out.data_ptr(), out.lbi.data_ptr(),
        out.topic_counts.data_ptr(), scratch.data_ptr(), words,
        kernels.stream_ptr(dev))
    kernels.check(code, "segment_reduce full")
    kernels.LAUNCHES["segment_reduce"] += 1
    return out


def offline_per_broker(state: ClusterTensors) -> torch.Tensor:
    """[B] f32 — offline replicas per broker (the per-round self-healing
    source bonus): K1's offline mode on the card, its twin on the CPU."""
    if state.device.type == "cpu":
        return offline_per_broker_plain(state)
    if state.device.type != "cuda":
        raise ValueError(f"segment_reduce: unsupported device {state.device}")
    (assignment, _ls, pmask, _ll, _fl, _t, bstate,
     bmask) = _kernel_inputs(state)
    p, s = assignment.shape
    b = state.num_brokers
    out = torch.empty(b, dtype=torch.float32, device=state.device)
    hist = torch.empty(b, dtype=torch.int32, device=state.device)
    lib = kernels.library("segment_reduce")
    code = lib.cc_segment_reduce_offline(
        assignment.data_ptr(), pmask.data_ptr(), bstate.data_ptr(),
        bmask.data_ptr(), p, s, b, hist.data_ptr(), out.data_ptr(),
        kernels.stream_ptr(state.device))
    kernels.check(code, "segment_reduce offline")
    kernels.LAUNCHES["segment_reduce_offline"] += 1
    return out


def _masked_add(target: torch.Tensor, index: torch.Tensor,
                values: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``target.at[where(sel, index, OOB)].add(values, mode="drop")``:
    unselected rows add into a pad row past the end, which is dropped, so
    the scatter's shape does not depend on the selection; on the CPU the
    rows add sequentially in row order (on CUDA the accumulating
    ``index_put_`` sorts per index instead of using float atomics, so the
    twin is at least deterministic there)."""
    n = target.shape[0]
    padded = torch.cat([target, target.new_zeros((1,) + tuple(
        target.shape[1:]))])
    rows = torch.where(sel, index.long(),
                       torch.full((), n, dtype=torch.int64,
                                  device=index.device))
    return padded.index_put_((rows,), values, accumulate=True)[:n]


def apply_deltas_to_agg_plain(agg: AggCarry, sub, sel: torch.Tensor,
                              pot_delta: torch.Tensor,
                              lbi_delta: torch.Tensor) -> AggCarry:
    """K4's twin: the reference's two scatters per aggregate (every
    selected row's source loses, then every selected row's destination
    gains), in row order."""
    src, dst = sub.src_broker, sub.dst_broker
    rep = sub.replica_delta.to(torch.int32)
    lead = sub.leader_delta.to(torch.int32)
    b = agg.broker_load.shape[0]
    t = agg.topic_counts.shape[0]

    def both(x, d):
        return _masked_add(_masked_add(x, src, -d, sel), dst, d, sel)

    flat = agg.topic_counts.reshape(-1)
    flat = _masked_add(flat, sub.topic * b + src, -rep, sel)
    flat = _masked_add(flat, sub.topic * b + dst, rep, sel)
    return AggCarry(
        broker_load=both(agg.broker_load, sub.load_delta),
        broker_replicas=both(agg.broker_replicas, rep),
        broker_leaders=both(agg.broker_leaders, lead),
        pot_nw_out=both(agg.pot_nw_out, pot_delta),
        lbi=both(agg.lbi, lbi_delta),
        topic_counts=flat.reshape(t, b),
    )


def apply_deltas_to_agg(agg: AggCarry, sub, sel: torch.Tensor,
                        pot_delta: torch.Tensor, lbi_delta: torch.Tensor,
                        ) -> AggCarry:
    """Scatter the effect of the accepted candidates (``sel``) onto the
    carry; the rest are dropped. K4 on the card, its twin on the CPU;
    both add in the reference's row order."""
    dev = agg.broker_load.device
    if dev.type == "cpu":
        return apply_deltas_to_agg_plain(agg, sub, sel, pot_delta, lbi_delta)
    if dev.type != "cuda":
        raise ValueError(f"apply_deltas: unsupported device {dev}")
    b = agg.broker_load.shape[0]
    t = agg.topic_counts.shape[0]
    m = sel.shape[0]
    if m > APPLY_DELTAS_MAX_M or b >= APPLY_DELTAS_MAX_BROKERS:
        raise kernels.limit_error("apply_deltas", f"m={m}, B={b}")
    req = kernels.requirer("apply_deltas")
    i32, f32 = torch.int32, torch.float32
    ins = (req(agg.broker_load, dev, f32, (b, 4), "broker_load"),
           req(agg.broker_replicas, dev, i32, (b,), "broker_replicas"),
           req(agg.broker_leaders, dev, i32, (b,), "broker_leaders"),
           req(agg.pot_nw_out, dev, f32, (b,), "pot_nw_out"),
           req(agg.lbi, dev, f32, (b,), "lbi"),
           req(agg.topic_counts, dev, i32, (t, b), "topic_counts"),
           req(sub.src_broker, dev, i32, (m,), "src_broker"),
           req(sub.dst_broker, dev, i32, (m,), "dst_broker"),
           req(sub.load_delta, dev, f32, (m, 4), "load_delta"),
           req(sub.replica_delta, dev, i32, (m,), "replica_delta"),
           req(sub.leader_delta, dev, i32, (m,), "leader_delta"),
           req(sub.topic, dev, i32, (m,), "topic"),
           req(sel, dev, torch.bool, (m,), "sel"),
           req(pot_delta, dev, f32, (m,), "pot_delta"),
           req(lbi_delta, dev, f32, (m,), "lbi_delta"))
    out = AggCarry(*(torch.empty_like(x) for x in ins[:6]))
    lib = kernels.library("apply_deltas")
    code = lib.cc_apply_deltas(
        *[x.data_ptr() for x in ins], m, b, t,
        *[getattr(out, f.name).data_ptr()
          for f in dataclasses.fields(out)],
        kernels.stream_ptr(dev))
    kernels.check(code, "apply_deltas")
    kernels.LAUNCHES["apply_deltas"] += 1
    return out


def pot_lbi_deltas(state: ClusterTensors, sub,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(pot_delta, lbi_delta) for a candidate batch: potential NW-out
    travels with the replica, leader bytes-in with the leadership."""
    part = sub.partition.long()
    zero = torch.zeros((), device=state.device)
    pot = torch.where(sub.replica_delta > 0,
                      state.leader_load[part, int(Resource.NW_OUT)], zero)
    lbi = torch.where(sub.leader_delta > 0,
                      state.leader_load[part, int(Resource.NW_IN)], zero)
    return pot, lbi


def maybe_refresh(agg: AggCarry, state: ClusterTensors, num_topics: int,
                  rounds_done: int) -> AggCarry:
    """Fresh recompute every REFRESH_EVERY rounds; the carry otherwise."""
    if rounds_done % REFRESH_EVERY == REFRESH_EVERY - 1:
        return compute_agg(state, num_topics)
    return agg

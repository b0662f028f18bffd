"""JBOD disk model and the intra-broker disk balancer, kernel K5.

Port of ``cruise_control_tpu/model/disks.py`` (model/Disk.java's per-disk
capacity and ALIVE/DEAD state, IntraBrokerDiskCapacityGoal.java and
IntraBrokerDiskUsageDistributionGoal.java: move replicas between one
broker's log dirs to respect per-disk capacity and balance usage).

``balance_intra_broker`` runs the reference's loop: every round, each
broker moves its heaviest movable replica off its most-pressured disk onto
its least-utilized alive disk, until no broker moves or ``max_rounds``.
On a CUDA tensor it launches K5 (``csrc/intra_broker.cu``), which runs
each broker's loop to its own fixed point in one CTA; on a CPU tensor it
runs the plain twin, a per-round loop over all brokers like the
reference's. ``disk_load`` on a CUDA tensor runs K5's load mode, a stable
placement of the slots by broker and a fold per (broker, disk), with no
host read; both sum each (broker, disk) in flat slot order, as the
reference's segment sum does.

Two properties of the reference that both versions carry on purpose:

- Its loop rounds every product before the difference it feeds: XLA
  hoists ``cap * capacity_threshold`` out of the loop, and computes
  ``avg * upper`` once per broker for all its disks, so neither is
  contracted into a multiply-add (the reference's optimized IR; the
  per-round shed pressure, captured from its loop, matches this form
  bit for bit at D = 2, 4 and 8, tests/test_torch_disks.py).
- The sentinel collision. A broker without a real pick still writes its
  scatter row: ``pick`` is int32's maximum when no replica sits on its
  source disk, and ``P * S`` when every one there is pinned; clipped,
  those land on slots ``(P-1, 2147483647 % S)`` and ``(P-1, 0)``, and the
  write puts back the slot's value from the start of the round. Writes
  with equal indices land in broker order, so such a broker with a higher
  index than the slot's owner undoes the owner's move of that slot in
  every round it has no pick (``sentinel_slots``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .. import kernels
from ..common.resources import Resource
from ..utils.device import resolve_device
from .tensors import (
    ClusterMeta, ClusterTensors, replica_exists, replica_load_column,
)

INT32_MAX = 2 ** 31 - 1
# K5's balancer stages one broker's replicas in one CTA's shared memory and
# keeps a broker's per-disk state in registers of one warp; its load mode
# takes any number of replicas on one broker (csrc/intra_broker.cu).
INTRA_BROKER_MAX_REPLICAS = 8192
INTRA_BROKER_MAX_DISKS = 32
INTRA_BROKER_MAX_BROKERS = 2 ** 20


@dataclasses.dataclass(frozen=True)
class DiskTensors:
    disk_assignment: torch.Tensor  # [P, S] int32 — disk slot in the broker, -1 none
    disk_capacity: torch.Tensor    # [B, D] float32 — 0 = slot unused
    disk_alive: torch.Tensor       # [B, D] bool

    @property
    def max_disks(self) -> int:
        return self.disk_capacity.shape[1]

    def to(self, device) -> "DiskTensors":
        return DiskTensors(*(getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)))


@dataclasses.dataclass
class DiskMeta:
    """Host-side log-dir names per (broker index, disk slot)."""

    dir_names: list[list[str]]   # [B][D] ('' for unused slots)

    def slot_of(self, broker_idx: int, logdir: str) -> int:
        return self.dir_names[broker_idx].index(logdir)


_DISK_FIELDS = {"disk_assignment": torch.int32,
                "disk_capacity": torch.float32, "disk_alive": torch.bool}


def disks_from_numpy(arrays: Mapping[str, np.ndarray], device) -> DiskTensors:
    """DiskTensors from numpy arrays named like its fields (the JAX
    package's ``DiskTensors`` fields, ``np.asarray``-ed) on ``device``."""
    return DiskTensors(**{
        f: torch.as_tensor(np.array(arrays[f])).to(device=device, dtype=dt)
        for f, dt in _DISK_FIELDS.items()})


def disks_to_numpy(disks: DiskTensors) -> dict[str, np.ndarray]:
    """The inverse of :func:`disks_from_numpy`."""
    return {f: getattr(disks, f).cpu().numpy() for f in _DISK_FIELDS}


def sentinel_slots(num_partitions: int, rf: int) -> tuple[int, int]:
    """Flat indices of the reference's two sentinel slots: where a broker
    with every replica of its source disk pinned writes (``pick = P*S``),
    and where a broker with no replica there writes (``pick`` = int32's
    maximum). The same slot when ``rf`` is 1."""
    last = (num_partitions - 1) * rf
    return last, last + INT32_MAX % rf


# ---- the plain twin --------------------------------------------------------

def _disk_load_plain(state: ClusterTensors, disk_assignment: torch.Tensor,
                     num_disks: int) -> torch.Tensor:
    """[B, D] per-(broker, disk) sum of the replicas' DISK load, one
    sequential ``index_add_`` over the flat slots (the reference's segment
    sum)."""
    b, d = state.num_brokers, num_disks
    exists = replica_exists(state) & (disk_assignment >= 0)
    seg = torch.where(exists, state.assignment.long() * d
                      + disk_assignment.long(), b * d).reshape(-1)
    load = replica_load_column(state, int(Resource.DISK))
    flat = torch.where(exists, load, torch.zeros((), device=load.device))
    out = load.new_zeros(b * d + 1).index_add_(0, seg, flat.reshape(-1))
    return out[:b * d].reshape(b, d)


def _over_capacity(load, cap, alive_disk, capacity_threshold: float):
    """The capacity part of the violation: load above cap * threshold
    plus any load on a dead disk."""
    zero = torch.zeros((), device=load.device)
    present = cap > 0
    over = torch.clamp(load - cap * capacity_threshold, min=0.0)
    dead = present & ~alive_disk
    return torch.where(present, over, zero) + torch.where(dead, load, zero)


def _band_parts(load, cap, alive_disk):
    """(util, alive, avg): per-disk utilization, alive present disks and
    each broker's mean utilization over them, summed in disk order."""
    zero = torch.zeros((), device=load.device)
    present = cap > 0
    util = torch.where(present, load / torch.clamp(cap, min=1e-9), zero)
    alive = present & alive_disk
    n_alive = torch.clamp(alive.sum(dim=1, keepdim=True), min=1)
    weighted = util * alive
    total = weighted[:, 0]
    for k in range(1, weighted.shape[1]):
        total = total + weighted[:, k]
    return util, alive, total[:, None] / n_alive


def _shed_pressure(load, cap, alive_disk, capacity_threshold: float,
                   upper: float | None):
    """[B, D] — the shed side of the violation: over capacity, load on a
    dead disk and, with a band, utilization above ``avg * upper``."""
    v = _over_capacity(load, cap, alive_disk, capacity_threshold)
    if upper is not None:
        util, alive, avg = _band_parts(load, cap, alive_disk)
        above = torch.clamp(util - avg * upper, min=0.0)
        v = v + torch.where(alive, above * cap,
                            torch.zeros((), device=load.device))
    return v


def _round_plain(state, disks, assign, rep_load, exists, cand,
                 capacity_threshold, upper):
    """One round of the reference's loop over every broker at once:
    (new disk assignment, whether any broker had a valid move)."""
    b, d = state.num_brokers, disks.max_disks
    p_count, s = assign.shape
    n = p_count * s
    dev = assign.device
    load = _disk_load_plain(state, assign, d)
    cap = disks.disk_capacity
    alive = (cap > 0) & disks.disk_alive
    viol = _shed_pressure(load, cap, disks.disk_alive, capacity_threshold,
                          upper)
    src_disk = torch.argmax(viol, dim=1)
    has_viol = viol.gather(1, src_disk[:, None])[:, 0] > 1e-9
    util = torch.where(alive, load / torch.clamp(cap, min=1e-9),
                       torch.full((), float("inf"), device=dev))
    dst_disk = torch.argmin(util, dim=1)
    dst_ok = alive.gather(1, dst_disk[:, None])[:, 0] & (dst_disk != src_disk)

    flat_broker = torch.where(exists, state.assignment.long(), b).reshape(-1)
    safe_broker = torch.clamp(flat_broker, 0, b - 1)
    flat_load = torch.where(cand, rep_load,
                            torch.full((), -1.0, device=dev)).reshape(-1)
    flat_disk = torch.where((assign >= 0) & exists, assign.long(),
                            -1).reshape(-1)
    on_src = (flat_disk == src_disk[safe_broker]) & (flat_broker < b)
    seg = torch.where(on_src, flat_broker, b)
    score = torch.where(on_src, flat_load,
                        torch.full((), -1.0, device=dev))
    best = torch.full((b + 1,), float("-inf"), device=dev).scatter_reduce_(
        0, seg, score, "amax")[:b]
    is_best = on_src & (score == best[safe_broker]) & (score >= 0)
    idx = torch.where(is_best, torch.arange(n, device=dev), n)
    pick = torch.full((b + 1,), INT32_MAX, dtype=torch.int64,
                      device=dev).scatter_reduce_(0, seg, idx, "amin")[:b]
    valid = has_viol & dst_ok & (pick < n)

    # Every broker writes one slot: its pick, or for a broker without one
    # a sentinel slot of the last partition. Writes to one slot land in
    # broker order, so the highest-indexed writer's value stands; every
    # writer of a slot is given that value, which makes the scatter's own
    # order among duplicates irrelevant.
    rows = torch.clamp(pick // s, 0, p_count - 1)
    cols = torch.clamp(pick % s, 0, s - 1)
    target = rows * s + cols
    flat_assign = assign.reshape(-1)
    value = torch.where(valid, dst_disk.to(assign.dtype), flat_assign[target])
    last = torch.full((n,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, target, torch.arange(b, device=dev), "amax")
    new_assign = flat_assign.clone()
    new_assign[target] = value[last[target]]
    return new_assign.reshape(p_count, s), valid.any()


def balance_intra_broker_plain(state: ClusterTensors, disks: DiskTensors,
                               capacity_threshold: float = 0.8,
                               balance_band: tuple[float, float] | None = None,
                               max_rounds: int = 64,
                               movable: torch.Tensor | None = None,
                               ) -> DiskTensors:
    """K5's twin: the reference's per-round loop over every broker."""
    rep_load = replica_load_column(state, int(Resource.DISK))
    exists = replica_exists(state)
    cand = exists & movable[:, None] if movable is not None else exists
    upper = balance_band[1] if balance_band is not None else None
    assign = disks.disk_assignment
    for _ in range(max_rounds):
        assign, moved = _round_plain(state, disks, assign, rep_load, exists,
                                     cand, capacity_threshold, upper)
        if not bool(moved):
            break
    return dataclasses.replace(disks, disk_assignment=assign)


# ---- K5 --------------------------------------------------------------------

def _k5_call(state: ClusterTensors, disks: DiskTensors,
             capacity_threshold: float, upper: float | None,
             max_rounds: int, movable: torch.Tensor | None,
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One call of K5's balancer on the card: (final disk assignment,
    final per-disk loads [B, D])."""
    dev = state.device
    p, s = state.assignment.shape
    b, d = state.num_brokers, disks.max_disks
    if (b > INTRA_BROKER_MAX_BROKERS or d > INTRA_BROKER_MAX_DISKS
            or p * s >= 2 ** 31 or p * s == 0):
        raise kernels.limit_error("intra_broker", f"B={b}, D={d}, P*S={p * s}")
    req = kernels.requirer("intra_broker")
    load = replica_load_column(state, int(Resource.DISK)).contiguous()
    if movable is None:
        movable = torch.ones(p, dtype=torch.bool, device=dev)
    ins = (req(state.assignment, dev, torch.int32, (p, s), "assignment"),
           req(state.partition_mask, dev, torch.bool, (p,), "partition_mask"),
           req(load, dev, torch.float32, (p, s), "replica_disk_load"),
           req(movable.contiguous(), dev, torch.bool, (p,), "movable"),
           req(disks.disk_assignment, dev, torch.int32, (p, s),
               "disk_assignment"),
           req(disks.disk_capacity, dev, torch.float32, (b, d),
               "disk_capacity"),
           req(disks.disk_alive, dev, torch.bool, (b, d), "disk_alive"))
    lib = kernels.library("intra_broker")
    scratch = torch.empty(lib.cc_intra_broker_scratch_words(p * s, b),
                          dtype=torch.int32, device=dev)
    stream = kernels.stream_ptr(dev)
    code = lib.cc_intra_broker_group(ins[0].data_ptr(), ins[1].data_ptr(),
                                     p, s, b, scratch.data_ptr(), stream)
    kernels.check(code, "intra_broker group")
    # The largest replica count of one broker sizes the balance kernel's
    # shared memory: one read of it on the host.
    most = int(scratch[lib.cc_intra_broker_max_offset(b)].item())
    LAST_CALL.update(max_replicas_per_broker=most)
    if most > INTRA_BROKER_MAX_REPLICAS:
        raise kernels.limit_error(
            "intra_broker", f"a broker hosts {most} replicas")
    out_assign = torch.empty_like(ins[4])
    out_load = torch.empty((b, d), dtype=torch.float32, device=dev)
    band = upper is not None
    code = lib.cc_intra_broker_balance(
        *[x.data_ptr() for x in ins], p, s, b, d, most,
        float(np.float32(capacity_threshold)),
        float(np.float32(upper)) if band else 0.0, int(band), max_rounds,
        out_assign.data_ptr(), out_load.data_ptr(), scratch.data_ptr(),
        stream)
    kernels.check(code, "intra_broker balance")
    # Per broker: replicas, the first round without a pick and its kind
    # (1: every replica of the source disk pinned, 2: none there) and the
    # rounds run (scratch words, see the source).
    LAST_CALL.update(replicas=scratch[:b], no_pick_round=scratch[-3 * b:-2 * b],
                     no_pick_kind=scratch[-2 * b:-b], rounds=scratch[-b:])
    return out_assign, out_load


# What the last call of K5's balancer on the card saw (read by
# chip_smoke.py): the largest replica count of one broker and per-broker
# tensors.
LAST_CALL: dict = {}


def disk_load(state: ClusterTensors, disks: DiskTensors) -> torch.Tensor:
    """[B, D] — DISK load per (broker, disk slot), summed in flat slot
    order: K5's load mode on the card (no host read), the twin's segment
    sum on the CPU. The kernel leaves out a slot whose disk is D or more,
    where the twin would add it to a later broker's disk."""
    dev = state.device
    if dev.type == "cpu":
        return _disk_load_plain(state, disks.disk_assignment,
                                disks.max_disks)
    if dev.type != "cuda":
        raise ValueError(f"intra_broker_load: unsupported device {dev}")
    p, s = state.assignment.shape
    b, d = state.num_brokers, disks.max_disks
    if (b > INTRA_BROKER_MAX_BROKERS or d > INTRA_BROKER_MAX_DISKS
            or p * s >= 2 ** 31 or p * s == 0):
        raise kernels.limit_error("intra_broker_load",
                                  f"B={b}, D={d}, P*S={p * s}")
    req = kernels.requirer("intra_broker_load")
    load = replica_load_column(state, int(Resource.DISK)).contiguous()
    ins = (req(state.assignment, dev, torch.int32, (p, s), "assignment"),
           req(state.partition_mask, dev, torch.bool, (p,), "partition_mask"),
           req(load, dev, torch.float32, (p, s), "replica_disk_load"),
           req(disks.disk_assignment, dev, torch.int32, (p, s),
               "disk_assignment"))
    lib = kernels.library("intra_broker")
    words = lib.cc_intra_broker_load_scratch_words(p * s, b)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    kernels.check(lib.cc_intra_broker_load(
        *[x.data_ptr() for x in ins], p, s, b, d, out.data_ptr(),
        scratch.data_ptr(), words, kernels.stream_ptr(dev)),
        "intra_broker_load")
    kernels.LAUNCHES["intra_broker_load"] += 1
    return out


def intra_broker_violations(state: ClusterTensors, disks: DiskTensors,
                            capacity_threshold: float = 0.8,
                            balance_band: tuple[float, float] | None = None,
                            ) -> torch.Tensor:
    """[B, D] violation magnitude: load beyond capacity·threshold, any load
    on a dead disk, and (optionally) load outside the per-broker balance
    band — the two intra-broker goals' objectives fused."""
    load = disk_load(state, disks)
    cap = disks.disk_capacity
    zero = torch.zeros((), device=load.device)
    v = _over_capacity(load, cap, disks.disk_alive, capacity_threshold)
    if balance_band is not None:
        lower, upper = balance_band
        util, alive, avg = _band_parts(load, cap, disks.disk_alive)
        band_v = torch.clamp(util - avg * upper, min=0.0) \
            + torch.clamp(avg * lower - util, min=0.0)
        v = v + torch.where(alive, band_v * cap, zero)
    return v


def balance_intra_broker(state: ClusterTensors, disks: DiskTensors,
                         capacity_threshold: float = 0.8,
                         balance_band: tuple[float, float] | None = None,
                         max_rounds: int = 64,
                         movable: torch.Tensor | None = None) -> DiskTensors:
    """Per round, every broker moves the heaviest movable replica off its
    most-pressured disk onto its least-utilized alive disk (if that disk
    differs and the source's pressure exceeds 1e-9), until no broker moves
    or ``max_rounds``. ``movable`` ([P] bool) pins the replicas of the
    partitions it leaves False: their load still counts, they never move.
    K5 on the card, the plain twin on the CPU."""
    dev = state.device
    if dev.type == "cpu":
        return balance_intra_broker_plain(state, disks, capacity_threshold,
                                          balance_band, max_rounds, movable)
    if dev.type != "cuda":
        raise ValueError(f"intra_broker: unsupported device {dev}")
    upper = balance_band[1] if balance_band is not None else None
    assign, _load = _k5_call(state, disks, capacity_threshold, upper,
                             max_rounds, movable)
    kernels.LAUNCHES["intra_broker"] += 1
    return dataclasses.replace(disks, disk_assignment=assign)


# ---- proposals and model assembly --------------------------------------------

@dataclasses.dataclass(frozen=True)
class IntraBrokerMove:
    """One logdir move (ExecutionProposal's intra-broker leg)."""

    topic: str
    partition: int
    broker_id: int
    source_logdir: str
    destination_logdir: str


def diff_intra_broker_moves(initial: DiskTensors, final: DiskTensors,
                            state: ClusterTensors, meta: ClusterMeta,
                            disk_meta: DiskMeta) -> list[IntraBrokerMove]:
    """Mirror of AnalyzerUtils.getDiff for the disk axis."""
    before = initial.disk_assignment.cpu().numpy()
    after = final.disk_assignment.cpu().numpy()
    assign = state.assignment.cpu().numpy()
    exists = replica_exists(state).cpu().numpy()
    moves: list[IntraBrokerMove] = []
    for p_idx, s_idx in zip(*np.nonzero((before != after) & exists)):
        broker_idx = int(assign[p_idx, s_idx])
        topic, part = meta.partition_index[int(p_idx)]
        names = disk_meta.dir_names[broker_idx]
        moves.append(IntraBrokerMove(
            topic=topic, partition=part,
            broker_id=meta.broker_ids[broker_idx],
            source_logdir=names[int(before[p_idx, s_idx])],
            destination_logdir=names[int(after[p_idx, s_idx])]))
    return moves


def build_disk_tensors(state: ClusterTensors, meta: ClusterMeta,
                       logdirs_by_broker: dict[int, dict[str, bool]],
                       replica_dirs: dict[tuple[str, int, int], str],
                       capacity_by_dir: dict[tuple[int, str], float] | None = None,
                       default_capacity: float = 1e12,
                       device=None) -> tuple[DiskTensors, DiskMeta]:
    """Assemble DiskTensors from backend JBOD facts (describe_logdirs +
    replica_logdirs + per-dir capacities from capacityJBOD.json), on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    b = state.num_brokers
    s = state.max_replication_factor
    idx_of = {bid: i for i, bid in enumerate(meta.broker_ids)}
    dir_names: list[list[str]] = [[] for _ in range(b)]
    for bid, dirs in logdirs_by_broker.items():
        if bid in idx_of:
            dir_names[idx_of[bid]] = sorted(dirs)
    d = max((len(n) for n in dir_names), default=1) or 1
    cap = np.zeros((b, d), dtype=np.float32)
    alive = np.zeros((b, d), dtype=bool)
    for bid, dirs in logdirs_by_broker.items():
        if bid not in idx_of:
            continue
        i = idx_of[bid]
        for slot, name in enumerate(dir_names[i]):
            cap[i, slot] = (capacity_by_dir or {}).get((bid, name),
                                                       default_capacity)
            alive[i, slot] = dirs[name]
        dir_names[i] += [""] * (d - len(dir_names[i]))
    for i in range(b):
        if not dir_names[i]:
            dir_names[i] = [""] * d

    assign = state.assignment.cpu().numpy()
    disk_assign = np.full((state.num_partitions, s), -1, dtype=np.int32)
    for p_idx, (topic, part) in enumerate(meta.partition_index):
        for s_idx in range(s):
            broker_idx = assign[p_idx, s_idx]
            if broker_idx < 0:
                continue
            bid = meta.broker_ids[broker_idx]
            logdir = replica_dirs.get((topic, part, bid))
            if logdir and logdir in dir_names[broker_idx]:
                disk_assign[p_idx, s_idx] = dir_names[broker_idx].index(logdir)
    return (disks_from_numpy({"disk_assignment": disk_assign,
                              "disk_capacity": cap, "disk_alive": alive},
                             device),
            DiskMeta(dir_names=dir_names))

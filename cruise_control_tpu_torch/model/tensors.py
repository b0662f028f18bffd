"""The cluster model as dense tensors on one device.

Port of ``cruise_control_tpu/model/tensors.py``. Same array schema
(P partitions × S replica slots × B brokers × R resources):

- ``assignment[P, S]`` int32 — broker index per replica slot, -1 empty.
- ``leader_slot[P]`` int32 — leader slot (-1 = offline/no leader).
- ``leader_load[P, R]`` / ``follower_load[P, R]`` float32.
- ``capacity[B, R]`` float32, ``rack[B]`` int32, ``broker_state[B]`` int8,
  ``topic[P]`` int32, ``partition_mask[P]`` / ``broker_mask[B]`` bool,
  ``host[B]`` int32.

Padded replica slots route to broker index B (one past the end) inside
segment reductions, which drop that bucket. A "mutation" returns a new
frozen value; the tensors it does not touch are shared.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ..common.broker_state import BrokerState
from ..common.resources import Resource
from ..utils.numerics import xla_sum

FIELDS = ("assignment", "leader_slot", "leader_load", "follower_load",
          "capacity", "rack", "broker_state", "topic", "partition_mask",
          "broker_mask", "host")

_DTYPES = {
    "assignment": torch.int32, "leader_slot": torch.int32,
    "leader_load": torch.float32, "follower_load": torch.float32,
    "capacity": torch.float32, "rack": torch.int32,
    "broker_state": torch.int8, "topic": torch.int32,
    "partition_mask": torch.bool, "broker_mask": torch.bool,
    "host": torch.int32,
}


@dataclasses.dataclass(frozen=True)
class ClusterTensors:
    assignment: torch.Tensor     # [P, S] int32
    leader_slot: torch.Tensor    # [P] int32
    leader_load: torch.Tensor    # [P, R] float32
    follower_load: torch.Tensor  # [P, R] float32
    capacity: torch.Tensor       # [B, R] float32
    rack: torch.Tensor           # [B] int32 (fault domain, host fallback folded in)
    broker_state: torch.Tensor   # [B] int8
    topic: torch.Tensor          # [P] int32
    partition_mask: torch.Tensor  # [P] bool
    broker_mask: torch.Tensor    # [B] bool
    host: torch.Tensor = None    # [B] int32

    def __post_init__(self):
        if self.host is None:
            object.__setattr__(self, "host", torch.arange(
                self.capacity.shape[0], dtype=torch.int32,
                device=self.capacity.device))

    @property
    def device(self) -> torch.device:
        return self.assignment.device

    @property
    def num_partitions(self) -> int:
        return self.assignment.shape[0]

    @property
    def max_replication_factor(self) -> int:
        return self.assignment.shape[1]

    @property
    def num_brokers(self) -> int:
        return self.capacity.shape[0]

    @property
    def num_topics(self) -> int:
        return self.num_partitions

    def to(self, device) -> "ClusterTensors":
        return ClusterTensors(**{f: getattr(self, f).to(device)
                                 for f in FIELDS})


@dataclasses.dataclass
class ClusterMeta:
    """Host-side names for the integer indices of a ClusterTensors value."""

    broker_ids: list[int]
    topic_names: list[str]
    rack_names: list[str]
    num_topics: int
    partition_index: list[tuple[str, int]]
    host_names: list[str] = dataclasses.field(default_factory=list)


def cluster_from_numpy(arrays: Mapping[str, np.ndarray],
                       device) -> ClusterTensors:
    """ClusterTensors from numpy arrays named like its fields (the JAX
    package's ``ClusterTensors`` fields, ``np.asarray``-ed), cast to the
    schema's dtypes on ``device``. ``host`` may be absent."""
    kwargs = {}
    for f in FIELDS:
        if f not in arrays or arrays[f] is None:
            if f == "host":
                continue
            raise ValueError(f"missing ClusterTensors field {f!r}")
        kwargs[f] = torch.as_tensor(np.array(arrays[f])).to(
            device=device, dtype=_DTYPES[f])
    return ClusterTensors(**kwargs)


def cluster_to_numpy(state: ClusterTensors) -> dict[str, np.ndarray]:
    """The inverse of :func:`cluster_from_numpy`."""
    return {f: getattr(state, f).cpu().numpy() for f in FIELDS}


# ---- derived quantities ----------------------------------------------------

def broker_segments(state: ClusterTensors) -> torch.Tensor:
    """[P, S] int64 — broker index per slot, B for empty slots."""
    return torch.where(state.assignment >= 0, state.assignment,
                       state.num_brokers).long()


def replica_exists(state: ClusterTensors) -> torch.Tensor:
    """[P, S] bool — slot holds a real replica of a real partition."""
    return (state.assignment >= 0) & state.partition_mask[:, None]


def is_leader_slot(state: ClusterTensors) -> torch.Tensor:
    """[P, S] bool — slot is the partition's leader."""
    s = torch.arange(state.max_replication_factor, dtype=torch.int32,
                     device=state.device)
    return (state.leader_slot[:, None] == s[None, :]) & replica_exists(state)


def replica_load(state: ClusterTensors) -> torch.Tensor:
    """[P, S, R] float32 — per-slot resource load (leader vs follower)."""
    lead = is_leader_slot(state)
    load = torch.where(lead[:, :, None], state.leader_load[:, None, :],
                       state.follower_load[:, None, :])
    return load * replica_exists(state)[:, :, None]


def replica_load_total(state: ClusterTensors) -> torch.Tensor:
    """[P, S] float32 — summed-over-resources load per replica slot."""
    lsum = xla_sum(state.leader_load, 1)
    fsum = xla_sum(state.follower_load, 1)
    lead = is_leader_slot(state)
    return torch.where(lead, lsum[:, None], fsum[:, None]) \
        * replica_exists(state)


def replica_load_column(state: ClusterTensors, r: int) -> torch.Tensor:
    """[P, S] float32 — one resource column of the per-replica load."""
    lead = is_leader_slot(state)
    return torch.where(lead, state.leader_load[:, r][:, None],
                       state.follower_load[:, r][:, None]) \
        * replica_exists(state)


def scatter_to_brokers(state: ClusterTensors,
                       per_slot: torch.Tensor) -> torch.Tensor:
    """Sum a [P, S] or [P, S, R] per-replica quantity into per-broker rows
    ([B] or [B, R]), sequentially in flat slot order (the reference's
    segment-sum order). Empty slots route to a dropped bucket at B."""
    b = state.num_brokers
    seg = broker_segments(state).reshape(-1)
    flat = per_slot.reshape((seg.shape[0],) + tuple(per_slot.shape[2:]))
    out = flat.new_zeros((b + 1,) + tuple(per_slot.shape[2:]))
    out.index_add_(0, seg, flat)
    return out[:b]


def broker_load(state: ClusterTensors) -> torch.Tensor:
    """[B, R] float32 — total resource load per broker."""
    return scatter_to_brokers(state, replica_load(state))


def broker_replica_counts(state: ClusterTensors) -> torch.Tensor:
    """[B] int32 — replicas hosted per broker."""
    return scatter_to_brokers(state, replica_exists(state).to(torch.int32))


def broker_leader_counts(state: ClusterTensors) -> torch.Tensor:
    """[B] int32 — leader replicas per broker."""
    return scatter_to_brokers(state, is_leader_slot(state).to(torch.int32))


def _topic_broker_counts(state: ClusterTensors, num_topics: int,
                         per_slot: torch.Tensor) -> torch.Tensor:
    """[T, B] int32 — count of ``per_slot``-selected replicas per
    (topic, broker); masked-out slots route to a dropped bucket."""
    b = state.num_brokers
    if num_topics == 0:
        return torch.zeros((0, b), dtype=torch.int32, device=state.device)
    seg = torch.where(per_slot,
                      state.topic[:, None].long() * (b + 1)
                      + broker_segments(state),
                      num_topics * (b + 1)).reshape(-1)
    out = torch.zeros(num_topics * (b + 1) + 1, dtype=torch.int32,
                      device=state.device)
    out.index_add_(0, seg, per_slot.to(torch.int32).reshape(-1))
    return out[:num_topics * (b + 1)].reshape(num_topics, b + 1)[:, :b]


def topic_broker_replica_counts(state: ClusterTensors,
                                num_topics: int) -> torch.Tensor:
    """[T, B] int32 — replicas per (topic, broker)."""
    return _topic_broker_counts(state, num_topics, replica_exists(state))


def topic_broker_leader_counts(state: ClusterTensors,
                               num_topics: int) -> torch.Tensor:
    """[T, B] int32 — leaders per (topic, broker)."""
    return _topic_broker_counts(state, num_topics, is_leader_slot(state))


def potential_nw_out(state: ClusterTensors) -> torch.Tensor:
    """[B] float32 — NW_OUT every broker would bear if all its replicas
    became leaders (PotentialNwOutGoal's aggregate)."""
    nw_out = state.leader_load[:, int(Resource.NW_OUT)]
    per_slot = nw_out[:, None].expand(state.assignment.shape) \
        * replica_exists(state)
    return scatter_to_brokers(state, per_slot)


def leader_bytes_in(state: ClusterTensors) -> torch.Tensor:
    """[B] float32 — leader NW_IN per broker."""
    nw_in = state.leader_load[:, int(Resource.NW_IN)]
    per_slot = torch.where(is_leader_slot(state),
                           nw_in[:, None].expand(state.assignment.shape),
                           torch.zeros((), device=state.device))
    return scatter_to_brokers(state, per_slot)


def rack_partition_counts(state: ClusterTensors,
                          num_racks: int) -> torch.Tensor:
    """[P, K] int32 — replicas of each partition per rack."""
    exists = replica_exists(state)
    broker_rack = torch.cat([state.rack, state.rack.new_full((1,), num_racks)])
    slot_rack = broker_rack[broker_segments(state)]
    racks = torch.arange(num_racks, dtype=slot_rack.dtype, device=state.device)
    one_hot = (slot_rack[:, :, None] == racks[None, None, :]) & exists[:, :, None]
    return one_hot.to(torch.int32).sum(dim=1, dtype=torch.int32)


def alive_mask(state: ClusterTensors) -> torch.Tensor:
    """[B] bool — broker alive & real (DEAD does not host)."""
    return (state.broker_state != int(BrokerState.DEAD)) & state.broker_mask


def new_broker_mask(state: ClusterTensors) -> torch.Tensor:
    return (state.broker_state == int(BrokerState.NEW)) & state.broker_mask


def offline_replicas(state: ClusterTensors) -> torch.Tensor:
    """[P, S] bool — replicas on dead brokers (self-healing eligible)."""
    dead_pad = torch.cat([~alive_mask(state),
                          torch.ones(1, dtype=torch.bool, device=state.device)])
    return replica_exists(state) & dead_pad[broker_segments(state)]


# ---- functional mutations --------------------------------------------------

def apply_replica_move(state: ClusterTensors, partition: torch.Tensor,
                       slot: torch.Tensor,
                       dst_broker: torch.Tensor) -> ClusterTensors:
    """Move the replica at (partition, slot) to dst_broker."""
    assignment = state.assignment.clone()
    assignment[partition.long(), slot.long()] = \
        dst_broker.to(assignment.dtype)
    return dataclasses.replace(state, assignment=assignment)


def apply_leadership_move(state: ClusterTensors, partition: torch.Tensor,
                          new_leader_slot: torch.Tensor) -> ClusterTensors:
    """Transfer leadership to another slot of the partition."""
    leader = state.leader_slot.clone()
    leader[partition.long()] = new_leader_slot.to(leader.dtype)
    return dataclasses.replace(state, leader_slot=leader)


def apply_swap(state: ClusterTensors, p1: torch.Tensor, s1: torch.Tensor,
               p2: torch.Tensor, s2: torch.Tensor) -> ClusterTensors:
    """Swap the broker placements of two replicas."""
    p1, s1, p2, s2 = p1.long(), s1.long(), p2.long(), s2.long()
    b1 = state.assignment[p1, s1]
    b2 = state.assignment[p2, s2]
    assignment = state.assignment.clone()
    assignment[p1, s1] = b2
    assignment[p2, s2] = b1
    return dataclasses.replace(state, assignment=assignment)


def set_broker_state(state: ClusterTensors, broker: torch.Tensor,
                     code: int) -> ClusterTensors:
    broker_state = state.broker_state.clone()
    broker_state[torch.as_tensor(broker, device=state.device).long()] = \
        int(code)
    return dataclasses.replace(state, broker_state=broker_state)

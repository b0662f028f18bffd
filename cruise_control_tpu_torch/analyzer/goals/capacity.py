"""Hard capacity goals (CapacityGoal.java and its four resource
specializations, ReplicaCapacityGoal.java).

Port of ``cruise_control_tpu/analyzer/goals/capacity.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from ...common.resources import Resource
from ...model.tensors import replica_load_column, replica_load_total
from ...utils.numerics import fma_f32
from ..candidates import CandidateDeltas
from ..derived import over_capacity
from .base import Goal, fzero, neg_inf, pair_improvement


@dataclasses.dataclass(frozen=True)
class ResourceCapacityGoal(Goal):
    """Keep every alive broker's load for one resource under
    capacity × capacity_threshold."""

    resource: Resource = Resource.DISK

    def _limit(self, state, constraint):
        r = int(self.resource)
        return constraint.capacity_threshold[r] * state.capacity[:, r]

    def broker_violations(self, state, derived, constraint, aux):
        load = derived.broker_load[:, int(self.resource)]
        return torch.where(derived.alive,
                           over_capacity(state, constraint, self.resource,
                                         load),
                           fzero(load))

    def acceptance(self, state, derived, constraint, aux,
                   deltas: CandidateDeltas):
        r = int(self.resource)
        limit = self._limit(state, constraint)
        dst = deltas.dst_broker.long()
        dst_after = derived.broker_load[dst, r] \
            + deltas.pre_load("pre_dst_load", r) + deltas.load_delta[:, r]
        return dst_after <= limit[dst] + 1e-6

    def improvement(self, state, derived, constraint, aux, deltas):
        r = int(self.resource)
        limit = self._limit(state, constraint)

        def viol(value, idx):
            return torch.clamp(value - limit[idx], min=0.0)

        return pair_improvement(derived.broker_load[:, r], deltas,
                                deltas.load_delta[:, r], viol)

    def dest_score(self, state, derived, constraint, aux):
        # ``limit - load`` rounded once: the reference's fused loop
        # contracts the threshold product into a multiply-add (fma_f32).
        r = int(self.resource)
        headroom = fma_f32(constraint.capacity_threshold[r],
                           state.capacity[:, r], -derived.broker_load[:, r])
        return torch.where(derived.allowed_replica_move, headroom,
                           neg_inf(headroom))

    def replica_weight(self, state, derived, constraint, aux):
        return replica_load_column(state, int(self.resource))

    def swap_leg_acceptance(self, state, derived, constraint, aux, leg):
        return torch.ones(leg.valid.shape[0], dtype=torch.bool,
                          device=leg.valid.device)

    def swap_net_acceptance(self, state, derived, constraint, aux, net):
        r = int(self.resource)
        limit = self._limit(state, constraint)
        d = net.load_delta[:, r]
        load = derived.broker_load[:, r]
        src, dst = net.src_broker.long(), net.dst_broker.long()
        dst_ok = load[dst] + d <= limit[dst] + 1e-6
        src_ok = load[src] - d <= limit[src] + 1e-6
        return dst_ok & src_ok


@dataclasses.dataclass(frozen=True)
class ReplicaCapacityGoal(Goal):
    """Max replicas per alive broker."""

    def broker_violations(self, state, derived, constraint, aux):
        over = derived.broker_replicas - constraint.max_replicas_per_broker
        return torch.where(derived.alive,
                           torch.clamp(over, min=0).to(torch.float32),
                           fzero(derived.broker_load))

    def acceptance(self, state, derived, constraint, aux,
                   deltas: CandidateDeltas):
        dst_after = derived.broker_replicas[deltas.dst_broker.long()] \
            + deltas.pre0("pre_dst_count") + deltas.replica_delta
        return dst_after <= constraint.max_replicas_per_broker

    def improvement(self, state, derived, constraint, aux, deltas):
        cap = float(constraint.max_replicas_per_broker)

        def viol(value, idx):
            return torch.clamp(value - cap, min=0.0)

        return pair_improvement(
            derived.broker_replicas.to(torch.float32), deltas,
            deltas.replica_delta.to(torch.float32), viol)

    def dest_score(self, state, derived, constraint, aux):
        headroom = (constraint.max_replicas_per_broker
                    - derived.broker_replicas).to(torch.float32)
        return torch.where(derived.allowed_replica_move & (headroom > 0),
                           headroom, neg_inf(headroom))

    def replica_weight(self, state, derived, constraint, aux):
        return -replica_load_total(state)

    def swap_leg_acceptance(self, state, derived, constraint, aux, leg):
        return torch.ones(leg.valid.shape[0], dtype=torch.bool,
                          device=leg.valid.device)

"""Per-round derived state shared by every goal.

Port of ``cruise_control_tpu/analyzer/derived.py``: alive, new and
excluded masks, per-resource averages, and the balance and count bands.
"""

from __future__ import annotations

import dataclasses

import torch

from ..common.resources import Resource
from ..model.tensors import ClusterTensors, alive_mask, new_broker_mask
from ..utils.numerics import fma_f32, xla_sum
from .agg import compute_agg
from .constraint import BalancingConstraint


@dataclasses.dataclass(frozen=True)
class DerivedState:
    broker_load: torch.Tensor        # [B, R]
    broker_replicas: torch.Tensor    # [B] int32
    broker_leaders: torch.Tensor     # [B] int32
    pot_nw_out: torch.Tensor         # [B]
    alive: torch.Tensor              # [B] bool
    new_brokers: torch.Tensor        # [B] bool
    allowed_replica_move: torch.Tensor  # [B] bool
    allowed_leadership: torch.Tensor    # [B] bool
    avg_util: torch.Tensor           # [R] — Σload / Σcapacity over allowed brokers
    avg_replicas: torch.Tensor       # scalar f32 over alive brokers
    avg_leaders: torch.Tensor        # scalar f32
    movable_partition: torch.Tensor  # [P] bool


def compute_derived(state: ClusterTensors,
                    excluded_topic_mask: torch.Tensor | None = None,
                    excluded_replica_move_brokers: torch.Tensor | None = None,
                    excluded_leadership_brokers: torch.Tensor | None = None,
                    agg=None) -> DerivedState:
    """All per-broker aggregates + cluster averages in one pass. ``agg``
    (an :class:`~cruise_control_tpu_torch.analyzer.agg.AggCarry`) supplies
    the per-broker aggregates pre-computed, skipping the O(P·S) sums."""
    alive = alive_mask(state)
    if agg is None:
        # K1 without the topic plane: deterministic on the card, and the
        # reference's segment sums on the CPU.
        agg = compute_agg(state, 0)
    load, reps, leads, pot = (agg.broker_load, agg.broker_replicas,
                              agg.broker_leaders, agg.pot_nw_out)
    new_b = new_broker_mask(state)

    allowed_rm = alive if excluded_replica_move_brokers is None \
        else alive & ~excluded_replica_move_brokers
    allowed_ld = alive if excluded_leadership_brokers is None \
        else alive & ~excluded_leadership_brokers

    # avgUtilizationPercentage = Σ load / Σ capacity over brokers allowed
    # replica moves (ResourceDistributionGoal.java:245-248).
    cap_sum = torch.clamp(xla_sum(state.capacity * allowed_rm[:, None], 0),
                          min=1e-9)
    load_sum = xla_sum(load * allowed_rm[:, None], 0)
    avg_util = load_sum / cap_sum

    n_alive = torch.clamp(alive.sum(), min=1).to(torch.float32)
    avg_reps = (reps * alive).sum() / n_alive
    avg_leads = (leads * alive).sum() / n_alive

    if excluded_topic_mask is None:
        movable = state.partition_mask
    else:
        movable = state.partition_mask \
            & ~excluded_topic_mask[state.topic.long()]

    return DerivedState(
        broker_load=load, broker_replicas=reps, broker_leaders=leads,
        pot_nw_out=pot, alive=alive, new_brokers=new_b,
        allowed_replica_move=allowed_rm, allowed_leadership=allowed_ld,
        avg_util=avg_util, avg_replicas=avg_reps, avg_leaders=avg_leads,
        movable_partition=movable,
    )


def resource_limits(state: ClusterTensors, derived: DerivedState,
                    constraint: BalancingConstraint, resource: Resource,
                    for_detector: bool = False,
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lower[B], upper[B], capacity_limit[B]) absolute load limits per
    broker for one resource."""
    lo_f, up_f, cap = band_factors(state, derived, constraint, resource,
                                   for_detector)
    cap_limit = constraint.capacity_threshold[int(resource)] * cap
    return lo_f * cap, up_f * cap, cap_limit


def band_factors(state: ClusterTensors, derived: DerivedState,
                 constraint: BalancingConstraint, resource: Resource,
                 for_detector: bool = False,
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(avg·lower multiplier, avg·upper multiplier, capacity[B]): the
    band limits are factor × capacity."""
    r = int(resource)
    lo_mult, up_mult = constraint.balance_band(resource, for_detector)
    return (derived.avg_util[r] * lo_mult, derived.avg_util[r] * up_mult,
            state.capacity[:, r])


def band_violation(state: ClusterTensors, derived: DerivedState,
                   constraint: BalancingConstraint, resource: Resource,
                   value: torch.Tensor) -> torch.Tensor:
    """[B] distance of ``value`` outside its resource balance band,
    ``max(value - upper, 0) + max(lower - value, 0)``, with each
    difference rounded once as the reference's fused loop does
    (``fma_f32``)."""
    lo_f, up_f, cap = band_factors(state, derived, constraint, resource)
    return torch.clamp(fma_f32(-up_f, cap, value), min=0.0) \
        + torch.clamp(fma_f32(lo_f, cap, -value), min=0.0)


def over_capacity(state: ClusterTensors, constraint: BalancingConstraint,
                  resource: Resource, value: torch.Tensor) -> torch.Tensor:
    """[B] ``max(value - threshold · capacity, 0)``, the difference
    rounded once as the reference's fused loop does (``fma_f32``)."""
    r = int(resource)
    return torch.clamp(fma_f32(-constraint.capacity_threshold[r],
                               state.capacity[:, r], value), min=0.0)


def count_limits(avg: torch.Tensor, threshold: float,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(lower, upper) replica-count limits: floor(avg/t), ceil(avg*t)."""
    upper = torch.ceil(avg * threshold)
    lower = torch.floor(avg / threshold)
    return lower, upper

"""Goal interface of the batched solver.

Port of ``cruise_control_tpu/analyzer/goals/base.py``. A goal is a frozen
object carrying only static config; its methods are plain functions over
(state, derived, constraint, aux, deltas) evaluated for every candidate at
once. The reference's "every previously optimized goal must accept the
action" becomes an AND over each goal's ``acceptance`` mask.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ...model.tensors import ClusterTensors, replica_load_total
from ...utils.numerics import fma_f32, xla_sum
from ..candidates import CandidateDeltas
from ..constraint import BalancingConstraint
from ..derived import DerivedState


@dataclasses.dataclass(frozen=True)
class Goal:
    """Base goal. Subclasses override the evaluation methods."""

    name: str = "goal"
    is_hard: bool = False
    include_leadership: bool = False
    leadership_only: bool = False
    # Swap phase eligibility (ResourceDistributionGoal.java:421-430).
    supports_swap: bool = False
    # Acceptance/improvement depend only on the candidate's own partition:
    # the selection may take many moves per broker per round.
    independent_per_broker: bool = False
    # Source-limited goals that the bounded per-goal driver runs on the
    # widened grid at and above solver.wide.batch.min.brokers.
    prefers_wide_batches: bool = False
    # Count-distribution goals: total band violation is about twice the
    # moves still needed, so the bounded driver may size the round's move
    # budget and source width from it (chain.deficit_sized_config).
    count_based: bool = False

    def prepare_partial(self, state: ClusterTensors, num_topics: int) -> Any:
        """Per-round aux tensors additive over the partition axis."""
        return None

    def partial_from_agg(self, agg) -> Any:
        """This goal's prepare_partial result read from the aggregate
        carry, or None when the goal is not agg-backed."""
        return None

    def finalize_aux(self, partial: Any, state: ClusterTensors,
                     derived: DerivedState,
                     constraint: BalancingConstraint) -> Any:
        return partial

    def broker_violations(self, state, derived, constraint, aux) -> torch.Tensor:
        """[B] violation magnitude per broker (0 = satisfied)."""
        raise NotImplementedError

    def objective(self, state, derived, constraint, aux) -> torch.Tensor:
        """Scalar, lower is better. Default: total violation."""
        return xla_sum(self.broker_violations(state, derived, constraint,
                                              aux), 0)

    def acceptance(self, state, derived, constraint, aux,
                   deltas: CandidateDeltas) -> torch.Tensor:
        """[N] bool — does this (already-optimized) goal tolerate each
        candidate action?"""
        return torch.ones(deltas.valid.shape[0], dtype=torch.bool,
                          device=deltas.valid.device)

    def improvement(self, state, derived, constraint, aux,
                    deltas: CandidateDeltas) -> torch.Tensor:
        """[N] — decrease of this goal's objective (positive improves)."""
        raise NotImplementedError

    def swap_leg_acceptance(self, state, derived, constraint, aux,
                            leg: CandidateDeltas) -> torch.Tensor:
        return self.acceptance(state, derived, constraint, aux, leg)

    def swap_net_acceptance(self, state, derived, constraint, aux,
                            net: CandidateDeltas) -> torch.Tensor:
        return torch.ones(net.valid.shape[0], dtype=torch.bool,
                          device=net.valid.device)

    def swap_improvement(self, state, derived, constraint, aux,
                         fwd: CandidateDeltas, rev: CandidateDeltas,
                         net: CandidateDeltas) -> torch.Tensor:
        return self.improvement(state, derived, constraint, aux, net)

    def swap_dest_score(self, state, derived, constraint, aux) -> torch.Tensor:
        return self.dest_score(state, derived, constraint, aux)

    def swap_acceptance(self, state, derived, constraint, aux,
                        fwd: CandidateDeltas, rev: CandidateDeltas,
                        net: CandidateDeltas) -> torch.Tensor:
        return self.swap_leg_acceptance(state, derived, constraint, aux, fwd) \
            & self.swap_leg_acceptance(state, derived, constraint, aux, rev) \
            & self.swap_net_acceptance(state, derived, constraint, aux, net)

    def source_score(self, state, derived, constraint, aux) -> torch.Tensor:
        """[B] — >0 means the broker should shed."""
        return self.broker_violations(state, derived, constraint, aux)

    def dest_score(self, state, derived, constraint, aux) -> torch.Tensor:
        """[B] — destination attractiveness; -inf = ineligible."""
        raise NotImplementedError

    def replica_weight(self, state, derived, constraint, aux) -> torch.Tensor:
        """[P, S] — which replicas to move first."""
        return replica_load_total(state)

    def target_dests(self, state, derived, constraint, aux,
                     cand_p: torch.Tensor, cand_s: torch.Tensor,
                     src_valid: torch.Tensor,
                     ) -> "tuple[torch.Tensor, torch.Tensor] | None":
        """Optional constructive per-card destination (analyzer.fill), or
        None when the goal has no per-card destination rule."""
        return None


def neg_inf(like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("-inf"), dtype=torch.float32,
                      device=like.device)


def fzero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=like.device)


def pair_improvement(values: torch.Tensor, deltas: CandidateDeltas,
                     delta: torch.Tensor, viol_fn) -> torch.Tensor:
    """Improvement of Σ viol(broker) restricted to the touched (src, dst)
    pair. ``viol_fn(value, broker_idx)`` is the violation magnitude."""
    src, dst = deltas.src_broker.long(), deltas.dst_broker.long()
    before = viol_fn(values[src], src) + viol_fn(values[dst], dst)
    after = viol_fn(values[src] - delta, src) \
        + viol_fn(values[dst] + delta, dst)
    return torch.where(deltas.valid, before - after, neg_inf(values))


def donor_widened_shed(values: torch.Tensor, lower, upper,
                       derived: DerivedState, cap=None) -> torch.Tensor:
    """Per-broker shed pressure with donor widening
    (ResourceDistributionGoal.java:388 requireMoreLoad); masked to alive
    brokers. With ``cap`` the band is ``lower * cap`` to ``upper * cap``
    and each difference from it is rounded once, as the reference's fused
    loop contracts it into a multiply-add (``fma_f32``)."""
    eligible = derived.alive & derived.allowed_replica_move
    if cap is None:
        lower_abs = lower
        over, donor = values - upper, values - lower
    else:
        lower_abs = lower * cap
        over = fma_f32(-upper, cap, values)
        donor = fma_f32(-lower, cap, values)
    under_any = ((values < lower_abs) & eligible).any(dim=-1, keepdim=True)
    zero = fzero(values)
    over = torch.clamp(over, min=0.0)
    donor = torch.where(under_any, torch.clamp(donor, min=0.0), zero)
    return torch.where(derived.alive, over + donor, zero)


def new_broker_gate(derived: DerivedState,
                    deltas: CandidateDeltas) -> torch.Tensor:
    """When NEW brokers exist, only they may receive replicas."""
    has_new = derived.new_brokers.any()
    dst_is_new = derived.new_brokers[deltas.dst_broker.long()]
    is_move = deltas.replica_delta > 0
    return torch.where(has_new & is_move, dst_is_new, True)

"""Soft distribution goals of the default chain.

Port of ``ResourceDistributionGoal``, ``CountDistributionGoal``,
``TopicReplicaDistributionGoal``, ``PotentialNwOutGoal`` and
``LeaderBytesInDistributionGoal`` from
``cruise_control_tpu/analyzer/goals/distribution.py``
(ResourceDistributionGoal.java, ReplicaDistributionAbstractGoal.java and
its subclasses, PotentialNwOutGoal.java,
LeaderBytesInDistributionGoal.java).
"""

from __future__ import annotations

import dataclasses

import torch

from ...common.resources import Resource
from ...model.tensors import (
    broker_segments, is_leader_slot, replica_exists,
    replica_load_column, replica_load_total, topic_broker_replica_counts,
)
from ...utils.numerics import fma_f32, xla_sum
from ..agg import compute_agg
from ..candidates import CandidateDeltas
from ..derived import (
    band_factors, band_violation, count_limits, over_capacity,
    resource_limits,
)
from ..fill import (
    best_fit_dests, deficit_fill_dests, exclusive_rank, rank_within_group,
)
from .base import (
    Goal, donor_widened_shed, fzero, neg_inf, new_broker_gate,
    pair_improvement,
)


def _band_viol(value, lower, upper):
    return torch.clamp(value - upper, min=0.0) \
        + torch.clamp(lower - value, min=0.0)


def _dest_eligible(derived):
    """Destination eligibility (new-broker gating per
    ResourceDistributionGoal.rebalanceByMovingLoadIn:444-447)."""
    has_new = derived.new_brokers.any()
    return torch.where(has_new, derived.new_brokers,
                       derived.allowed_replica_move) & derived.alive


def _int_deficit_headroom(counts, lower, upper):
    """Integer (deficit, remaining-headroom) planes from a float count
    plane and band."""
    h_int = torch.floor(torch.clamp(upper - counts, min=0.0) + 1e-6)
    d_int = torch.minimum(h_int, torch.ceil(
        torch.clamp(lower - counts, min=0.0) - 1e-6))
    d_pos = torch.clamp(d_int, min=0.0)
    return d_pos, h_int - d_pos


def _var_diff(gap, d):
    """gap² - (gap - 2d)², the first product fused into the subtraction as
    the reference's loop contracts it (fma_f32); exact on counts. The
    variance gain is 1e-6 times it."""
    rest = gap - 2 * d
    return fma_f32(gap, gap, -(rest * rest))


def _var_gain(gap, d):
    return _var_diff(gap, d) * 1e-6


@dataclasses.dataclass(frozen=True)
class ResourceDistributionGoal(Goal):
    """Per-resource balance band around the cluster-average utilization."""

    resource: Resource = Resource.DISK

    def _limits(self, state, derived, constraint):
        return resource_limits(state, derived, constraint, self.resource)

    def _low_util(self, derived, constraint):
        r = int(self.resource)
        return derived.avg_util[r] <= constraint.low_utilization_threshold[r]

    def broker_violations(self, state, derived, constraint, aux):
        viol = band_violation(state, derived, constraint, self.resource,
                              derived.broker_load[:, int(self.resource)])
        zero = fzero(viol)
        viol = torch.where(derived.alive & derived.allowed_replica_move,
                           viol, zero)
        return torch.where(self._low_util(derived, constraint), zero, viol)

    def acceptance(self, state, derived, constraint, aux,
                   deltas: CandidateDeltas):
        r = int(self.resource)
        lower, upper, _cap = self._limits(state, derived, constraint)
        load = derived.broker_load[:, r]
        d = deltas.load_delta[:, r]
        src, dst = deltas.src_broker.long(), deltas.dst_broker.long()
        eps = 1e-6
        ls = load[src] - deltas.pre_load("pre_src_load", r)
        ld = load[dst] + deltas.pre_load("pre_dst_load", r)
        # Branch choice on the UNSHIFTED loads (the pre terms may
        # overcount); band checks inside each branch on the shifted ones.
        src_above_lower = load[src] >= lower[src] - eps
        dst_under_upper = load[dst] <= upper[dst] + eps
        stays_in_band = (ld + d <= upper[dst] + eps) \
            & (ls - d >= lower[src] - eps)
        cap_src = torch.clamp(state.capacity[src, r], min=1e-9)
        cap_dst = torch.clamp(state.capacity[dst, r], min=1e-9)
        no_worse = (ld + d) / cap_dst <= ls / cap_src + eps
        accept = torch.where(src_above_lower & dst_under_upper,
                             stays_in_band, no_worse)
        return accept | (d <= eps) | self._low_util(derived, constraint) \
            | (~derived.alive[src])

    def improvement(self, state, derived, constraint, aux, deltas):
        r = int(self.resource)
        lower, upper, _cap = self._limits(state, derived, constraint)

        def viol(value, idx):
            return _band_viol(value, lower[idx], upper[idx])

        imp = pair_improvement(derived.broker_load[:, r], deltas,
                               deltas.load_delta[:, r], viol)
        load = derived.broker_load[:, r]
        d = deltas.load_delta[:, r]
        src, dst = deltas.src_broker.long(), deltas.dst_broker.long()
        var_gain = _var_gain(load[src] - load[dst], d)
        return torch.where(deltas.valid,
                           imp + torch.where(imp > 0, var_gain, fzero(imp)),
                           neg_inf(imp)) * new_broker_gate(derived, deltas)

    # The per-broker scores below round each band difference (and the
    # dest score's bonus sum) once: the reference's per-broker loops
    # contract them into multiply-adds (fma_f32). Its per-candidate
    # improvement and acceptance read the band from memory, unfused.

    def source_score(self, state, derived, constraint, aux):
        r = int(self.resource)
        lo_f, up_f, cap = band_factors(state, derived, constraint,
                                       self.resource)
        shed = donor_widened_shed(derived.broker_load[:, r], lo_f, up_f,
                                  derived, cap=cap)
        return torch.where(self._low_util(derived, constraint), fzero(shed),
                           shed)

    def dest_score(self, state, derived, constraint, aux):
        r = int(self.resource)
        lo_f, up_f, cap = band_factors(state, derived, constraint,
                                       self.resource)
        load = derived.broker_load[:, r]
        headroom = fma_f32(up_f, cap, -load)
        under = torch.clamp(fma_f32(lo_f, cap, -load), min=0.0)
        has_new = derived.new_brokers.any()
        eligible = torch.where(has_new, derived.new_brokers,
                               derived.allowed_replica_move)
        return torch.where(eligible & (headroom > 0),
                           fma_f32(under, 10.0, headroom),
                           neg_inf(headroom))

    def replica_weight(self, state, derived, constraint, aux):
        # Fit priority: replicas that fit some destination's band gap AND
        # their own broker's surplus above its lower band rank first.
        r = int(self.resource)
        size = replica_load_column(state, r)
        lo_f, up_f, cap = band_factors(state, derived, constraint,
                                       self.resource)
        load = derived.broker_load[:, r]
        headroom = fma_f32(up_f, cap, -load)
        elig = _dest_eligible(derived) & (headroom > 0)
        max_gap = torch.where(elig, headroom, fzero(headroom)).max()
        src_room = torch.cat([fma_f32(-lo_f, cap, load), load.new_zeros(1)])[
            broker_segments(state)]
        peak = size.max() + 1.0
        fits = (size <= max_gap) & (size <= src_room) & (size > 0)
        return torch.where(fits, peak + size, size)

    def target_dests(self, state, derived, constraint, aux,
                     cand_p, cand_s, src_valid):
        r = int(self.resource)
        lower, upper, _cap = self._limits(state, derived, constraint)
        headroom = upper - derived.broker_load[:, r]
        size = replica_load_column(state, r)[cand_p.long(), cand_s.long()]
        rank = exclusive_rank(src_valid)
        dst, ok = best_fit_dests(size, rank, headroom,
                                 _dest_eligible(derived) & (headroom > 0))
        return dst, ok & src_valid & ~self._low_util(derived, constraint)

    def swap_leg_acceptance(self, state, derived, constraint, aux, leg):
        return torch.ones(leg.valid.shape[0], dtype=torch.bool,
                          device=leg.valid.device)

    def swap_net_acceptance(self, state, derived, constraint, aux, net):
        r = int(self.resource)
        lower, upper, _cap = self._limits(state, derived, constraint)
        load = derived.broker_load[:, r]
        d = net.load_delta[:, r]
        src, dst = net.src_broker.long(), net.dst_broker.long()

        def viol(value, idx):
            return _band_viol(value, lower[idx], upper[idx])

        before = viol(load[src], src) + viol(load[dst], dst)
        after = viol(load[src] - d, src) + viol(load[dst] + d, dst)
        return (after <= before + 1e-6) | self._low_util(derived, constraint)


@dataclasses.dataclass(frozen=True)
class CountDistributionGoal(Goal):
    """Replica- / leader-count balance."""

    leaders: bool = False
    count_based: bool = True

    def _counts(self, derived):
        return (derived.broker_leaders if self.leaders
                else derived.broker_replicas).to(torch.float32)

    def _limits(self, derived, constraint):
        if self.leaders:
            return count_limits(derived.avg_leaders,
                                constraint.leader_replica_balance_threshold)
        return count_limits(derived.avg_replicas,
                            constraint.replica_balance_threshold)

    def _delta(self, deltas):
        return (deltas.leader_delta if self.leaders
                else deltas.replica_delta).to(torch.float32)

    def broker_violations(self, state, derived, constraint, aux):
        lower, upper = self._limits(derived, constraint)
        viol = _band_viol(self._counts(derived), lower, upper)
        return torch.where(derived.alive, viol, fzero(viol))

    def acceptance(self, state, derived, constraint, aux,
                   deltas: CandidateDeltas):
        lower, upper = self._limits(derived, constraint)
        counts = self._counts(derived)
        d = self._delta(deltas)
        pre_dst = deltas.pre0("pre_dst_leaders" if self.leaders
                              else "pre_dst_count")
        pre_src = deltas.pre0("pre_src_leaders" if self.leaders
                              else "pre_src_count")
        src, dst = deltas.src_broker.long(), deltas.dst_broker.long()
        dst_ok = counts[dst] + pre_dst + d <= upper + 1e-6
        src_ok = counts[src] - pre_src - d >= lower - 1e-6
        return (d == 0) | (dst_ok & src_ok) | (~derived.alive[src])

    def improvement(self, state, derived, constraint, aux, deltas):
        lower, upper = self._limits(derived, constraint)

        def viol(value, idx):
            return _band_viol(value, lower, upper)

        counts = self._counts(derived)
        d = self._delta(deltas)
        imp = pair_improvement(counts, deltas, d, viol)
        src, dst = deltas.src_broker.long(), deltas.dst_broker.long()
        var_gain = _var_gain(counts[src] - counts[dst], d)
        return torch.where(deltas.valid,
                           imp + torch.where(imp > 0, var_gain, fzero(imp)),
                           neg_inf(imp)) * new_broker_gate(derived, deltas)

    def source_score(self, state, derived, constraint, aux):
        lower, upper = self._limits(derived, constraint)
        return donor_widened_shed(self._counts(derived), lower, upper,
                                  derived)

    def dest_score(self, state, derived, constraint, aux):
        lower, upper = self._limits(derived, constraint)
        counts = self._counts(derived)
        headroom = upper - counts
        under_bonus = torch.clamp(lower - counts, min=0.0) * 10.0
        has_new = derived.new_brokers.any()
        eligible = torch.where(has_new, derived.new_brokers,
                               derived.allowed_replica_move)
        return torch.where(eligible & (headroom > 0), headroom + under_bonus,
                           neg_inf(headroom))

    def replica_weight(self, state, derived, constraint, aux):
        w = -replica_load_total(state)
        if self.leaders:
            return torch.where(is_leader_slot(state), w, neg_inf(w))
        return w

    def target_dests(self, state, derived, constraint, aux,
                     cand_p, cand_s, src_valid):
        lower, upper = self._limits(derived, constraint)
        counts = self._counts(derived)
        deficit, headroom = _int_deficit_headroom(counts[None, :], lower,
                                                  upper)
        rank = exclusive_rank(src_valid)
        dst, ok = deficit_fill_dests(torch.zeros_like(cand_p), rank, deficit,
                                     headroom, _dest_eligible(derived))
        return dst, ok & src_valid

    def swap_leg_acceptance(self, state, derived, constraint, aux, leg):
        return torch.ones(leg.valid.shape[0], dtype=torch.bool,
                          device=leg.valid.device)

    def swap_net_acceptance(self, state, derived, constraint, aux, net):
        lower, upper = self._limits(derived, constraint)
        counts = self._counts(derived)
        d = self._delta(net)
        src, dst = net.src_broker.long(), net.dst_broker.long()
        before = _band_viol(counts[src], lower, upper) \
            + _band_viol(counts[dst], lower, upper)
        after = _band_viol(counts[src] - d, lower, upper) \
            + _band_viol(counts[dst] + d, lower, upper)
        return after <= before + 1e-6


@dataclasses.dataclass(frozen=True)
class TopicReplicaDistributionGoal(Goal):
    """Per-topic replica balance across brokers over a [T, B] count plane."""

    prefers_wide_batches: bool = True
    count_based: bool = True

    def prepare_partial(self, state, num_topics):
        return {"counts": topic_broker_replica_counts(state, num_topics)
                .to(torch.float32)}

    def partial_from_agg(self, agg):
        return {"counts": agg.topic_counts.to(torch.float32)}

    def finalize_aux(self, partial, state, derived, constraint):
        counts = partial["counts"]
        n_alive = torch.clamp(derived.alive.sum(), min=1).to(torch.float32)
        avg = xla_sum(counts * derived.alive[None, :], 1) / n_alive
        upper = torch.ceil(avg * constraint.topic_replica_balance_threshold)
        lower = torch.floor(avg / constraint.topic_replica_balance_threshold)
        return {"counts": counts, "upper": upper, "lower": lower}

    def broker_violations(self, state, derived, constraint, aux):
        viol = _band_viol(aux["counts"], aux["lower"][:, None],
                          aux["upper"][:, None])
        return torch.where(derived.alive, xla_sum(viol, 0), fzero(viol))

    def acceptance(self, state, derived, constraint, aux,
                   deltas: CandidateDeltas):
        t = deltas.topic.long()
        src, dst = deltas.src_broker.long(), deltas.dst_broker.long()
        d = deltas.replica_delta.to(torch.float32)
        dst_cnt = aux["counts"][t, dst] + deltas.pre0("pre_dst_topic_count")
        src_cnt = aux["counts"][t, src] - deltas.pre0("pre_src_topic_count")
        dst_ok = dst_cnt + d <= aux["upper"][t] + 1e-6
        src_ok = src_cnt - d >= aux["lower"][t] - 1e-6
        return (d == 0) | (dst_ok & src_ok) | (~derived.alive[src])

    def improvement(self, state, derived, constraint, aux, deltas):
        t = deltas.topic.long()
        src, dst = deltas.src_broker.long(), deltas.dst_broker.long()
        d = deltas.replica_delta.to(torch.float32)
        up, lo = aux["upper"][t], aux["lower"][t]
        src_cnt = aux["counts"][t, src]
        dst_cnt = aux["counts"][t, dst]
        before = _band_viol(src_cnt, lo, up) + _band_viol(dst_cnt, lo, up)
        after = _band_viol(src_cnt - d, lo, up) \
            + _band_viol(dst_cnt + d, lo, up)
        imp = before - after
        var_gain = _var_gain(src_cnt - dst_cnt, d)
        return torch.where(deltas.valid,
                           imp + torch.where(imp > 0, var_gain, fzero(imp)),
                           neg_inf(imp)) * new_broker_gate(derived, deltas)

    def _over_donor(self, derived, aux):
        return donor_widened_shed(aux["counts"], aux["lower"][:, None],
                                  aux["upper"][:, None], derived)

    def source_score(self, state, derived, constraint, aux):
        score = xla_sum(self._over_donor(derived, aux), 0)
        return torch.where(derived.alive, score, fzero(score))

    def dest_score(self, state, derived, constraint, aux):
        headroom = xla_sum(torch.clamp(aux["upper"][:, None] - aux["counts"],
                                       min=0.0), 0)
        has_new = derived.new_brokers.any()
        eligible = torch.where(has_new, derived.new_brokers,
                               derived.allowed_replica_move)
        return torch.where(eligible, headroom, neg_inf(headroom))

    def replica_weight(self, state, derived, constraint, aux):
        b = state.num_brokers
        t = state.topic[:, None].long().expand(state.assignment.shape)
        slot_b = torch.clamp(state.assignment, 0, b - 1).long()
        w = self._over_donor(derived, aux)[t, slot_b]
        return torch.where(replica_exists(state), w, neg_inf(w))

    def target_dests(self, state, derived, constraint, aux,
                     cand_p, cand_s, src_valid):
        t = state.topic[cand_p.long()]
        deficit, headroom = _int_deficit_headroom(
            aux["counts"], aux["lower"][:, None], aux["upper"][:, None])
        rank = rank_within_group(t, src_valid)
        dst, ok = deficit_fill_dests(t, rank, deficit, headroom,
                                     _dest_eligible(derived))
        return dst, ok & src_valid


@dataclasses.dataclass(frozen=True)
class PotentialNwOutGoal(Goal):
    """Keep potential NW-out (all replicas promoted) under the outbound
    capacity limit."""

    def _limit(self, state, constraint):
        r = int(Resource.NW_OUT)
        return constraint.capacity_threshold[r] * state.capacity[:, r]

    def broker_violations(self, state, derived, constraint, aux):
        return torch.where(derived.alive,
                           over_capacity(state, constraint, Resource.NW_OUT,
                                         derived.pot_nw_out),
                           fzero(derived.pot_nw_out))

    def _pot_delta(self, state, deltas):
        nw = state.leader_load[deltas.partition.long(), int(Resource.NW_OUT)]
        return torch.where(deltas.replica_delta > 0, nw, fzero(nw))

    def acceptance(self, state, derived, constraint, aux,
                   deltas: CandidateDeltas):
        limit = self._limit(state, constraint)
        d = self._pot_delta(state, deltas)
        src, dst = deltas.src_broker.long(), deltas.dst_broker.long()
        dst_after = derived.pot_nw_out[dst] + deltas.pre0("pre_dst_pot") + d
        src_viol = derived.pot_nw_out[src] > limit[src]
        return (dst_after <= limit[dst] + 1e-6) | (d <= 0) | src_viol

    def improvement(self, state, derived, constraint, aux, deltas):
        limit = self._limit(state, constraint)

        def viol(value, idx):
            return torch.clamp(value - limit[idx], min=0.0)

        return pair_improvement(derived.pot_nw_out, deltas,
                                self._pot_delta(state, deltas), viol)

    def dest_score(self, state, derived, constraint, aux):
        headroom = self._limit(state, constraint) - derived.pot_nw_out
        return torch.where(derived.allowed_replica_move & (headroom > 0),
                           headroom, neg_inf(headroom))

    def replica_weight(self, state, derived, constraint, aux):
        nw = state.leader_load[:, int(Resource.NW_OUT)]
        return torch.where(replica_exists(state), nw[:, None], neg_inf(nw))


@dataclasses.dataclass(frozen=True)
class LeaderBytesInDistributionGoal(Goal):
    """Balance leader bytes-in across brokers via leadership moves."""

    def prepare_partial(self, state, num_topics):
        return {"lbi": compute_agg(state, 0).lbi}

    def partial_from_agg(self, agg):
        return {"lbi": agg.lbi}

    def finalize_aux(self, partial, state, derived, constraint):
        lbi = partial["lbi"]
        n = torch.clamp(derived.allowed_leadership.sum(), min=1).to(
            torch.float32)
        avg = xla_sum(lbi * derived.allowed_leadership, 0) / n
        return {"lbi": lbi, "avg": avg}

    def _upper(self, aux, constraint):
        t = constraint.resource_balance_threshold[int(Resource.NW_IN)]
        return aux["avg"] * t

    def broker_violations(self, state, derived, constraint, aux):
        upper = self._upper(aux, constraint)
        return torch.where(derived.alive,
                           torch.clamp(aux["lbi"] - upper, min=0.0),
                           fzero(upper))

    def _lbi_delta(self, state, deltas):
        nw_in = state.leader_load[deltas.partition.long(),
                                  int(Resource.NW_IN)]
        return torch.where(deltas.leader_delta > 0, nw_in, fzero(nw_in))

    def acceptance(self, state, derived, constraint, aux,
                   deltas: CandidateDeltas):
        upper = self._upper(aux, constraint)
        d = self._lbi_delta(state, deltas)
        src, dst = deltas.src_broker.long(), deltas.dst_broker.long()
        dst_after = aux["lbi"][dst] + deltas.pre0("pre_dst_lbi") + d
        src_over = aux["lbi"][src] > upper
        return (dst_after <= upper + 1e-6) | (d <= 0) | src_over

    def improvement(self, state, derived, constraint, aux, deltas):
        upper = self._upper(aux, constraint)

        def viol(value, idx):
            return torch.clamp(value - upper, min=0.0)

        d = self._lbi_delta(state, deltas)
        imp = pair_improvement(aux["lbi"], deltas, d, viol)
        lbi = aux["lbi"]
        src, dst = deltas.src_broker.long(), deltas.dst_broker.long()
        # The gain's scaling is fused into the sum here (no select between
        # them, unlike the other goals).
        with_gain = fma_f32(_var_diff(lbi[src] - lbi[dst], d), 1e-6, imp)
        return torch.where(deltas.valid, with_gain, neg_inf(imp))

    def dest_score(self, state, derived, constraint, aux):
        headroom = self._upper(aux, constraint) - aux["lbi"]
        return torch.where(derived.allowed_leadership, headroom,
                           neg_inf(headroom))

    def replica_weight(self, state, derived, constraint, aux):
        nw_in = state.leader_load[:, int(Resource.NW_IN)]
        return torch.where(is_leader_slot(state), nw_in[:, None],
                           neg_inf(nw_in))

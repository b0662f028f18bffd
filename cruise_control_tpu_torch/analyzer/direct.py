"""The direct-assignment transport for the count-distribution goals.

Port of the single-device parts of ``cruise_control_tpu/analyzer/direct.py``.
A count goal's fixed point is known in closed form (its per-broker or
per-(topic, broker) band), so its bulk work is a transport problem —
surplus replicas to deficit slots — solved in a few sweeps instead of
hundreds of greedy rounds; the greedy polish that follows places what the
feasibility masks vetoed. One sweep:

1. the goal's count plane and band give integral (surplus, deficit,
   headroom) planes from fractional targets, systematically rounded by a
   crc32-seeded splitmix uniform per (group, plane, sweep) (KD3);
2. one stable sort of the replica axis by (cell, weight), cell = (group,
   source broker), ranks each replica in its cell; the ``surplus[cell]``
   lightest movable ones are the movers (KD1, KD2);
3. each mover's rank in its group, rotated by the sweep, falls in the
   group's [deficit | headroom] profile at its destination (KD2, KD4);
4. structural feasibility (sibling, rack, leadership, same-sweep sibling
   dedupe) in plain PyTorch, then the prior goals' caps and floors,
   judged jointly in destination- and source-sorted frames (KD1 and KD2
   with its guard verdicts);
5. the survivors land in one scatter.

The leader-count goal transports LEADERSHIP instead (``_leadership_sweep``:
each surplus leader's menu is its partition's own siblings).

The sweep loop (``_direct_rounds_driver``) runs on the host: each sweep is
fixed-shape device work with no host synchronisation inside it, and the
loop reads (applied, planned) once a sweep to test its exit — at most
``max_sweeps`` reads a goal, counted in ``chain.LOOP_STATS`` as
``direct_reads``. The reference's rank-stride layout (its partition-sharded
mesh) and its megabatch twins are not ported; every rank here is the
stride-1 single-device one. PyTorch has no buffer donation, so the
reference's donated arm (``direct_transport_rounds_donated``) is the plain
call: ``run_direct_pass`` records every pass as not donated.

On the card every sort, segmented scan, plan and fill search of a sweep is
one of KD1-KD4 (``direct_kernels``, ``fill.direct_fill_dests``); on the CPU
their twins run, which the tests hold to the JAX package bit for bit. The
reference's helpers live there under these names: ``_hash_uniform``,
``_round_systematic`` and ``_surplus_deficit`` are ``hash_uniform``,
``round_systematic`` and ``surplus_deficit_plain`` (KD3's twin, the plan
planes of ``direct_plan``); ``_segment_exclusive`` is ``segment_scan``
(KD2; twin ``segment_exclusive_plain``), whose int mode on ones is
``_segment_rank``; ``_segment_starts`` is where that rank is 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..common.resources import Resource
from ..model.tensors import (
    ClusterTensors, is_leader_slot, replica_load_total,
    topic_broker_replica_counts,
)
from ..utils.numerics import xla_sum
from .constraint import BalancingConstraint
from .derived import compute_derived, count_limits, resource_limits
from .direct_kernels import (
    SPARSE_ROUNDING_SEED, Check, direct_plan, segment_scan, sort_pairs,
    sparse_rounding_seed,
)
from .fill import direct_fill_dests
from .goals.base import Goal
from .goals.capacity import ReplicaCapacityGoal, ResourceCapacityGoal
from .goals.distribution import (
    CountDistributionGoal, PotentialNwOutGoal, ResourceDistributionGoal,
    TopicReplicaDistributionGoal,
)
from .goals.rack import RackAwareGoal
from .search import ExclusionMasks, goal_aux

_EPS = 1e-6
_F32, _I32 = torch.float32, torch.int32


@dataclasses.dataclass(frozen=True)
class DirectGuards:
    """The prior-goal constraints the plan must respect, one flag or tuple
    per constraint family the feasibility pass models."""

    rack: bool = False              # strict sibling-rack exclusion
    replica_cap: bool = False       # ReplicaCapacityGoal hard cap
    replica_band: bool = False      # per-broker replica-count band
    leader_band: bool = False       # per-broker leader-count band
    topic_band: bool = False        # per-(topic, broker) count band
    resources: tuple[int, ...] = ()      # distribution bands (upper+lower)
    cap_resources: tuple[int, ...] = ()  # hard capacity thresholds
    pot_nw_out: bool = False        # potential NW-out limit


def _guards_for(goals: tuple[Goal, ...], index: int) -> DirectGuards:
    priors = goals[:index]
    return DirectGuards(
        rack=any(isinstance(g, RackAwareGoal) for g in priors),
        replica_cap=any(isinstance(g, ReplicaCapacityGoal) for g in priors),
        replica_band=any(isinstance(g, CountDistributionGoal)
                         and not g.leaders for g in priors),
        leader_band=any(isinstance(g, CountDistributionGoal)
                        and g.leaders for g in priors),
        topic_band=any(isinstance(g, TopicReplicaDistributionGoal)
                       for g in priors),
        resources=tuple(sorted({int(g.resource) for g in priors
                                if isinstance(g, ResourceDistributionGoal)})),
        cap_resources=tuple(sorted({int(g.resource) for g in priors
                                    if isinstance(g, ResourceCapacityGoal)})),
        pot_nw_out=any(isinstance(g, PotentialNwOutGoal) for g in priors))


def direct_eligible(goals, index: int) -> bool:
    """True when ``goals[index]`` has a transport formulation and every
    prior goal's acceptance is one the guards model; otherwise the caller
    keeps the greedy path."""
    goal = goals[index]
    if not getattr(goal, "supports_direct", False):
        return False
    recognized = (RackAwareGoal, ReplicaCapacityGoal, ResourceCapacityGoal,
                  CountDistributionGoal, TopicReplicaDistributionGoal,
                  PotentialNwOutGoal, ResourceDistributionGoal)
    return all(isinstance(g, recognized) for g in goals[:index])


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------

def _ones(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=_I32, device=device)


def _pad(x: torch.Tensor, fill: float) -> torch.Tensor:
    """``x`` [K] f32 with one more entry, ``fill``: the sentinel key's."""
    return torch.cat([x.to(_F32), torch.full((1,), fill, dtype=_F32,
                                             device=x.device)])


# ---------------------------------------------------------------------------
# Prior-goal guards in sorted frames
# ---------------------------------------------------------------------------

def _load_checks(state, derived, constraint, guards: DirectGuards,
                 floors: bool) -> list[Check]:
    """The per-resource guards of a load scan: upper bands and capacity
    thresholds at the destination (``_dst_load_caps``), lower bands at the
    source (``_src_load_floors``)."""
    checks = []
    # One padded load column a resource, shared by its band and capacity
    # checks: KD2 judges checks on the same table and column as one.
    loads = {}
    for r in guards.resources:
        lo_r, up_r, _c = resource_limits(state, derived, constraint,
                                         Resource(r))
        load = loads.setdefault(r, _pad(derived.broker_load[:, r], 0.0))
        if floors:
            checks.append(Check(limit=_pad(lo_r, float("-inf")), base=load,
                                column=r, own_column=r, floor=True))
        else:
            checks.append(Check(limit=_pad(up_r, float("inf")), base=load,
                                column=r, own_column=r))
    if not floors:
        for r in guards.cap_resources:
            limit = constraint.capacity_threshold[r] * state.capacity[:, r]
            checks.append(Check(limit=_pad(limit, float("inf")),
                                base=loads.setdefault(r, _pad(
                                    derived.broker_load[:, r], 0.0)),
                                column=r, own_column=r))
    return checks


def _load_verdict(keys, load_vec, perm, state, derived, constraint,
                  guards: DirectGuards, floors: bool):
    """[N] bool at original positions: every load guard of the frame
    holds for the element's cumulative in- or outflow (None: no guard)."""
    checks = _load_checks(state, derived, constraint, guards, floors)
    if not checks:
        return None
    return segment_scan(keys, load_vec, checks, perm)[1]


# ---------------------------------------------------------------------------
# The sweeps
# ---------------------------------------------------------------------------

def _plan(goal, state, constraint, num_topics, masks, sweep, margin_frac,
          seed, elig_for_leadership: bool):
    """The sweep's derived state, the goal's transport formulation, the
    destination-eligible brokers and KD3's plan."""
    derived = compute_derived(state, masks.excluded_topics,
                              masks.excluded_replica_move_brokers,
                              masks.excluded_leadership_brokers)
    aux = goal_aux(goal, state, derived, constraint, num_topics)
    counts, lower, upper, group, movable = goal.direct_spec(
        state, derived, constraint, aux, num_topics)
    alive = derived.alive
    if elig_for_leadership:
        elig = derived.allowed_leadership & alive
    else:
        has_new = derived.new_brokers.any()
        elig = torch.where(has_new, derived.new_brokers,
                           derived.allowed_replica_move) & alive
    cnt = counts.to(_F32)
    plan = direct_plan(cnt, lower.contiguous(), upper.contiguous(), alive,
                       elig, sweep, margin_frac, seed)
    return derived, counts, group, movable, elig, plan


def _src_floor_filter(mv, state, derived, constraint, guards, src_plane,
                      own_of) -> torch.Tensor:
    """Movers whose departure alone would cross a prior resource goal's
    lower band at the source can reach no destination: filtered before
    ranking (``own_of(r)`` is each slot's outbound load of resource r)."""
    for r in guards.resources:
        lo_r, _up_r, _c = resource_limits(state, derived, constraint,
                                          Resource(r))
        load_pad = _pad(derived.broker_load[:, r], 0.0)
        lo_pad = _pad(lo_r, float("-inf"))
        mv = mv & (load_pad[src_plane] - own_of(r)
                   >= lo_pad[src_plane] - _EPS)
    return mv


def _leadership_sweep(state: ClusterTensors, goals: tuple[Goal, ...],
                      index: int, constraint: BalancingConstraint,
                      num_topics: int, masks: ExclusionMasks, sweep: int = 0,
                      margin_frac: float = 0.25,
                      seed: int = SPARSE_ROUNDING_SEED,
                      ) -> tuple[ClusterTensors, torch.Tensor, torch.Tensor]:
    """Transport sweep of the leader-count goal by leadership transfers:
    each surplus leader's destination menu is its partition's own sibling
    replicas; the best sibling with leader-band room wins (deficits before
    headroom, ties to the lowest slot), joint intake capped per
    destination, the resource guards judged on the leadership's load
    shift (leader_load − follower_load). Returns (new_state, applied,
    planned) as 0-dim int32 tensors on the state's device."""
    goal = goals[index]
    guards = _guards_for(goals, index)
    derived, _counts, _group, movable, lead_elig, plan = _plan(
        goal, state, constraint, num_topics, masks, sweep, margin_frac, seed,
        elig_for_leadership=True)
    surplus, defi, headr = plan[:3]
    dev = state.device
    p, s = state.assignment.shape
    b = state.num_brokers
    n = p * s
    alive = derived.alive
    room = (defi + headr)[0]                                       # [B]

    alive_pad = torch.cat([alive, torch.zeros(1, dtype=torch.bool,
                                              device=dev)])
    src_plane = torch.where(state.assignment >= 0, state.assignment,
                            b).long()
    mv = movable & derived.movable_partition[:, None] & alive_pad[src_plane]
    if guards.resources:
        mv = _src_floor_filter(
            mv, state, derived, constraint, guards, src_plane,
            lambda r: torch.clamp(state.leader_load[:, r]
                                  - state.follower_load[:, r],
                                  min=0.0)[:, None])
    cell = torch.where(mv, src_plane, b).to(_I32)
    weight = replica_load_total(state)
    sc, si = sort_pairs(cell.reshape(-1), b, weight.reshape(-1))
    rank_cell = segment_scan(sc, _ones(n, dev))[0]
    sur_pad = _pad(surplus[0], 0.0)
    mover = rank_cell.to(_F32) < sur_pad[sc.long()]

    si_l = si.long()
    p_m = si_l // s
    s_m = si_l % s
    src = torch.clamp((sc % (b + 1)).long(), max=b - 1)
    assign_p = state.assignment[p_m]                               # [N, S]
    not_me = torch.arange(s, device=dev)[None, :] != s_m[:, None]
    sib_b = torch.clamp(assign_p, 0, b - 1).long()
    lead_elig_sib = lead_elig[sib_b] & (assign_p >= 0) & not_me
    sib_room = torch.where(lead_elig_sib, room[sib_b],
                           torch.full((), -1.0, device=dev))
    sib_score = torch.where(lead_elig_sib,
                            defi[0][sib_b] * 1e6 + headr[0][sib_b],
                            torch.full((), float("-inf"), device=dev))
    best_slot = torch.argmax(sib_score, dim=1)
    dst = sib_b.gather(1, best_slot[:, None])[:, 0]
    ok = mover & (sib_room.gather(1, best_slot[:, None])[:, 0] >= 1.0)
    ok = ok & (dst != src)

    sel = ok
    lead_vec = torch.clamp(state.leader_load[p_m] - state.follower_load[p_m],
                           min=0.0)
    # Joint intake per destination and the prior resource bands, in one
    # destination-sorted frame.
    dkey = torch.where(sel, dst, b).to(_I32)
    ds, d_i = sort_pairs(dkey, b)
    sel_d = sel[d_i.long()]
    one_d = sel_d.to(_F32)
    room_cap = _pad(room, float("inf"))
    okd = segment_scan(ds, one_d, [Check(limit=room_cap)], d_i)[1]
    sel = sel & okd
    okd_load = _load_verdict(ds, lead_vec[d_i.long()] * sel_d[:, None], d_i,
                             state, derived, constraint, guards,
                             floors=False)
    if okd_load is not None:
        sel = sel & okd_load

    # Joint source-side floors: several leaderships leaving one broker in
    # the same sweep must not jointly cross a prior lower band.
    if guards.resources:
        skey = torch.where(sel, src, b).to(_I32)
        ss, s_i = sort_pairs(skey, b)
        sel_s = sel[s_i.long()]
        sel = sel & _load_verdict(
            ss, lead_vec[s_i.long()] * sel_s[:, None], s_i, state, derived,
            constraint, guards, floors=True)

    rows = torch.where(sel, p_m, p)
    leader = torch.cat([state.leader_slot,
                        torch.zeros(1, dtype=state.leader_slot.dtype,
                                    device=dev)])
    leader = leader.index_put((rows,), best_slot.to(leader.dtype))[:p]
    return (dataclasses.replace(state, leader_slot=leader),
            sel.sum().to(_I32), mover.sum().to(_I32))


def _direct_sweep(state: ClusterTensors, goals: tuple[Goal, ...], index: int,
                  constraint: BalancingConstraint, num_topics: int,
                  masks: ExclusionMasks, sweep: int = 0,
                  margin_frac: float = 0.25,
                  seed: int = SPARSE_ROUNDING_SEED,
                  ) -> tuple[ClusterTensors, torch.Tensor, torch.Tensor]:
    """One transport sweep for ``goals[index]``: plan the surplus → deficit
    matching on the current counts, veto infeasible assignments, apply the
    rest in one scatter. ``sweep`` rotates each group's rank → profile
    mapping (a golden-ratio jump) so a vetoed pairing meets another
    destination next sweep. Returns (new_state, applied, planned) as 0-dim
    int32 tensors on the state's device."""
    goal = goals[index]
    guards = _guards_for(goals, index)
    derived, counts, group, movable, elig_dst, plan = _plan(
        goal, state, constraint, num_topics, masks, sweep, margin_frac, seed,
        elig_for_leadership=False)
    surplus, defi, headr, cum_d, cum_h = plan
    dev = state.device
    p, s = state.assignment.shape
    b = state.num_brokers
    g_dim = counts.shape[0]
    n = p * s
    alive = derived.alive
    ninf, inf = float("-inf"), float("inf")

    # --- mover selection: one sort by (cell, weight) ----------------------
    alive_pad = torch.cat([alive, torch.zeros(1, dtype=torch.bool,
                                              device=dev)])
    src_plane = torch.where(state.assignment >= 0, state.assignment,
                            b).long()
    mv = movable & derived.movable_partition[:, None] & alive_pad[src_plane]
    lead_plane = is_leader_slot(state)
    if guards.resources:
        mv = _src_floor_filter(
            mv, state, derived, constraint, guards, src_plane,
            lambda r: torch.where(lead_plane, state.leader_load[:, r][:, None],
                                  state.follower_load[:, r][:, None]))
    if guards.replica_band:
        rl, _ru = count_limits(derived.avg_replicas,
                               constraint.replica_balance_threshold)
        reps_pad = _pad(derived.broker_replicas, 0.0)
        rlo_pad = _pad(rl.expand(b), ninf)
        mv = mv & (reps_pad[src_plane] - 1.0 >= rlo_pad[src_plane] - _EPS)
    if guards.leader_band:
        ll, _lu = count_limits(derived.avg_leaders,
                               constraint.leader_replica_balance_threshold)
        leads_pad = _pad(derived.broker_leaders, 0.0)
        llo_pad = _pad(ll.expand(b), ninf)
        mv = mv & (~lead_plane | (leads_pad[src_plane] - 1.0
                                  >= llo_pad[src_plane] - _EPS))
    cell = torch.where(mv, group * (b + 1) + src_plane,
                       g_dim * (b + 1)).to(_I32)
    weight = replica_load_total(state)
    sc, si = sort_pairs(cell.reshape(-1), g_dim * (b + 1),
                        weight.reshape(-1))
    rank_cell = segment_scan(sc, _ones(n, dev))[0]
    sc_l = sc.long()
    sur_pad = _pad(torch.cat([surplus, torch.zeros((g_dim, 1), dtype=_F32,
                                                   device=dev)],
                             1).reshape(-1), 0.0)
    mover = rank_cell.to(_F32) < sur_pad[sc_l]

    # --- rank assignment over the [deficit | headroom] profile -------------
    grp_key = (sc_l // (b + 1)).to(_I32)           # sorted; sentinel g_dim
    grp = torch.clamp(grp_key, max=g_dim - 1)
    rank_grp = segment_scan(grp_key, mover.to(_I32))[0]
    # tot_pos = Σ_b (defi + headr): integral, so the profiles' last
    # entries give it exactly.
    tot_pos = cum_d[:, -1] + cum_h[:, -1]                          # [G]
    t_g = tot_pos[grp.long()]
    rank_f = rank_grp.to(_F32)
    # The golden-ratio rotation, f32(sweep) * f32(0.6180339887) * t_g: the
    # first product is exact in f32 as a Python float.
    rot = float(np.float32(sweep) * np.float32(0.6180339887))
    offs = torch.floor(t_g * rot)
    rank_f = torch.where(rank_f < t_g,
                         torch.fmod(rank_f + offs, torch.clamp(t_g, min=1.0)),
                         rank_f)
    dst, ok = direct_fill_dests(grp, rank_f, cum_d, cum_h)
    ok = ok & mover

    # --- structural feasibility ------------------------------------------
    si_l = si.long()
    p_m = si_l // s
    s_m = si_l % s
    src = (sc_l % (b + 1))
    dst_l = dst.long()
    ok = ok & (dst_l != torch.clamp(src, max=b - 1))
    assign_p = state.assignment[p_m]                           # [N, S]
    ok = ok & ~(assign_p == dst[:, None]).any(1)
    is_lead = state.leader_slot[p_m] == s_m
    ok = ok & (~is_lead | derived.allowed_leadership[dst_l])
    not_me = torch.arange(s, device=dev)[None, :] != s_m[:, None]
    if guards.rack:
        rack_pad = torch.cat([state.rack, state.rack[:1]])
        slot_racks = torch.where(assign_p >= 0,
                                 rack_pad[torch.clamp(assign_p, 0,
                                                      b - 1).long()],
                                 torch.full((), -1, dtype=state.rack.dtype,
                                            device=dev))
        dst_rack = state.rack[dst_l]
        ok = ok & ~((slot_racks == dst_rack[:, None]) & not_me
                    & (assign_p >= 0)).any(1)

    # --- same-sweep sibling dedupe via planned-destination planes ---------
    pos = torch.arange(n, dtype=_I32, device=dev)
    sel0 = mover & ok
    planned_dst = torch.empty(n, dtype=_I32, device=dev)
    planned_dst[si_l] = torch.where(sel0, dst, torch.full((), -1, dtype=_I32,
                                                          device=dev))
    planned_pri = torch.empty(n, dtype=_I32, device=dev)
    planned_pri[si_l] = torch.where(sel0, pos, torch.full((), n, dtype=_I32,
                                                          device=dev))
    others_dst = planned_dst.reshape(p, s)[p_m]                # [N, S]
    others_pri = planned_pri.reshape(p, s)[p_m]
    earlier = not_me & (others_pri < pos[:, None])
    ok = ok & ~((others_dst == dst[:, None]) & earlier).any(1)
    if guards.rack:
        others_rack = torch.where(
            others_dst >= 0, rack_pad[torch.clamp(others_dst, 0,
                                                  b - 1).long()],
            torch.full((), -2, dtype=state.rack.dtype, device=dev))
        ok = ok & ~((others_rack == dst_rack[:, None]) & earlier).any(1)

    sel = mover & ok
    # A moving leader carries its leader load, a follower its follower
    # load.
    load_vec = torch.where(is_lead[:, None], state.leader_load[p_m],
                           state.follower_load[p_m])              # [N, R]

    # --- prior-goal guards: destination-sorted joint caps -----------------
    dst_caps = (guards.replica_cap or guards.replica_band
                or guards.leader_band or guards.resources
                or guards.cap_resources or guards.pot_nw_out)
    if dst_caps:
        dkey = torch.where(sel, dst, b).to(_I32)
        ds, d_i = sort_pairs(dkey, b)
        d_l = d_i.long()
        sel_d = sel[d_l]
        one_d = sel_d.to(_F32)
        okd = torch.ones(n, dtype=torch.bool, device=dev)
        if guards.replica_cap or guards.replica_band:
            reps = derived.broker_replicas.to(_F32)
            cap_b = torch.full((b,), inf, dtype=_F32, device=dev)
            if guards.replica_band:
                _rl, ru = count_limits(derived.avg_replicas,
                                       constraint.replica_balance_threshold)
                cap_b = torch.minimum(cap_b, ru - reps)
            if guards.replica_cap:
                cap_b = torch.minimum(
                    cap_b, constraint.max_replicas_per_broker - reps)
            okd = okd & segment_scan(ds, one_d, [Check(limit=_pad(cap_b, inf))],
                                     d_i)[1]
        if guards.leader_band:
            lead_d = (is_lead[d_l] & sel_d).to(_F32)
            _ll, lu = count_limits(derived.avg_leaders,
                                   constraint.leader_replica_balance_threshold)
            lcap = _pad(lu - derived.broker_leaders.to(_F32), inf)
            okd = okd & segment_scan(ds, lead_d, [Check(
                limit=lcap, gate=lead_d != 0)], d_i)[1]
        okd_load = _load_verdict(ds, load_vec[d_l] * sel_d[:, None], d_i,
                                 state, derived, constraint, guards,
                                 floors=False)
        if okd_load is not None:
            okd = okd & okd_load
        if guards.pot_nw_out:
            r = int(Resource.NW_OUT)
            pot_own = state.leader_load[p_m, r][d_l] * one_d
            limit = constraint.capacity_threshold[r] * state.capacity[:, r]
            pot_pad = _pad(derived.pot_nw_out, 0.0)
            lim_pad = _pad(limit, inf)
            # The reference's escape hatch: a move whose source already
            # violates its potential limit is tolerated.
            src_d = torch.clamp(src[d_l], max=b)
            src_viol = pot_pad[src_d] > lim_pad[src_d] + _EPS
            okd = okd & segment_scan(ds, pot_own, [Check(
                limit=lim_pad, base=pot_pad, own_column=0,
                gate=~src_viol)], d_i)[1]
        sel = sel & okd

    # --- prior-goal guards: source-sorted joint floors --------------------
    if guards.replica_band or guards.leader_band or guards.resources:
        skey = torch.where(sel, src, b).to(_I32)
        ss, s_i = sort_pairs(skey, b)
        s_l = s_i.long()
        sel_s = sel[s_l]
        one_s = sel_s.to(_F32)
        oks = torch.ones(n, dtype=torch.bool, device=dev)
        if guards.replica_band:
            rl, _ru = count_limits(derived.avg_replicas,
                                   constraint.replica_balance_threshold)
            oks = oks & segment_scan(ss, one_s, [Check(
                limit=_pad(rl.expand(b), ninf),
                base=_pad(derived.broker_replicas, 0.0), floor=True)],
                s_i)[1]
        if guards.leader_band:
            lead_s = (is_lead[s_l] & sel_s).to(_F32)
            ll, _lu = count_limits(derived.avg_leaders,
                                   constraint.leader_replica_balance_threshold)
            oks = oks & segment_scan(ss, lead_s, [Check(
                limit=_pad(ll.expand(b), ninf),
                base=_pad(derived.broker_leaders, 0.0), floor=True,
                gate=lead_s != 0)], s_i)[1]
        oks_load = _load_verdict(ss, load_vec[s_l] * sel_s[:, None], s_i,
                                 state, derived, constraint, guards,
                                 floors=True)
        if oks_load is not None:
            oks = oks & oks_load
        sel = sel & oks

    # --- per-(topic, broker) band of a prior topic goal -------------------
    if guards.topic_band and not isinstance(goal,
                                            TopicReplicaDistributionGoal):
        tb = topic_broker_replica_counts(state, num_topics).to(_F32)
        n_alive = torch.clamp(alive.sum(), min=1).to(_F32)
        t_avg = xla_sum(tb * alive[None, :], 1) / n_alive
        t_up = torch.ceil(t_avg * constraint.topic_replica_balance_threshold)
        t_lo = torch.floor(t_avg / constraint.topic_replica_balance_threshold)
        topic_m = state.topic[p_m].long()
        sentinel = num_topics * (b + 1)
        tb_pad = _pad(torch.cat([tb, torch.zeros((num_topics, 1), dtype=_F32,
                                                 device=dev)], 1).reshape(-1),
                      0.0)
        up_flat = _pad(t_up[:, None].expand(num_topics, b + 1).reshape(-1),
                       inf)
        lo_flat = _pad(t_lo[:, None].expand(num_topics, b + 1).reshape(-1),
                       ninf)
        # Destination side: joint intake per (topic, dst) under the upper.
        tdkey = torch.where(sel, topic_m * (b + 1) + dst_l,
                            sentinel).to(_I32)
        ts, t_i = sort_pairs(tdkey, sentinel)
        sel_t = sel[t_i.long()].to(_F32)
        sel = sel & segment_scan(ts, sel_t, [Check(
            limit=up_flat, base=tb_pad, gate=sel_t != 0)], t_i)[1]
        # Source side: joint outflow per (topic, src) above the lower.
        tskey = torch.where(sel, topic_m * (b + 1) + src, sentinel).to(_I32)
        ts2, t2_i = sort_pairs(tskey, sentinel)
        sel_t2 = sel[t2_i.long()].to(_F32)
        sel = sel & segment_scan(ts2, sel_t2, [Check(
            limit=lo_flat, base=tb_pad, floor=True, gate=sel_t2 != 0)],
            t2_i)[1]

    # --- one-shot scatter apply (si is a permutation of the slots) --------
    flat = state.assignment.reshape(-1)
    new_flat = torch.empty_like(flat)
    new_flat[si_l] = torch.where(sel, dst.to(flat.dtype), flat[si_l])
    return (dataclasses.replace(state, assignment=new_flat.reshape(p, s)),
            sel.sum().to(_I32), mover.sum().to(_I32))


def _sweep_fn(goals: tuple[Goal, ...], index: int):
    """Leader-count goals transport leadership; every other count goal
    transports replicas."""
    g = goals[index]
    if isinstance(g, CountDistributionGoal) and g.leaders:
        return _leadership_sweep
    return _direct_sweep


def _stall_limit(goals: tuple[Goal, ...], index: int) -> int:
    """Consecutive zero-apply (or non-improving) sweeps tolerated before
    the loop leaves the residue to the greedy polish: the replica
    transports re-pair vetoed movers by rotation, so they get three; the
    leadership sweep has no rotation and would recompute the same plan,
    so it stops at the first."""
    return 1 if _sweep_fn(goals, index) is _leadership_sweep else 3


def _direct_rounds_driver(state: ClusterTensors, goals: tuple[Goal, ...],
                          index: int, constraint: BalancingConstraint,
                          num_topics: int, masks: ExclusionMasks,
                          max_sweeps: int, margin_frac: float = 0.25,
                          seed: int = SPARSE_ROUNDING_SEED):
    """The sweep loop: sweeps while the plan still has movers, at most
    ``max_sweeps``, until ``_stall_limit`` consecutive sweeps applied
    nothing or failed to shrink ``planned`` by an eighth below the best so
    far. One host read of (applied, planned) a sweep. Returns
    (final_state, moves, sweeps, planned at exit)."""
    from .chain import LOOP_STATS
    if not direct_eligible(goals, index):
        raise ValueError(
            f"goal {goals[index].name} / chain prefix not direct-eligible "
            "(see direct_eligible)")
    sweep_fn = _sweep_fn(goals, index)
    stall = _stall_limit(goals, index)
    total, i, planned, zeros, noprog = 0, 0, 1, 0, 0
    best = 2 ** 31 - 1
    while planned > 0 and i < max_sweeps and zeros < stall \
            and noprog < stall:
        state, applied_t, planned_t = sweep_fn(
            state, goals, index, constraint, num_topics, masks, sweep=i,
            margin_frac=margin_frac, seed=seed)
        applied, planned = (int(v) for v in
                            torch.stack([applied_t, planned_t]).cpu())
        LOOP_STATS["direct_reads"] += 1
        LOOP_STATS["direct_sweeps"] += 1
        zeros = 0 if applied > 0 else zeros + 1
        noprog = 0 if planned < best - best // 8 else noprog + 1
        best = min(best, planned)
        total += applied
        i += 1
    return state, total, i, planned


def direct_transport_rounds(state: ClusterTensors, goals: tuple[Goal, ...],
                            index: int, constraint: BalancingConstraint,
                            num_topics: int, masks: ExclusionMasks,
                            max_sweeps: int = 8, margin_frac: float = 0.25,
                            seed: int = SPARSE_ROUNDING_SEED):
    """The direct-assignment solve of ``goals[index]`` under the guards of
    ``goals[:index]``: up to ``max_sweeps`` sweeps. Returns (final_state,
    moves_applied, sweeps_run, movers_stranded) with host ints."""
    return _direct_rounds_driver(state, tuple(goals), index, constraint,
                                 num_topics, masks, max_sweeps,
                                 margin_frac=margin_frac, seed=seed)


def run_direct_pass(state: ClusterTensors, goals, index: int,
                    constraint: BalancingConstraint, num_topics: int,
                    masks: ExclusionMasks, megastep, max_sweeps: int,
                    stats=None):
    """One direct pass, recorded as one dispatch of kind ``"direct"``
    (its sweeps as its rounds, never donated). Returns (state, moves,
    sweeps, stranded): ``stranded`` is the movers the plan still wanted at
    exit, the caller's residue signal for sizing the greedy polish."""
    margin_frac = float(getattr(megastep, "direct_sparse_margin", 0.25))
    seed = sparse_rounding_seed(getattr(megastep, "direct_sparse_salt", ""))
    state, moves, sweeps, stranded = direct_transport_rounds(
        state, tuple(goals), index, constraint, num_topics, masks,
        max_sweeps, margin_frac=margin_frac, seed=seed)
    if stats is not None:
        stats.record("direct", sweeps, donated=False)
    return state, moves, sweeps, stranded

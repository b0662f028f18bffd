"""One search round's candidate scoring, and kernel K6 (``score_grid``).

The grid mode expands the candidate grid from its inputs (the move
block's sources, destinations and targeted column, the leadership
block's partitions: :class:`~.candidates.GridSpec`), computes every
row's deltas (``compute_deltas``), ANDs every prior goal's acceptance,
scores the active goal's improvement with the offline bonus and masks the
score to ``-inf`` where some goal refuses. The recheck mode is the joint
acceptance of a rank-ordered batch carrying cumulative pre-deltas: every
prior goal's, and the active goal's where an earlier row of the batch
touches the same brokers.

On a CUDA tensor the grid mode launches ``csrc/score_grid.cu`` twice (a
panel of the per-broker values every goal reads at the move block's
destinations, then the rows: CTAs over groups of sources staged in
shared memory, the leadership block one thread a row) and the recheck
mode once; on a CPU tensor each runs the plain twin, the reference's ops
(``score_grid_plain``, ``recheck_plain``). The kernel reads the goals
through a table of descriptors (``goal_table``): each goal's family and
the device arrays its ``score_args`` builds in PyTorch; the panel's plan
(``GridParams.field`` / ``goal_slot``: the core per-broker fields, then
each goal's [B] arrays) is packed with it.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import torch

from .. import kernels
from ..model.tensors import ClusterTensors
from .candidates import (
    PRE_FIELDS, CandidateDeltas, GridSpec, compute_deltas, expand_grid,
)
from .constraint import BalancingConstraint
from .derived import DerivedState
from .goals.base import Family, Goal, ScoreArgs
from .search import _OFFLINE_BONUS

# Descriptors the kernel's parameters hold (kMaxGoals in the source).
MAX_GOALS = 24
# The panel's fields: the kernel's core per-broker fields (alive, new, the
# two exclusions, rack, replica and leader counts, potential NW-out, four
# loads, four capacities), then at most two [B] arrays a goal (kCore and
# kMaxFields in the source).
PANEL_CORE_FIELDS = 16
MAX_PANEL_FIELDS = PANEL_CORE_FIELDS + 2 * MAX_GOALS

# The arrays each family's descriptor holds: (dtype, shape), the shape in
# the symbols B (brokers), T (topics), P (partitions) and "" (0-dim).
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
FAMILY_ARRAYS = {
    Family.RACK_AWARE: (),
    Family.REPLICA_CAPACITY: (),
    Family.RESOURCE_CAPACITY: ((_F32, "B"),),
    Family.COUNT_DISTRIBUTION: ((_F32, ""), (_F32, "")),
    Family.POTENTIAL_NW_OUT: ((_F32, "B"),),
    Family.RESOURCE_DISTRIBUTION: ((_F32, "B"), (_F32, "B"), (_BOOL, "")),
    Family.TOPIC_REPLICA_DISTRIBUTION: ((_F32, "TB"), (_F32, "T"),
                                        (_F32, "T")),
    Family.LEADER_BYTES_IN: ((_F32, "B"), (_F32, "")),
    Family.RACK_AWARE_DISTRIBUTION: ((_I32, "P"),),
    Family.PREFERRED_LEADER: ((_I32, "P"),),
    Family.MIN_TOPIC_LEADERS: ((_I32, "TB"),),
    Family.BROKER_SET_AWARE: ((_I32, "B"), (_I32, "T")),
    Family.KAFKA_ASSIGNER_RACK: ((_I32, ""), (_I32, "B")),
    Family.KAFKA_ASSIGNER_DISK: ((_F32, ""), (_F32, "")),
}


class GoalDesc(ctypes.Structure):
    """One goal of the table (``GoalDesc`` in csrc/score_grid.cu)."""

    _fields_ = [("family", ctypes.c_int32), ("resource", ctypes.c_int32),
                ("ival", ctypes.c_int32), ("fval", ctypes.c_float),
                ("p", ctypes.c_void_p * 4)]


_VP = ctypes.c_void_p
_PTRS = ("assignment", "leader_slot", "leader_load", "follower_load",
         "topic", "pmask", "rack", "capacity", "broker_load",
         "broker_replicas", "broker_leaders", "pot_nw_out", "alive",
         "new_brokers", "allowed_rm", "allowed_ld", "movable", "has_new",
         "off", "cand_p", "cand_s", "src_valid", "dst_idx", "dst_val",
         "t_dst", "t_ok", "lp", "top_lw")
_ROWS = ("kind", "partition", "src_broker", "dst_broker", "topic_out",
         "src_slot", "dst_slot", "replica_delta", "leader_delta",
         "load_delta", "valid", "pre_src_load", "pre_dst_load")


class GridParams(ctypes.Structure):
    """A launch's parameters (``GridParams`` in csrc/score_grid.cu), passed
    to the kernel by value."""

    _fields_ = ([(f, ctypes.c_int32) for f in ("mode", "n", "P", "S", "B",
                                                 "T")]
                + [(f, _VP) for f in _PTRS]
                + [(f, ctypes.c_int32) for f in ("k_src", "k_dst", "extra",
                                                 "k_l", "move_block_ok",
                                                 "lead_block_ok")]
                + [(f, _VP) for f in _ROWS]
                + [("pre", _VP * 9), ("has_earlier", _VP), ("accept", _VP),
                   ("score", _VP), ("n_goals", ctypes.c_int32),
                   ("active", ctypes.c_int32),
                   ("prior_mask", ctypes.c_uint32),
                   ("pad_", ctypes.c_int32),
                   ("goals", GoalDesc * MAX_GOALS),
                   ("panel", _VP), ("n_fields", ctypes.c_int32),
                   ("pad2_", ctypes.c_int32),
                   ("field", ctypes.c_int16 * MAX_PANEL_FIELDS),
                   ("goal_slot", ctypes.c_int8 * (4 * MAX_GOALS))])


@dataclasses.dataclass(frozen=True)
class GoalTable:
    """The goals K6 reads: the prior goals and the active one, each with
    its descriptor, and which of them are prior. ``active`` indexes
    ``args``."""

    args: tuple[ScoreArgs, ...]
    prior: tuple[bool, ...]
    active: int


def goal_table(goals: Sequence[Goal], aux_list, active: int,
               prior: Sequence[bool], state: ClusterTensors,
               derived: DerivedState,
               constraint: BalancingConstraint) -> GoalTable:
    """Every prior goal's and the active goal's descriptor, in chain
    order. Raises ``kernels.limit_error`` beyond ``MAX_GOALS``."""
    picked = [i for i in range(len(goals)) if prior[i] or i == active]
    if len(picked) > MAX_GOALS:
        raise kernels.limit_error(
            "score_grid", f"a goal table of {len(picked)} goals")
    args = tuple(goals[i].score_args(state, derived, constraint,
                                     aux_list[i]) for i in picked)
    return GoalTable(args, tuple(bool(prior[i]) for i in picked),
                     picked.index(active))


def _pack_goals(params: GridParams, table: GoalTable, sizes: dict,
                dev) -> None:
    """The goal table, and the panel's plan: the core fields at slots
    0-15, then every goal's [B] array at the next slot (``goal_slot`` -1
    for the other arrays)."""
    params.n_goals = len(table.args)
    params.active = table.active
    params.prior_mask = sum(1 << j for j, p in enumerate(table.prior) if p)
    n_fields = PANEL_CORE_FIELDS
    for f in range(PANEL_CORE_FIELDS):
        params.field[f] = f
    ctypes.memset(ctypes.addressof(params.goal_slot), 0xFF,
                  ctypes.sizeof(params.goal_slot))
    for j, a in enumerate(table.args):
        spec = FAMILY_ARRAYS[a.family]
        if a.family == Family.MIN_TOPIC_LEADERS and not a.ival:
            spec = ()
        if len(a.arrays) != len(spec):
            raise ValueError(f"score_grid kernel: family {a.family.name} "
                             f"takes {len(spec)} arrays, got "
                             f"{len(a.arrays)}")
        desc = params.goals[j]
        desc.family, desc.resource = int(a.family), int(a.resource)
        desc.ival, desc.fval = int(a.ival), float(a.fval)
        for k, (t, (dtype, dims)) in enumerate(zip(a.arrays, spec)):
            shape = tuple(sizes[d] for d in dims)
            kernels.require(t, dev, dtype, shape,
                            f"{a.family.name} array {k}", "score_grid")
            desc.p[k] = t.data_ptr()
            if dims == "B":
                params.field[n_fields] = PANEL_CORE_FIELDS + 4 * j + k
                params.goal_slot[4 * j + k] = n_fields
                n_fields += 1
    params.n_fields = n_fields


def _common_params(mode: int, n: int, state: ClusterTensors,
                   derived: DerivedState, table: GoalTable, num_topics: int,
                   ) -> GridParams:
    dev = state.device
    p, s = state.assignment.shape
    b = state.num_brokers
    if not 0 < p * s < 2 ** 31 or s > 64 or n >= 2 ** 31:
        raise kernels.limit_error("score_grid",
                                  f"P*S={p * s}, S={s}, {n} rows")
    req = kernels.requirer("score_grid")
    q = GridParams()
    q.mode, q.n, q.P, q.S, q.B, q.T = mode, n, p, s, b, num_topics
    for name, t, dtype, shape in (
            ("assignment", state.assignment, _I32, (p, s)),
            ("leader_slot", state.leader_slot, _I32, (p,)),
            ("leader_load", state.leader_load, _F32, (p, 4)),
            ("follower_load", state.follower_load, _F32, (p, 4)),
            ("topic", state.topic, _I32, (p,)),
            ("pmask", state.partition_mask, _BOOL, (p,)),
            ("rack", state.rack, _I32, (b,)),
            ("capacity", state.capacity, _F32, (b, 4)),
            ("broker_load", derived.broker_load, _F32, (b, 4)),
            ("broker_replicas", derived.broker_replicas, _I32, (b,)),
            ("broker_leaders", derived.broker_leaders, _I32, (b,)),
            ("pot_nw_out", derived.pot_nw_out, _F32, (b,)),
            ("alive", derived.alive, _BOOL, (b,)),
            ("new_brokers", derived.new_brokers, _BOOL, (b,)),
            ("allowed_rm", derived.allowed_replica_move, _BOOL, (b,)),
            ("allowed_ld", derived.allowed_leadership, _BOOL, (b,)),
            ("movable", derived.movable_partition, _BOOL, (p,))):
        setattr(q, name, req(t, dev, dtype, shape, name).data_ptr())
    _pack_goals(q, table, {"B": b, "T": num_topics, "P": p}, dev)
    return q


def _launch(q: GridParams, dev, name: str) -> None:
    lib = kernels.library("score_grid")
    if lib.cc_score_grid_params_bytes() != ctypes.sizeof(GridParams):
        raise RuntimeError("score_grid kernel: the parameter block's layout "
                           "differs between csrc/score_grid.cu and Python")
    kernels.check(lib.cc_score_grid(ctypes.byref(q), kernels.stream_ptr(dev)),
                  name)
    kernels.LAUNCHES[name] += 1


def score_grid_plain(state: ClusterTensors, derived: DerivedState,
                     constraint: BalancingConstraint,
                     goals: Sequence[Goal], aux_list, active: int,
                     prior: Sequence[bool], off: torch.Tensor,
                     spec: GridSpec, move_block_ok: bool,
                     lead_block_ok: bool,
                     ) -> tuple[CandidateDeltas, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """K6's twin in grid mode: the grid materialized, its rows' deltas,
    the AND of every prior goal's acceptance, and the active goal's
    improvement with the offline bonus where every prior goal accepts,
    ``-inf`` elsewhere. ``move_block_ok`` / ``lead_block_ok`` gate each
    block's rows. Returns (deltas, kind [N] int8, accept [N], score
    [N] f32)."""
    dev = state.device
    cand = expand_grid(spec)
    (r0, c0), (r1, c1) = spec.layout
    block_ok = torch.cat([
        torch.full((r0 * c0,), move_block_ok, dtype=torch.bool, device=dev),
        torch.full((r1 * c1,), lead_block_ok, dtype=torch.bool, device=dev)])
    cand = dataclasses.replace(cand, valid=cand.valid & block_ok)
    deltas = compute_deltas(state, derived, cand)

    accept = deltas.valid
    for i, g in enumerate(goals):
        if prior[i]:
            accept = accept & g.acceptance(state, derived, constraint,
                                           aux_list[i], deltas)
    moving_offline = off[deltas.partition.long(), deltas.src_slot.long()] \
        & (deltas.replica_delta > 0)
    imp = goals[active].improvement(state, derived, constraint,
                                    aux_list[active], deltas) \
        .to(torch.float32)
    imp = torch.where(moving_offline & torch.isfinite(imp) & deltas.valid,
                      torch.clamp(imp, min=0.0) + _OFFLINE_BONUS, imp)
    score = torch.where(accept, imp,
                        torch.full((), float("-inf"), device=dev))
    return deltas, cand.kind, accept, score


def score_grid(state: ClusterTensors, derived: DerivedState,
               constraint: BalancingConstraint, goals: Sequence[Goal],
               aux_list, active: int, prior: Sequence[bool],
               off: torch.Tensor, spec: GridSpec, move_block_ok: bool,
               lead_block_ok: bool, num_topics: int,
               table: GoalTable | None = None,
               ) -> tuple[CandidateDeltas, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """K6 in grid mode on the card, its twin on the CPU (see
    score_grid_plain). ``table`` is this round's ``goal_table`` when the
    caller already has it."""
    dev = state.device
    if dev.type == "cpu":
        return score_grid_plain(state, derived, constraint, goals, aux_list,
                                active, prior, off, spec, move_block_ok,
                                lead_block_ok)
    if dev.type != "cuda":
        raise ValueError(f"score_grid: unsupported device {dev}")
    if table is None:
        table = goal_table(goals, aux_list, active, prior, state, derived,
                           constraint)
    q, outs, _keep = grid_params(state, derived, off, spec, move_block_ok,
                                 lead_block_ok, table, num_topics)
    _launch(q, dev, "score_grid")
    return outs


def grid_params(state: ClusterTensors, derived: DerivedState,
                off: torch.Tensor, spec: GridSpec, move_block_ok: bool,
                lead_block_ok: bool, table: GoalTable, num_topics: int):
    """The grid mode's launch parameters and its outputs, allocated on the
    state's device. Returns (params, (deltas, kind, accept, score), the
    tensors the parameters point to that nothing else holds)."""
    dev = state.device
    if spec.dst_idx is None or spec.lp is None:
        raise ValueError("score_grid kernel: expects the move and the "
                         "leadership block")
    (r0, c0), (r1, c1) = spec.layout
    n = r0 * c0 + r1 * c1
    q = _common_params(0, n, state, derived, table, num_topics)
    p, s = state.assignment.shape
    k_src, k_dst, k_l = r0, spec.dst_idx.shape[0], r1
    extra = spec.t_dst is not None
    req = kernels.requirer("score_grid")
    for name, t, dtype, shape in (
            ("off", off, _BOOL, (p, s)),
            ("cand_p", spec.cand_p, _I32, (k_src,)),
            ("cand_s", spec.cand_s, _I32, (k_src,)),
            ("src_valid", spec.src_valid, _BOOL, (k_src,)),
            ("dst_idx", spec.dst_idx, _I32, (k_dst,)),
            ("dst_val", spec.dst_val, _F32, (k_dst,)),
            ("lp", spec.lp, _I32, (k_l,)),
            ("top_lw", spec.top_lw, _F32, (k_l,))) + ((
            ("t_dst", spec.t_dst, _I32, (k_src,)),
            ("t_ok", spec.t_ok, _BOOL, (k_src,))) if extra else ()):
        setattr(q, name, req(t, dev, dtype, shape, name).data_ptr())
    has_new = derived.new_brokers.any()
    q.has_new = has_new.data_ptr()
    q.k_src, q.k_dst, q.extra, q.k_l = k_src, k_dst, int(extra), k_l
    panel = torch.empty(q.n_fields * (k_dst + (1 + int(extra)) * k_src),
                        dtype=_I32, device=dev)
    q.panel = panel.data_ptr()
    q.move_block_ok, q.lead_block_ok = int(move_block_ok), int(lead_block_ok)

    def out(dtype, *shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    kind = out(torch.int8, n)
    deltas = CandidateDeltas(
        src_broker=out(_I32, n), dst_broker=out(_I32, n),
        load_delta=out(_F32, n, 4), replica_delta=out(_I32, n),
        leader_delta=out(_I32, n), partition=out(_I32, n),
        topic=out(_I32, n), src_slot=out(_I32, n), dst_slot=out(_I32, n),
        valid=out(_BOOL, n))
    accept, score = out(_BOOL, n), out(_F32, n)
    q.kind = kind.data_ptr()
    for name in ("partition", "src_broker", "dst_broker", "src_slot",
                 "dst_slot", "replica_delta", "leader_delta", "load_delta",
                 "valid"):
        setattr(q, name, getattr(deltas, name).data_ptr())
    q.topic_out = deltas.topic.data_ptr()
    q.accept, q.score = accept.data_ptr(), score.data_ptr()
    return q, (deltas, kind, accept, score), (has_new, panel)


def recheck_plain(state: ClusterTensors, derived: DerivedState,
                  constraint: BalancingConstraint, goals: Sequence[Goal],
                  aux_list, active: int, prior: Sequence[bool],
                  sub: CandidateDeltas, has_earlier: torch.Tensor,
                  ) -> torch.Tensor:
    """K6's twin in recheck mode: the joint acceptance of a rank-ordered
    batch with cumulative pre-deltas, every prior goal's, plus the ACTIVE
    goal's own for rows that interact with an earlier one. [m] bool."""
    a = torch.ones(sub.valid.shape[0], dtype=torch.bool,
                   device=state.device)
    for i, g in enumerate(goals):
        if prior[i] or i == active:
            g_acc = g.acceptance(state, derived, constraint, aux_list[i], sub)
            if prior[i]:
                a = a & g_acc
            if i == active:
                a = a & ((~has_earlier) | g_acc)
    return a


def recheck(state: ClusterTensors, derived: DerivedState,
            constraint: BalancingConstraint, goals: Sequence[Goal],
            aux_list, active: int, prior: Sequence[bool],
            sub: CandidateDeltas, has_earlier: torch.Tensor,
            num_topics: int, table: GoalTable | None = None,
            ) -> torch.Tensor:
    """K6 in recheck mode on the card, its twin on the CPU (see
    recheck_plain)."""
    dev = state.device
    if dev.type == "cpu":
        return recheck_plain(state, derived, constraint, goals, aux_list,
                             active, prior, sub, has_earlier)
    if dev.type != "cuda":
        raise ValueError(f"score_grid: unsupported device {dev}")
    if table is None:
        table = goal_table(goals, aux_list, active, prior, state, derived,
                           constraint)
    q, ok = recheck_params(state, derived, sub, has_earlier, table,
                           num_topics)
    _launch(q, dev, "score_grid_recheck")
    return ok


def recheck_params(state: ClusterTensors, derived: DerivedState,
                   sub: CandidateDeltas, has_earlier: torch.Tensor,
                   table: GoalTable, num_topics: int):
    """The recheck mode's launch parameters and its output [m] bool,
    allocated on the state's device."""
    dev = state.device
    m = sub.valid.shape[0]
    q = _common_params(1, m, state, derived, table, num_topics)
    req = kernels.requirer("score_grid")
    for name, field, dtype, shape in (
            ("partition", "partition", _I32, (m,)),
            ("src_broker", "src_broker", _I32, (m,)),
            ("dst_broker", "dst_broker", _I32, (m,)),
            ("topic_out", "topic", _I32, (m,)),
            ("src_slot", "src_slot", _I32, (m,)),
            ("dst_slot", "dst_slot", _I32, (m,)),
            ("replica_delta", "replica_delta", _I32, (m,)),
            ("leader_delta", "leader_delta", _I32, (m,)),
            ("load_delta", "load_delta", _F32, (m, 4)),
            ("valid", "valid", _BOOL, (m,)),
            ("pre_src_load", "pre_src_load", _F32, (m, 4)),
            ("pre_dst_load", "pre_dst_load", _F32, (m, 4))):
        setattr(q, name, req(getattr(sub, field), dev, dtype, shape,
                             field).data_ptr())
    for i, name in enumerate(PRE_FIELDS):
        q.pre[i] = req(getattr(sub, name), dev, _F32, (m,), name).data_ptr()
    q.has_earlier = req(has_earlier, dev, _BOOL, (m,),
                        "has_earlier").data_ptr()
    ok = torch.empty(m, dtype=torch.bool, device=dev)
    q.accept = ok.data_ptr()
    return q, ok

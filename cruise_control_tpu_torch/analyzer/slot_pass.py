"""The round's per-slot pass, and kernel K7 (``slot_weights``).

One pass over the [P, S] slots gives the active goal's replica weight in
f32, the offline mask ``off`` (replicas on DEAD brokers), whether any
slot is offline and, with ``override``, the count of offline replicas per
broker (``off_pb``, int32, the self-healing source bonus the move round
adds to its source scores; zeros without ``override``). With
``override`` the weight of every offline slot is also 1e30 (the
self-healing priority of the move round of a goal that moves replicas;
the swap round and leadership goals apply neither).

On a CUDA tensor the wrapper launches ``csrc/slot_pass.cu`` once; on a CPU
tensor it runs the plain twin, ``slot_weights_plain``: the goal's own
``replica_weight``, ``offline_replicas`` with the override and K1's
offline twin (``agg.offline_per_broker_plain``) as int32. The kernel
reads the goal through one descriptor (``Goal.weight_args``): its weight
family and the per-broker, per-topic or 0-dim arrays made in PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..model.tensors import ClusterTensors, offline_replicas
from .agg import offline_per_broker_plain
from .constraint import BalancingConstraint
from .derived import DerivedState
from .goals.base import Goal, WeightArgs, WeightFamily

# The weight every offline slot takes under the override.
OFFLINE_WEIGHT = 1e30
# Slots a partition may have (kMaxS in the source).
MAX_SLOTS = 16
# Words of a call's scratch before the [B] count (kScratchHead): the
# any-offline flag and the peak's bits, each on a 128-byte line of its own.
SCRATCH_HEAD = 64

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
# The arrays each family's descriptor holds: (dtype, shape), the shape in
# the symbols B (brokers), T (topics), "2" (two values) and "" (0-dim).
FAMILY_ARRAYS = {
    WeightFamily.LOAD_TOTAL: (),
    WeightFamily.NEG_LOAD_TOTAL: (),
    WeightFamily.LOAD_COLUMN: (),
    WeightFamily.FIT_PRIORITY: ((_F32, ""), (_F32, "B")),
    WeightFamily.LEADER_LOAD: (),
    WeightFamily.TOPIC_DONOR: ((_F32, "TB"),),
    WeightFamily.RACK_DUPLICATE: (),
    WeightFamily.PREFERRED_LEADER: ((_BOOL, "B"),),
    WeightFamily.BROKER_SET: ((_I32, "B"), (_I32, "T")),
    WeightFamily.KAFKA_ASSIGNER_RACK: ((_BOOL, "B"), (_BOOL, "B"),
                                       (_I32, "B"), (_I32, "B"),
                                       (_I32, "2"), (_BOOL, "B")),
}

_VP = ctypes.c_void_p


class WeightParams(ctypes.Structure):
    """A launch's parameters (``WeightParams`` in csrc/slot_pass.cu),
    passed to the kernel by value."""

    _fields_ = ([(f, ctypes.c_int32) for f in (
        "P", "S", "B", "T", "family", "resource", "ival",
        "override_offline")]
        + [(f, _VP) for f in ("assignment", "leader_slot", "leader_load",
                              "follower_load", "topic", "pmask", "rack",
                              "alive")]
        + [("p", _VP * 6)]
        + [(f, _VP) for f in ("weight", "off", "scratch")])


def slot_weights_plain(goal: Goal, state: ClusterTensors,
                       derived: DerivedState,
                       constraint: BalancingConstraint, aux,
                       override: bool,
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """K7's twin: ``(weight [P, S] f32, off [P, S] bool, off.any(),
    off_pb [B] i32)`` — the goal's ``replica_weight``; with ``override``
    1e30 at every offline slot and the offline replicas per broker (K1's
    offline twin, exact integers), else zeros."""
    weight = goal.replica_weight(state, derived, constraint, aux) \
        .to(torch.float32)
    off = offline_replicas(state)
    if override:
        weight = torch.where(off, torch.full((), OFFLINE_WEIGHT,
                                             device=state.device), weight)
        off_pb = offline_per_broker_plain(state).to(torch.int32)
    else:
        off_pb = torch.zeros(state.num_brokers, dtype=torch.int32,
                             device=state.device)
    return weight, off, off.any(), off_pb


def weight_params(state: ClusterTensors, derived: DerivedState,
                  args: WeightArgs, num_topics: int, override: bool,
                  ) -> tuple[WeightParams, tuple]:
    """The parameter block of one call, with its outputs allocated on the
    state's device. Returns (params, (weight, off, off_any, off_pb)):
    off_any and off_pb are views of the call's one scratch allocation
    (``SCRATCH_HEAD`` + B int32 words, zeroed by the call). On the card, a
    tensor the block points to that is freed after the launch is reused
    only in stream order (PyTorch's caching allocator), as in K6's
    wrapper."""
    dev = state.device
    p, s = state.assignment.shape
    b = state.num_brokers
    if not 0 < p * s < 2 ** 31 or s > MAX_SLOTS:
        raise kernels.limit_error("slot_weights", f"P*S={p * s}, S={s}")
    req = kernels.requirer("slot_weights")
    q = WeightParams()
    q.P, q.S, q.B, q.T = p, s, b, num_topics
    q.family, q.resource = int(args.family), int(args.resource)
    q.ival, q.override_offline = int(args.ival), int(bool(override))
    for name, t, dtype, shape in (
            ("assignment", state.assignment, _I32, (p, s)),
            ("leader_slot", state.leader_slot, _I32, (p,)),
            ("leader_load", state.leader_load, _F32, (p, 4)),
            ("follower_load", state.follower_load, _F32, (p, 4)),
            ("topic", state.topic, _I32, (p,)),
            ("pmask", state.partition_mask, _BOOL, (p,)),
            ("rack", state.rack, _I32, (b,)),
            ("alive", derived.alive, _BOOL, (b,))):
        setattr(q, name, req(t, dev, dtype, shape, name).data_ptr())
    spec = FAMILY_ARRAYS[args.family]
    if len(args.arrays) != len(spec):
        raise ValueError(f"slot_weights kernel: family {args.family.name} "
                         f"takes {len(spec)} arrays, got {len(args.arrays)}")
    sizes = {"B": b, "T": num_topics, "2": 2}
    for k, (t, (dtype, dims)) in enumerate(zip(args.arrays, spec)):
        req(t, dev, dtype, tuple(sizes[d] for d in dims),
            f"{args.family.name} array {k}")
        q.p[k] = t.data_ptr()
    weight = torch.empty((p, s), dtype=_F32, device=dev)
    off = torch.empty((p, s), dtype=_BOOL, device=dev)
    scratch = torch.empty(SCRATCH_HEAD + b, dtype=_I32, device=dev)
    q.weight, q.off = weight.data_ptr(), off.data_ptr()
    q.scratch = scratch.data_ptr()
    off_any = scratch[:1].view(_BOOL)[0]
    return q, (weight, off, off_any, scratch[SCRATCH_HEAD:])


def slot_weights(goal: Goal, state: ClusterTensors, derived: DerivedState,
                 constraint: BalancingConstraint, aux, num_topics: int,
                 override: bool,
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """``(weight, off, off_any, off_pb)`` of the active goal: K7 on the
    card, its twin on the CPU."""
    dev = state.device
    if dev.type == "cpu":
        return slot_weights_plain(goal, state, derived, constraint, aux,
                                  override)
    if dev.type != "cuda":
        raise ValueError(f"slot_weights: unsupported device {dev}")
    args = goal.weight_args(state, derived, constraint, aux)
    q, outs = weight_params(state, derived, args, num_topics, override)
    lib = kernels.library("slot_pass")
    if lib.cc_slot_weights_params_bytes() != ctypes.sizeof(WeightParams) \
            or lib.cc_slot_weights_scratch_head() != SCRATCH_HEAD:
        raise RuntimeError("slot_weights kernel: the parameter block's "
                           "layout differs between csrc/slot_pass.cu and "
                           "Python")
    kernels.check(lib.cc_slot_weights(ctypes.byref(q),
                                      kernels.stream_ptr(dev)),
                  "slot_weights")
    kernels.LAUNCHES["slot_weights"] += 1
    return outs

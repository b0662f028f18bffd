"""Where a pinned bounded solve's device time goes, on one GPU.

    python3 -m cruise_control_tpu_torch.testing.profile_round [NAME ...]

Each NAME is an entry of ``testing/reference_outcomes.json`` (default:
``1k_100k`` and ``7k_1m``). For each, the entry's fixture is solved with
its config and chain three times: a warm-up solve (the graph capture),
which also records the inputs of the eager round run before each
capture; a steady solve, timed; and a solve under ``torch.profiler``,
which gives the device-busy share of its wall, the device ops that take
the most time (the kernels of the replayed CUDA graphs among them) and
the calls and device time of each of the port's own kernels.

Then the round body's device time is split three ways: each goal's first
recorded round runs eagerly under the profiler with Python stacks, and
every device op is charged, by the innermost function of the package
that launched it, to

- ``a``: the P*S-wide per-slot passes (``replica_weight``,
  ``offline_replicas``, the offline count per broker, ``on_source`` and
  the leadership block's stable top-k over P*S keys; K7
  ``slot_weights``, which also counts the offline replicas, and K2's
  leadership mode where they run, and K1's offline mode where the round
  still runs it);
- ``b``: the grid-wide scoring (the candidate layout, ``compute_deltas``,
  every goal's acceptance and improvement, the offline bonus, the joint
  recheck; K6 ``score_grid`` where it runs);
- ``c``: the rest (derived state, aux, source and destination scores,
  K2, K3, K4, the apply).

PyTorch ops are charged by the Python stack that launched them; the
port's own kernels, launched through ctypes with no op above them, by
their names.

Each goal's per-round split is weighted by its rounds in the steady
solve. The steady solve's round-loop accounting (``last_loop_stats()``:
device rounds, swap rounds among them) and its kernel launches are
printed with it. Run it from the root of a checkout (or of an unpacked ``git
archive`` of another commit, with ``PYTHONPATH`` at that root, to profile
that commit). Prints the card's name and power limit first and one JSON
line per entry last. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import re
import subprocess
import sys
import time

# Innermost package function -> part. Functions not named here defer to
# their callers; in the ``_MIXED`` callers, whose own ops belong to more
# than one part, an op is charged by its operands' sizes: [P, S] (or
# P*S) to a, larger than the broker and topic axes to b (the grid's rows),
# the rest to c. (The profiler's Python stacks give each frame's function
# and its first line, not the line running.)
_FUNCS = {
    "replica_weight": "a", "offline_replicas": "a", "on_source": "a",
    "offline_per_broker": "a",
    "leadership_sources": "a", "slot_weights": "a",
    "compute_deltas": "b", "acceptance": "b", "improvement": "b",
    "recheck": "b", "score_grid": "b", "score_grid_plain": "b",
    "goal_table": "b", "pair_improvement": "b", "new_broker_gate": "b",
    "expand_grid": "b",
    "select_sources": "c", "select_batch": "c", "apply_selected": "c",
    "apply_deltas_to_agg": "c", "compute_agg": "c", "source_score": "c",
    "dest_score": "c", "target_dests": "c", "_derived": "c",
    "_aux_list": "c", "pot_lbi_deltas": "c",
}
_MIXED = ("generate_candidates", "grid_spec", "_chain_round_body")
_FRAME = re.compile(r"^(.*)\((\d+)\): (\S+)$")
# The port's own kernels (csrc/*.cu, every one in an anonymous namespace)
# are launched through ctypes: the trace links no PyTorch op to them, so
# their device events are charged by name: K7, K1's offline mode and K2's
# leadership mode to a, K6 to b, the others to c.
_OWN_KERNEL = re.compile(r"^(void )?\(anonymous namespace\)::(\w+)(<[^>]*>)?")
_KERNEL_PARTS = {"weights_kernel": "a", "peak_kernel": "a",
                 "offline_count_kernel": "a", "to_float_kernel": "a",
                 "leadership_kernel": "a", "panel_kernel": "b",
                 "score_grid_kernel": "b", "recheck_kernel": "b"}


# The labelled ranges split_round opens around the kernels' wrappers.
_LABELS = ("score_grid", "recheck", "slot_weights", "leadership_sources")


def own_kernel_part(name: str) -> str | None:
    """The part of a device event of one of the port's kernels, or None
    for any other device event."""
    m = _OWN_KERNEL.match(name)
    if not m:
        return None
    return _KERNEL_PARTS.get(m.group(2), "c")


def part_of(stack, shapes=(), sizes=None) -> str:
    """The part (a, b or c) of a device op launched under ``stack``
    (innermost frame first) with operand ``shapes``; ``sizes`` holds P*S
    and the larger of the broker and topic counts ("ps", "bt")."""
    for frame in stack:
        m = _FRAME.match(frame)
        if not m or "cruise_control_tpu_torch" not in m.group(1):
            continue
        func = m.group(3)
        if func in _FUNCS:
            return _FUNCS[func]
        if func in _MIXED:
            numels = [math.prod(s) for s in shapes if s]
            if sizes and sizes["ps"] in numels:
                return "a"
            if sizes and numels and max(numels) > sizes["bt"]:
                return "b"
            return "c"
    return "c"


def _dev_us(evt, self_only: bool) -> float:
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def split_round(body, args, kwargs) -> dict:
    """{part: device ms} of one eager run of the round body, and the ops
    of each part (name -> ms)."""
    state, num_topics = args[0], args[7]
    sizes = {"ps": state.assignment.numel(),
             "bt": max(state.num_brokers, num_topics)}
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from cruise_control_tpu_torch.analyzer import candidates as cand_mod
    from cruise_control_tpu_torch.analyzer import chain as chain_mod
    # A kernel launched through ctypes has no PyTorch op above it: the
    # wrappers of K6, K7 and K2's leadership mode, where the round body
    # has them, run under a labelled range whose stack names them (the
    # others' launches fall to c).
    patched = {}
    for mod, attr in ((chain_mod, "score_grid"), (chain_mod, "recheck"),
                      (chain_mod, "slot_weights"),
                      (cand_mod, "leadership_sources")):
        orig = getattr(mod, attr, None)
        if orig is not None:
            patched[(mod, attr)] = orig
    orig_of = {attr: fn for (_m, attr), fn in patched.items()}

    def score_grid(*a, **kw):
        with record_function("score_grid"):
            return orig_of["score_grid"](*a, **kw)

    def recheck(*a, **kw):
        with record_function("recheck"):
            return orig_of["recheck"](*a, **kw)

    def slot_weights(*a, **kw):
        with record_function("slot_weights"):
            return orig_of["slot_weights"](*a, **kw)

    def leadership_sources(*a, **kw):
        with record_function("leadership_sources"):
            return orig_of["leadership_sources"](*a, **kw)

    wrappers = {"score_grid": score_grid, "recheck": recheck,
                "slot_weights": slot_weights,
                "leadership_sources": leadership_sources}
    assert set(wrappers) == set(_LABELS)
    for mod, attr in patched:
        setattr(mod, attr, wrappers[attr])
    try:
        for _ in range(2):
            body(*args, **kwargs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_stack=True, record_shapes=True,
                     experimental_config=torch._C._profiler
                     ._ExperimentalConfig(verbose=True)) as prof:
            body(*args, **kwargs)
            torch.cuda.synchronize()
    finally:
        for (mod, attr), fn in patched.items():
            setattr(mod, attr, fn)
    parts = collections.Counter()
    ops = {p: collections.Counter() for p in "abc"}
    for evt in prof.events():
        us = _dev_us(evt, True)
        if us <= 0:
            continue
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            part = own_kernel_part(evt.name)
            if part is not None:
                parts[part] += us / 1e3
                ops[part][_OWN_KERNEL.match(evt.name).group(0)] += us / 1e3
            continue
        if evt.name in _LABELS or evt.name.startswith("cuda"):
            # Ranges and runtime calls around the port's kernels: those
            # are charged by their own device events above.
            continue
        owner = evt
        while owner is not None and not any(
                "cruise_control_tpu_torch" in f for f in owner.stack or ()):
            owner = owner.cpu_parent
        part = "c" if owner is None else part_of(
            owner.stack, evt.input_shapes or (), sizes)
        parts[part] += us / 1e3
        ops[part][evt.name] += us / 1e3
    return dict(parts=dict(parts), ops={p: dict(c) for p, c in ops.items()})


def profile_entry(name: str, whole: bool = True) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import chain as chain_mod
    from cruise_control_tpu_torch.analyzer.goals import ALL_GOALS
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.config import CruiseControlConfig
    from cruise_control_tpu_torch.testing import (
        build_fixture, digest, load_reference_outcomes,
    )
    ref = load_reference_outcomes()[name]
    dev = torch.device("cuda")
    opt = GoalOptimizer(CruiseControlConfig(ref["config"]), device="cuda")
    goals = [ALL_GOALS[g]() for g in ref["chain"]] if "chain" in ref \
        else None
    chain_mod.clear_graphs()

    recorded = {}
    orig_body = chain_mod._chain_round_body

    def recording_body(*args, **kwargs):
        active = args[2]
        if not torch.cuda.is_current_stream_capturing() \
                and active not in recorded:
            recorded[active] = (_clone(args), _clone(kwargs))
        return orig_body(*args, **kwargs)

    def solve():
        state, meta = build_fixture(ref, dev)
        torch.cuda.synchronize()
        t0 = time.time()
        final, result = opt.optimizations(state, meta, goals)
        torch.cuda.synchronize()
        return final, result, time.time() - t0

    chain_mod._chain_round_body = recording_body
    try:
        _f, _r, warm_s = solve()
    finally:
        chain_mod._chain_round_body = orig_body
    kernels.LAUNCHES.clear()
    final, result, steady_s = solve()
    launches = dict(kernels.LAUNCHES)
    loop = opt.last_loop_stats()
    equal = digest(final.assignment.cpu().numpy()) \
        == ref["assignment_sha256"]
    del final
    prof_s = busy = float("nan")
    top_ops = []
    own_kernels = {}   # the port's kernels by name: (calls, device ms)
    if whole:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _f, _r, prof_s = solve()
        del _f
        avgs = [e for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")]
        busy = sum(_dev_us(e, True) for e in avgs) / 1e6
        top = sorted(avgs, key=lambda e: _dev_us(e, True),
                     reverse=True)[:12]
        top_ops = [(e.key[:100], e.count, _dev_us(e, True) / 1e3)
                   for e in top]
        for e in avgs:
            m = _OWN_KERNEL.match(e.key)
            if m:
                calls, ms = own_kernels.get(m.group(2), (0, 0.0))
                own_kernels[m.group(2)] = (calls + e.count,
                                           ms + _dev_us(e, True) / 1e3)
        del prof, avgs

    rounds = [g.rounds for g in result.goal_results]
    names = [g.name for g in result.goal_results]
    split = collections.Counter()
    per_goal = {}
    top_parts = {p: collections.Counter() for p in "abc"}
    for active, (args, kwargs) in sorted(recorded.items()):
        one = split_round(orig_body, args, kwargs)
        w = rounds[active] if active < len(rounds) else 0
        per_goal[names[active]] = dict(rounds=w, **one["parts"])
        for p, ms in one["parts"].items():
            split[p] += w * ms
        for p, c in one["ops"].items():
            for op, ms in c.items():
                top_parts[p][op] += w * ms
    del recorded
    total = sum(split.values()) or 1.0
    return dict(
        entry=name, warmup_s=warm_s, steady_s=steady_s,
        profiled_s=prof_s, rounds=sum(rounds), assignment_equal=equal,
        loop=loop, launches=launches,
        device_busy_s=busy, device_busy_share=busy / prof_s,
        top_ops=top_ops, own_kernels=own_kernels,
        split_ms={p: split[p] for p in "abc"},
        split_share={p: split[p] / total for p in "abc"},
        split_top_ops={p: top_parts[p].most_common(6) for p in "abc"},
        per_goal=per_goal)


def _clone(obj):
    """A recorded argument with every tensor cloned (the round loop's
    static buffers are overwritten by later replays)."""
    import dataclasses

    import torch
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _clone(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    return obj


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", default=["1k_100k", "7k_1m"])
    ap.add_argument("--split-only", action="store_true",
                    help="skip the profiled whole solve")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_round needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for name in args.names:
        out = profile_entry(name, whole=not args.split_only)
        print(f"{name}: steady {out['steady_s']:.3f} s, {out['rounds']} "
              f"rounds, profiled {out['profiled_s']:.3f} s, device busy "
              f"{out['device_busy_s']:.3f} s = "
              f"{out['device_busy_share']:.1%}; split a/b/c "
              + " / ".join(f"{out['split_share'][p]:.1%}" for p in "abc")
              + f" of {sum(out['split_ms'].values()):.1f} ms; device rounds "
              f"{out['loop'].get('device_rounds')}, swap "
              f"{out['loop'].get('swap_device_rounds', 'not counted')}",
              flush=True)
        for key, count, ms in out["top_ops"]:
            print(f"  device {ms:10.2f} ms  calls {count:7d}  {key}")
        print(json.dumps(dict(card=card, **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

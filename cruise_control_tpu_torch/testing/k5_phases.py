"""Where a call of K5's balancer (``disks.balance_intra_broker`` on the
card) spends its device time, phase by phase, on one GPU.

    python3 -m cruise_control_tpu_torch.testing.k5_phases [SOURCE]

Builds ``SOURCE`` (default: this package's ``csrc/intra_broker.cu``; an
earlier commit's file works too) several times with nvcc and times each
build's two entry points as the wrapper calls them (the grouping, then the
balance with the largest broker's count from a real call): the device time
a call of every kernel, memset and copy, from a torch.profiler trace of 20
calls after five untraced ones. The cumulative builds, each returning
after one more phase:

- ``launch``: every kernel returns at once (the memset of the counts and
  the copy of the input disks stay);
- ``group``: each broker's slots grouped (the parent: counts, their scan
  and the lists by integer atomics; the current design: the load mode's
  pass 1 and the split into each broker's run in flat order);
- ``stage``: each broker's slots staged in shared memory (the parent
  sorts its list back into flat order first);
- ``rounds``: each broker's loop to its fixed point (the sentinel fix-up
  returns at once);
- ``fixup``: the whole source.

A phase's cost is the difference between consecutive builds. Inside the
parent's rounds, each part is timed by a build that runs it twice a
round on top of the whole source (each is idempotent there, and its
barriers keep the compiler from folding the copy away), its cost the
difference from the whole source: ``loads`` (the full refold of the
per-disk loads), ``pressure`` (the shed pressure and the source and
destination disks) and ``pick`` (the heaviest movable replica's block
reduction). The current design's parts are pure warp code that the
compiler would fold when run twice, so a clocked build splits its
rounds instead (below). The
inputs: the JBOD pair at 7k/1M (``7k_1m_rebalance_disk`` with the usage
goal's band, ``7k_1m_remove_disks`` with none, two log dirs a broker) and
the 1k/100k fixture's seeded random placements at D = 4 (band) and D = 8,
10 % of partitions pinned, as ``testing/kernel_times.py --k5-only`` times
them; beside each, the rounds of the broker that ran most, how many
brokers ran more than 8 and how many brokers without a pick sit above a
sentinel slot's owner (their first no-pick round blocks its move there).

For the current design the clocked build reads clock64() around each
part of a round (``cycles_a_round``: the shed pressure, the pick, the
destination's prefix at the moved slot, and the refold's gathering of
the two lists, its chain of adds and the prefixes' scatter), summed by
each broker's warp, as cycles a round of the 50 brokers that ran most
rounds and of all, beside each broker's initial fold.

The builds go under the git-ignored ``_build/phases/``. Prints the card's
name and power limit first, the whole build's ``ptxas -v`` lines, and one
JSON line last. Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

# Each design's kernels: the parent's (the atomics' grouping, a CTA a
# broker) and the current one's (pass 1 and the split, a warp a broker).
_KERNELS = {
    "full refold": ("count_kernel", "scan_kernel", "scatter_kernel",
                    "balance_kernel", "fixup_kernel"),
    "warp a broker": ("load_count_kernel", "load_scan_kernel",
                      "load_scatter_kernel", "split_kernel",
                      "balance_kernel", "fixup_kernel"),
}
_PICK_FROM = "    const int8_t src = static_cast<int8_t>(sh.src);\n"
_PICK_TO = "      sh.red_any[warp] = any;\n    }\n    __syncthreads();\n"
# The parent's design: the loads rebuilt every round by one thread a disk,
# the pressure by thread 0.
_FULL_LOADS = "    disk_loads(st, D, sh);\n    __syncthreads();\n"
_FULL_PRESSURE_FROM = ("    if (threadIdx.x == 0) {\n"
                       "      // Shed pressure; util and the mean over alive "
                       "disks.\n")
_FULL_PRESSURE_TO = ("      sh.ok = (best_v > 1e-9f) && dst_alive && dst != "
                     "src;\n    }\n")
def _at_entry(text: str, names) -> str:
    """``text`` with each named kernel returning at once."""
    for name in names:
        m = re.search(r"__global__[^;{]*?\b" + name + r"\(", text)
        if m is None:
            raise ValueError(f"k5_phases: kernel {name} not in the source")
        brace = text.index("{", m.end())
        text = text[:brace + 1] + "\n  if (1) return;" + text[brace + 1:]
    return text


def _twice(text: str, start: str, end: str) -> str:
    """The block from ``start`` to ``end`` (inclusive) run twice, each
    copy in its own scope (the code after it reads no local of it)."""
    a = text.index(start)
    b = text.index(end, a) + len(end)
    block = "    {\n" + text[a:b] + "    }\n"
    return text[:a] + block * 2 + text[b:]


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"k5_phases: {old!r} not in the source")
    return text.replace(old, new)


def variants(source: str) -> tuple[str, dict[str, str]]:
    """(design, {build: source})."""
    design = "warp a broker" if "split_kernel" in source else "full refold"
    kernels = _KERNELS[design]
    stage_stop = ("  stage_broker(in, sc, b, st);\n"
                  "  const Block none{-1, kNever};\n")
    builds = {
        "launch": _at_entry(source, kernels),
        "group": _at_entry(source, ("balance_kernel", "fixup_kernel")),
        "stage": _at_entry(_replace(source, stage_stop, (
            "  stage_broker(in, sc, b, st);\n  if (1) return;\n"
            "  const Block none{-1, kNever};\n")), ("fixup_kernel",)),
        "rounds": _at_entry(source, ("fixup_kernel",)),
        "fixup": source,
    }
    if design == "full refold":
        builds["loads_twice"] = _replace(source, _FULL_LOADS,
                                         _FULL_LOADS * 2)
        builds["pressure_twice"] = _twice(source, _FULL_PRESSURE_FROM,
                                          _FULL_PRESSURE_TO)
        builds["pick_twice"] = _twice(source, _PICK_FROM, _PICK_TO)
    else:
        builds["clocked"] = clocked(source)
    return design, builds


# The clocked build (the current design only): clock64() read around each
# part of a round, each broker's cycles a part summed by its warp's lane 0
# into a device array (brokers below 8,192), read by cc_k5_clocks.
_CLOCK_PARTS = ("pressure", "pick", "prefix_at", "collect", "chain",
                "scatter", "fold_all", "rounds")
_CLOCK_PRELUDE = """
__device__ unsigned long long cc_cycles[8192][8];
#define CC_TICK(part, since) do { const long long _t = clock64(); \\
  if ((threadIdx.x & 31) == 0 && gridDim.x > 1 && blockIdx.x < 8192) \\
    cc_cycles[blockIdx.x][part] += _t - (since); since = _t; } while (0)
"""
_CLOCK_EDITS = (
    ("  Outcome o{kNever, 0, 0, fold_all(st)};\n",
     "  long long cc_t = clock64();\n"
     "  Outcome o{kNever, 0, 0, fold_all(st)};\n  CC_TICK(6, cc_t);\n"),
    ("    dk = pick_disks(in, dl, o.load);\n",
     "    cc_t = clock64();\n    dk = pick_disks(in, dl, o.load);\n"
     "    CC_TICK(0, cc_t);\n"),
    ("    pk = pick_slot(st, dk.src);\n",
     "    pk = pick_slot(st, dk.src);\n    CC_TICK(1, cc_t);\n"
     "    if ((threadIdx.x & 31) == 0 && gridDim.x > 1 && blockIdx.x < 8192)"
     "\n      cc_cycles[blockIdx.x][7] += 1;\n"),
    ("    __syncwarp();\n    if (lane == 0) st.dsk[j] = "
     "static_cast<int8_t>(dk.dst);\n",
     "    CC_TICK(2, cc_t);\n    __syncwarp();\n    if (lane == 0) "
     "st.dsk[j] = static_cast<int8_t>(dk.dst);\n"),
    ("  const Lists l = collect2(st, j + 1, s, d);\n",
     "  long long cc_t = clock64();\n"
     "  const Lists l = collect2(st, j + 1, s, d);\n  CC_TICK(3, cc_t);\n"),
    ("  __syncwarp();\n  scatter2(st, j + 1, s, d, from_src, d0);\n",
     "  __syncwarp();\n  CC_TICK(4, cc_t);\n"
     "  scatter2(st, j + 1, s, d, from_src, d0);\n  CC_TICK(5, cc_t);\n"),
)
_CLOCK_READER = """
extern "C" int cc_k5_clocks(unsigned long long* out, int reset) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, cc_cycles, sizeof(cc_cycles));
  if (e == cudaSuccess && reset) {
    static unsigned long long zero[8192][8];
    e = cudaMemcpyToSymbol(cc_cycles, zero, sizeof(cc_cycles));
  }
  return static_cast<int>(e);
}
"""


def clocked(source: str) -> str:
    """The current design's source with its rounds clocked by part."""
    text = source.replace("namespace {\n", _CLOCK_PRELUDE + "namespace {\n",
                          1)
    for old, new in _CLOCK_EDITS:
        text = _replace(text, old, new)
    return text + _CLOCK_READER


def _clock_split(lib, fn, b: int) -> dict:
    """Cycles a round by part, of the 50 brokers that ran most rounds and
    of all (one call after a reset)."""
    import numpy as np
    lib.cc_k5_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = np.zeros((8192, 8), np.uint64)
    fn()
    lib.cc_k5_clocks(buf.ctypes.data, 1)
    fn()
    if lib.cc_k5_clocks(buf.ctypes.data, 1) != 0:
        raise RuntimeError("k5_phases: reading the clocks failed")
    cyc = buf[:min(b, 8192)].astype(np.float64)
    rounds = np.maximum(cyc[:, 7], 1.0)
    top = np.argsort(-cyc[:, 7], kind="stable")[:50]
    out = {}
    for who, rows in (("top50", top), ("all", slice(None))):
        per = cyc[rows, :6].sum(axis=0) / rounds[rows].sum()
        out[who] = dict(zip(_CLOCK_PARTS[:6], np.round(per, 1).tolist()))
        out[who]["fold_all_per_broker"] = round(float(
            cyc[rows, 6].mean()), 1)
        out[who]["rounds"] = float(cyc[rows, 7].sum())
    return out


def _cases(dev):
    import torch

    from ..analyzer.goals.intra_broker import (
        IntraBrokerDiskUsageDistributionGoal)
    from ..model import disks as disks_mod
    from ..model.tensors import cluster_to_numpy
    from . import (build_fixture, entry_disks, load_reference_outcomes,
                   random_placement_disks)
    refs = load_reference_outcomes()
    band = IntraBrokerDiskUsageDistributionGoal()._band()
    jb_state, _m = build_fixture(refs["7k_1m_rebalance_disk"], dev)
    jb = cluster_to_numpy(jb_state)
    cases = {entry.replace("7k_1m_", "7k_1m_d2_"): (
        jb_state, disks_mod.disks_from_numpy(entry_disks(refs[entry], jb),
                                             dev), b_, None)
        for entry, b_ in (("7k_1m_rebalance_disk", band),
                          ("7k_1m_remove_disks", None))}
    rp_state, _m = build_fixture(refs["1k_100k"], dev)
    rp = cluster_to_numpy(rp_state)
    for num_disks, b_, seed in ((4, band, 4), (8, None, 8)):
        dk, mv = random_placement_disks(rp["assignment"],
                                        rp["partition_mask"],
                                        rp["capacity"][:, 3], num_disks, seed)
        cases[f"1k_100k_d{num_disks}_random_placement"] = (
            rp_state, disks_mod.disks_from_numpy(dk, dev), b_,
            torch.as_tensor(mv, device=dev))
    return cases


def _facts(state, disks, band, movable) -> dict:
    """The package's own call: the largest broker, the rounds and the
    brokers without a pick above a sentinel slot's owner."""
    import torch

    from ..model import disks as disks_mod
    disks_mod.balance_intra_broker(state, disks, 0.8, band, 64, movable)
    last = disks_mod.LAST_CALL
    rounds = last["rounds"].cpu()
    kinds = last["no_pick_kind"].cpu()
    p, s = state.assignment.shape
    flat = state.assignment.reshape(-1).cpu()
    owners = [int(flat[f]) for f in disks_mod.sentinel_slots(p, s)]
    blocking = {}
    for kind, code, owner in (("pinned", 1, owners[0]),
                              ("empty", 2, owners[1])):
        above = (kinds == code) & (torch.arange(kinds.shape[0]) > owner)
        blocking[kind] = int(above.sum()) if owner >= 0 else 0
    return dict(most=int(last["max_replicas_per_broker"]),
                rounds_max=int(rounds.max()),
                brokers_above_8_rounds=int((rounds > 8).sum()),
                sentinel_owners=owners, blocking=blocking)


def _bind(lib, design, state, disks, band, movable, most, dev):
    """(one call of the build's two entry points, what it keeps alive)."""
    import numpy as np
    import torch

    from ..common.resources import Resource
    from ..model.tensors import replica_load_column
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cc_intra_broker_scratch_words.argtypes = [ctypes.c_longlong, i]
    lib.cc_intra_broker_scratch_words.restype = ctypes.c_longlong
    group_args = 3 if design == "warp a broker" else 2
    lib.cc_intra_broker_group.argtypes = [vp] * group_args + [i] * (
        group_args + 1) + [vp, vp]
    lib.cc_intra_broker_balance.argtypes = [vp] * 7 + [i] * 5 + [f, f] \
        + [i] * 2 + [vp] * 4
    p, s = state.assignment.shape
    b, d = disks.disk_capacity.shape
    load = replica_load_column(state, int(Resource.DISK)).contiguous()
    mv = (movable if movable is not None
          else torch.ones(p, dtype=torch.bool, device=dev)).contiguous()
    ins = (state.assignment, state.partition_mask, load, mv,
           disks.disk_assignment, disks.disk_capacity, disks.disk_alive)
    scratch = torch.empty(lib.cc_intra_broker_scratch_words(p * s, b),
                          dtype=torch.int32, device=dev)
    out_assign = torch.empty_like(disks.disk_assignment)
    out_load = torch.empty((b, d), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    upper = float(np.float32(band[1])) if band is not None else 0.0

    group = ((ins[0].data_ptr(), ins[1].data_ptr(), ins[4].data_ptr(), p, s,
              b, d) if group_args == 3
             else (ins[0].data_ptr(), ins[1].data_ptr(), p, s, b))

    def call():
        code = lib.cc_intra_broker_group(*group, scratch.data_ptr(), stream)
        if code == 0:
            code = lib.cc_intra_broker_balance(
                *[x.data_ptr() for x in ins], p, s, b, d, most,
                float(np.float32(0.8)), upper, int(band is not None), 64,
                out_assign.data_ptr(), out_load.data_ptr(),
                scratch.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"k5_phases: entry point returned {code}")

    return call, (ins, scratch, out_assign, out_load)


def _device_ms(fn, reps: int = 20) -> float:
    """Device time a call of every kernel, memset and copy ``fn`` makes."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=2, active=reps)) as prof:
        for _ in range(3 + reps):
            fn()
            torch.cuda.synchronize()
            prof.step()
    total = 0.0
    for e in prof.key_averages():
        if e.count and str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            total += us
    return total / reps / 1e3


def main() -> int:
    import torch

    from .. import kernels
    if not torch.cuda.is_available():
        print("k5_phases needs a CUDA device", file=sys.stderr)
        return 2
    source = Path(sys.argv[1]) if len(sys.argv) > 1 else \
        kernels.CSRC / "intra_broker.cu"
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    design, builds = variants(source.read_text())
    out_dir = kernels.BUILD_DIR / "phases" / \
        f"k5_{design.replace(' ', '_')}"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in builds.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        lib = out_dir / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    dev = torch.device("cuda")
    cases = _cases(dev)
    facts = {name: _facts(*case) for name, case in cases.items()}
    times = {name: {} for name in cases}
    clocks = {}
    for name, (lib_path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return proc.returncode
        if name == "fixup":
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "stack" in line:
                    print(f"  ptxas: {line.strip()}")
        lib = ctypes.CDLL(str(lib_path))
        for case, (st, dk, band, mv) in cases.items():
            fn, _keep = _bind(lib, design, st, dk, band, mv,
                              facts[case]["most"], dev)
            if name == "clocked":
                clocks[case] = _clock_split(lib, fn, st.num_brokers)
            else:
                times[case][name] = _device_ms(fn)
    phases = {}
    order = ("launch", "group", "stage", "rounds", "fixup")
    for case, t in times.items():
        ph = {n: t[n] - (t[order[q - 1]] if q else 0.0)
              for q, n in enumerate(order)}
        for part in ("loads", "pressure", "pick"):
            if f"{part}_twice" in t:
                ph[f"rounds.{part}"] = t[f"{part}_twice"] - t["fixup"]
        phases[case] = ph
    print(json.dumps({"kernel": "k5", "design": design, "source": str(source),
                      "facts": facts, "device_ms_through": times,
                      "phase_ms": phases,
                      "cycles_a_round": clocks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

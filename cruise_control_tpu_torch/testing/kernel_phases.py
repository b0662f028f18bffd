"""Where a call of K8 (``swap_top_replicas``) or of K2's leadership mode
(``select_leadership``) spends its device time, phase by phase, on one
GPU.

    python3 -m cruise_control_tpu_torch.testing.kernel_phases k8 [SOURCE]
    python3 -m cruise_control_tpu_torch.testing.kernel_phases k2l [SOURCE]

Builds ``SOURCE`` (default: this package's ``csrc/swap_select.cu`` or
``csrc/select_leadership.cu``; K8's file of an earlier commit works too)
several times with nvcc, each build returning after one more of its
kernel's phases, and times each build's entry point: the device time a
call of its kernels and memsets, from a torch.profiler trace of 50 calls
after eight untraced ones (host launch costs do not enter). A phase's cost
is the difference between consecutive builds. The inputs:

- K8: one eager swap round of DiskUsageDistributionGoal (every earlier
  goal of the default chain prior) at 1k/100k and at 7k/1M;
- K2's leadership mode: DiskUsageDistributionGoal's round scores and
  weights with the offline override (``k2_round_inputs``) at k = 2,048 on
  the 1k/100k fixture (the cap) and at 7k/1M with the last 50 brokers
  DEAD.

The phases:

- K8 of one memset, 528 CTAs and a ticket (``SwapState``): ``launch`` (the
  memset, the launch and the lists' set-up), ``stream`` (the assignment
  read, each slot compared with one broker), ``membership`` (each slot
  compared with the 2k brokers, hits inserted), ``merge`` (each CTA's
  lists into the global ones by atomicMax chains), ``tail`` (the ticket
  and the last CTA's outputs);
- K8's cooperative design: ``launch`` (an empty kernel), ``stream`` (the
  filter's set-up, the assignment read, each slot's filter lookup and the
  hits buffered), ``hits`` (the buffered hits folded into each entry's
  top keys, and each CTA's lists written), ``merge`` (the grid barrier
  and the merge, a CTA an entry), ``tail`` (the outputs and the padding);
- K2's leadership mode: ``launch`` (an empty kernel), ``keys`` (the keys,
  the top digit's histogram, the zeroing and its grid barrier), ``passes``
  (the digit passes, a grid barrier each), ``collect`` (the buffer, the tie
  counts, the padding and their grid barrier), ``ties`` (the ties
  written), ``rank`` (the buffered keys ranked and written).

The builds go under the git-ignored ``_build/phases/``. Prints the card's
name and power limit first, the full build's ``ptxas -v`` lines, and one
JSON line last. Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

# (phase, ((text, replacement), ...)): the edits of each build, in order;
# a last build, the source as it is, takes the last phase's name.
_K8_TICKET_STOPS = (
    ("launch", (("  const int tile = kThreads * kItems;\n  for (int base",
                 "  if (1) return;\n  const int tile = kThreads * kItems;\n"
                 "  for (int base"),)),
    ("stream", (("      for (int e = 0; e < entries; ++e) hit = hit || "
                 "brokers[e] == a[r];",
                 "      hit = brokers[0] == a[r];"),
                ("  __syncthreads();\n  for (int t = threadIdx.x; t < entries",
                 "  if (1) return;\n  __syncthreads();\n"
                 "  for (int t = threadIdx.x; t < entries"))),
    ("membership", (("  __syncthreads();\n  for (int t = threadIdx.x; t < "
                     "entries",
                     "  if (1) return;\n  __syncthreads();\n"
                     "  for (int t = threadIdx.x; t < entries"),)),
    ("merge", (("  __threadfence();\n  __syncthreads();\n  if (threadIdx.x == 0)"
                "\n    last = atomicAdd(&st->ticket",
                "  if (1) return;\n  __threadfence();\n  __syncthreads();\n"
                "  if (threadIdx.x == 0)\n    last = atomicAdd(&st->ticket"),)),
    ("tail", ()),
)
_K8_STOPS = (
    ("launch", (("  phase_setup(g, sm);\n  phase_stream(g, sm",
                 "  if (1) return;\n  phase_setup(g, sm);\n"
                 "  phase_stream(g, sm"),)),
    ("stream", (("  const int n = static_cast<int>(sm.count);",
                 "  const int n = 0;"),
                ("  cg::this_grid().sync();\n  // [merge]",
                 "  if (1) return;\n  cg::this_grid().sync();\n  // [merge]"))),
    ("hits", (("  cg::this_grid().sync();\n  // [merge]",
               "  if (1) return;\n  cg::this_grid().sync();\n  // [merge]"),)),
    ("merge", (("    // [tail]\n    if (lane < g.j)",
                "    if (false && lane < g.j)"),)),
    ("tail", ()),
)
_K2L_STOPS = (
    ("launch", (("  phase_keys(a, s, c, sm);\n  grid.sync();",
                 "  if (1) return;\n  phase_keys(a, s, c, sm);\n"
                 "  grid.sync();"),)),
    ("keys", (("  grid.sync();\n  for (int pass = 0;",
               "  grid.sync();\n  if (1) return;\n  for (int pass = 0;"),)),
    ("passes", (("  phase_collect(a, s, c, sm);\n  if (sm.sel.need",
                 "  if (1) return;\n  phase_collect(a, s, c, sm);\n"
                 "  if (sm.sel.need"),)),
    ("collect", (("  phase_ties(a, s, c, sm);\n  phase_rank(",
                  "  if (1) return;\n  phase_ties(a, s, c, sm);\n"
                  "  phase_rank("),)),
    ("ties", (("  phase_rank(a, s, c, sm);\n}",
               "  if (1) return;\n  phase_rank(a, s, c, sm);\n}"),)),
    ("rank", ()),
)


def variants(kernel: str, source: str) -> tuple[str, dict[str, str]]:
    """(design, {phase: source}): each phase's build returns after it."""
    if kernel == "k2l":
        design, stops = "cooperative", _K2L_STOPS
    elif "SwapState" in source:
        design, stops = "ticket", _K8_TICKET_STOPS
    else:
        design, stops = "cooperative", _K8_STOPS
    out = {}
    for name, edits in stops:
        text = source
        for old, new in edits:
            if old not in text:
                raise ValueError(f"kernel_phases: {old!r} not in the source")
            text = text.replace(old, new, 1)
        out[name] = text
    return design, out


def _k8_calls(dev, refs):
    from . import build_fixture, k6_goals, k8_round_inputs
    calls = {}
    for entry in ("1k_100k", "7k_1m"):
        state, meta = build_fixture(refs[entry], dev)
        goals = k6_goals("default", state.num_brokers)
        active = [g.name for g in goals].index("DiskUsageDistributionGoal")
        st, weight, src_b, dst_b, j = k8_round_inputs(state, goals, active,
                                                      meta.num_topics)
        calls[entry] = (st, weight, src_b, dst_b, j)
    return calls


def _k2l_calls(dev, refs):
    import torch

    from ..model.tensors import set_broker_state
    from . import build_fixture, k2_round_inputs
    calls = {}
    for entry, name in (("1k_100k", "1k_100k_cap"),
                        ("7k_1m", "7k_1m_dead50")):
        state, meta = build_fixture(refs[entry], dev)
        if entry == "7k_1m":
            b = state.num_brokers
            state = set_broker_state(state, torch.arange(b - 50, b), 1)
        score, weight = k2_round_inputs(state, meta.num_topics)
        calls[name] = (state, score, weight)
    return calls


def _bind(kernel: str, design: str, lib, call, dev):
    """(a function that makes one call of the build's entry point, the
    tensors it reads and writes)."""
    import torch
    vp, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel == "k8":
        st, weight, src_b, dst_b, j = call
        p, s = st.assignment.shape
        k = src_b.shape[0]
        fn = lib.cc_swap_top_replicas
        fn.argtypes = [vp] * 4 + [i] * 4 + [vp] * 4
        size = lib.cc_swap_top_replicas_scratch_bytes
        size.restype = ctypes.c_longlong
        size.argtypes = [] if design == "ticket" else [i, i]
        nbytes = size() if design == "ticket" else size(p, s)
        brokers = torch.cat([src_b, dst_b]).to(torch.int32)
        outs = (torch.empty((2, k, j), dtype=torch.int32, device=dev),
                torch.empty((2, k, j), dtype=torch.bool, device=dev))
        ins = (weight, st.assignment, st.partition_mask, brokers)
        args = [t.data_ptr() for t in ins] + [p, s, k, j] \
            + [t.data_ptr() for t in outs]
    else:
        st, score, weight = call
        p, s = st.assignment.shape
        k = 2048
        fn = lib.cc_select_leadership
        fn.argtypes = [vp] * 5 + [i] * 4 + [vp] * 4
        size = lib.cc_select_leadership_scratch_bytes
        size.restype = ctypes.c_longlong
        size.argtypes = [i, i]
        nbytes = size(p, k)
        outs = (torch.empty(k, dtype=torch.float32, device=dev),
                torch.empty(k, dtype=torch.int32, device=dev))
        ins = (weight, score, st.assignment, st.partition_mask,
               st.leader_slot)
        args = [t.data_ptr() for t in ins] + [p, s, st.num_brokers, k] \
            + [t.data_ptr() for t in outs]
    scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=dev)
    args += [scratch.data_ptr(), stream]
    # The tensors behind the pointers, kept alive by the caller.
    return (lambda: fn(*args)), (ins, outs, scratch)


def _device_ms(fn, reps: int = 50) -> float:
    """Device time a call of every kernel and memset ``fn`` launches."""
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
    from . import load_reference_outcomes
    if len(sys.argv) < 2 or sys.argv[1] not in ("k8", "k2l"):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    kernel = sys.argv[1]
    if not torch.cuda.is_available():
        print("kernel_phases needs a CUDA device", file=sys.stderr)
        return 2
    source = Path(sys.argv[2]) if len(sys.argv) > 2 else kernels.CSRC / (
        "swap_select.cu" if kernel == "k8" else "select_leadership.cu")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    design, builds = variants(kernel, source.read_text())
    out_dir = kernels.BUILD_DIR / "phases" / f"{kernel}_{design}"
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
    refs = load_reference_outcomes()
    calls = (_k8_calls if kernel == "k8" else _k2l_calls)(dev, refs)
    times = {entry: {} for entry in calls}
    last = list(builds)[-1]
    for name, (lib_path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return proc.returncode
        if name == last:
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "stack" in line:
                    print(f"  ptxas: {line.strip()}")
        lib = ctypes.CDLL(str(lib_path))
        for entry, call in calls.items():
            fn, _keep = _bind(kernel, design, lib, call, dev)

            def checked(fn=fn, name=name):
                kernels.check(fn(), name)
            times[entry][name] = _device_ms(checked)
    phases = {}
    for entry, by_build in times.items():
        names = list(by_build)
        phases[entry] = {n: by_build[n] - (by_build[names[q - 1]] if q
                                           else 0.0)
                         for q, n in enumerate(names)}
    print(json.dumps({"kernel": kernel, "design": design,
                      "source": str(source), "device_ms_through": times,
                      "phase_ms": phases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

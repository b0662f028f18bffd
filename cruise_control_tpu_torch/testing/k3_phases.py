"""Where a K3 (``select_batch``) call's device time goes, phase by phase,
on one GPU.

    python3 -m cruise_control_tpu_torch.testing.k3_phases [SOURCE]

Builds ``SOURCE`` (default: this package's ``csrc/select_batch.cu``)
seven times with nvcc, each build returning from the select kernel after
one more of its phases (after the quarter sorts, after the ranks, after
the gather, the dedupe, has_earlier, the grouping's order, and the whole
kernel), and times each build's entry point on K3's inputs at the 1k/100k
cap (the inputs one eager round of ReplicaDistributionGoal gives it with
2,048 sources and 250 destinations: 4,096 reduced rows, m = 2,048): CUDA
events around 100 calls after five untimed ones, the reduce launch
included. A phase's cost is the difference between consecutive builds.
The builds go under the git-ignored ``_build/k3_phases/``. Prints the
card's name and power limit first, each build's ``ptxas -v`` lines, and
one JSON line last. Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

# (the line a stop goes before or after, the stop's name), in order.
_STOPS = (
    ("  cluster.sync();\n  phase_rank(L, c);", "quarter_sorts"),
    ("  phase_select(q, L, c, records);\n}", "ranks"),
    ("  // 4. partition dedupe", "gather"),
    ("  // 5. has_earlier", "dedupe"),
    ("  // 6. this grouping's order", "has_earlier"),
    ("  // 7. the blocked scans", "group_order"),
)


def variants(source: str) -> dict[str, str]:
    """{stop name: source} with a return before each marker line, and the
    whole kernel under "scans"."""
    out = {}
    for n, (marker, name) in enumerate(_STOPS, 1):
        if marker not in source:
            raise ValueError(f"k3_phases: marker {marker!r} not in the source")
        out[name] = source.replace(marker, f"  if ({n}) return;\n{marker}", 1)
    out["scans"] = source
    return out


def main() -> int:
    import torch

    from .. import kernels
    from ..analyzer import agg, chain, search
    from ..analyzer.constraint import BalancingConstraint
    from ..analyzer.search import ExclusionMasks, SearchConfig
    from . import build_fixture, k6_goals, load_reference_outcomes
    if not torch.cuda.is_available():
        print("k3_phases needs a CUDA device", file=sys.stderr)
        return 2
    source = Path(sys.argv[1]) if len(sys.argv) > 1 else \
        kernels.CSRC / "select_batch.cu"
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    out_dir = kernels.BUILD_DIR / "k3_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(source.read_text()).items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        lib = out_dir / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    dev = torch.device("cuda")
    state, meta = build_fixture(load_reference_outcomes()["1k_100k"], dev)
    goals = k6_goals("default", state.num_brokers)
    active = [g.name for g in goals].index("ReplicaDistributionGoal")
    calls = []
    orig = search.select_batch

    def record(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)

    search.select_batch = record
    try:
        chain._chain_round_body(
            state, agg.compute_agg(state, meta.num_topics), active,
            [j < active for j in range(len(goals))], goals,
            BalancingConstraint(),
            SearchConfig(num_sources=2048, num_dests=250,
                         moves_per_round=2048),
            meta.num_topics, ExclusionMasks())
    finally:
        search.select_batch = orig
    params, _buffers = search.select_batch_params(*calls[0][0],
                                                  **calls[0][1])
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = {}
    for name, (lib_path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return proc.returncode
        if name == "scans":
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas: {line.strip()}")
        lib = ctypes.CDLL(str(lib_path))
        lib.cc_select_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        for _ in range(5):
            kernels.check(lib.cc_select_batch(ctypes.byref(params), stream),
                          name)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(100):
            lib.cc_select_batch(ctypes.byref(params), stream)
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end) / 100
    names = list(times)
    print(json.dumps({"ms_through": times, "phase_ms": {
        n: times[n] - (times[names[i - 1]] if i else 0.0)
        for i, n in enumerate(names)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

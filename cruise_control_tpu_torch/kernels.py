"""Build, load and count the hand-written Hopper kernels.

Each ``csrc/*.cu`` file is one kernel family with a plain C interface. At
first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library
under ``_build/`` (git-ignored, keyed by the content hash of the source
and of the ``csrc/*.cuh`` headers) and
loaded with ``ctypes``. Every C entry point launches on the stream it is
given, allocates nothing, never synchronises, and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.

``LAUNCHES`` counts, per kernel name, the wrapper calls that launched the
kernel (never the plain-PyTorch twin); a run resets it to show that its
path went through the kernels. K1's two modes count apart:
``segment_reduce`` (full) and ``segment_reduce_offline``; so do K5's:
``intra_broker`` (the balancer) and ``intra_broker_load`` (per-disk
loads, its own entry ``cc_intra_broker_load``). K6 counts as
``score_grid`` (the candidate grid: a panel launch and a row launch); the
joint recheck of a selected batch runs in K3's select kernel
(``select_batch``), which reads the goal table through
``csrc/goal_accept.cuh`` as K6 does. K2's leadership mode, a source of
its own (``select_leadership.cu``), counts as ``select_leadership``. K7 counts as
``slot_weights`` (its call also counts the round's offline replicas
per broker, so the move round no longer runs K1's offline mode) and K8 as
``swap_top_replicas``. The direct-assignment transport's kernels count
as ``direct_sort`` (KD1), ``segment_scan`` (KD2), ``direct_plan`` (KD3)
and ``direct_fill`` (KD4). A wrapper
called while a CUDA graph captures launches nothing then: the capture
(``utils/graphs.py``) takes those calls out of ``LAUNCHES``, keeps them as
the graph's launches and adds them back at every replay, so the counts
stay true under replay.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("segment_reduce", "select_sources", "select_leadership",
           "select_batch", "apply_deltas", "intra_broker", "score_grid",
           "slot_pass", "swap_select", "direct_sort", "segment_scan",
           "direct_plan", "direct_fill")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_VP = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns {name: ptxas report} for the libraries built now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


_SIGNATURES = {
    "segment_reduce": {
        "cc_segment_reduce_full": [_VP] * 6 + [_I] * 4 + [_VP] * 7
        + [ctypes.c_longlong, _VP],
        "cc_segment_reduce_offline": [_VP] * 4 + [_I] * 3 + [_VP] * 3,
        "cc_segment_reduce_scratch_words": ([ctypes.c_longlong, _I],
                                            ctypes.c_longlong),
    },
    "select_sources": {
        "cc_select_sources": [_VP] * 4 + [_I] * 5 + [_VP] * 5,
        "cc_select_sources_scratch_bytes": ([_I, _I], ctypes.c_longlong),
    },
    "select_leadership": {
        "cc_select_leadership": [_VP] * 5 + [_I] * 4 + [_VP] * 4,
        "cc_select_leadership_scratch_bytes": ([_I, _I], ctypes.c_longlong),
    },
    "select_batch": {
        "cc_select_batch": [_VP, _VP, _VP],
        "cc_select_batch_params_bytes": ([], ctypes.c_longlong),
        "cc_select_batch_smem_bytes": [_I, _I],
    },
    "apply_deltas": {
        "cc_apply_deltas": [_VP] * 15 + [_I] * 3 + [_VP] * 6 + [_VP],
    },
    "intra_broker": {
        "cc_intra_broker_scratch_words": ([ctypes.c_longlong, _I],
                                          ctypes.c_longlong),
        "cc_intra_broker_max_offset": ([_I], ctypes.c_longlong),
        "cc_intra_broker_group": [_VP] * 3 + [_I] * 4 + [_VP, _VP],
        "cc_intra_broker_balance": [_VP] * 7 + [_I] * 5
        + [ctypes.c_float] * 2 + [_I] * 2 + [_VP] * 4,
        "cc_intra_broker_load_scratch_words": ([ctypes.c_longlong, _I],
                                               ctypes.c_longlong),
        "cc_intra_broker_load": [_VP] * 4 + [_I] * 4 + [_VP] * 2
        + [ctypes.c_longlong, _VP],
    },
    "score_grid": {
        "cc_score_grid": [_VP, _VP],
        "cc_score_grid_max_goals": ([], _I),
        "cc_score_grid_params_bytes": ([], ctypes.c_longlong),
    },
    "slot_pass": {
        "cc_slot_weights": [_VP, _VP],
        "cc_slot_weights_params_bytes": ([], ctypes.c_longlong),
        "cc_slot_weights_scratch_head": ([], _I),
    },
    "swap_select": {
        "cc_swap_top_replicas": [_VP] * 4 + [_I] * 4 + [_VP] * 4,
        "cc_swap_top_replicas_scratch_bytes": ([_I, _I], ctypes.c_longlong),
    },
    "direct_sort": {
        "cc_direct_sort": [_VP, _VP, _I, _I] + [_VP] * 4,
        "cc_direct_sort_scratch_bytes": ([_I], ctypes.c_longlong),
    },
    "segment_scan": {
        "cc_segment_scan": [_VP, _VP],
        "cc_segment_scan_params_bytes": ([], ctypes.c_longlong),
        "cc_segment_scan_scratch_bytes": ([ctypes.c_longlong, _I],
                                          ctypes.c_longlong),
    },
    "direct_plan": {
        "cc_direct_plan": [_VP, _VP],
        "cc_direct_plan_params_bytes": ([], ctypes.c_longlong),
        "cc_direct_plan_smem_bytes": ([_I], ctypes.c_longlong),
        "cc_direct_plan_max_brokers": ([], _I),
    },
    "direct_fill": {
        "cc_direct_fill": [_VP] * 4 + [_I] * 3 + [_VP] * 3,
    },
}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel family ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            for fn, sig in _SIGNATURES[name].items():
                argtypes, restype = sig if isinstance(sig, tuple) \
                    else (sig, ctypes.c_int)
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


# What each kernel takes beyond matching shapes (csrc/*.cu).
LIMITS = {
    "segment_reduce": "P*S < 2**31 slots and, in full mode, B <= 16384 "
                      "brokers (two [B] histograms in shared memory)",
    "select_sources": "half <= 2048 global rows (k_src = 2048 at any B), "
                      "B <= 16384 brokers and 0 < P*S < 2**31",
    "select_leadership": "k_l <= 2048 rows (one CTA's shared memory "
                         "ranks them) and 0 < P*S < 2**31; any broker "
                         "count",
    "select_batch": "<= 4096 reduced rows (move + leadership), "
                    "1 <= m <= 2048 and B < 2**20 brokers; with the joint "
                    "recheck, the goal table's limits (score_grid's)",
    "apply_deltas": "m <= 2048 rows (2m events in one block's radix sort) "
                    "and B < 2**19 brokers",
    "intra_broker": "<= 8192 replicas on one broker (one warp's shared "
                    "memory), D <= 32 disks a broker, B <= 2**20 brokers and "
                    "0 < P*S < 2**31",
    "intra_broker_load": "D <= 32 disks a broker, B <= 2**20 brokers and "
                         "0 < P*S < 2**31 (any number of replicas on one "
                         "broker)",
    "score_grid": "<= 24 goals in the table (prior and active; the "
                  "parameters are passed by value), S <= 64 slots, "
                  "0 < P*S < 2**31 and fewer than 2**31 rows",
    "slot_weights": "S <= 16 slots a partition (one thread holds a "
                    "partition's slots in registers and compares them "
                    "pairwise) and 0 < P*S < 2**31; any broker count",
    "swap_top_replicas": "k <= 8 brokers a side, j <= 4 replicas a "
                         "broker, j <= P*S < 2**31 and the assignment "
                         "16-byte aligned (16-byte loads)",
    "direct_sort": "0 < N < 2**31 - 4096 elements and keys in [0, 2**31); "
                   "the passes over the key follow its largest value",
    "segment_scan": "0 < N < 2**29 elements, R <= 4 value columns, at most "
                    "12 checks a call and checks on f32 values only",
    "direct_plan": "0 < G < 2**20 groups, 0 < B <= 16816 brokers (a row's "
                   "planes in one CTA's shared memory) and G*B < 2**31",
    "direct_fill": "0 < n < 2**31 movers, 0 < B < 2**30 brokers and "
                   "G*B < 2**31",
}


def require(t, device, dtype, shape, name: str, kernel: str):
    """Validate one argument of ``kernel``: device, dtype, shape,
    contiguity. A shape error names the kernel's limits too."""
    where = f"{kernel} kernel: {name}"
    if t.device != device:
        raise ValueError(f"{where}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{where}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{where}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)} (its limits: {LIMITS[kernel]})")
    if not t.is_contiguous():
        raise ValueError(f"{where}: not contiguous")
    return t


def requirer(kernel: str):
    """``require`` bound to one kernel's name."""
    return functools.partial(require, kernel=kernel)


def limit_error(kernel: str, detail: str) -> ValueError:
    """The error a wrapper raises for sizes beyond ``kernel``'s limits."""
    return ValueError(f"{kernel} kernel: {detail}; its limits are "
                      f"{LIMITS[kernel]}")

"""Build, load and count the hand-written Hopper kernels.

Each ``csrc/*.cu`` file is one kernel family with a plain C interface. At
first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library
under ``_build/`` (git-ignored, keyed by the source's content hash) and
loaded with ``ctypes``. Every C entry point launches on the stream it is
given, allocates nothing, never synchronises, and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.

``LAUNCHES`` counts, per kernel name, the wrapper calls that launched the
kernel (never the plain-PyTorch twin); a run resets it to show that its
path went through the kernels. K1's two modes count apart:
``segment_reduce`` (full) and ``segment_reduce_offline``; so do K5's:
``intra_broker`` (the balancer) and ``intra_broker_load`` (per-disk
loads, its own entry ``cc_intra_broker_load``); so do K6's:
``score_grid`` (the candidate grid: a panel launch and a row launch) and
``score_grid_recheck`` (the joint recheck of a selected batch); and K2's
leadership mode counts as ``select_sources_leadership``. K7 counts as
``slot_weights`` and K8 as ``swap_top_replicas``. A wrapper
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
SOURCES = ("segment_reduce", "select_sources", "select_batch",
           "apply_deltas", "intra_broker", "score_grid", "slot_pass",
           "swap_select")
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
    common = (CSRC / "common.cuh").read_bytes()
    digest = hashlib.sha1(src + common + " ".join(NVCC_FLAGS).encode()
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
        "cc_select_leadership": [_VP] * 5 + [_I] * 4 + [_VP] * 4,
        "cc_select_leadership_scratch_bytes": ([_I], ctypes.c_longlong),
    },
    "select_batch": {
        "cc_select_batch": [_VP] * 9 + [_I] * 6 + [_VP] * 6
        + [ctypes.c_longlong, _VP],
        "cc_select_batch_scratch_bytes": ([_I, _I], ctypes.c_longlong),
    },
    "apply_deltas": {
        "cc_apply_deltas": [_VP] * 15 + [_I] * 3 + [_VP] * 6 + [_VP],
    },
    "intra_broker": {
        "cc_intra_broker_scratch_words": ([ctypes.c_longlong, _I],
                                          ctypes.c_longlong),
        "cc_intra_broker_max_offset": ([_I], ctypes.c_longlong),
        "cc_intra_broker_group": [_VP, _VP] + [_I] * 3 + [_VP, _VP],
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
    },
    "swap_select": {
        "cc_swap_top_replicas": [_VP] * 4 + [_I] * 4 + [_VP] * 4,
        "cc_swap_top_replicas_scratch_bytes": ([], ctypes.c_longlong),
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
                      "in leadership mode k_l <= 2048 rows, "
                      "B <= 16384 brokers and 0 < P*S < 2**31",
    "select_batch": "<= 4096 reduced rows (move + leadership) and "
                    "1 <= m <= 2048",
    "apply_deltas": "m <= 2048 rows (2m events in one block's radix sort) "
                    "and B < 2**19 brokers",
    "intra_broker": "<= 8192 replicas on one broker (one CTA's shared "
                    "memory), D <= 32 disks a broker, B <= 2**20 brokers and "
                    "0 < P*S < 2**31",
    "intra_broker_load": "D <= 32 disks a broker, B <= 2**20 brokers and "
                         "0 < P*S < 2**31 (any number of replicas on one "
                         "broker)",
    "score_grid": "<= 24 goals in the table (prior and active; the "
                  "parameters are passed by value), S <= 64 slots, "
                  "0 < P*S < 2**31 and fewer than 2**31 rows",
    "slot_weights": "S <= 16 slots a partition (one thread compares a "
                    "partition's slots pairwise) and 0 < P*S < 2**31",
    "swap_top_replicas": "k <= 8 brokers a side, j <= 4 replicas a "
                         "broker and j <= P*S < 2**31",
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

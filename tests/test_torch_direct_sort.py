"""KD1 (``csrc/direct_sort.cu``) built as host C++ against its twin
(``direct_kernels.sort_pairs_plain``) on the CPU.

The source compiles without ``__CUDACC__`` (g++, ``-ffp-contract=off``):
the count launch's phases run over its CTAs in turn between the grid
barriers, and each pass ranks its tiles one after the other with one
"thread" in index order, so every look-back finds the tiles before it
published. That holds the design the card runs -- the digit histograms
of every pass taken in one read, the trivial passes skipped and routed
around, each digit's first output position, the tiles' look-back offsets,
the reorder through shared memory and the scatter -- to the twin, exact,
on ``testing.kd1_case``'s edge cases at N = 1, 2,047, 2,049, one tile of
4,096 and one either side, and 100,003, with and without the second key.
The card runs the same cases in ``tests/test_torch_direct_cuda.py``.
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer import direct_kernels as dk
from cruise_control_tpu_torch.testing import KD1_CASES, KD1_SIZES, kd1_case


@functools.lru_cache(maxsize=1)
def _host_library(tmp_dir):
    out = f"{tmp_dir}/libdirect_sort_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-x", "c++",
                    str(kernels.CSRC / "direct_sort.cu"), "-o", out],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(out)
    lib.cc_direct_sort_host.argtypes = [ctypes.c_void_p] * 2 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    return lib


@pytest.fixture
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler")
    return _host_library(str(tmp_path_factory.getbasetemp()))


def host_sort(lib, key, key_max, second=None, ctas=1):
    """KD1 built for the host: (sorted key, perm)."""
    n = key.shape[0]
    sorted_key = torch.empty(n, dtype=torch.int32)
    perm = torch.empty(n, dtype=torch.int32)
    assert lib.cc_direct_sort_host(
        key.data_ptr(), None if second is None else second.data_ptr(), n,
        dk.key_bits(key_max), sorted_key.data_ptr(), perm.data_ptr(),
        ctas) == 0
    return sorted_key, perm


@pytest.mark.parametrize("name", KD1_CASES)
@pytest.mark.parametrize("n", KD1_SIZES)
def test_kernel_built_for_the_host_equals_the_twin(lib, name, n):
    key, sec, key_max = kd1_case(name, n)
    kt, st = torch.from_numpy(key), torch.from_numpy(sec)
    for second in (st, None):
        want_k, want_p = dk.sort_pairs_plain(kt, second)
        for ctas in (1, 7):
            got_k, got_p = host_sort(lib, kt, key_max, second, ctas)
            what = f"{name} n={n} second={second is not None} ctas={ctas}"
            np.testing.assert_array_equal(got_p.numpy(), want_p.numpy(),
                                          err_msg=what)
            np.testing.assert_array_equal(got_k.numpy(), want_k.numpy(),
                                          err_msg=what)


def test_wrapper_runs_the_twin_on_the_cpu_and_rejects_bad_sizes(lib):
    """On a CPU tensor the wrapper is the twin; the host build agrees
    with it on a position-keyed sort whose key passes are partly trivial
    (every key below 2**8 of a 13-bit key_max)."""
    rng = np.random.default_rng(3)
    key = torch.from_numpy(rng.integers(0, 200, 9000).astype(np.int32))
    got = dk.sort_pairs(key, 7000)
    want = dk.sort_pairs_plain(key)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    host = host_sort(lib, key, 7000)
    assert all(torch.equal(a, b) for a, b in zip(host, want))
    assert lib.cc_direct_sort_host(key.data_ptr(), None, 0, 13,
                                   key.data_ptr(), key.data_ptr(), 1) != 0

"""KD2 (``csrc/segment_scan.cu``) built as host C++ against its twin
(``direct_kernels.segment_exclusive_plain`` and ``check_verdicts_plain``)
on the CPU, bit for bit.

The source compiles without ``__CUDACC__`` (g++, ``-ffp-contract=off``):
the cooperative launch's phases run one after the other, phase 1 over its
CTAs' tiles in turn, then CTA 0's scan of the tile totals, then the tiles
in order, so each look-back finds the tiles before it published. That
holds the association the card runs -- each 4,096-element tile's levels
0-2, the three boundary prefixes a tile takes from the one before, the
16-blocked scan of the tile totals -- and the running maximum's carry and
the guard epilogue to the twin, on ``testing.kd2_case``'s segment layouts
at N = 16^k and one either side for k = 1..4 and 16^5 + 1, R = 1..4, f32
and int32 values, and 12 checks with gates, floors and own columns. The
card runs the same cases in ``tests/test_torch_direct_cuda.py``.
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
from cruise_control_tpu_torch.testing import (
    KD2_CASES, KD2_SIZES, kd2_case, kd2_checks,
)


@functools.lru_cache(maxsize=1)
def _host_library(tmp_dir):
    out = f"{tmp_dir}/libsegment_scan_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-x", "c++",
                    str(kernels.CSRC / "segment_scan.cu"), "-o", out],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(out)
    lib.cc_segment_scan_host.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cc_segment_scan_scratch_bytes.argtypes = [ctypes.c_longlong,
                                                  ctypes.c_int]
    lib.cc_segment_scan_scratch_bytes.restype = ctypes.c_longlong
    lib.cc_segment_scan_params_bytes.restype = ctypes.c_longlong
    return lib


@pytest.fixture
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler")
    return _host_library(str(tmp_path_factory.getbasetemp()))


def host_scan(lib, keys, values, checks=(), perm=None, ctas=1):
    """KD2 built for the host: (excl, verdict or None)."""
    n = keys.shape[0]
    r = 1 if values.dim() == 1 else values.shape[1]
    q = dk.ScanParams()
    q.n, q.R, q.num_checks = n, r, len(checks)
    q.is_int = int(not values.is_floating_point())
    excl = torch.empty_like(values)
    scratch = torch.empty(lib.cc_segment_scan_scratch_bytes(n, r),
                          dtype=torch.uint8)
    q.keys, q.values = keys.data_ptr(), values.data_ptr()
    q.excl, q.scratch = excl.data_ptr(), scratch.data_ptr()
    verdict = None
    if checks:
        verdict = torch.empty(n, dtype=torch.bool)
        q.perm, q.verdict = perm.data_ptr(), verdict.data_ptr()
        for i, c in enumerate(checks):
            d = q.checks[i]
            d.column, d.floor = c.column, int(c.floor)
            d.own_column = -1 if c.own_column is None else c.own_column
            d.limit = c.limit.data_ptr()
            d.base = None if c.base is None else c.base.data_ptr()
            d.gate = None if c.gate is None else c.gate.data_ptr()
    assert lib.cc_segment_scan_host(ctypes.byref(q), ctas) == 0
    return excl, verdict


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int32) if t.dtype == torch.float32 else t).numpy()


def _checks(n, r, table, count=12):
    """``testing.kd2_checks`` as Checks; a pair's shared arrays stay one
    tensor (one pointer), as KD2 groups them."""
    return [dk.Check(limit=torch.from_numpy(lim),
                     base=None if base is None else torch.from_numpy(base),
                     column=col, own_column=own, floor=floor,
                     gate=None if gate is None else torch.from_numpy(gate))
            for lim, base, col, own, floor, gate
            in kd2_checks(n, r, table, count)]


@pytest.mark.parametrize("name", KD2_CASES)
@pytest.mark.parametrize("n", KD2_SIZES)
def test_kernel_built_for_the_host_equals_the_twin(lib, name, n):
    assert lib.cc_segment_scan_params_bytes() == ctypes.sizeof(dk.ScanParams)
    for r in (1, 2, 3, 4):
        keys, vals, table = kd2_case(name, n, r)
        k = torch.from_numpy(keys)
        v = torch.from_numpy(vals if r > 1 else vals[:, 0].copy())
        want = dk.segment_exclusive_plain(k, v)
        for ctas in (1, 3):
            got, _ = host_scan(lib, k, v, ctas=ctas)
            np.testing.assert_array_equal(
                _bits(got), _bits(want), err_msg=f"{name} n={n} r={r}")
        ints = torch.from_numpy(
            np.random.default_rng(n + r).integers(0, 3, vals.shape)
            .astype(np.int32))
        ints = ints if r > 1 else ints[:, 0].contiguous()
        np.testing.assert_array_equal(
            host_scan(lib, k, ints)[0].numpy(),
            dk.segment_exclusive_plain(k, ints).numpy(),
            err_msg=f"{name} n={n} r={r} int32")
    perm = torch.from_numpy(
        np.random.default_rng(n).permutation(n).astype(np.int32))
    # 3 checks: two groups; 8: four groups, staged for a tile's keys
    # where they span few enough; 12: six groups, each read per element.
    for count in (3, 8, 12):
        checks = _checks(n, 4, table, count)
        excl, verdict = host_scan(lib, k, v, checks, perm)
        np.testing.assert_array_equal(
            verdict.numpy(),
            dk.check_verdicts_plain(k, v, want, checks, perm).numpy(),
            err_msg=f"{name} n={n} {count} checks: verdicts")


@pytest.mark.parametrize("r", [1, 3])
def test_two_levels_above_the_tiles(lib, r):
    """16^5 + 1 elements: 257 tiles, so the tile totals' scan has two
    levels of its own; segments span tiles; f32 and int32."""
    n = 16 ** 5 + 1
    keys, vals, table = kd2_case("span_tiles", n, r)
    k = torch.from_numpy(keys)
    v = torch.from_numpy(vals if r > 1 else vals[:, 0].copy())
    np.testing.assert_array_equal(
        _bits(host_scan(lib, k, v, ctas=5)[0]),
        _bits(dk.segment_exclusive_plain(k, v)))
    ones = torch.ones_like(k) if r == 1 else \
        torch.ones((n, r), dtype=torch.int32)
    np.testing.assert_array_equal(
        host_scan(lib, k, ones)[0].numpy(),
        dk.segment_exclusive_plain(k, ones).numpy())

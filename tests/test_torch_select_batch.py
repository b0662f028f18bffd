"""K3 (``select_batch``) on its edge cases (``testing.K3_CASES``), three
ways:

- the plain twin against the JAX package's ``cumulative_select`` (its
  reduce per source, top-m, partition dedupe, selected rows, pot / lbi,
  pre-deltas and ``has_earlier``, captured through the recheck);
- a numpy model of the kernel's decomposition against the twin, bit for
  bit: the per-row reduce, the top-m by packed (value, ~row) keys, the
  partition dedupe by a first-rank table (a minimum), the per-broker least
  considered rank for ``has_earlier``, each grouping's order by packed
  (broker + 1, topic, row) keys with its group starts found by a search
  of the sorted keys, and the 16-blocked scan, level by level, in f32;
- ``csrc/select_batch.cu`` built as host C++ with g++ (no ``__CUDACC__``:
  the kernels' phase code walked by one thread, the cluster's four CTAs
  in turn between its barriers) against the twin, bit for bit.

The cases: many equal reduced scores (lower row first), six partitions
among all rows, rows at or below 1e-9 sharing partitions with scoring
rows, no scoring row, m = 1, m = nr, odd sizes, a leadership block of two
rows, brokers at the top of the fixture's range, three scan levels (m =
520) and the kernel's cap (4,096 rows, m = 2,048).
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import candidates as jc
from cruise_control_tpu.analyzer import search as js_
from cruise_control_tpu.model.fixtures import random_cluster as j_random_cluster
from cruise_control_tpu_torch.analyzer import candidates as tc
from cruise_control_tpu_torch.analyzer import search as ts_
from cruise_control_tpu_torch.model.fixtures import random_cluster as t_random_cluster
from cruise_control_tpu_torch.testing import K3_CASES, k3_case, k3_mismatches
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)

FIXTURE = dict(num_brokers=20, num_topics=8, num_partitions=600, rf=3,
               num_racks=5, seed=5, skew_to_first=2.0)
DELTA_FIELDS = tuple(f.name for f in dataclasses.fields(tc.CandidateDeltas)
                     if not f.name.startswith("pre_"))
CASES = sorted(K3_CASES)
SOURCE = Path(tc.__file__).parent.parent / "csrc" / "select_batch.cu"


@pytest.fixture(scope="module")
def worlds():
    js, _ = j_random_cluster(**FIXTURE)
    ts, meta = t_random_cluster(**FIXTURE, device="cpu")
    np.testing.assert_array_equal(np.asarray(js.leader_load),
                                  ts.leader_load.numpy())
    return js, ts, meta.num_topics


def _case(ts, num_topics, name):
    c = k3_case(name, ts.num_partitions, ts.num_brokers, num_topics)
    deltas = tc.CandidateDeltas(**{
        f: torch.from_numpy(np.ascontiguousarray(c[f])) for f in DELTA_FIELDS})
    return c, (ts, deltas, torch.from_numpy(c["score"]), c["layout"], c["m"],
               c["extra_last_col"])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("case", CASES)
def test_twin_matches_jax(worlds, case):
    """Integer and bool outputs and the gathered rows exactly; the
    pre-deltas within rtol 1e-5 / atol 1e-6, as in test_torch_search: the
    twin adds in the association of XLA:CPU's 16-blocked cumsum, which is
    the lowering's choice and not the JAX program's (the other two tests
    here hold the kernel to the twin bit for bit)."""
    js, ts, num_topics = worlds
    c, args = _case(ts, num_topics, case)
    jdel = jc.CandidateDeltas(**{f: jnp.asarray(c[f]) for f in DELTA_FIELDS})
    seen = {}

    def recheck(sub, has_earlier):
        seen["has_earlier"] = has_earlier
        return jnp.ones(has_earlier.shape, bool)

    j_idx, j_sel, j_sub, j_pot, j_lbi = js_.cumulative_select(
        js, jdel, jnp.asarray(c["score"]), c["layout"], c["m"], c["m"],
        True, recheck, extra_last_col=c["extra_last_col"])
    idx, part_ok, sub, has_earlier, pot, lbi = ts_.select_batch_plain(*args)
    np.testing.assert_array_equal(_np(idx), np.asarray(j_idx))
    np.testing.assert_array_equal(_np(part_ok), np.asarray(j_sel))
    np.testing.assert_array_equal(_np(has_earlier),
                                  np.asarray(seen["has_earlier"]))
    np.testing.assert_array_equal(_np(pot), np.asarray(j_pot))
    np.testing.assert_array_equal(_np(lbi), np.asarray(j_lbi))
    for f in dataclasses.fields(j_sub):
        want = np.asarray(getattr(j_sub, f.name))
        got = _np(getattr(sub, f.name))
        if f.name.startswith("pre_"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f.name)


# --- the numpy model of the kernel's decomposition ---------------------------

F32 = np.float32
ROW_BITS = 11


def _reduce(score, layout, extra):
    """Each reduced row's grid index: the tie window, the rotation rule."""
    out, offset = [], 0
    for block_i, (rows, cols) in enumerate(layout):
        block = score[offset:offset + rows * cols].reshape(rows, cols)
        finite = np.isfinite(block)
        row_max = np.where(finite, block, -np.inf).max(1).astype(F32)
        window = F32(0.01) * np.maximum(np.abs(row_max), F32(1e-6))
        tied = finite & (block >= (row_max - window)[:, None])
        rot_cols = cols - 1 if extra and block_i == 0 else cols
        col = np.arange(cols)[None, :]
        rot = np.where(col < rot_cols,
                       (col - np.arange(rows)[:, None]) % max(rot_cols, 1),
                       cols)
        best = np.argmin(np.where(tied, rot, cols + 1), 1)
        best = np.where(finite.any(1), best, 0)
        out.append(offset + np.arange(rows) * cols + best)
        offset += rows * cols
    return np.concatenate(out)


def _ordered(values):
    b = values.astype(F32).view(np.uint32).astype(np.uint64)
    sign = np.uint64(0x80000000)
    return np.where(b & sign, ~b & np.uint64(0xFFFFFFFF), b | sign)


def _blocked_inclusive(x):
    """XLA:CPU's inclusive cumsum of x [n, C] in f32: blocks of 16 scanned
    serially, their totals scanned the same way, offsets added top
    down; n <= 16 is one serial scan."""
    n = x.shape[0]
    nb = -(-n // 16)
    inner = np.zeros((nb * 16,) + x.shape[1:], F32)
    inner[:n] = x
    inner = inner.reshape((nb, 16) + x.shape[1:])
    for i in range(1, 16):
        inner[:, i] = inner[:, i - 1] + inner[:, i]
    flat = inner.reshape((nb * 16,) + x.shape[1:])[:n]
    if n <= 16:
        return flat
    last = np.minimum(np.arange(nb) * 16 + 15, n - 1)
    totals = _blocked_inclusive(flat[last].copy())
    offsets = np.concatenate([np.zeros((1,) + x.shape[1:], F32),
                              totals[:-1]])
    return (flat + np.repeat(offsets, 16, 0)[:n]).astype(F32)


def _model(c, leader_load, num_partitions):
    score = c["score"]
    red = _reduce(score, c["layout"], c["extra_last_col"])
    nr = red.shape[0]
    k = min(c["m"], nr)
    keys = (_ordered(score[red]) << np.uint64(32)) \
        | (np.uint64(0xFFFFFFFF) - np.arange(nr, dtype=np.uint64))
    top = np.sort(keys)[::-1][:k]
    rows = (np.uint64(0xFFFFFFFF) - (top & np.uint64(0xFFFFFFFF))) \
        .astype(np.int64)
    idx = red[rows]
    ok = score[idx] > F32(1e-9)
    f = {name: c[name][idx] for name in DELTA_FIELDS}
    first_p = {}
    for i in np.flatnonzero(ok):
        first_p.setdefault(int(f["partition"][i]), i)
    cons = np.array([bool(ok[i]) and first_p[int(f["partition"][i])] == i
                     for i in range(k)])
    first_b = {}
    for i in np.flatnonzero(cons):
        for b in (int(f["src_broker"][i]), int(f["dst_broker"][i])):
            first_b.setdefault(b, i)
    has_earlier = np.array([
        min(first_b.get(int(f["src_broker"][i]), k),
            first_b.get(int(f["dst_broker"][i]), k)) < i for i in range(k)])
    part = np.where(f["partition"] < 0, f["partition"] + num_partitions,
                    f["partition"])
    pot = np.where(f["replica_delta"] > 0, leader_load[part, 2], F32(0))
    lbi = np.where(f["leader_delta"] > 0, leader_load[part, 1], F32(0))
    vals = np.concatenate([f["load_delta"],
                           f["replica_delta"][:, None].astype(F32),
                           f["leader_delta"][:, None].astype(F32),
                           pot[:, None], lbi[:, None]], 1).astype(F32)
    vals = vals * cons.astype(F32)[:, None]
    pre = {}
    for broker, topic, cols, names in (
            ("src_broker", False, slice(0, 6), "src"),
            ("dst_broker", False, slice(0, 8), "dst"),
            ("src_broker", True, slice(4, 6), "src_topic"),
            ("dst_broker", True, slice(4, 5), "dst_topic")):
        key = (f[broker].astype(np.int64) + 1).astype(np.uint64) \
            << np.uint64(32 + ROW_BITS)
        if topic:
            key |= (f["topic"].astype(np.uint32) ^ np.uint32(0x80000000)) \
                .astype(np.uint64) << np.uint64(ROW_BITS)
        key |= np.arange(k, dtype=np.uint64)
        order = np.argsort(key, kind="stable")
        sorted_keys = key[order]
        start = np.searchsorted(sorted_keys,
                                sorted_keys & ~np.uint64(2 ** ROW_BITS - 1))
        incl = _blocked_inclusive(vals[order, cols])
        excl = np.concatenate([np.zeros((1, incl.shape[1]), F32), incl[:-1]])
        out = np.empty_like(excl)
        out[order] = excl - excl[start]
        pre[names] = out
    return dict(idx=idx.astype(np.int32), part_ok=cons,
                has_earlier=has_earlier, pot=pot.astype(F32),
                lbi=lbi.astype(F32), fields=f, pre=pre)


@pytest.mark.parametrize("case", CASES)
def test_numpy_model_matches_twin(worlds, case):
    _js, ts, num_topics = worlds
    c, args = _case(ts, num_topics, case)
    got = _model(c, ts.leader_load.numpy(), ts.num_partitions)
    idx, part_ok, sub, has_earlier, pot, lbi = ts_.select_batch_plain(*args)

    def bits(x):
        return np.ascontiguousarray(x, F32).view(np.uint32)

    np.testing.assert_array_equal(got["idx"], _np(idx))
    np.testing.assert_array_equal(got["part_ok"], _np(part_ok))
    np.testing.assert_array_equal(got["has_earlier"], _np(has_earlier))
    np.testing.assert_array_equal(bits(got["pot"]), bits(_np(pot)))
    np.testing.assert_array_equal(bits(got["lbi"]), bits(_np(lbi)))
    for name in DELTA_FIELDS:
        np.testing.assert_array_equal(got["fields"][name],
                                      _np(getattr(sub, name)), err_msg=name)
    pre = got["pre"]
    want = {
        "pre_src_load": pre["src"][:, :4], "pre_dst_load": pre["dst"][:, :4],
        "pre_src_count": pre["src"][:, 4], "pre_dst_count": pre["dst"][:, 4],
        "pre_src_leaders": pre["src"][:, 5],
        "pre_dst_leaders": pre["dst"][:, 5],
        "pre_src_topic_count": pre["src_topic"][:, 0],
        "pre_dst_topic_count": pre["dst_topic"][:, 0],
        "pre_src_topic_leaders": pre["src_topic"][:, 1],
        "pre_dst_pot": pre["dst"][:, 6], "pre_dst_lbi": pre["dst"][:, 7]}
    assert set(want) == {"pre_src_load", "pre_dst_load", *tc.PRE_FIELDS}
    for name, value in want.items():
        np.testing.assert_array_equal(bits(value),
                                      bits(_np(getattr(sub, name))),
                                      err_msg=name)


# --- the kernel's source built for the host ----------------------------------

@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("k3") / "libselect_batch_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-x", "c++", str(SOURCE), "-o",
                    str(out)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.cc_select_batch_host.argtypes = [ctypes.c_void_p]
    lib.cc_select_batch_params_bytes.restype = ctypes.c_longlong
    lib.cc_select_batch_scratch_bytes.argtypes = [ctypes.c_int]
    lib.cc_select_batch_scratch_bytes.restype = ctypes.c_longlong
    assert lib.cc_select_batch_params_bytes() == \
        ctypes.sizeof(ts_.SelectBatchParams)
    return lib


@pytest.mark.parametrize("case", CASES)
def test_kernel_built_for_the_host_matches_twin(worlds, host_library, case):
    _js, ts, num_topics = worlds
    _c, args = _case(ts, num_topics, case)
    params, buffers = ts_.select_batch_params(*args)
    nr = sum(r for r, _c in args[3])
    assert params.scratch_bytes == host_library.cc_select_batch_scratch_bytes(
        nr)
    assert host_library.cc_select_batch_host(ctypes.byref(params)) == 0
    got = ts_.select_batch_outputs(buffers)
    assert k3_mismatches(got, ts_.select_batch_plain(*args)) == []


def test_phase_probe_stops_after_each_phase():
    """``testing/k3_phases.py`` builds the kernel's source with a return
    after each phase: every marker line it cuts at is in the source once,
    and each build has one return more than the source (the whole kernel's
    none)."""
    from cruise_control_tpu_torch.testing import k3_phases
    source = SOURCE.read_text()
    builds = k3_phases.variants(source)
    assert list(builds) == [name for _m, name in k3_phases._STOPS] + [
        "scans"]
    for marker, _name in k3_phases._STOPS:
        assert source.count(marker) == 1, marker
    for name, text in builds.items():
        assert text.count("return;\n") == source.count("return;\n") + (
            name != "scans")

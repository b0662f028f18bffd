"""Kernel K8 (``swap_top_replicas``) off the card.

- The twin (``_per_broker_top_replicas`` for each side, what
  ``search.swap_top_replicas`` runs on a CPU tensor) against JAX
  ``_per_broker_top_replicas``, and the port's ``swap_grid`` against the
  reference's, exact (indices, validity, every leg field), at 12/96,
  16/512 and 100/10k with DEAD brokers, on a goal's weights and on
  crafted ones: ties, signed zeros, a broker with fewer than j finite
  replicas (top_k's -inf padding, lowest flat indices first) and brokers
  with none (every replica non-finite, or no replica at all).
- ``csrc/swap_select.cu`` built as host C++ with g++ (no ``__CUDACC__``:
  the CTAs' streams in turn, then the merge of their lists) against the
  twin on the same inputs, bit for bit, with 1 to 2,048 CTAs, and on a
  broker that holds many CTAs' worth of hits.
"""

import ctypes
import dataclasses
import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import derived as jderived
from cruise_control_tpu.analyzer import search as jsearch
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer import derived as tderived
from cruise_control_tpu_torch.analyzer import search as tsearch
from cruise_control_tpu_torch.analyzer import slot_pass
from tests.test_torch_slot_pass import CASES, _goal_world, _states
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)

KINDS = ("goal", "ties", "signed_zeros", "few_and_none", "empty_broker")
K, J = 8, 4


def _inputs(case, kind):
    """(js, jd, ts, td, weight [P, S] f32, src_brokers [K], dst_brokers [K],
    src_score [B], dst_score [B])."""
    js, jd, ts, td, _topics = _states(case)
    b = ts.num_brokers
    rng = np.random.default_rng(7 * len(kind) + b)
    shape = tuple(ts.assignment.shape)
    if kind == "goal":
        _jg, tg, _ja, targs = _goal_world(case, "DiskUsageDistributionGoal")
        w = slot_pass.slot_weights_plain(tg, *targs, False)[0].numpy()
    elif kind == "ties":
        w = np.round(rng.random(shape) * 4).astype(np.float32) / 4
    elif kind == "signed_zeros":
        w = np.where(rng.random(shape) < 0.5, np.float32(0.0),
                     np.float32(-0.0)).astype(np.float32)
        w[rng.random(shape) < 0.05] = -1.0
    else:
        w = rng.standard_normal(shape).astype(np.float32)
    a = ts.assignment.numpy().copy()
    src_b = rng.permutation(b)[:K].astype(np.int32)
    dst_b = rng.permutation(b)[:K].astype(np.int32)
    if kind == "few_and_none":
        # src_b[0]: two finite replicas; src_b[1] and dst_b[0]: none.
        for broker, keep, bad in ((src_b[0], 2, np.nan), (src_b[1], 0, np.inf),
                                  (dst_b[0], 0, -np.inf)):
            on = np.flatnonzero(a.reshape(-1) == broker)
            w.reshape(-1)[on[keep:]] = bad
    if kind == "empty_broker":
        # src_b[2] and dst_b[1] host nothing.
        empty = {int(src_b[2]), int(dst_b[1])}
        for broker in empty:
            other = (broker + 1) % b
            while other in empty:
                other = (other + 1) % b
            a[a == broker] = other
        js = dataclasses.replace(js, assignment=jnp.asarray(a))
        ts = dataclasses.replace(ts, assignment=torch.from_numpy(a))
        jd, td = jderived.compute_derived(js), tderived.compute_derived(ts)
    src = rng.uniform(-1.0, 2.0, b).astype(np.float32)
    dst = rng.uniform(-1.0, 2.0, b).astype(np.float32)
    return js, jd, ts, td, w, src_b, dst_b, src, dst


def _same(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_equals_jax_per_broker_top_replicas(case, kind):
    js, _jd, ts, _td, w, src_b, dst_b, _s, _d = _inputs(case, kind)
    got = tsearch.swap_top_replicas(ts, torch.from_numpy(w),
                                    torch.from_numpy(src_b),
                                    torch.from_numpy(dst_b), J)
    for side, brokers, largest in ((0, src_b, True), (1, dst_b, False)):
        want_idx, want_ok = jsearch._per_broker_top_replicas(
            js, jnp.asarray(w), jnp.asarray(brokers), J, largest)
        _same(got[2 * side], want_idx, f"{case} {kind} side {side} idx")
        _same(got[2 * side + 1], want_ok, f"{case} {kind} side {side} ok")
    if kind in ("few_and_none", "empty_broker"):
        ok = got[1].numpy()
        assert not ok.all(axis=1).all(), "padding was reached"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_swap_grid_equals_jax(case, kind):
    js, jd, ts, td, w, _sb, _db, src, dst = _inputs(case, kind)
    want = jsearch.swap_grid(js, jd, jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(w))
    got = tsearch.swap_grid(ts, td, torch.from_numpy(src),
                            torch.from_numpy(dst), torch.from_numpy(w))
    for k, (g, jw) in enumerate(zip(got, want)):
        if dataclasses.is_dataclass(g):
            for f in dataclasses.fields(g):
                gv, wv = getattr(g, f.name), getattr(jw, f.name)
                if gv is None:
                    assert wv is None
                    continue
                _same(gv, wv, f"{case} {kind} output {k}.{f.name}")
        else:
            _same(g, jw, f"{case} {kind} output {k}")


@functools.lru_cache(maxsize=1)
def _host_library(tmp_dir):
    out = f"{tmp_dir}/libswap_select_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-x", "c++",
                    str(kernels.CSRC / "swap_select.cu"), "-o", out],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(out)
    lib.cc_swap_top_replicas_host.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    return lib


def host_top_replicas(lib, state, weight, src_b, dst_b, j, ctas=1):
    """K8's selection built for the host, its CTAs in turn and then the
    merge: (flat_idx, valid), [2, k, j]."""
    p, s = state.assignment.shape
    k = src_b.shape[0]
    brokers = torch.cat([src_b, dst_b]).to(torch.int32).contiguous()
    flat_idx = torch.empty((2, k, j), dtype=torch.int32)
    valid = torch.empty((2, k, j), dtype=torch.bool)
    w = weight.contiguous()
    assert lib.cc_swap_top_replicas_host(
        w.data_ptr(), state.assignment.data_ptr(),
        state.partition_mask.data_ptr(), brokers.data_ptr(), p, s, k, j,
        flat_idx.data_ptr(), valid.data_ptr(), ctas) == 0
    return flat_idx, valid


@pytest.mark.parametrize("kind", KINDS + ("hot_broker",))
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_built_for_the_host_equals_the_twin(case, kind,
                                                   tmp_path_factory):
    """``hot_broker``: slot 0 of 60 % of the partitions on src_b[0], which
    is also dst_b[0], on the tied weights: many CTAs' worth of hits on one
    broker, every CTA's lists full."""
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler")
    lib = _host_library(str(tmp_path_factory.getbasetemp()))
    hot = kind == "hot_broker"
    _js, _jd, ts, _td, w, src_b, dst_b, _s, _d = _inputs(
        case, "ties" if hot else kind)
    if hot:
        a = ts.assignment.numpy().copy()
        rng = np.random.default_rng(5)
        a[rng.random(a.shape[0]) < 0.6, 0] = src_b[0]
        dst_b = dst_b.copy()
        dst_b[0] = src_b[0]
        ts = dataclasses.replace(ts, assignment=torch.from_numpy(a))
    wt, sb, db = (torch.from_numpy(x) for x in (w, src_b, dst_b))
    for j in (1, 3, J):
        want = tsearch.swap_top_replicas(ts, wt, sb, db, j)
        for ctas in (1, 7, 64, 2048):
            flat_idx, valid = host_top_replicas(lib, ts, wt, sb, db, j, ctas)
            what = f"{case} {kind} j={j} ctas={ctas}"
            _same(flat_idx[0], want[0], f"{what} heavy idx")
            _same(valid[0], want[1], f"{what} heavy ok")
            _same(flat_idx[1], want[2], f"{what} light idx")
            _same(valid[1], want[3], f"{what} light ok")


def test_phase_probe_stops_after_each_phase():
    """``testing/kernel_phases.py k8`` builds K8's source once a phase,
    each build stopping after its phase: every text it edits is in the
    source once, each build but the last differs from the source, and
    the last is the source."""
    from cruise_control_tpu_torch.testing import kernel_phases
    source = (kernels.CSRC / "swap_select.cu").read_text()
    design, builds = kernel_phases.variants("k8", source)
    assert design == "cooperative"
    names = [name for name, _edits in kernel_phases._K8_STOPS]
    assert list(builds) == names
    for _name, edits in kernel_phases._K8_STOPS:
        for old, _new in edits:
            assert source.count(old) == 1, old
    assert builds[names[-1]] == source
    assert all(builds[name] != source for name in names[:-1])

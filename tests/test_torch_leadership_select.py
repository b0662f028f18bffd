"""K2's leadership mode off the card: the twin ``leadership_sources_plain``
against JAX ``generate_candidates``'s leadership block (its partitions and
validity) and the reference's own top-k of the leader weights (values),
exact, on a goal's weights and on tie-heavy (1e30), signed-zero and
few-finite inputs at 12/96, 16/512 and 100/10k, k_l above P included; a
numpy model of the kernel's selection (value digits, the keys above the
boundary ranked, ties by the ranges' prefix counts, then the lowest flat
indices of -inf keys in [0, k_l)) against the twin on the same inputs;
and ``csrc/select_leadership.cu`` built as host C++ with g++ (no
``__CUDACC__``: the phases with one thread, the CTAs in turn) against the
twin bit for bit on those inputs and on ``testing.K2_CASES``, with one
CTA and many, keys in shared memory and in the global scratch.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import candidates as jc
from cruise_control_tpu.model import tensors as jt
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer import candidates as tc
from cruise_control_tpu_torch.analyzer import slot_pass
from cruise_control_tpu_torch.testing import K2_CASES, k2_adversarial_inputs
from tests.test_torch_slot_pass import (
    CASES, _assert_bitwise, _goal_world, _states,
)
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)



def _jax_leadership(js, jd, src, weight, num_sources):
    """(top_lw, lp, valid) of the reference: its own top-k of the leader
    weights, and generate_candidates's leadership block."""
    b = js.num_brokers
    s_dim = js.max_replication_factor
    exists = jt.replica_exists(js)
    seg = jnp.where(js.assignment >= 0, js.assignment, b)
    on_source = (jnp.concatenate([src, jnp.array([-1.0])])[seg] > 0.0) \
        & exists
    lead_weight = jnp.where(on_source & jt.is_leader_slot(js), weight,
                            -jnp.inf).reshape(-1)
    k_l = min(num_sources, lead_weight.shape[0])
    top_lw, _idx = jax.lax.top_k(lead_weight, k_l)
    cand, layout = jc.generate_candidates(
        js, jd, src, jnp.zeros(b, jnp.float32), weight, num_sources, 4,
        include_leadership=True, leadership_only=True)
    assert layout == ((k_l, s_dim),)
    return (np.asarray(top_lw), np.asarray(cand.partition)[::s_dim],
            np.asarray(cand.valid)[::s_dim])


def _model_leadership(state, src, weight, num_sources, ctas=7):
    """The kernel's selection (``csrc/select_leadership.cu``) in numpy,
    phase by phase: one 32-bit key a partition (the ordered bits of its
    leader slot's weight, 0 off source or at -inf); the boundary value T
    found by digit passes of 11, 11 and 10 bits over the histograms of
    the keys that match the digits picked so far (the search ends at the
    first pass that leaves at most 8,192 keys at or above its bin's low
    edge, and at most ``ctas`` * 2**19 compares to rank them); the A keys
    above T ranked (value descending, lower partition first), the first
    min(k_l, finite) of them kept; after the last digit, the first
    ``take`` keys equal to T in partition order, each of ``ctas``
    contiguous ranges of partitions counting its own ties and an
    exclusive prefix over the ranges ranking them; then, with fewer than
    k_l finite keys, the lowest flat indices in [0, k_l) whose key is
    -inf."""
    a = state.assignment.numpy()
    p, s = a.shape
    b = state.num_brokers
    ls = state.leader_slot.numpy().astype(np.int64)
    pm = state.partition_mask.numpy()
    w = weight.numpy().reshape(-1)
    score = src.numpy()
    k_l = min(num_sources, p * s)
    parts = np.arange(p)
    has = pm & (ls >= 0) & (ls < s)
    flat = parts * s + np.where(has, ls, 0)
    broker = np.where(has, a.reshape(-1)[flat], -1)
    on = has & (broker >= 0) & (broker < b) \
        & (score[np.clip(broker, 0, b - 1)] > 0)
    bits = w[flat].view(np.uint32)
    ordered = np.where(bits >> 31 == 1, ~bits, bits | np.uint32(1 << 31))
    keys = np.where(on & (ordered > 0x007FFFFF), ordered,
                    np.uint32(0)).astype(np.int64)
    finite = int((keys > 0).sum())
    need = min(k_l, finite)
    if need == finite:
        t_val, above, take = 0, finite, 0
    else:
        above, pfx, top = 0, 0, 32
        for shift, width in ((21, 11), (10, 11), (0, 10)):
            match = keys[(keys > 0) & ((keys >> top) == pfx)]
            hist = np.bincount((match >> shift) & ((1 << width) - 1),
                               minlength=1 << width)
            rem = need - above
            from_top = np.cumsum(hist[::-1])
            bin_ = (1 << width) - 1 - int(np.searchsorted(from_top, rem))
            before = int(hist[bin_ + 1:].sum())
            m = above + before + int(hist[bin_])
            pfx = (pfx << width) | bin_
            if m <= 8192 and m * m <= ctas * 2 ** 19:
                t_val, above, take = (pfx << shift) - 1, m, 0
                break
            above += before
            if shift == 0:
                t_val, take = pfx, need - above
                break
            top = shift
    rows = [int(q) for q in sorted(np.flatnonzero(keys > t_val),
                                   key=lambda q: (-keys[q], q))]
    assert len(rows) == above
    rows = rows[:need]
    if take:
        per = -(-p // ctas)
        tie = keys == t_val
        counts = [int(tie[c * per:(c + 1) * per].sum()) for c in range(ctas)]
        prefix = np.concatenate([[0], np.cumsum(counts)[:-1]])
        ranked = {}
        for c in range(ctas):
            for r, q in enumerate(np.flatnonzero(tie[c * per:(c + 1) * per])):
                if prefix[c] + r < take:
                    ranked[int(prefix[c] + r)] = c * per + int(q)
        rows += [ranked[r] for r in range(take)]
    vals = [w[flat[q]] for q in rows]
    lp = list(rows)
    if finite < k_l:
        leader_flat = set(flat[keys > 0].tolist())
        pads = [i for i in range(k_l) if i not in leader_flat]
        vals += [-np.inf] * (k_l - len(rows))
        lp += [i // s for i in pads[:k_l - len(rows)]]
    return np.array(vals, np.float32), np.array(lp, np.int64)


def _leadership_inputs(case, kind):
    js, jd, ts, td, topics = _states(case)
    b = ts.num_brokers
    rng = np.random.default_rng(len(kind) + b)
    a = ts.assignment.numpy()
    src = rng.uniform(-1.0, 1.0, b).astype(np.float32)
    if kind == "goal":
        _jg, tg, _ja, targs = _goal_world(case, "LeaderReplicaDistributionGoal")
        w, _off, _any, _pb = slot_pass.slot_weights_plain(tg, *targs, True)
        return src, w.numpy()
    if kind == "offline_ties":
        # Every offline replica at 1e30, as the override gives them; the
        # dead brokers' leaders tie on it.
        _jg, tg, _ja, targs = _goal_world(case, "DiskUsageDistributionGoal")
        w, _off, _any, _pb = slot_pass.slot_weights_plain(tg, *targs, True)
        src[list(CASES[case][3])] = 5.0
        return src, w.numpy()
    if kind == "all_ties":
        return np.ones(b, np.float32), np.full(a.shape, 1e30, np.float32)
    if kind == "signed_zeros":
        w = np.where(rng.random(a.shape) < 0.5, np.float32(0.0),
                     np.float32(-0.0)).astype(np.float32)
        w[rng.random(a.shape) < 0.1] = 1.0
        return src, w
    # few_finite: one source broker, so fewer finite keys than k_l and the
    # padding reaches non-leader slots.
    src = np.full(b, -1.0, np.float32)
    src[1] = 2.0
    return src, rng.standard_normal(a.shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["goal", "offline_ties", "all_ties",
                                  "signed_zeros", "few_finite"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_leadership_twin_equals_jax_and_the_kernels_model(case, kind):
    js, jd, ts, _td, _topics = _states(case)
    src, w = _leadership_inputs(case, kind)
    p = ts.num_partitions
    for num_sources in sorted({64, 2048, min(2 * p, 2048)}):
        want_lw, want_lp, want_valid = _jax_leadership(
            js, jd, jnp.asarray(src), jnp.asarray(w), num_sources)
        top_lw, lp = tc.leadership_sources(
            ts, torch.from_numpy(src), torch.from_numpy(w), num_sources)
        what = f"{case} {kind} k={num_sources}"
        _assert_bitwise(top_lw, want_lw, f"{what} top_lw")
        np.testing.assert_array_equal(lp.numpy(), want_lp, err_msg=what)
        np.testing.assert_array_equal(np.isfinite(top_lw.numpy()),
                                      want_valid, err_msg=what)
        m_lw, m_lp = _model_leadership(ts, torch.from_numpy(src),
                                       torch.from_numpy(w), num_sources)
        _assert_bitwise(torch.from_numpy(m_lw), top_lw, f"{what} model")
        np.testing.assert_array_equal(m_lp, lp.numpy(), err_msg=what)
    if kind == "few_finite":
        assert not np.isfinite(want_lw).all(), "padding was reached"


# --- the kernel's source built for the host -----------------------------------

@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("k2l") / "libselect_leadership_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-x", "c++",
                    str(kernels.CSRC / "select_leadership.cu"), "-o",
                    str(out)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.cc_select_leadership_host.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    return lib


def host_leadership(lib, state, score, weight, num_sources, ctas, key_cap):
    """K2's leadership mode built for the host: (top_lw, lp)."""
    p, s = state.assignment.shape
    k_l = min(num_sources, p * s)
    top_lw = torch.empty(k_l, dtype=torch.float32)
    lp = torch.empty(k_l, dtype=torch.int32)
    w, sc = weight.contiguous(), score.contiguous()
    assert lib.cc_select_leadership_host(
        w.data_ptr(), sc.data_ptr(), state.assignment.data_ptr(),
        state.partition_mask.data_ptr(), state.leader_slot.data_ptr(), p, s,
        state.num_brokers, k_l, top_lw.data_ptr(), lp.data_ptr(), ctas,
        key_cap) == 0
    return top_lw, lp


@pytest.mark.parametrize("kind", ["goal", "offline_ties", "all_ties",
                                  "signed_zeros", "few_finite",
                                  *(f"k2_{c}" for c in K2_CASES)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_built_for_the_host_equals_the_twin(host_library, case, kind):
    _js, _jd, ts, _td, _topics = _states(case)
    if kind.startswith("k2_"):
        w, src = k2_adversarial_inputs(ts.assignment.numpy(),
                                       ts.num_brokers, 2048, kind[3:],
                                       seed=11)
    else:
        src, w = _leadership_inputs(case, kind)
    src, w = torch.from_numpy(src), torch.from_numpy(w)
    p = ts.num_partitions
    # One CTA; the card's ranges at 1,024 partitions a CTA; many CTAs
    # (some empty where P is small); keys in the global scratch (a CTA
    # keeps 5).
    grids = sorted({(1, 8192), (-(-p // 1024), 8192), (37, 8192),
                    (512, 8192), (9, 5)})
    for num_sources in sorted({64, 2048, min(2 * p, 2048)}):
        want = tc.leadership_sources_plain(ts, src, w, num_sources)
        for ctas, key_cap in grids:
            got = host_leadership(host_library, ts, src, w, num_sources, ctas,
                                  key_cap)
            what = f"{case} {kind} k={num_sources} ctas={ctas} cap={key_cap}"
            _assert_bitwise(got[0], want[0], f"{what} top_lw")
            np.testing.assert_array_equal(got[1].numpy(), want[1].numpy(),
                                          err_msg=what)


def test_phase_probe_stops_after_each_phase():
    """``testing/kernel_phases.py k2l`` builds the kernel's source once a
    phase, each build stopping after its phase: every text it edits is
    in the source once, each build but the last has one return more than
    the source, and the last is the source."""
    from cruise_control_tpu_torch.testing import kernel_phases
    source = (kernels.CSRC / "select_leadership.cu").read_text()
    design, builds = kernel_phases.variants("k2l", source)
    assert design == "cooperative"
    names = [name for name, _edits in kernel_phases._K2L_STOPS]
    assert list(builds) == names
    for _name, edits in kernel_phases._K2L_STOPS:
        for old, _new in edits:
            assert source.count(old) == 1, old
    for name in names:
        assert builds[name].count("return;\n") == source.count(
            "return;\n") + (name != names[-1])

"""K2's leadership mode off the card: the twin ``leadership_sources_plain``
against JAX ``generate_candidates``'s leadership block (its partitions and
validity) and the reference's own top-k of the leader weights (values),
exact, on a goal's weights and on tie-heavy (1e30), signed-zero and
few-finite inputs at 12/96, 16/512 and 100/10k, k_l above P included; and
a numpy model of the kernel's selection (finite keys ranked, then the
lowest flat indices of -inf keys in [0, k_l)) against the twin on the
same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import candidates as jc
from cruise_control_tpu.model import tensors as jt
from cruise_control_tpu_torch.analyzer import candidates as tc
from cruise_control_tpu_torch.analyzer import slot_pass
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


def _model_leadership(state, src, weight, num_sources):
    """The kernel's selection in numpy: the finite keys (one a partition,
    its leader slot's) by (value in total order descending, flat index),
    then the lowest flat indices in [0, k_l) whose key is -inf."""
    a = state.assignment.numpy()
    p, s = a.shape
    ls = state.leader_slot.numpy()
    pm = state.partition_mask.numpy()
    w = weight.numpy().reshape(-1)
    score = src.numpy()
    k_l = min(num_sources, p * s)
    finite = []
    for part in range(p):
        slot = ls[part]
        if not 0 <= slot < s:
            continue
        flat = part * s + slot
        on = a[part, slot] >= 0 and pm[part] and score[a[part, slot]] > 0
        if on and w[flat] > -np.inf:
            bits = np.float32(w[flat]).view(np.int32)
            key = bits ^ 0x7FFFFFFF if bits < 0 else bits
            finite.append((-int(key), flat))
    finite.sort()
    rows = [flat for _k, flat in finite[:k_l]]
    finite_flats = {flat for _k, flat in finite}
    pads = [i for i in range(k_l) if i not in finite_flats]
    rows += pads[:k_l - len(rows)]
    vals = np.array([w[i] if i in finite_flats else -np.inf for i in rows],
                    np.float32)
    return vals, np.array(rows, np.int64) // s


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

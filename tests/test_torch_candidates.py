"""K2's twin, the candidate grid, the deltas, the cumulative pre-deltas
and the targeted-destination fills of the PyTorch port against the JAX
package (analyzer/candidates.py, analyzer/fill.py).

Inputs are built with numpy from a seed to carry ties and -inf rows, where
the two frameworks' default top-k orders differ; integer outputs must be
exactly equal. K2's twin is also held against the JAX function on the
inputs where its card kernel's order is hardest to keep
(``testing.K2_CASES``), and a numpy model of the kernel's radix select
(csrc/select_sources.cu) is held against ``stable_topk`` and the twin's
per-broker picks on tie-heavy inputs at the 1k-broker / 100k-partition
shape.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import candidates as jc
from cruise_control_tpu.analyzer import derived as jderived
from cruise_control_tpu.analyzer import fill as jfill
from cruise_control_tpu.model.fixtures import random_cluster as j_random_cluster
from cruise_control_tpu_torch.analyzer import candidates as tc
from cruise_control_tpu_torch.analyzer import derived as tderived
from cruise_control_tpu_torch.analyzer import fill as tfill
from cruise_control_tpu_torch.model.fixtures import random_cluster as t_random_cluster
from cruise_control_tpu_torch.model.tensors import ClusterTensors
from cruise_control_tpu_torch.testing import K2_CASES, k2_adversarial_inputs, k2_half
from cruise_control_tpu_torch.utils.numerics import stable_topk
from tests.torch_support import one_torch_thread  # noqa: F401  (autouse)

FIXTURE = dict(num_brokers=16, num_topics=8, num_partitions=400, rf=3,
               num_racks=4, seed=21, skew_to_first=2.0)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair():
    js, jm = j_random_cluster(**FIXTURE)
    ts, _ = t_random_cluster(**FIXTURE, device="cpu")
    return js, ts, jm


def _scores(shape_p, b, seed, neg_frac=0.3, levels=4):
    """Tied integer-valued weights with -inf rows, tied broker scores with
    non-positive brokers."""
    rng = np.random.default_rng(seed)
    weight = rng.integers(0, levels, shape_p).astype(np.float32)
    weight[rng.random(shape_p) < neg_frac] = -np.inf
    weight[rng.random(shape_p) < 0.02] = np.float32(1e30)
    score = rng.integers(-1, 3, b).astype(np.float32)
    return weight, score


CASES = [(256, 1, 4), (256, 2, 2), (64, 3, 3), (32, 4, 1), (400, 5, 6)]


@pytest.mark.parametrize("num_sources,seed,levels", CASES)
def test_select_sources_twin_matches_with_ties(num_sources, seed, levels):
    js, ts, _ = _pair()
    weight, score = _scores(tuple(js.assignment.shape), js.num_brokers, seed,
                            levels=levels)
    want = jc.select_sources(js, jnp.asarray(score), jnp.asarray(weight),
                             num_sources)
    got = tc.select_sources(ts, torch.from_numpy(score),
                            torch.from_numpy(weight), num_sources)
    for a, b, name in zip(want, got, ("cand_p", "cand_s", "src_valid")):
        np.testing.assert_array_equal(_np(b), np.asarray(a), err_msg=name)
    # The inputs really carry -inf rows and tied weights.
    assert np.isneginf(weight).any()
    assert len(np.unique(weight[np.isfinite(weight)])) < weight.size // 2


@pytest.mark.parametrize("num_sources", [256, 64])
@pytest.mark.parametrize("case", K2_CASES)
def test_select_sources_twin_matches_on_adversarial_inputs(case, num_sources):
    """1e30 ties filling the global block and spilling past it, signed
    zeros, all weights equal, fewer source rows than the block, a top
    broker without a second row."""
    js, ts, _ = _pair()
    weight, score = k2_adversarial_inputs(np.asarray(js.assignment),
                                          js.num_brokers, num_sources, case,
                                          seed=5)
    want = jc.select_sources(js, jnp.asarray(score), jnp.asarray(weight),
                             num_sources)
    got = tc.select_sources(ts, torch.from_numpy(score),
                            torch.from_numpy(weight), num_sources)
    for a, b, name in zip(want, got, ("cand_p", "cand_s", "src_valid")):
        np.testing.assert_array_equal(_np(b), np.asarray(a), err_msg=name)
    half = k2_half(weight.size, js.num_brokers, num_sources)
    if case == "offline_1e30":
        assert (weight == np.float32(1e30)).sum() > half
    elif case == "few_sources":
        assert np.isin(np.asarray(js.assignment),
                       np.flatnonzero(score > 0)).sum() < half
    elif case == "single_replica_broker":
        # broker 1, the top source broker, has a best row and no second
        quarter = (len(want[0]) - half) // 2
        p, s, ok = (np.asarray(a) for a in want)
        assert ok[half] and not ok[half + quarter]
        assert np.asarray(js.assignment)[p[half], s[half]] == 1


# -- a numpy model of the card kernel's radix select -------------------------
# Constants of csrc/select_sources.cu.
DIGIT_BITS, PASSES, BUCKET_CAP = 11, 6, 8192
MASK64 = (1 << 64) - 1


def _keys(flat_weight):
    """common.cuh's packed keys: total-order value bits, then ~index."""
    bits = flat_weight.astype(np.float32).view(np.uint32).astype(np.uint64)
    ordered = np.where(bits & 0x80000000, ~bits & 0xFFFFFFFF,
                       bits | 0x80000000).astype(np.uint64)
    idx = np.arange(flat_weight.size, dtype=np.uint64)
    return (ordered << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - idx)


def model_select(keys, half):
    """The kernel's global block: digit passes (a histogram of the next
    digit of the keys under the prefix; the digit where the count from
    the top reaches ``half``; when every counted key falls in one bin, the
    next digit starts below the bits they share), stopping once the
    boundary bucket holds at most BUCKET_CAP keys; then the compaction of
    every key at or above the bucket's low edge and their ranks. Returns
    (the block's keys in order, real digit passes, compacted keys)."""
    prefix, high, shift, above = 0, 0, 64 - DIGIT_BITS, 0
    for passes in range(1, PASSES + 1):
        top = (high & -high).bit_length() - 1 if high else 64
        width = top - shift
        counted = keys[(keys & np.uint64(high)) == np.uint64(prefix)]
        digits = ((counted >> np.uint64(shift))
                  & np.uint64((1 << width) - 1)).astype(np.int64)
        hist = np.bincount(digits, minlength=1 << width)
        from_top = np.cumsum(hist[::-1])
        j = int(np.searchsorted(from_top, half - above))
        d = (1 << width) - 1 - j
        count = int(hist[d])
        above += int(from_top[j]) - count
        done = count <= BUCKET_CAP or shift == 0
        next_prefix, next_high = prefix | (d << shift), (MASK64 << shift) & MASK64
        next_shift = max(shift - DIGIT_BITS, 0)
        if not done and count == counted.size:
            lo, hi = int(counted.min()), int(counted.max())
            differ = (lo ^ hi).bit_length() - 1
            next_high = (MASK64 << (differ + 1)) & MASK64
            next_prefix = lo & next_high
            next_shift = max(differ + 1 - DIGIT_BITS, 0)
        prefix, high, shift = next_prefix, next_high, next_shift
        if done:
            break
    buf = keys[keys >= np.uint64(prefix)]
    assert buf.size < half + BUCKET_CAP
    return np.sort(buf)[::-1][:half], passes, buf.size


def model_best_two(keys_rest, broker, order):
    """The kernel's per-broker best two: each key, in ``order``, offered
    by atomicMax to the best slot, the key it displaced (or itself) to the
    second."""
    best = {}
    for i in order:
        b, k = int(broker[i]), int(keys_rest[i])
        first, second = best.get(b, (0, 0))
        if k < second:
            continue
        best[b] = (k, first) if k > first else (first, max(second, k))
    return best


@pytest.fixture(scope="module")
def shape_1k():
    """An assignment at the 1k-broker / 100k-partition shape: random
    brokers, 1 % empty slots, the last 100 partitions masked."""
    rng = np.random.default_rng(8)
    assignment = rng.integers(0, 1000, (100_000, 3)).astype(np.int32)
    assignment[rng.random(assignment.shape) < 0.01] = -1
    mask = np.ones(100_000, bool)
    mask[-100:] = False
    return assignment, mask


def _drain50_inputs(assignment, seed):
    """Uniform weights, and the chain's offline override for brokers
    950-999: every replica there weighs 1e30 and each broker's offline
    count is added to its score."""
    rng = np.random.default_rng(seed)
    weight = rng.random(assignment.shape).astype(np.float32)
    score = (rng.random(1000) - 0.5).astype(np.float32)
    offline = assignment >= 950
    weight[offline] = np.float32(1e30)
    score += np.bincount(assignment[offline], minlength=1000).astype(
        np.float32)
    return weight, score


@pytest.mark.parametrize("case", K2_CASES + ("drain50",))
def test_radix_select_model_matches_stable_topk_at_1k(shape_1k, case):
    assignment, mask = shape_1k
    if case == "drain50":
        weight, score = _drain50_inputs(assignment, seed=2)
    else:
        weight, score = k2_adversarial_inputs(assignment, 1000, 2048, case,
                                              seed=3)
    state = ClusterTensors(
        assignment=torch.from_numpy(assignment),
        leader_slot=torch.zeros(100_000, dtype=torch.int32),
        leader_load=torch.zeros(100_000, 4), follower_load=torch.zeros(
            100_000, 4), capacity=torch.ones(1000, 4),
        rack=torch.zeros(1000, dtype=torch.int32),
        broker_state=torch.zeros(1000, dtype=torch.int8),
        topic=torch.zeros(100_000, dtype=torch.int32),
        partition_mask=torch.from_numpy(mask),
        broker_mask=torch.ones(1000, dtype=torch.bool))
    src = tc.on_source(state, torch.from_numpy(score)).numpy()
    flat = np.where(src, weight, np.float32(-np.inf)).reshape(-1)
    half = k2_half(flat.size, 1000, 2048)
    keys = _keys(flat)
    block, passes, compacted = model_select(keys, half)
    # The block, in order, is lax.top_k's, and a row is in it iff it is
    # finite and its key is at or above the half-th key.
    want_w, want_idx = stable_topk(torch.from_numpy(flat), half)
    got_idx = (np.uint64(0xFFFFFFFF) - (block & np.uint64(0xFFFFFFFF)))
    np.testing.assert_array_equal(got_idx.astype(np.int64),
                                  want_idx.numpy().astype(np.int64))
    in_block = np.isfinite(flat) & (keys >= block[-1])
    want_in = np.zeros(flat.size, bool)
    want_in[want_idx.numpy()[np.isfinite(want_w.numpy())]] = True
    np.testing.assert_array_equal(in_block, want_in)
    # Ties reach the row index in at most three real passes.
    assert passes <= 3, passes
    if case in ("offline_1e30", "all_equal", "drain50"):
        assert (flat == flat.max()).sum() > half
    # The per-broker best two outside the block, offered in any order, are
    # the twin's picks: its best row, then its best row but that one.
    rest = np.isfinite(flat) & ~in_block
    folded = np.where(flat == 0, np.float32(0), flat)
    keys_rest = _keys(folded)
    broker = assignment.reshape(-1)
    rows = np.flatnonzero(rest)
    order = np.random.default_rng(1).permutation(rows)
    best = model_best_two(keys_rest, broker, order)
    for b in range(0, 1000, 7):
        mine = rows[broker[rows] == b]
        ranked = mine[np.lexsort((mine, -folded[mine].astype(np.float64)))]
        first, second = best.get(b, (0, 0))
        want_first = ranked[0] if ranked.size else None
        want_second = ranked[1] if ranked.size > 1 else None
        got_first = 0xFFFFFFFF - (first & 0xFFFFFFFF) if first else None
        got_second = 0xFFFFFFFF - (second & 0xFFFFFFFF) if second else None
        assert (got_first, got_second) == (want_first, want_second), b


def _grid(js, ts, seed, extra):
    jd = jderived.compute_derived(js)
    td = tderived.compute_derived(ts)
    weight, score = _scores(tuple(js.assignment.shape), js.num_brokers, seed)
    rng = np.random.default_rng(seed + 100)
    dst_score = rng.integers(-2, 3, js.num_brokers).astype(np.float32)
    dst_score[rng.random(js.num_brokers) < 0.2] = -np.inf
    j_extra = t_extra = None
    if extra:
        t_dst = rng.integers(0, js.num_brokers, 64).astype(np.int32)
        t_ok = rng.random(64) < 0.5
        j_extra = (jnp.asarray(t_dst), jnp.asarray(t_ok))
        t_extra = (torch.from_numpy(t_dst), torch.from_numpy(t_ok))
    jcand, jlay = jc.generate_candidates(
        js, jd, jnp.asarray(score), jnp.asarray(dst_score),
        jnp.asarray(weight), 64, 6, True, extra_dst=j_extra)
    tcand, tlay = tc.generate_candidates(
        ts, td, torch.from_numpy(score), torch.from_numpy(dst_score),
        torch.from_numpy(weight), 64, 6, True, extra_dst=t_extra)
    return jd, td, jcand, jlay, tcand, tlay


@pytest.mark.parametrize("extra", [False, True])
def test_generate_candidates_and_deltas_match(extra):
    js, ts, _ = _pair()
    jd, td, jcand, jlay, tcand, tlay = _grid(js, ts, 9, extra)
    assert jlay == tlay
    for f in dataclasses.fields(jcand):
        np.testing.assert_array_equal(_np(getattr(tcand, f.name)),
                                      np.asarray(getattr(jcand, f.name)),
                                      err_msg=f.name)
    jdel = jc.compute_deltas(js, jd, jcand)
    tdel = tc.compute_deltas(ts, td, tcand)
    for f in dataclasses.fields(jdel):
        a = getattr(jdel, f.name)
        if a is None:
            assert getattr(tdel, f.name) is None
            continue
        np.testing.assert_array_equal(_np(getattr(tdel, f.name)),
                                      np.asarray(a), err_msg=f.name)
    assert np.asarray(jdel.valid).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attach_cumulative_matches_segment_form(seed):
    js, ts, _ = _pair()
    jd, td, jcand, _jl, tcand, _tl = _grid(js, ts, 30 + seed, False)
    jdel = jc.compute_deltas(js, jd, jcand)
    tdel = tc.compute_deltas(ts, td, tcand)
    rng = np.random.default_rng(seed)
    m = 256
    idx = rng.choice(np.flatnonzero(np.asarray(jdel.valid)), m,
                     replace=True).astype(np.int32)
    considered = rng.random(m) < 0.7
    pot = (rng.random(m) * 5).astype(np.float32)
    lbi = (rng.random(m) * 5).astype(np.float32)
    import jax
    jsub = jax.tree.map(lambda a: a[jnp.asarray(idx)], jdel)
    jout, jhe = jc.attach_cumulative_segments(
        jsub, jnp.asarray(considered), jnp.asarray(pot), jnp.asarray(lbi))
    tout, the = tc.attach_cumulative_plain(
        tdel.take(torch.from_numpy(idx)), torch.from_numpy(considered),
        torch.from_numpy(pot), torch.from_numpy(lbi))
    np.testing.assert_array_equal(_np(the), np.asarray(jhe))
    for name in ("pre_src_load", "pre_dst_load") + tc.PRE_FIELDS:
        np.testing.assert_allclose(_np(getattr(tout, name)),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_fill_primitives_match():
    rng = np.random.default_rng(3)
    g, b, k = 5, 23, 97
    deficit = rng.integers(0, 3, (g, b)).astype(np.float32)
    headroom = rng.integers(0, 4, (g, b)).astype(np.float32)
    eligible = rng.random(b) < 0.8
    group = rng.integers(0, g, k).astype(np.int32)
    valid = rng.random(k) < 0.7
    rank_j = jfill.rank_within_group(jnp.asarray(group), jnp.asarray(valid))
    rank_t = tfill.rank_within_group(torch.from_numpy(group),
                                     torch.from_numpy(valid))
    np.testing.assert_array_equal(_np(rank_t), np.asarray(rank_j))
    np.testing.assert_array_equal(
        _np(tfill.exclusive_rank(torch.from_numpy(valid))),
        np.asarray(jfill.exclusive_rank(jnp.asarray(valid))))
    want = jfill.deficit_fill_dests(jnp.asarray(group), rank_j,
                                    jnp.asarray(deficit),
                                    jnp.asarray(headroom),
                                    jnp.asarray(eligible))
    got = tfill.deficit_fill_dests(torch.from_numpy(group), rank_t,
                                   torch.from_numpy(deficit),
                                   torch.from_numpy(headroom),
                                   torch.from_numpy(eligible))
    for a, c in zip(want, got):
        np.testing.assert_array_equal(_np(c), np.asarray(a))
    size = (rng.random(k) * 3).astype(np.float32)
    size[::7] = 0.0
    gap = rng.integers(-1, 4, b).astype(np.float32)
    want = jfill.best_fit_dests(jnp.asarray(size), rank_j, jnp.asarray(gap),
                                jnp.asarray(eligible))
    got = tfill.best_fit_dests(torch.from_numpy(size), rank_t,
                               torch.from_numpy(gap),
                               torch.from_numpy(eligible))
    for a, c in zip(want, got):
        np.testing.assert_array_equal(_np(c), np.asarray(a))
    assert tfill.targets_enabled(10_000) and not tfill.targets_enabled(500_000)

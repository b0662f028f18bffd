"""KD4 (``csrc/direct_fill.cu``) as a numpy model of its CTAs' ranges,
against its twin ``fill.fill_from_profiles`` and the reference's
``deficit_fill_dests``, exactly.

The kernel runs as many CTAs as the card holds at once, each over one
contiguous range of the movers (which the caller sorts by group, so a
range holds one group or a few and its rows stay in the SM's L1), each
mover searched by the reference's unrolled binary search in its own
group's rows. The model follows that split mover by mover and records
which range placed each, so the tests show that every mover is placed
exactly once, by the reference's search, on any group order: groups split
across ranges, the wrap of the fill position, zero-width cells, one
group, the clamped sentinel group, runs of a few movers and an unsorted
group. The card runs the same cases in ``tests/test_torch_direct_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import fill as jfill
from cruise_control_tpu_torch.analyzer import fill as tfill
from cruise_control_tpu_torch.testing import KD4_CASES, kd4_case

# The kernel's CTAs on an H100: 132 SMs, eight 256-thread CTAs each (the
# wrapper asks the occupancy API; any count places the same).
RESIDENT = 8 * 132


def search(row: np.ndarray, q: np.float32, steps: int) -> int:
    """The reference's unrolled binary search on one row."""
    n = row.shape[0]
    lo, hi = 0, n
    for _ in range(steps):
        mid = (lo + hi) >> 1
        gt = row[min(mid, n - 1)] > q
        if gt and mid < hi:
            hi = mid
        lo = lo if gt else min(mid + 1, hi)
    return hi


def kd4_model(group, rank, cum_d, cum_h, resident=RESIDENT):
    """(dst, ok, the range [n] that placed each mover) of KD4: ranges of
    ceil(n / resident) consecutive movers, each mover searched in its own
    group's rows."""
    n = group.shape[0]
    b = cum_d.shape[1]
    steps = int(b).bit_length()
    per = -(-n // resident)
    dst = np.full(n, -1, np.int32)
    ok = np.zeros(n, bool)
    cta = np.full(n, -1, np.int64)
    for c, lo in enumerate(range(0, n, per)):
        for i in range(lo, min(n, lo + per)):
            assert cta[i] == -1, f"mover {i} placed twice"
            rd, rh = cum_d[group[i]], cum_h[group[i]]
            q = np.float32(rank[i]) + np.float32(0.5)
            tot_d = rd[b - 1]
            in_def = q < tot_d
            j = search(rd, q, steps) if in_def else \
                search(rh, np.float32(q - tot_d), steps)
            ok[i] = bool(q < np.float32(tot_d + rh[b - 1])) and j < b
            dst[i] = min(max(j, 0), b - 1)
            cta[i] = c
    assert (cta >= 0).all(), "a mover was never placed"
    return dst, ok, cta


def _profiles(deficit, headroom, eligible):
    d = torch.where(torch.as_tensor(eligible)[None, :],
                    torch.as_tensor(deficit), 0.0)
    h = torch.where(torch.as_tensor(eligible)[None, :],
                    torch.as_tensor(headroom), 0.0)
    return torch.cumsum(d, 1), torch.cumsum(h, 1)


def _check(name, n, g, b, resident=RESIDENT):
    group, rank, deficit, headroom, eligible = kd4_case(name, n, g, b)
    cum_d, cum_h = _profiles(deficit, headroom, eligible)
    got = kd4_model(group, rank, cum_d.numpy(), cum_h.numpy(), resident)
    twin = tfill.fill_from_profiles(torch.as_tensor(group),
                                    torch.as_tensor(rank), cum_d, cum_h)
    ref = jax.jit(jfill.deficit_fill_dests)(
        jnp.asarray(group), jnp.asarray(rank), jnp.asarray(deficit),
        jnp.asarray(headroom), jnp.asarray(eligible))
    for label, want in (("twin", twin), ("reference", ref)):
        np.testing.assert_array_equal(got[0], np.asarray(want[0]),
                                      err_msg=f"{name} dst vs {label}")
        np.testing.assert_array_equal(got[1], np.asarray(want[1]),
                                      err_msg=f"{name} ok vs {label}")
    return group, rank, got


@pytest.mark.parametrize("name", KD4_CASES)
@pytest.mark.parametrize("n,g,b,resident", [
    (3000, 4, 257, RESIDENT), (12_000, 9, 1000, RESIDENT),
    (9000, 3, 7000, 7), (3000, 4, 257, 1)])
def test_ranges_match_twin_and_reference(name, n, g, b, resident):
    _group, _rank, (_dst, ok, _cta) = _check(name, n, g, b, resident)
    assert 0 < ok.sum() < n          # some movers beyond their group's total


def test_cases_reach_every_branch():
    """Sorted groups split across ranges; the wrapped ranks give each
    group two increasing runs; runs of about three movers and an unsorted
    order put many groups in one range."""
    group, rank, (_d, _o, cta) = _check("sorted", 24_000, 9, 1000, 24)
    runs = np.flatnonzero(np.diff(group)) + 1
    assert (cta[runs] == cta[runs - 1]).any()       # a range holds two
    starts = np.flatnonzero(np.diff(cta)) + 1
    assert (group[starts] == group[starts - 1]).any()   # a group split
    first = np.r_[0, runs]
    for s, e in zip(first, np.r_[runs, group.shape[0]]):
        assert int((np.diff(rank[s:e]) < 0).sum()) <= 1   # one wrap at most
    assert any((np.diff(rank[s:e]) < 0).any()
               for s, e in zip(first, np.r_[runs, group.shape[0]]))
    for name in ("short_runs", "unsorted"):
        group, _r, (_d, _o, cta) = _check(name, 20_000, 9, 64, 8)
        per_range = [np.unique(group[cta == c]).size for c in range(8)]
        assert min(per_range) > 8


def test_zero_width_cells_and_sentinel_tail():
    """Equal neighbouring cumsum entries are never a destination of a
    placed mover; the sentinel tail's movers (rank 0) all land where its
    group's first cell lies."""
    group, rank, deficit, headroom, eligible = kd4_case("sentinel", 20_000,
                                                        9, 1000)
    cum_d, cum_h = _profiles(deficit, headroom, eligible)
    dst, ok, _cta = kd4_model(group, rank, cum_d.numpy(), cum_h.numpy())
    width = np.concatenate([deficit * eligible, headroom * eligible], 1)
    assert (width == 0).mean() > 0.3
    tail = slice(20_000 - 20_000 // 3, None)
    assert (group[tail] == 8).all() and (dst[tail] == dst[tail][0]).all()
    cd, ch = cum_d.numpy(), cum_h.numpy()
    q = rank + np.float32(0.5)
    for i in np.flatnonzero(ok)[::97]:
        g, j = group[i], dst[i]
        in_def = q[i] < cd[g, -1]
        row = cd[g] if in_def else ch[g]
        x = q[i] if in_def else q[i] - cd[g, -1]
        lo = row[j - 1] if j else np.float32(0.0)
        assert lo <= x < row[j] and row[j] > lo

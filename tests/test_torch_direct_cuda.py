"""The direct-assignment transport's kernels KD1-KD4 against their twins on
the card, on adversarial inputs, and a direct solve on the card against
the CPU.

Every comparison is exact: KD1's permutation and KD4's destinations are
integers; KD2 and KD3 reproduce the twins' f32 association, so their
outputs are compared bit for bit with the twins run on a CPU copy.

These tests need an NVIDIA GPU with nvcc; they skip elsewhere. On the card
run them with ``python -m pytest --noconftest -q -m cuda
tests/test_torch_direct_cuda.py``.
"""

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer import direct_kernels as dk
from cruise_control_tpu_torch.analyzer import fill
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.config import CruiseControlConfig
from cruise_control_tpu_torch.model.fixtures import Dist, random_cluster
from cruise_control_tpu_torch.testing import (
    KD1_CASES, KD1_SIZES, KD2_CASES, KD2_SIZES, KD3_CASES, KD4_CASES,
    kd1_case, kd2_case, kd2_checks, kd3_case, kd4_case,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    return (t.view(torch.int32) if t.dtype == torch.float32 else t).numpy()


@pytest.mark.parametrize("name", KD1_CASES)
@pytest.mark.parametrize("n", KD1_SIZES)
@pytest.mark.parametrize("with_second", [True, False])
def test_direct_sort_matches_twin(card, name, n, with_second):
    key, sec, key_max = kd1_case(name, n)
    kt, st = torch.as_tensor(key), torch.as_tensor(sec)
    want_k, want_p = dk.sort_pairs(kt, key_max, st if with_second else None)
    kernels.LAUNCHES.clear()
    got_k, got_p = dk.sort_pairs(kt.to(card), key_max,
                                 st.to(card) if with_second else None)
    assert kernels.LAUNCHES["direct_sort"] == 1
    np.testing.assert_array_equal(got_p.cpu().numpy(), want_p.numpy())
    np.testing.assert_array_equal(got_k.cpu().numpy(), want_k.numpy())


def _card_checks(n, r, table, card, count):
    """``testing.kd2_checks`` on ``card``; the arrays a pair shares become
    one tensor, so KD2 judges the pair as one group."""
    copies = {}

    def on(x):
        if x is None:
            return None
        if id(x) not in copies:
            copies[id(x)] = torch.as_tensor(x).to(card)
        return copies[id(x)]

    return [dk.Check(limit=on(lim), base=on(base), column=col,
                     own_column=own, floor=floor, gate=on(gate))
            for lim, base, col, own, floor, gate
            in kd2_checks(n, r, table, count)]


@pytest.mark.parametrize("name", KD2_CASES)
@pytest.mark.parametrize("n", (1,) + KD2_SIZES + (300_001, 16 ** 5 + 1))
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_segment_scan_matches_twin(card, name, n, r):
    keys, vals, table = kd2_case(name, n, r)
    k = torch.as_tensor(keys)
    v = torch.as_tensor(vals if r > 1 else vals[:, 0].copy())
    perm = torch.as_tensor(
        np.random.default_rng(n + r).permutation(n).astype(np.int32))
    count = {4: 12, 3: 8, 2: 3, 1: 3}[r]
    checks = _card_checks(n, r, table, "cpu", count)
    want_e, want_v = dk.segment_scan(k, v, checks, perm)
    kernels.LAUNCHES.clear()
    got_e, got_v = dk.segment_scan(
        k.to(card), v.to(card), _card_checks(n, r, table, card, count),
        perm.to(card))
    assert kernels.LAUNCHES["segment_scan"] == 1
    np.testing.assert_array_equal(_bits(got_e), _bits(want_e))
    np.testing.assert_array_equal(got_v.cpu().numpy(), want_v.numpy())
    # int32 values (the ranks), exact.
    ones = torch.as_tensor(np.random.default_rng(n).integers(
        0, 2, vals.shape).astype(np.int32))
    ones = ones if r > 1 else ones[:, 0].contiguous()
    want_i, _ = dk.segment_scan(k, ones)
    got_i, _ = dk.segment_scan(k.to(card), ones.to(card))
    np.testing.assert_array_equal(got_i.cpu().numpy(), want_i.numpy())


def _plan_case(name: str, g: int, b: int, rng):
    if name == "dense":
        cnt = rng.poisson(30.0, (g, b)).astype(np.float32)
    elif name == "sparse":
        cnt = rng.poisson(0.6, (g, b)).astype(np.float32)
    else:   # balanced: an empty plan
        cnt = np.full((g, b), 3.0, np.float32)
    avg = cnt.mean(axis=1, keepdims=True)
    upper = np.ceil(avg * 1.1).astype(np.float32)
    lower = np.floor(avg / 1.1).astype(np.float32)
    alive = rng.random(b) > 0.05
    elig = alive & (rng.random(b) > 0.05)
    return cnt, lower, upper, alive, elig


# KD3's rows: one broker, either side of a window of 32, 1k and 7k brokers
# and the kernel's limit, at one row (1,024-thread CTAs), 100 and 700.
KD3_SHAPES = [(g, b) for b in (1, 31, 32, 33, 1000, 7000,
                               dk.PLAN_MAX_BROKERS)
              for g in (1, 100, 700)]


@pytest.mark.parametrize("name", KD3_CASES)
@pytest.mark.parametrize("g,b", KD3_SHAPES)
@pytest.mark.parametrize("sweep", [0, 5])
def test_direct_plan_matches_twin(card, name, g, b, sweep):
    args = [torch.as_tensor(x)
            for x in kd3_case(name, g, b, seed=g * b + sweep)]
    seed = dk.sparse_rounding_seed("" if sweep == 0 else "fleet-a")
    want = dk.direct_plan(*args, sweep, 0.25, seed)
    kernels.LAUNCHES.clear()
    got = dk.direct_plan(*[a.to(card) for a in args], sweep, 0.25, seed)
    assert kernels.LAUNCHES["direct_plan"] == 1
    for w, gt in zip(want, got):
        np.testing.assert_array_equal(_bits(gt), _bits(w))


@pytest.mark.parametrize("name", ["dense", "sparse", "balanced"])
def test_direct_fill_matches_twin(card, name):
    rng = np.random.default_rng(7)
    args = [torch.as_tensor(x) for x in _plan_case(name, 70, 700, rng)]
    _s, _d, _h, cum_d, cum_h = dk.direct_plan(*args)
    n = 50_001
    grp = torch.as_tensor(rng.integers(0, 70, n).astype(np.int32))
    rank = torch.as_tensor(rng.integers(0, 200, n).astype(np.float32))
    want = fill.direct_fill_dests(grp, rank, cum_d, cum_h)
    kernels.LAUNCHES.clear()
    got = fill.direct_fill_dests(grp.to(card), rank.to(card),
                                 cum_d.to(card), cum_h.to(card))
    assert kernels.LAUNCHES["direct_fill"] == 1
    for w, gt in zip(want, got):
        np.testing.assert_array_equal(gt.cpu().numpy(), w.numpy())


@pytest.mark.parametrize("name", KD4_CASES)
@pytest.mark.parametrize("n,g,b", [(3000, 4, 257), (600_001, 2100, 1000),
                                   (1_100_000, 300, 7000),
                                   (20_000, 3, 20_000)])
def test_direct_fill_matches_twin_on_range_cases(card, name, n, g, b):
    """KD4 on `testing.KD4_CASES` (tests/test_torch_direct_fill.py):
    groups split across the CTAs' ranges, wrapped ranks, zero-width
    cells, one group, the clamped sentinel tail, runs of a few movers
    (6,666 groups) and an unsorted group, from a few movers a CTA to
    thousands, and rows of 20,000 brokers."""
    if name == "short_runs":        # n // 3 groups
        n, b = 20_000, 400 if b in (1000, 7000) else min(b, 257)
    group, rank, deficit, headroom, eligible = kd4_case(name, n, g, b)
    elig = torch.as_tensor(eligible)[None, :]
    cum_d = torch.cumsum(torch.where(elig, torch.as_tensor(deficit), 0.0), 1)
    cum_h = torch.cumsum(torch.where(elig, torch.as_tensor(headroom), 0.0),
                         1)
    grp, rk = torch.as_tensor(group), torch.as_tensor(rank)
    want = fill.direct_fill_dests(grp, rk, cum_d, cum_h)
    kernels.LAUNCHES.clear()
    got = fill.direct_fill_dests(grp.to(card), rk.to(card), cum_d.to(card),
                                 cum_h.to(card))
    assert kernels.LAUNCHES["direct_fill"] == 1
    for w, gt in zip(want, got):
        np.testing.assert_array_equal(gt.cpu().numpy(), w.numpy())


def test_direct_solve_on_the_card_equals_the_cpu(card):
    """A direct solve at 100 brokers / 10k partitions (density 30: every
    count goal takes the direct arm) on the card equals the CPU twin's,
    and its sweeps went through KD1-KD4."""
    props = {"solver.direct.assignment.enabled": True,
             "solver.wide.batch.min.brokers": 64,
             "solver.fused.chain.max.brokers": 64,
             "solver.dispatch.target.seconds": 0}
    size = dict(num_brokers=100, num_topics=10, num_partitions=10_000, rf=3,
                num_racks=8, seed=42, skew_to_first=2.0,
                target_utilization=0.55, dist=Dist.EXPONENTIAL)
    results = {}
    for dev in ("cpu", card):
        state, meta = random_cluster(**size, device=dev)
        kernels.LAUNCHES.clear()
        opt = GoalOptimizer(CruiseControlConfig(props), device=dev)
        final, res = opt.optimizations(state, meta)
        results[str(dev)] = (final.assignment.cpu().numpy(),
                             final.leader_slot.cpu().numpy(),
                             [(g.name, g.rounds, g.moves_applied,
                               d["direct_moves"], d["direct_sweeps"])
                              for g, d in zip(res.goal_results,
                                              opt.last_direct_stats())],
                             dict(kernels.LAUNCHES))
    cpu, gpu = results["cpu"], results[str(card)]
    assert any(g[4] > 0 for g in cpu[2])
    np.testing.assert_array_equal(gpu[0], cpu[0])
    np.testing.assert_array_equal(gpu[1], cpu[1])
    assert gpu[2] == cpu[2]
    for name in ("direct_sort", "segment_scan", "direct_plan",
                 "direct_fill"):
        assert gpu[3].get(name, 0) > 0, name

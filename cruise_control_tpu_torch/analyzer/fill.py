"""Constructive destination assignment for the candidate grid.

Port of ``cruise_control_tpu/analyzer/fill.py``: one TARGETED destination
per source card, appended to the move block as an extra grid column —
``deficit_fill_dests`` (proportional fill over per-(topic, broker)
deficits then headroom) for count goals, ``best_fit_dests`` (size-matched
round robin) for resource goals.

The direct-assignment transport (``analyzer/direct.py``) places its movers
by the same proportional fill, over the row-cumulative profiles its plan
(KD3) already wrote: ``direct_fill_dests``, kernel KD4
(``csrc/direct_fill.cu``, the reference's binary search step for step,
one thread a mover, each CTA over a contiguous range of the movers
sorted by group so a group's rows stay in its SM's L1) on the card and
its twin ``fill_from_profiles`` on the CPU. The targeted column keeps the plain ``deficit_fill_dests``.
"""

from __future__ import annotations

import os

import torch

from .. import kernels
from ..utils.numerics import stable_topk

# The reference's experiment switches, read from the same environment
# variables when the module is imported: CC_TARGET_DESTS=0 removes the
# targeted column everywhere (the control arm of its experiments); the
# column is on below CC_TARGET_DESTS_MAX_P partitions (the scale gate,
# 500,000 by default); CC_TGT_CLASSES, a comma-separated list of goal
# class names, keeps it for those goals only (empty: every goal).
TARGET_DESTS_ON = os.environ.get("CC_TARGET_DESTS", "1") == "1"
TARGET_DESTS_MAX_P = int(os.environ.get("CC_TARGET_DESTS_MAX_P", "500000"))
_TGT_CLASSES = os.environ.get("CC_TGT_CLASSES", "")


def targets_enabled(num_partitions: int) -> bool:
    return TARGET_DESTS_ON and num_partitions < TARGET_DESTS_MAX_P


def class_enabled(goal) -> bool:
    """Whether ``goal``'s class contributes targeted destinations."""
    return (not _TGT_CLASSES
            or type(goal).__name__ in _TGT_CLASSES.split(","))


def pow2_width(n: int) -> int:
    """Round a measured work size up to the next power of two (the
    quantization of every deficit-sized grid width)."""
    return 1 << max(0, int(n) - 1).bit_length()


def row_searchsorted(cum: torch.Tensor, rows: torch.Tensor,
                     q: torch.Tensor) -> torch.Tensor:
    """Per-card first index j with ``cum[rows[i], j] > q[i]`` (rows of
    ``cum`` non-decreasing); ``cum.shape[1]`` when no such j. The same
    unrolled binary search as the reference."""
    n = cum.shape[1]
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    hi = torch.full(q.shape, n, dtype=torch.int64, device=q.device)
    rows = rows.long()
    for _ in range(max(1, int(n).bit_length())):
        mid = (lo + hi) // 2
        v = cum[rows, torch.clamp(mid, max=n - 1)]
        gt = v > q
        hi = torch.where(gt & (mid < hi), mid, hi)
        lo = torch.where(gt, lo, torch.minimum(mid + 1, hi))
    return hi.to(torch.int32)


def rank_within_group(group: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[k] — number of EARLIER valid cards with the same group id."""
    k = group.shape[0]
    idx = torch.arange(k, device=group.device)
    earlier = idx[:, None] > idx[None, :]
    same = group[:, None] == group[None, :]
    return (earlier & same & valid[None, :]).sum(dim=1).to(torch.int32)


def exclusive_rank(valid: torch.Tensor) -> torch.Tensor:
    """[k] — number of earlier valid cards."""
    v = valid.to(torch.int32)
    return (torch.cumsum(v, 0) - v).to(torch.int32)


def deficit_fill_dests(topic_idx: torch.Tensor, rank: torch.Tensor,
                       deficit: torch.Tensor, headroom: torch.Tensor,
                       eligible: torch.Tensor,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Targeted destination per card by proportional fill over the
    concatenated [deficit | headroom] profile of its group. The profiles
    are integer-valued, so their cumsums are exact in any order."""
    zero = torch.zeros((), dtype=torch.float32, device=deficit.device)
    d = torch.where(eligible[None, :], deficit, zero).to(torch.float32)
    h = torch.where(eligible[None, :], headroom, zero).to(torch.float32)
    return fill_from_profiles(topic_idx, rank, torch.cumsum(d, 1),
                              torch.cumsum(h, 1))


def fill_from_profiles(group: torch.Tensor, rank: torch.Tensor,
                       cum_d: torch.Tensor, cum_h: torch.Tensor,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """``deficit_fill_dests`` from the row-inclusive cumsums of its
    (eligible-masked) deficit and headroom planes; KD4's twin."""
    t = group.long()
    tot_d = cum_d[:, -1][t]
    tot_h = cum_h[:, -1][t]
    q = rank.to(torch.float32) + 0.5
    in_def = q < tot_d
    j_d = row_searchsorted(cum_d, t, q)
    j_h = row_searchsorted(cum_h, t, q - tot_d)
    b = cum_d.shape[1]
    dst = torch.where(in_def, j_d, j_h)
    ok = (q < tot_d + tot_h) & (dst < b)
    return torch.clamp(dst, 0, b - 1).to(torch.int32), ok


def direct_fill_dests(group: torch.Tensor, rank: torch.Tensor,
                      cum_d: torch.Tensor, cum_h: torch.Tensor,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dst [n] int32, ok [n] bool)`` of the direct transport's movers:
    mover i (group ``group[i]`` in [0, G), f32 fill position ``rank[i]``)
    lands where its position falls in its group's [deficit | headroom]
    profile, given as the row-inclusive cumsums ``cum_d`` / ``cum_h``
    [G, B] f32. KD4 on the card, ``fill_from_profiles`` on the CPU."""
    dev = group.device
    if dev.type == "cpu":
        return fill_from_profiles(group, rank, cum_d, cum_h)
    if dev.type != "cuda":
        raise ValueError(f"direct_fill_dests: unsupported device {dev}")
    n = group.shape[0]
    g_dim, b = cum_d.shape
    if not 0 < n < 2 ** 31 or not 0 < b < 2 ** 30 \
            or g_dim * b >= 2 ** 31:
        raise kernels.limit_error("direct_fill", f"n={n}, G={g_dim}, B={b}")
    req = kernels.requirer("direct_fill")
    req(group, dev, torch.int32, (n,), "group")
    req(rank, dev, torch.float32, (n,), "rank")
    req(cum_d, dev, torch.float32, (g_dim, b), "cum_d")
    req(cum_h, dev, torch.float32, (g_dim, b), "cum_h")
    dst = torch.empty(n, dtype=torch.int32, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    lib = kernels.library("direct_fill")
    kernels.check(lib.cc_direct_fill(
        group.data_ptr(), rank.data_ptr(), cum_d.data_ptr(),
        cum_h.data_ptr(), n, g_dim, b, dst.data_ptr(), ok.data_ptr(),
        kernels.stream_ptr(dev)), "direct_fill")
    kernels.LAUNCHES["direct_fill"] += 1
    return dst, ok


def best_fit_dests(size: torch.Tensor, rank: torch.Tensor,
                   headroom: torch.Tensor, eligible: torch.Tensor,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Targeted destination per card by size fit: destinations by band
    gap descending; card i is assigned round-robin across those whose gap
    fits its size."""
    b = headroom.shape[0]
    key = torch.where(eligible, headroom,
                      torch.full((), float("-inf"), device=headroom.device))
    vals, idx = stable_topk(key, b)
    m = row_searchsorted(-vals[None, :], torch.zeros_like(rank), -size)
    ok = (m > 0) & torch.isfinite(size) & (size > 0)
    q = rank % torch.clamp(m, min=1)
    dst = idx[torch.clamp(q, 0, b - 1).long()]
    return dst.to(torch.int32), ok

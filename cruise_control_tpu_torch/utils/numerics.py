"""Float reductions in the reference's order.

The JAX package runs on XLA, whose CPU backend sums with a fixed,
data-independent association that differs from PyTorch's kernels:

- ``reduce(add)`` over an axis of length n > 32 is rewritten into a
  window-32 reduce-window over the axis padded symmetrically to a
  multiple of 32 (``pad_lo = (32·ceil(n/32) - n) // 2``), then the
  window sums are reduced the same way, recursively; a window (and any
  axis of length ≤ 32) is summed sequentially in index order.
- ``cumsum`` over an axis of length n > 16 is blocked by 16: sequential
  inclusive prefixes inside each block, plus the exclusive prefix of the
  block totals (computed the same way, recursively).

Reproducing the association makes every f32 sum of the port carry the
reference's bits, so decisions made on those sums (bands, averages,
pre-deltas) agree exactly instead of within an ulp. Integer sums are
exact in any order and use ``torch.sum`` directly.

XLA:CPU also contracts a multiply feeding an add in one fused loop into a
fused multiply-add (``fma_f32``), which rounds once where PyTorch's
elementwise kernels round twice. Where LLVM's loop vectorizer takes a
short fused reduce, the association is that of an 8-lane vector
accumulator instead (``xla_vector_sum``).
"""

from __future__ import annotations

import numpy as np
import torch

_SUM_WINDOW = 32
_CUMSUM_BLOCK = 16
_VECTOR_LANES = 8


def _seq_sum0(x: torch.Tensor) -> torch.Tensor:
    """Sequential sum over dim 0 (index order)."""
    acc = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        acc = acc + x[i]
    return acc


def xla_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum of a float tensor over ``dim`` with XLA:CPU's association
    (module docstring). ``dim`` is removed from the result."""
    x = torch.movedim(x, dim, 0)
    n = x.shape[0]
    if n == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while n > _SUM_WINDOW:
        nw = -(-n // _SUM_WINDOW)
        pad = nw * _SUM_WINDOW - n
        lo = pad // 2
        zeros = x.new_zeros((pad,) + tuple(x.shape[1:]))
        xp = torch.cat([zeros[:lo], x, zeros[lo:]], dim=0)
        xp = xp.reshape((nw, _SUM_WINDOW) + tuple(x.shape[1:]))
        x = _seq_sum0(torch.movedim(xp, 1, 0))
        n = nw
    return _seq_sum0(x)


# Lengths at which XLA:CPU vectorizes the fused violation reduce with 8
# lanes (``xla_vector_sum``), as a jitted program of the same shape shows
# (tests/test_torch_agg.py): up to 15 it stays scalar and sequential; at
# 20-23 neither form was seen to match, and ``xla_sum`` stays; above 32 the
# reduce is a reduce-window.
VECTOR_SUM_LENGTHS = frozenset([*range(16, 20), *range(24, 33)])


def xla_vector_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a 1-D f32 tensor whose length is in ``VECTOR_SUM_LENGTHS``
    as XLA:CPU emits a fused reduce that LLVM's loop vectorizer took: 8
    lanes (AVX2's 256 bits), lane j adding elements j, j+8, ... in turn,
    over the first 8 * floor((n - 1) / 8) elements (the loop reads its
    operand with a strided load whose group leaves a gap, so at least one
    iteration is left to the scalar epilogue); the lanes then reduced by
    halves (``llvm.vector.reduce.fadd`` with reassociation: lane j + lane
    j+4, then j + j+2, then 0 + 1); then the remaining elements added in
    index order. The reference's optimized HLO and LLVM IR show this form
    in the resource distribution goals' violation reduce when a
    replica-move exclusion mask enters it (16 brokers); without the mask
    that reduce is scalar and sequential (``xla_sum``)."""
    n = x.shape[0]
    if n not in VECTOR_SUM_LENGTHS:
        raise ValueError(f"xla_vector_sum: length {n} is not one at which "
                         "the reduce was seen vectorized")
    nv = _VECTOR_LANES * ((n - 1) // _VECTOR_LANES)
    lanes = _seq_sum0(x[:nv].reshape(-1, _VECTOR_LANES))
    while lanes.shape[0] > 1:
        half = lanes.shape[0] // 2
        lanes = lanes[:half] + lanes[half:]
    acc = lanes[0]
    for i in range(nv, n):
        acc = acc + x[i]
    return acc


def xla_cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inclusive cumulative sum over ``dim`` with XLA:CPU's association
    (module docstring)."""
    x = torch.movedim(x, dim, 0)
    n = x.shape[0]
    if n <= _CUMSUM_BLOCK:
        out = x.clone()
        for i in range(1, n):
            out[i] = out[i - 1] + x[i]
        return torch.movedim(out, 0, dim)
    nb = -(-n // _CUMSUM_BLOCK)
    rest = tuple(x.shape[1:])
    xp = torch.cat([x, x.new_zeros((nb * _CUMSUM_BLOCK - n,) + rest)])
    blocks = xp.reshape((nb, _CUMSUM_BLOCK) + rest)
    inner = blocks.clone()
    for i in range(1, _CUMSUM_BLOCK):
        inner[:, i] = inner[:, i - 1] + blocks[:, i]
    totals = inner[:, -1]
    incl = torch.movedim(xla_cumsum(totals, 0), 0, 0)
    offsets = torch.cat([incl.new_zeros((1,) + rest), incl[:-1]])
    out = (inner + offsets[:, None]).reshape((nb * _CUMSUM_BLOCK,) + rest)[:n]
    return torch.movedim(out, 0, dim)


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` of f32 operands rounded once to f32: the fused
    multiply-add into which XLA:CPU's LLVM backend contracts a multiply
    and an add of one fused loop (the balance-band and capacity-limit
    arithmetic ``load - threshold * capacity`` of the reference's goals).

    The product of two f32 values is exact in f64; the f64 sum is then
    rounded to odd (its error, from TwoSum, sets the last bit) so that the
    final rounding to f32 equals one rounding of the exact value. Plain
    f64 arithmetic, so the CPU and the card give the same bits, and no
    reliance on what a compiler contracts."""
    a, b, c = (x.to(torch.float32).double() if isinstance(x, torch.Tensor)
               else float(np.float32(x)) for x in (a, b, c))
    if not isinstance(c, torch.Tensor):
        c = torch.full_like(a if isinstance(a, torch.Tensor) else b, c)
    p = a * b
    c64 = c
    s = p + c64
    cb = s - p
    err = (p - (s - cb)) + (c64 - cb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose signed order is the IEEE total order of the f32
    values (-0.0 < +0.0, NaN above +inf) — the order ``lax.top_k`` and
    ``lax.sort`` use."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def stable_topk(x: torch.Tensor, k: int,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis of an f32 tensor: the k largest
    values in descending total order, ties (and ``-inf``s) lower index
    first. ``torch.topk`` promises no order among ties and ``torch.sort``
    treats -0.0 and +0.0 as equal, so this sorts total-order keys
    stably."""
    _, idx = torch.sort(total_order_key(x), dim=-1, descending=True,
                        stable=True)
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx.to(torch.int32)

"""Top-k in `jax.lax.top_k`'s order: largest first, ties to the lower
index. `torch.topk` promises no order among equal values, and the
anchor-free assigners meet ties (SimOTA's non-candidate cost band, TAL's
zero metric outside a GT) where the order picks the assignment."""

from __future__ import annotations

import torch

_LOW31 = 0x7FFFFFFF


def topk_lower_index_first(x: torch.Tensor, k: int):
    """(values, indices) of the k largest float32 entries along the last
    dim, sorted descending, equal values by ascending index. Each entry
    gets one int64 key, its float's bits made monotone in the upper 32
    (negative floats have their lower 31 bits flipped) and its reversed
    index in the lower 32, so the keys are distinct and `torch.topk` on
    them has one answer. No NaNs."""
    bits = x.float().contiguous().view(torch.int32)
    bits = torch.where(bits < 0, bits ^ _LOW31, bits).to(torch.int64)
    n = x.shape[-1]
    rev = torch.arange(n - 1, -1, -1, device=x.device, dtype=torch.int64)
    _, idx = torch.topk(bits * (1 << 32) + rev, k, dim=-1)
    return x.gather(-1, idx), idx

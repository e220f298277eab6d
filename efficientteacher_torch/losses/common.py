"""Loss primitives (counterpart of `efficientteacher_tpu/losses/common.py`;
reference models/loss/loss.py:16-60): stable BCE-with-logits with torch's
`pos_weight` semantics, its focal form, the masked mean that stands in
for `.mean()` over a ragged selection, and the losses' input cast."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smooth_bce(eps: float = 0.0):
    """Positive/negative BCE targets for label smoothing (loss.py:16-19)."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: float = 1.0) -> torch.Tensor:
    """Elementwise -[pw t log s(x) + (1 - t) log(1 - s(x))]."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def focal_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                          gamma: float, alpha: float = 0.25,
                          pos_weight: float = 1.0) -> torch.Tensor:
    """The reference FocalLoss wrapper around BCE (loss.py:24-46)."""
    loss = bce_with_logits(logits, targets, pos_weight)
    p = torch.sigmoid(logits)
    p_t = targets * p + (1.0 - targets) * (1.0 - p)
    alpha_factor = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    return loss * alpha_factor * (1.0 - p_t) ** gamma


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                eps: float = 1e-9) -> torch.Tensor:
    """Mean of `x` where `mask` (broadcastable) is true; 0 where none is."""
    mask = mask.to(x.dtype)
    return (x * mask).sum() / mask.sum().clamp(min=eps)


def loss_dtype(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32, the losses' precision (a bf16 forward's maps are
    cast up), or in float64 as it is, for float64 parity checks."""
    return x if x.dtype == torch.float64 else x.float()

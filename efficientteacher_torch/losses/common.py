"""Loss primitives (counterpart of `efficientteacher_tpu/losses/common.py`;
reference models/loss/loss.py:16-60): stable BCE-with-logits with torch's
`pos_weight` semantics, its focal form, the masked mean that stands in
for `.mean()` over a ragged selection, the keypoints' wing loss, and the
losses' input cast.

Under DDP (`parallel/distributed.py`) each rank's loss is its share of
the global batch's: normalisers are summed over the ranks, batch means
divided by the world size and the loss scaled by the global batch, so
the gradients summed over the ranks are the global batch's."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel.distributed import global_sum, world_size


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
    """Mean of `x` where `mask` (broadcastable) is true; 0 where none is.
    Under DDP the count is the global batch's (`global_sum`), so the
    ranks' terms add up to the global batch's mean."""
    mask = mask.to(x.dtype)
    return (x * mask).sum() / global_sum(mask.sum()).clamp(min=eps)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """`x.mean()` over a batch-shaped tensor; under DDP this rank's share
    of the global batch's mean (every rank holds as many images)."""
    return x.mean() / world_size()


def batch_scale(b: int) -> int:
    """The global batch size of a rank's batch of `b`: the losses' scale
    (reference `loss * bs` with `loss *= WORLD_SIZE` under DDP)."""
    return b * world_size()


def wing_loss(pred: torch.Tensor, target: torch.Tensor, w: float = 10.0,
              e: float = 2.0) -> torch.Tensor:
    """Elementwise Wing loss for landmark regression (reference
    models/loss/loss.py:573-595, arXiv:1711.06753)."""
    c = w - w * math.log(1.0 + w / e)
    d = (pred - target).abs()
    return torch.where(d < w, w * torch.log(1.0 + d / e), d - c)


def landmarks_loss(pred: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Wing loss summed over the visible keypoint coordinates, over their
    count (reference LandmarksLossYolov5, loss.py:436-445)."""
    m = mask.to(pred.dtype)
    return wing_loss(pred * m, target * m).sum() / (global_sum(m.sum())
                                                    + 1e-13)


def loss_dtype(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32, the losses' precision (a bf16 forward's maps are
    cast up), or in float64 as it is, for float64 parity checks."""
    return x if x.dtype == torch.float64 else x.float()

"""Box geometry primitives (counterpart of
`efficientteacher_tpu/ops/boxes.py`).

Only what the eval and training slices run is ported so far. Same
arithmetic, in the same order, as the JAX functions, so NMS decisions match
bit for bit:
  - xywh2xyxy: reference utils/general.py:575
  - box_iou (pairwise NxM): reference utils/metrics.py:252-274
  - bbox_ciou (elementwise CIoU, xywh): reference utils/metrics.py:207-249
"""

from __future__ import annotations

import math

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2) over the last dim."""
    cx, cy, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def box_iou(box1: torch.Tensor, box2: torch.Tensor,
            eps: float = 0.0) -> torch.Tensor:
    """Pairwise IoU: (..., N, 4) x (..., M, 4) xyxy -> (..., N, M).
    With eps 0, as the JAX oracle `greedy_nms_keep` uses it."""
    area1 = (box1[..., 2] - box1[..., 0]) * (box1[..., 3] - box1[..., 1])
    area2 = (box2[..., 2] - box2[..., 0]) * (box2[..., 3] - box2[..., 1])
    lt = torch.maximum(box1[..., :, None, :2], box2[..., None, :, :2])
    rb = torch.minimum(box1[..., :, None, 2:4], box2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[..., :, None] + area2[..., None, :] - inter + eps)


def bbox_ciou(box1: torch.Tensor, box2: torch.Tensor,
              eps: float = 1e-7) -> torch.Tensor:
    """Elementwise CIoU of broadcastable xywh boxes (..., 4): the JAX
    `bbox_iou(x1y1x2y2=False, CIoU=True)` (ops/boxes.py:140), the form both
    losses call. As the reference: `+eps` on the heights only, and alpha is
    a constant to autograd. The JAX function's other forms (xyxy input,
    plain IoU, GIoU, DIoU, SIoU) have no caller in the port."""
    b1_x1 = box1[..., 0] - box1[..., 2] / 2
    b1_x2 = box1[..., 0] + box1[..., 2] / 2
    b1_y1 = box1[..., 1] - box1[..., 3] / 2
    b1_y2 = box1[..., 1] + box1[..., 3] / 2
    b2_x1 = box2[..., 0] - box2[..., 2] / 2
    b2_x2 = box2[..., 0] + box2[..., 2] / 2
    b2_y1 = box2[..., 1] - box2[..., 3] / 2
    b2_y2 = box2[..., 1] + box2[..., 3] / 2

    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1))
             .clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1))
             .clamp(min=0))
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2
            + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    # the JAX function's NaN guard: where iou rounds to 1 + eps the
    # denominator cancels to 0
    den = v - iou + (1 + eps)
    den = torch.where(den.abs() < 1e-12, 1e-12, den)
    alpha = (v / den).detach()
    return iou - (rho2 / c2 + v * alpha)

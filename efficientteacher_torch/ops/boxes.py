"""Box geometry primitives (counterpart of
`efficientteacher_tpu/ops/boxes.py`).

Only what the eval slice runs is ported so far. Same arithmetic, in the
same order, as the JAX functions, so NMS decisions match bit for bit:
  - xywh2xyxy: reference utils/general.py:575
  - box_iou (pairwise NxM): reference utils/metrics.py:252-274
"""

from __future__ import annotations

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

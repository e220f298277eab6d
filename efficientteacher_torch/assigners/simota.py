"""SimOTA dynamic-k assignment, dense over padded GT rows (counterpart of
`efficientteacher_tpu/assigners/simota.py`).

Parity with reference models/assigner/simota_assigner.py:35-372:
  - candidate gate: anchor centre inside a GT box OR within the
    center_radius (2.5) * stride square around a GT centre (:289-346)
  - cost = cls_weight * BCE(sqrt(sigmoid(cls) * sigmoid(obj)), onehot) +
    iou_weight (3) * (-log iou) + 1e5 * (candidate but not in both)
    (:241-271), plus the JAX package's dense penalties: 1e9 for
    non-candidate anchors, 1e12 for padded GT rows
  - dynamic k per GT = clamp(int(sum of the top-10 candidate IoUs), 1)
    (:349-354)
  - per-GT lowest-cost top-k; anchors claimed by several GTs go to the
    lowest-cost one (:356-365)

The class cost is not formed as JAX forms it, a one-hot (M, 1, nc)
broadcast against (1, N, nc) and summed over the classes: eager PyTorch
would hold (B, M, N, nc) tensors (20.6 GB each at batch 64, M 120,
N 8,400, nc 80). The one-hot picks one class per GT, so the sum is
S[n] - log q[n, c_m] + log1p(-clip(q[n, c_m])), with S[n] =
-sum_c log1p(-clip(q[n, c])) and the clips where JAX puts them: an
(M, N) gather. Top-k ties go to the lower index, as `jax.lax.top_k`
gives them (`topk.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.boxes import bbox_iou
from .topk import topk_lower_index_first


class SimOTAResult(NamedTuple):
    fg_mask: torch.Tensor       # (B, N) bool
    matched_gt: torch.Tensor    # (B, N) int64 (valid where fg)
    matched_iou: torch.Tensor   # (B, N) float (0 where not fg)
    num_fg: torch.Tensor        # () total over the batch


def _inside(gx, gy, hx, hy, centers):
    """(B, M, N): anchor centres strictly inside the boxes gx -+ hx,
    gy -+ hy (each (B, M, 1)), as JAX's min over the four distances."""
    cx, cy = centers[:, 0], centers[:, 1]
    d = torch.minimum(torch.minimum(cx - (gx - hx), cy - (gy - hy)),
                      torch.minimum((gx + hx) - cx, (gy + hy) - cy))
    return d > 0.0


def class_cost(cls_logits, obj_logits, gt_cls):
    """(B, M, N) BCE of sqrt(sigmoid(cls) * sigmoid(obj)) against each GT's
    one-hot class, summed over the classes, without the (B, M, N, nc)
    broadcast (module docstring)."""
    p = torch.sigmoid(cls_logits) * torch.sigmoid(obj_logits)   # (B, N, nc)
    q = torch.sqrt(p.clamp(1e-12, 1.0))
    l1p = torch.log1p(-q.clamp(0.0, 1.0 - 1e-7))
    s = -l1p.sum(-1)                                             # (B, N)
    idx = gt_cls[:, :, None].expand(-1, -1, q.shape[1])          # (B, M, N)
    q_m = q.transpose(1, 2).gather(1, idx)
    l1p_m = l1p.transpose(1, 2).gather(1, idx)
    return s[:, None, :] - torch.log(q_m) + l1p_m


@torch.no_grad()
def simota_assign(gt_boxes, gt_cls, gt_mask, pred_boxes, cls_logits,
                  obj_logits, centers, strides, *, nc: int, top_k: int = 10,
                  center_radius: float = 2.5, iou_weight: float = 3.0,
                  cls_weight: float = 1.0) -> SimOTAResult:
    """gt_boxes (B, M, 4) xywh pixels, gt_cls (B, M) int, gt_mask (B, M)
    bool, pred_boxes (B, N, 4) xywh pixels (decoded), cls_logits (B, N,
    nc), obj_logits (B, N, 1), centers (N, 2) anchor centres in pixels,
    strides (N,)."""
    m = gt_boxes.shape[1]
    n = pred_boxes.shape[1]
    gx, gy = gt_boxes[..., 0:1], gt_boxes[..., 1:2]              # (B, M, 1)
    in_boxes = _inside(gx, gy, 0.5 * gt_boxes[..., 2:3],
                       0.5 * gt_boxes[..., 3:4], centers)
    r = center_radius * strides
    in_centers = _inside(gx, gy, r, r, centers)
    valid = gt_mask[:, :, None]
    in_boxes &= valid
    in_centers &= valid
    fg_anchor = in_boxes.any(1) | in_centers.any(1)              # (B, N)
    in_both = in_boxes & in_centers

    iou = bbox_iou(gt_boxes[:, :, None, :], pred_boxes[:, None, :, :],
                   x1y1x2y2=False)
    iou = torch.where(valid, iou, 0.0)

    cost = (cls_weight * class_cost(cls_logits, obj_logits, gt_cls)
            + iou_weight * (-torch.log(iou + 1e-8))
            + 100000.0 * (~in_both)
            + 1e9 * (~fg_anchor)[:, None, :]
            + 1e12 * (~valid))

    k = min(top_k, n)
    iou_cand = torch.where(fg_anchor[:, None, :], iou, 0.0)
    topk_ious, _ = topk_lower_index_first(iou_cand, k)
    dynamic_k = topk_ious.sum(-1).to(torch.int32).clamp(1, k)    # (B, M)

    _, topk_idx = topk_lower_index_first(-cost, k)               # (B, M, k)
    rank = torch.arange(k, device=cost.device)
    chosen = (rank < dynamic_k[..., None]) & valid
    mm = torch.zeros(cost.shape, dtype=torch.bool, device=cost.device)
    mm.scatter_(2, topk_idx, chosen)

    # an anchor claimed by several GTs goes to its lowest-cost GT
    claims = mm.sum(1)
    best_gt = torch.where(mm, cost, float("inf")).argmin(1)      # (B, N)
    rows = torch.arange(m, device=cost.device)[None, :, None]
    mm &= (claims <= 1)[:, None, :] | (rows == best_gt[:, None, :])

    fg = mm.any(1)
    matched_gt = mm.to(torch.uint8).argmax(1)
    matched_iou = (mm * iou).sum(1)
    return SimOTAResult(fg, matched_gt, matched_iou, fg.sum())

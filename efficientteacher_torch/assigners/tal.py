"""Task-aligned assignment (TAL, PPYOLOE style), dense over padded GT rows
(counterpart of `efficientteacher_tpu/assigners/tal.py`).

Parity with reference models/assigner/tal_assigner.py:13-158 and the
nanodet_utils helpers (select_candidates_in_gts :206,
select_highest_overlaps :227):
  - align metric = score[gt_cls]^alpha * IoU^beta (alpha 1, beta 6)
  - candidates: anchor centres strictly inside the GT box
  - top-k (13) candidates per GT by metric, ties to the lower index as
    `jax.lax.top_k` gives them (`topk.py`); the reference's duplicate-index
    drop (select_topk_candidates' `where(count > 1, 0, count)`) is kept
  - an anchor in several GTs' top-k: its whole column is replaced by the
    one-hot argmax of the overlaps over ALL GT rows, which can hand it to
    a GT that never claimed it (select_highest_overlaps :239-246, a
    mirrored quirk; padded rows have overlap 0, so row 0 wins only where
    every overlap is 0, as torch's argmax)
  - target score = onehot(cls) * (metric * max overlap / max metric per
    GT) (:117-123)
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.boxes import box_iou
from .topk import topk_lower_index_first


class TALResult(NamedTuple):
    target_labels: torch.Tensor  # (B, N) int64, nc where not fg
    target_bboxes: torch.Tensor  # (B, N, 4) xyxy pixels
    target_scores: torch.Tensor  # (B, N, nc)
    fg_mask: torch.Tensor        # (B, N) bool


@torch.no_grad()
def tal_assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes,
               gt_mask, *, nc: int, top_k: int = 13, alpha: float = 1.0,
               beta: float = 6.0, eps: float = 1e-9) -> TALResult:
    """pd_scores (B, N, nc) sigmoid scores, pd_bboxes (B, N, 4) xyxy
    pixels, anc_points (N, 2) pixels, gt_labels (B, M) int, gt_bboxes
    (B, M, 4) xyxy pixels, gt_mask (B, M) bool."""
    b, m = gt_labels.shape
    n = pd_bboxes.shape[1]
    valid = gt_mask[:, :, None]
    overlaps = torch.where(valid, box_iou(gt_bboxes, pd_bboxes), 0.0)
    idx = gt_labels[:, :, None].expand(-1, -1, n)
    cls_score = pd_scores.transpose(1, 2).gather(1, idx)         # (B, M, N)
    align = cls_score ** alpha * overlaps ** beta

    ax, ay = anc_points[:, 0], anc_points[:, 1]
    lt_ok = torch.minimum(ax - gt_bboxes[..., 0:1],
                          ay - gt_bboxes[..., 1:2]) > eps
    rb_ok = torch.minimum(gt_bboxes[..., 2:3] - ax,
                          gt_bboxes[..., 3:4] - ay) > eps
    in_gts = lt_ok & rb_ok & valid

    metric = align * in_gts
    k = min(top_k, n)
    _, topk_idx = topk_lower_index_first(metric, k)              # (B, M, k)
    counts = torch.zeros(metric.shape, dtype=torch.int32,
                         device=metric.device)
    counts.scatter_add_(2, topk_idx,
                        valid.expand(-1, -1, k).to(torch.int32))
    mask_pos = torch.where(counts > 1, 0, counts).bool() & in_gts

    multi = mask_pos.sum(1) > 1                                  # (B, N)
    best_gt_all = overlaps.argmax(1)
    rows = torch.arange(m, device=metric.device)[None, :, None]
    mask_pos = torch.where(multi[:, None, :],
                           rows == best_gt_all[:, None, :], mask_pos)

    fg = mask_pos.any(1)
    target_gt = mask_pos.to(torch.uint8).argmax(1)               # (B, N)
    t_labels = torch.where(fg, gt_labels.gather(1, target_gt), nc)
    t_boxes = gt_bboxes.gather(1, target_gt[..., None].expand(-1, -1, 4))
    onehot = F.one_hot(t_labels.clamp(0, nc - 1), nc).to(pd_scores.dtype)
    onehot = onehot * fg[..., None]

    align_pos = align * mask_pos
    pos_max_metric = align_pos.amax(-1, keepdim=True)            # (B, M, 1)
    pos_max_overlap = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align_pos * pos_max_overlap / (pos_max_metric + eps)).amax(1)
    return TALResult(t_labels, t_boxes, onehot * norm[..., None], fg)

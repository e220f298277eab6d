"""TAL loss of the YOLOv6 / YOLOv8 heads: class BCE + IoU + DFL
(counterpart of `efficientteacher_tpu/losses/tal_loss.py`).

The reference's ComputeTalLoss does not run (it imports modules it lacks,
models/loss/tal_loss.py:11-14, and its trainer refuses it); the JAX
package rebuilt it from the pieces that are there (TaskAlignedAssigner,
dist2bbox/bbox2dist in models/module/nanodet_utils.py:92-133, the DFL
projection of yolov6_head.py:94-96), and this is that rebuild:

  - assignment: `assigners/tal.py` (alpha 1, beta 6, top-k Loss.top_k)
  - cls: BCE(cls_logits, target_scores), sum / max(sum(target_scores), 1)
  - box: (1 - IoU of Loss.iou_type, GIoU by default) weighted by the
    anchor's target-score sum, same norm, weight Loss.box_loss_weight
  - dfl: distribution focal loss over the ltrb bins in stride units, same
    weighting and norm, weight Loss.dfl_loss_weight

The raw maps are the port's (B, 1, ny, nx, 4*(reg_max+1)+nc).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..assigners.tal import tal_assign
from ..models.heads.yolov6 import dfl_project
from ..ops.boxes import iou_loss
from ..parallel.distributed import global_sum
from .common import bce_with_logits


@dataclasses.dataclass(frozen=True)
class TALLossConfig:
    nc: int
    reg_max: int = 16
    use_dfl: bool = True
    strides: Tuple[float, ...] = (8.0, 16.0, 32.0)
    iou_type: str = "giou"
    box_weight: float = 2.5
    dfl_weight: float = 0.5
    cls_weight: float = 1.0
    top_k: int = 13

    @classmethod
    def from_cfg(cls, cfg):
        return cls(
            nc=int(cfg.Dataset.nc),
            reg_max=int(cfg.Loss.reg_max),
            use_dfl=bool(cfg.Loss.use_dfl),
            strides=tuple(float(s) for s in cfg.Model.Head.strides),
            iou_type=str(cfg.Loss.iou_type),
            box_weight=float(cfg.Loss.box_loss_weight),
            dfl_weight=float(cfg.Loss.dfl_loss_weight),
            cls_weight=float(cfg.Loss.qfl_loss_weight),
            top_k=int(cfg.Loss.top_k),
        )


def _anchor_points(preds, strides, offset=0.5):
    """Anchor points (N, 2) px and per-anchor stride (N,), in the
    flattened maps' order."""
    pts, strd = [], []
    for p, s in zip(preds, strides):
        ny, nx = p.shape[2], p.shape[3]
        gy, gx = torch.meshgrid(
            torch.arange(ny, dtype=torch.float32, device=p.device),
            torch.arange(nx, dtype=torch.float32, device=p.device),
            indexing="ij")
        pts.append(torch.stack([(gx.reshape(-1) + offset) * s,
                                (gy.reshape(-1) + offset) * s], -1))
        strd.append(torch.full((ny * nx,), s, dtype=torch.float32,
                               device=p.device))
    return torch.cat(pts), torch.cat(strd)


def _dfl_loss(reg_dist, target_ltrb, reg_max):
    """Distribution focal loss: cross-entropy against the two integer bins
    around each target distance, mean over ltrb."""
    bins = reg_dist.reshape(reg_dist.shape[:-1] + (4, reg_max + 1))
    logp = F.log_softmax(bins, -1)
    t = target_ltrb.clamp(0.0, reg_max - 0.01)
    tl = t.floor().long()
    tr = tl + 1
    wl = tr.float() - t
    wr = 1.0 - wl
    lp_l = logp.gather(-1, tl[..., None])[..., 0]
    lp_r = logp.gather(-1, tr[..., None])[..., 0]
    return -(wl * lp_l + wr * lp_r).mean(-1)


def compute_tal_loss(preds: Sequence[torch.Tensor], labels: torch.Tensor,
                     label_mask: torch.Tensor, img_size: int,
                     lc: TALLossConfig):
    """preds: raw maps (B, 1, ny, nx, 4*(reg_max+1)+nc); labels (B, M, 5)
    [cls, xywhn]; label_mask (B, M). Returns (loss, {[dfl,] cls, box,
    loss})."""
    b = preds[0].shape[0]
    nbins = 4 * (lc.reg_max + 1)
    raw = torch.cat([p.float().reshape(b, -1, nbins + lc.nc) for p in preds],
                    1)
    reg_dist = raw[..., :nbins]
    cls_logits = raw[..., nbins:]

    anc, strides = _anchor_points(preds, lc.strides)
    st = strides[None, :, None]
    ltrb = (dfl_project(reg_dist, lc.reg_max) if lc.use_dfl
            else reg_dist[..., :4])
    ltrb_px = ltrb * st
    pred_xyxy = torch.cat([anc[None] - ltrb_px[..., 0:2],
                           anc[None] + ltrb_px[..., 2:4]], -1)

    labels = labels.float()
    gt_cls = labels[..., 0].long()
    cxy = labels[..., 1:3] * float(img_size)
    wh = labels[..., 3:5] * float(img_size)
    gt_xyxy = torch.cat([cxy - wh / 2, cxy + wh / 2], -1)

    asn = tal_assign(torch.sigmoid(cls_logits.detach()), pred_xyxy.detach(),
                     anc, gt_cls, gt_xyxy, label_mask.bool(), nc=lc.nc,
                     top_k=lc.top_k)
    # the global batch's sum under DDP (losses/common.py)
    score_sum = global_sum(asn.target_scores.sum()).clamp(min=1.0)
    fg = asn.fg_mask

    loss_cls = bce_with_logits(cls_logits, asn.target_scores).sum() / score_sum
    w = asn.target_scores.sum(-1)
    loss_box = (iou_loss(pred_xyxy, asn.target_bboxes, lc.iou_type) * w
                * fg).sum() / score_sum

    parts = {}
    total = lc.cls_weight * loss_cls + lc.box_weight * loss_box
    if lc.use_dfl:
        t_ltrb = torch.cat([anc[None] - asn.target_bboxes[..., 0:2],
                            asn.target_bboxes[..., 2:4] - anc[None]],
                           -1) / st
        ldfl = (_dfl_loss(reg_dist, t_ltrb, lc.reg_max) * w * fg).sum() \
            / score_sum
        total = total + lc.dfl_weight * ldfl
        parts["dfl"] = lc.dfl_weight * ldfl
    parts.update({"cls": lc.cls_weight * loss_cls,
                  "box": lc.box_weight * loss_box, "loss": total})
    return total, parts

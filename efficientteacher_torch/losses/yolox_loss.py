"""YOLOX loss (ComputeXLoss / ComputeFastXLoss), dense over padded GT rows
(counterpart of `efficientteacher_tpu/losses/yolox_loss.py`).

Parity with reference models/loss/yolox_loss.py:20-179:
  - the raw maps decoded to absolute boxes: xy = (reg + grid) * stride,
    wh = exp(reg) * stride (:140-151); GT normalized xywh scaled by the
    input size (:126-132)
  - SimOTA assignment on the detached decodes (:70-77)
  - losses, each summed over the batch and divided by num_fg (:103-118):
      iou: IOUloss (giou by default; the reference's own variant, see
           `_iou_loss`) on fg anchors, times box_loss_weight (5)
      obj: BCE over ALL anchors against the fg mask, times obj_loss_weight
      cls: BCE on fg anchors against onehot * matched IoU, times
           cls_loss_weight
      l1:  |reg_raw - t| behind `use_l1`, which the trainer turns on for
           the no-aug tail as the JAX trainer does (the reference adds it
           always, yolox_loss.py:107,122, storing use_l1 unread)
  - iou_obj: the obj target becomes the matched IoU (:166-176)

The raw maps are the port's (B, 1, ny, nx, 5+nc), flattened in (y, x)
order as JAX's (B, ny, nx, 1, 5+nc).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..assigners.simota import simota_assign
from ..ops.boxes import bbox_iou
from ..parallel.distributed import global_sum
from .common import bce_with_logits


@dataclasses.dataclass(frozen=True)
class YoloXLossConfig:
    nc: int
    strides: Tuple[float, ...] = (8.0, 16.0, 32.0)
    iou_type: str = "giou"
    reg_weight: float = 5.0
    obj_weight: float = 1.0
    cls_weight: float = 1.0
    iou_obj: bool = False
    use_l1: bool = False
    top_k: int = 10

    @classmethod
    def from_cfg(cls, cfg, use_l1: bool = False):
        return cls(
            nc=int(cfg.Dataset.nc),
            strides=tuple(float(s) for s in cfg.Model.Head.strides),
            iou_type=str(cfg.Loss.iou_type),
            reg_weight=float(cfg.Loss.box_loss_weight),
            obj_weight=float(cfg.Loss.obj_loss_weight),
            cls_weight=float(cfg.Loss.cls_loss_weight),
            iou_obj=bool(cfg.Loss.iou_obj),
            use_l1=use_l1,
        )


def _grids(preds: Sequence[torch.Tensor], strides):
    """Anchor centres (N, 2) px, per-anchor stride (N,), grid offsets
    (N, 2), in the flattened maps' order."""
    centers, strd, shifts = [], [], []
    for p, s in zip(preds, strides):
        ny, nx = p.shape[2], p.shape[3]
        gy, gx = torch.meshgrid(
            torch.arange(ny, dtype=torch.float32, device=p.device),
            torch.arange(nx, dtype=torch.float32, device=p.device),
            indexing="ij")
        shift = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
        shifts.append(shift)
        centers.append((shift + 0.5) * s)
        strd.append(torch.full((ny * nx,), s, dtype=torch.float32,
                               device=p.device))
    return torch.cat(centers), torch.cat(strd), torch.cat(shifts)


def _iou_loss(pred: torch.Tensor, target: torch.Tensor,
              iou_type: str) -> torch.Tensor:
    """Elementwise IOUloss on xywh boxes: the reference's own variant
    (models/loss/loss.py:726-859), which differs from the bbox_iou family:
    'iou' returns 1 - iou^2 (:759), 'giou' penalizes (area_c -
    INTERSECTION) / area_c and clamps to [-1, 1] (:771-773), 'diou' and
    'ciou' clamp likewise (:790, :815)."""
    p_tl = pred[..., :2] - pred[..., 2:4] / 2
    p_br = pred[..., :2] + pred[..., 2:4] / 2
    t_tl = target[..., :2] - target[..., 2:4] / 2
    t_br = target[..., :2] + target[..., 2:4] / 2
    tl = torch.maximum(p_tl, t_tl)
    br = torch.minimum(p_br, t_br)
    area_p = torch.prod(pred[..., 2:4], -1)
    area_g = torch.prod(target[..., 2:4], -1)
    area_i = torch.prod((br - tl).clamp(min=0), -1)
    iou = area_i / (area_p + area_g - area_i + 1e-16)

    if iou_type == "iou":
        return 1.0 - iou ** 2
    c_tl = torch.minimum(p_tl, t_tl)
    c_br = torch.maximum(p_br, t_br)
    if iou_type == "giou":
        area_c = torch.prod(c_br - c_tl, -1)
        giou = iou - (area_c - area_i) / area_c.clamp(min=1e-16)
        return 1.0 - giou.clamp(-1.0, 1.0)
    if iou_type in ("diou", "ciou"):
        convex_dis = ((c_br[..., 0] - c_tl[..., 0]) ** 2
                      + (c_br[..., 1] - c_tl[..., 1]) ** 2 + 1e-7)
        center_dis = ((pred[..., 0] - target[..., 0]) ** 2
                      + (pred[..., 1] - target[..., 1]) ** 2)
        if iou_type == "diou":
            diou = iou - center_dis / convex_dis
            return 1.0 - diou.clamp(-1.0, 1.0)
        v = (4 / math.pi ** 2) * (
            torch.atan(target[..., 2] / target[..., 3].clamp(min=1e-7))
            - torch.atan(pred[..., 2] / pred[..., 3].clamp(min=1e-7))) ** 2
        alpha = (v / ((1 + 1e-7) - iou + v)).detach()
        ciou = iou - (center_dis / convex_dis + alpha * v)
        return 1.0 - ciou.clamp(-1.0, 1.0)
    if iou_type == "siou":
        return 1.0 - bbox_iou(pred, target, x1y1x2y2=False, SIoU=True)
    raise NotImplementedError(iou_type)


def compute_yolox_loss(preds: Sequence[torch.Tensor], labels: torch.Tensor,
                       label_mask: torch.Tensor, img_size: int,
                       lc: YoloXLossConfig):
    """preds: raw maps (B, 1, ny, nx, 5+nc) [xywh, obj, cls]; labels (B, M,
    5) [cls, xywhn]; label_mask (B, M). Returns (loss, {iou, obj, cls[,
    l1], loss})."""
    b = preds[0].shape[0]
    nc = lc.nc
    raw = torch.cat([p.float().reshape(b, -1, 5 + nc) for p in preds], 1)
    centers, strides, shifts = _grids(preds, lc.strides)
    st = strides[None, :, None]

    xy = (raw[..., 0:2] + shifts[None]) * st
    wh = torch.exp(raw[..., 2:4]) * st
    boxes = torch.cat([xy, wh], -1)                       # absolute xywh
    obj_logits = raw[..., 4:5]
    cls_logits = raw[..., 5:]

    labels = labels.float()
    gt_cls = labels[..., 0].long()
    gt_boxes = labels[..., 1:5] * float(img_size)
    label_mask = label_mask.bool()

    asn = simota_assign(gt_boxes, gt_cls, label_mask, boxes.detach(),
                        cls_logits.detach(), obj_logits.detach(), centers,
                        strides, nc=nc, top_k=lc.top_k)
    # the global batch's count under DDP (losses/common.py)
    num_fg = global_sum(asn.num_fg.float()).clamp(min=1.0)
    fg = asn.fg_mask

    reg_t = gt_boxes.gather(1, asn.matched_gt[..., None].expand(-1, -1, 4))
    cls_t = F.one_hot(gt_cls.gather(1, asn.matched_gt), nc).float()
    if lc.iou_obj:
        obj_t = asn.matched_iou
    else:
        cls_t = cls_t * asn.matched_iou[..., None]
        obj_t = fg.float()

    loss_iou = (_iou_loss(boxes, reg_t, lc.iou_type) * fg).sum() / num_fg
    loss_obj = bce_with_logits(obj_logits[..., 0], obj_t).sum() / num_fg
    loss_cls = (bce_with_logits(cls_logits, cls_t)
                * fg[..., None]).sum() / num_fg

    total = (lc.reg_weight * loss_iou + lc.obj_weight * loss_obj
             + lc.cls_weight * loss_cls)
    parts = {"iou": lc.reg_weight * loss_iou,
             "obj": lc.obj_weight * loss_obj,
             "cls": lc.cls_weight * loss_cls}
    if lc.use_l1:
        # the L1 target in grid units (reference get_l1_target)
        t_xy = reg_t[..., 0:2] / st - shifts[None]
        t_wh = torch.log(reg_t[..., 2:4] / st + 1e-8)
        l1 = (raw[..., 0:4] - torch.cat([t_xy, t_wh], -1)).abs()
        loss_l1 = (l1 * fg[..., None]).sum() / num_fg
        total = total + loss_l1
        parts["l1"] = loss_l1
    parts["loss"] = total
    return total, parts

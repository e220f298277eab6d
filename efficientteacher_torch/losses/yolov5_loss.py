"""Supervised YOLOv5 loss, dense-masked (counterpart of
`efficientteacher_tpu/losses/yolov5_loss.py`; reference
models/loss/loss.py:93-215 `ComputeLoss.default_loss`):
  - CIoU box loss, mean over positives (loss.py:165-172)
  - objectness BCE against IoU-valued soft targets, per-scale balance
    (4.0, 1.0, 0.4) (loss.py:117, 174-196)
  - class BCE with smoothed targets (loss.py:182-186)
  - weights box * 3/nl, cls * nc/80 * 3/nl, obj as is (loss.py:122-124)
  - focal BCE when fl_gamma > 0 (loss.py:112-114)
  - with `num_keypoints` (Dataset.np) the landmark term: the wing loss of
    the keypoint offsets, times kp_w (loss.py:175-179), as parts["kp"]
  - returns (loss * batch size, parts) (loss.py:208-212)

Raw maps are the port's (B, na, ny, nx, no), taken to float32 first
(float64 stays: `common.loss_dtype`). The
objectness targets are scattered with a max over duplicate cells, as the
JAX package does, into a buffer with one extra slot per image that takes
the invalid slots (`_scatter_max`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..assigners.yolo_anchor import DenseAssignment, assign_all_scales
from ..ops.boxes import bbox_ciou
from .common import (batch_mean, batch_scale, bce_with_logits,
                     focal_bce_with_logits, landmarks_loss, loss_dtype,
                     masked_mean, smooth_bce)


@dataclasses.dataclass(frozen=True)
class YoloV5LossConfig:
    nc: int
    nl: int = 3
    anchor_t: float = 4.0
    box_w: float = 0.05
    obj_w: float = 1.0
    cls_w: float = 0.5
    cls_pw: float = 1.0
    obj_pw: float = 1.0
    fl_gamma: float = 0.0
    label_smoothing: float = 0.0
    single_targets: bool = False
    gr: float = 1.0
    balance: Tuple[float, ...] = (4.0, 1.0, 0.4)
    num_keypoints: int = 0
    kp_w: float = 10.0

    @classmethod
    def from_cfg(cls, cfg, nl: int = 3):
        """From any attribute tree with the config's layout (the card's
        machine has no yacs or yaml)."""
        nc = 1 if cfg.single_cls else cfg.Dataset.nc
        balance = ((4.0, 1.0, 0.4) if nl == 3
                   else (4.0, 1.0, 0.25, 0.06, 0.02)[:nl])
        return cls(
            nc=nc, nl=nl, anchor_t=float(cfg.Loss.anchor_t),
            box_w=float(cfg.Loss.box) * 3.0 / nl,
            obj_w=float(cfg.Loss.obj),
            cls_w=float(cfg.Loss.cls) * nc / 80.0 * 3.0 / nl,
            cls_pw=float(cfg.Loss.cls_pw), obj_pw=float(cfg.Loss.obj_pw),
            fl_gamma=float(cfg.Loss.fl_gamma),
            label_smoothing=float(cfg.Loss.label_smoothing),
            single_targets=bool(cfg.Loss.single_targets),
            balance=balance, num_keypoints=int(cfg.Dataset.np),
            kp_w=float(cfg.Loss.kp_loss_weight))


def _bce(logits, targets, pw, gamma):
    if gamma > 0:
        return focal_bce_with_logits(logits, targets, gamma, pos_weight=pw)
    return bce_with_logits(logits, targets, pw)


def decode_pred_boxes(ps: torch.Tensor, anchor_wh: torch.Tensor
                      ) -> torch.Tensor:
    """Positive-sample box decode in grid units (loss.py:166-169)."""
    pxy = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5
    pwh = (torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2 * anchor_wh
    return torch.cat([pxy, pwh], -1)


def _gather_positives(p: torch.Tensor, asn: DenseAssignment) -> torch.Tensor:
    """p (B, na, ny, nx, no) at the slots' cells -> (B, K, no)."""
    b, no = p.shape[0], p.shape[-1]
    return p.reshape(b, -1, no).gather(
        1, asn.flat_cell[..., None].expand(-1, -1, no))


def _scatter_max(values: torch.Tensor, flat_cell: torch.Tensor,
                 valid: torch.Tensor, ncell: int) -> torch.Tensor:
    """(B, ncell) map of the max of `values` per cell over the valid
    slots, 0 elsewhere: JAX `t.at[f].max(v, mode="drop")` with the invalid
    slots sent to an extra, dropped cell."""
    idx = torch.where(valid, flat_cell, ncell)
    out = values.new_zeros((values.shape[0], ncell + 1))
    out.scatter_reduce_(1, idx, values, reduce="amax")
    return out[:, :ncell]


def compute_loss(preds: Sequence[torch.Tensor], labels: torch.Tensor,
                 label_mask: torch.Tensor, anchors_grid,
                 lc: YoloV5LossConfig):
    """preds: per-scale raw maps (B, na, ny, nx, no); labels (B, M, 5)
    [cls, cx, cy, w, h] normalized; label_mask (B, M); anchors_grid
    (nl, na, 2) in grid units. Returns (loss * B, parts)."""
    grid_shapes = [(p.shape[2], p.shape[3]) for p in preds]
    assignments = assign_all_scales(labels, label_mask, grid_shapes,
                                    anchors_grid, lc.anchor_t,
                                    lc.single_targets)
    cp, cn = smooth_bce(lc.label_smoothing)
    lbox = lobj = lcls = lmark = 0.0
    npk = lc.num_keypoints
    for i, (p, asn) in enumerate(zip(preds, assignments)):
        p = loss_dtype(p)
        b = p.shape[0]
        ncell = p[..., 4].numel() // b
        ps = _gather_positives(p, asn)

        pbox = decode_pred_boxes(ps, asn.anchor_wh)
        tbox = torch.cat([asn.txy, asn.twh], -1)
        iou = bbox_ciou(pbox, tbox)   # (B, K)
        lbox = lbox + masked_mean(1.0 - iou, asn.valid)

        tobj_val = (1.0 - lc.gr) + lc.gr * iou.detach().clamp(min=0.0)
        tobj = _scatter_max(tobj_val, asn.flat_cell, asn.valid, ncell)
        obji = batch_mean(_bce(p[..., 4].reshape(b, ncell), tobj,
                               lc.obj_pw, lc.fl_gamma))
        lobj = lobj + obji * lc.balance[i]

        if npk > 0:
            lmark = lmark + _landmark_term(p, ps, asn, lc)

        if lc.nc > 1:
            onehot = F.one_hot(asn.tcls, lc.nc).to(p.dtype)
            t = onehot * cp + (1.0 - onehot) * cn
            ce = _bce(ps[..., 5:5 + lc.nc], t, lc.cls_pw, lc.fl_gamma)
            # mean over classes, then over positives: torch BCE's mean over
            # the ragged (n, nc) matrix
            lcls = lcls + masked_mean(ce.mean(-1), asn.valid)

    lbox = lbox * lc.box_w
    lobj = lobj * lc.obj_w
    lcls = lcls * lc.cls_w
    parts = {"box": lbox, "obj": lobj, "cls": lcls}
    total = lbox + lobj + lcls
    if npk > 0:
        parts["kp"] = lmark * lc.kp_w
        total = total + parts["kp"]
    loss = total * batch_scale(preds[0].shape[0])
    return loss, {**parts, "loss": loss}


def _landmark_term(p: torch.Tensor, ps: torch.Tensor, asn: DenseAssignment,
                   lc: YoloV5LossConfig) -> torch.Tensor:
    """One scale's keypoint loss (reference loss.py:175-179, JAX
    yolov5_loss.py:157-178): the wing loss of the anchor-scaled predicted
    offsets against the targets relative to the positive's cell, over the
    visible points. The normalised keypoints ride in `asn.extra`; the
    cell is read back from `flat_cell`, (a ny + gj) nx + gi."""
    npk = lc.num_keypoints
    ny, nx = p.shape[2], p.shape[3]
    b, k = asn.extra.shape[:2]
    kp_n = asn.extra[..., :2 * npk].reshape(b, k, npk, 2)
    kp_t = kp_n * torch.tensor([nx, ny], dtype=p.dtype, device=p.device)
    cell = asn.flat_cell % (ny * nx)
    cell_xy = torch.stack([cell % nx, cell // nx], -1).to(p.dtype)
    kp_rel = kp_t - cell_xy[:, :, None, :]
    visible = (kp_n > 0) & asn.valid[:, :, None, None]
    pk = ps[..., 5 + lc.nc:].reshape(kp_t.shape) \
        * asn.anchor_wh[:, :, None, :]
    return landmarks_loss(pk, kp_rel, visible)

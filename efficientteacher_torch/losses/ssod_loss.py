"""SSOD pseudo-label loss, dense-masked (counterpart of
`efficientteacher_tpu/losses/ssod_loss.py` `compute_ssod_loss`; reference
models/loss/ssod/ssod_loss.py:25-299 ComputeStudentMatchLoss):
  - per-class threshold split of the teacher's labels [cls, xywh, conf,
    obj_conf, cls_conf] (ssod_loss.py:130-192):
      conf >= thr_high[cls]                   -> reliable
      thr_low[cls] <= conf < thr_high[cls]    -> uncertain; with
        pseudo_label_with_obj, obj_conf >= .99 -> uncertain-obj (box loss)
        and cls_conf >= .99                   -> uncertain-cls (cls loss)
  - reliable targets: CIoU box, IoU-soft objectness, class BCE; uncertain
    targets write their score into the objectness map (or -1, ignored, with
    ignore_obj), and the objectness BCE runs over cells >= 0
    (ssod_loss.py:213-296)
  - weights: box/obj from SSOD.{box,obj}_loss_weight, cls * nc/80 * 3/nl
  - a single centre cell per target unless uncertain_aug (ssod_loss.py:66)

Raw maps are the port's (B, na, ny, nx, no).

`compute_ssod_ota_loss` is the SimOTA branch (SSOD.use_ota; reference
ssod_loss.py:296-345): the reliable and the uncertain pseudo labels each
get their own dynamic-k matching over the find-3-positive candidates
(`losses/yolov5_ota_loss.py`), reliable matches take box, class and
IoU-soft objectness targets, uncertain matches write their score (or -1
with ignore_obj) into the objectness map.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..assigners.yolo_anchor import assign_all_scales
from ..ops.boxes import bbox_ciou
from .common import (batch_scale, bce_with_logits, focal_bce_with_logits,
                     loss_dtype, masked_mean, smooth_bce)
from .yolov5_loss import _gather_positives, _scatter_max, decode_pred_boxes


@dataclasses.dataclass(frozen=True)
class SSODLossConfig:
    nc: int
    nl: int = 3
    anchor_t: float = 4.0
    box_w: float = 0.05
    obj_w: float = 1.0
    cls_w: float = 0.5
    cls_pw: float = 1.0
    obj_pw: float = 1.0
    focal_loss: float = 0.0
    label_smoothing: float = 0.0
    uncertain_aug: bool = False
    ignore_obj: bool = False
    pseudo_label_with_obj: bool = False
    pseudo_label_with_bbox: bool = False
    pseudo_label_with_cls: bool = False
    gr: float = 1.0
    balance: Tuple[float, ...] = (4.0, 1.0, 0.4)

    @classmethod
    def from_cfg(cls, cfg, nl: int = 3):
        """From any attribute tree with the config's layout."""
        nc = cfg.Dataset.nc
        s = cfg.SSOD
        return cls(
            nc=nc, nl=nl, anchor_t=float(cfg.Loss.anchor_t),
            box_w=float(s.box_loss_weight), obj_w=float(s.obj_loss_weight),
            cls_w=float(s.cls_loss_weight) * nc / 80.0 * 3.0 / nl,
            cls_pw=float(cfg.Loss.cls_pw), obj_pw=float(cfg.Loss.obj_pw),
            focal_loss=float(s.focal_loss),
            label_smoothing=float(cfg.Loss.label_smoothing),
            uncertain_aug=bool(s.uncertain_aug),
            ignore_obj=bool(s.ignore_obj),
            pseudo_label_with_obj=bool(s.pseudo_label_with_obj),
            pseudo_label_with_bbox=bool(s.pseudo_label_with_bbox),
            pseudo_label_with_cls=bool(s.pseudo_label_with_cls))


def compute_ssod_loss(preds: Sequence[torch.Tensor],
                      pseudo_labels: torch.Tensor, pseudo_mask: torch.Tensor,
                      thr_high: torch.Tensor, thr_low: torch.Tensor,
                      anchors_grid, lc: SSODLossConfig):
    """pseudo_labels (B, Mp, 8) [cls, xywhn, conf, obj_conf, cls_conf],
    pseudo_mask (B, Mp), thr_high / thr_low (nc,). Returns (loss * B,
    {ss_box, ss_obj, ss_cls})."""
    cls_idx = pseudo_labels[..., 0].long()
    conf = pseudo_labels[..., 5]
    obj_conf = pseudo_labels[..., 6]
    cls_conf = pseudo_labels[..., 7]

    reliable = pseudo_mask & (conf >= thr_high[cls_idx])
    uncertain = pseudo_mask & ~reliable & (conf >= thr_low[cls_idx])
    if lc.pseudo_label_with_obj:
        uc_obj = uncertain & (obj_conf >= 0.99)
        uc_cls = uncertain & (cls_conf >= 0.99)
        uc_score = obj_conf
    else:
        uc_obj = uc_cls = torch.zeros_like(uncertain)
        uc_score = conf

    # one assignment; the score and the categories ride as extra columns
    extra = torch.stack([uc_score, reliable.float(), uncertain.float(),
                         uc_obj.float(), uc_cls.float()], -1)
    labels_ext = torch.cat([pseudo_labels[..., :5], extra], -1)
    grid_shapes = [(p.shape[2], p.shape[3]) for p in preds]
    assignments = assign_all_scales(labels_ext, pseudo_mask, grid_shapes,
                                    anchors_grid, lc.anchor_t,
                                    single_targets=not lc.uncertain_aug)
    cp, cn = smooth_bce(lc.label_smoothing)

    def obj_bce(logits, t):
        if lc.focal_loss > 0:
            return focal_bce_with_logits(logits, t, 1.5, pos_weight=lc.obj_pw)
        return bce_with_logits(logits, t, lc.obj_pw)

    lbox = lobj = lcls = 0.0
    for i, (p, asn) in enumerate(zip(preds, assignments)):
        p = loss_dtype(p)
        b = p.shape[0]
        ncell = p[..., 4].numel() // b
        ps = _gather_positives(p, asn)
        k_score = asn.extra[..., 0]
        k_rel = asn.valid & (asn.extra[..., 1] > 0.5)
        k_uc = asn.valid & (asn.extra[..., 2] > 0.5)
        k_uc_obj = asn.valid & (asn.extra[..., 3] > 0.5)
        k_uc_cls = asn.valid & (asn.extra[..., 4] > 0.5)

        pbox = decode_pred_boxes(ps, asn.anchor_wh)
        tbox = torch.cat([asn.txy, asn.twh], -1)
        iou = bbox_ciou(pbox, tbox)

        lbox = lbox + masked_mean(1.0 - iou, k_rel)
        if lc.pseudo_label_with_bbox:
            lbox = lbox + masked_mean(1.0 - iou, k_uc_obj)
        if lc.nc > 1:
            onehot = F.one_hot(asn.tcls, lc.nc).to(p.dtype)
            tmat = onehot * cp + (1.0 - onehot) * cn
            ce = bce_with_logits(ps[..., 5:5 + lc.nc], tmat, lc.cls_pw)
            ce = ce.mean(-1)
            lcls = lcls + masked_mean(ce, k_rel)
            if lc.pseudo_label_with_cls:
                lcls = lcls + masked_mean(ce, k_uc_cls)

        # objectness map: reliable cells take max(IoU); uncertain cells
        # then take their score (or -1: ignored), as the reference scatters
        # them after the reliable ones (ssod_loss.py:240-248)
        rel_val = (1.0 - lc.gr) + lc.gr * iou.detach().clamp(min=0.0)
        tobj = _scatter_max(rel_val, asn.flat_cell, k_rel, ncell)
        uc_flag = _scatter_max(torch.ones_like(k_score), asn.flat_cell, k_uc,
                               ncell) > 0
        if lc.ignore_obj:
            tobj = torch.where(uc_flag, -1.0, tobj)
        else:
            uc_map = _scatter_max(k_score.detach(), asn.flat_cell, k_uc,
                                  ncell)
            tobj = torch.where(uc_flag, uc_map, tobj)
        obji = masked_mean(
            obj_bce(p[..., 4].reshape(b, ncell), tobj.clamp(min=0.0)),
            tobj >= 0.0)
        lobj = lobj + obji * lc.balance[i]

    lbox = lbox * lc.box_w
    lobj = lobj * lc.obj_w
    lcls = lcls * lc.cls_w
    loss = (lbox + lobj + lcls) * batch_scale(preds[0].shape[0])
    return loss, {"ss_box": lbox, "ss_obj": lobj, "ss_cls": lcls}


def compute_ssod_ota_loss(preds: Sequence[torch.Tensor],
                          pseudo_labels: torch.Tensor,
                          pseudo_mask: torch.Tensor, thr_high: torch.Tensor,
                          thr_low: torch.Tensor, anchors_grid, strides,
                          img_size: int, lc: SSODLossConfig,
                          top_k: int = 10):
    """The SSOD OTA branch (JAX `compute_ssod_ota_loss`, reference
    ssod_loss.py:296-345 with targets.shape[1] > 6): one candidate lattice
    over all pseudo labels, the reliable and the uncertain ones matched
    apart, the objectness BCE over the cells >= 0. Same arguments as
    `compute_ssod_loss`, plus the strides and the image size. Returns
    (loss * B, {ss_box, ss_obj, ss_cls})."""
    from .yolov5_ota_loss import (_slices, ota_box_targets, ota_candidates,
                                  simota_match)

    cls_idx = pseudo_labels[..., 0].long()
    conf = pseudo_labels[..., 5]
    reliable = pseudo_mask & (conf >= thr_high[cls_idx])
    uncertain = pseudo_mask & ~reliable & (conf >= thr_low[cls_idx])
    uc_score = pseudo_labels[..., 6] if lc.pseudo_label_with_obj else conf

    extra = torch.stack([uc_score, reliable.float(), uncertain.float()], -1)
    labels_ext = torch.cat([pseudo_labels[..., :5], extra], -1)
    grid_shapes = [(p.shape[2], p.shape[3]) for p in preds]
    assignments = assign_all_scales(labels_ext, pseudo_mask, grid_shapes,
                                    anchors_grid, lc.anchor_t,
                                    single_targets=not lc.uncertain_aug)
    cand = ota_candidates(preds, assignments, strides)
    slot_rel = torch.cat([a.valid & (a.extra[..., 1] > 0.5)
                          for a in assignments], 1)
    slot_uc = torch.cat([a.valid & (a.extra[..., 2] > 0.5)
                         for a in assignments], 1)
    labels5 = pseudo_labels[..., :5]
    box_px = labels5[..., 1:5] * float(img_size)
    fg_r, match_r = simota_match(box_px, cls_idx, reliable, cand, slot_rel,
                                 lc.nc, top_k)
    fg_u, match_u = simota_match(box_px, cls_idx, uncertain, cand, slot_uc,
                                 lc.nc, top_k)
    cp, cn = smooth_bce(lc.label_smoothing)

    def obj_bce(logits, t):
        if lc.focal_loss > 0:
            return focal_bce_with_logits(logits, t, 1.5, pos_weight=lc.obj_pw)
        return bce_with_logits(logits, t, lc.obj_pw)

    lbox = lobj = lcls = 0.0
    for i, (p, asn, fg_ri, mt_ri, fg_ui, mt_ui) in enumerate(zip(
            preds, assignments, *(_slices(x, cand.k_sizes)
                                  for x in (fg_r, match_r, fg_u, match_u)))):
        p = loss_dtype(p)
        b, _, ny, nx, _ = p.shape
        ncell = p[..., 4].numel() // b
        # reliable: CIoU box and class against the matched pseudo label
        iou = bbox_ciou(cand.pbox_grid_all[i],
                        ota_box_targets(labels5, mt_ri, asn, ny, nx))
        lbox = lbox + masked_mean(1.0 - iou, fg_ri)
        if lc.nc > 1:
            onehot = F.one_hot(cls_idx.gather(1, mt_ri), lc.nc).to(p.dtype)
            t = onehot * cp + (1.0 - onehot) * cn
            ce = bce_with_logits(cand.ps_all[i][..., 5:5 + lc.nc], t,
                                 lc.cls_pw).mean(-1)
            lcls = lcls + masked_mean(ce, fg_ri)
        # objectness: reliable IoU targets, then the uncertain score / -1
        tobj = _scatter_max((1.0 - lc.gr) + lc.gr * iou.detach().clamp(
            min=0.0), asn.flat_cell, fg_ri, ncell)
        uc_flag = _scatter_max(torch.ones_like(iou), asn.flat_cell, fg_ui,
                               ncell) > 0
        if lc.ignore_obj:
            tobj = torch.where(uc_flag, -1.0, tobj)
        else:
            uc_map = _scatter_max(uc_score.gather(1, mt_ui).detach(),
                                  asn.flat_cell, fg_ui, ncell)
            tobj = torch.where(uc_flag, uc_map, tobj)
        obji = masked_mean(
            obj_bce(p[..., 4].reshape(b, ncell), tobj.clamp(min=0.0)),
            tobj >= 0.0)
        lobj = lobj + obji * lc.balance[i]

    lbox = lbox * lc.box_w
    lobj = lobj * lc.obj_w
    lcls = lcls * lc.cls_w
    loss = (lbox + lobj + lcls) * batch_scale(preds[0].shape[0])
    return loss, {"ss_box": lbox, "ss_obj": lobj, "ss_cls": lcls}

"""OTA loss for anchor heads, dense-masked (counterpart of
`efficientteacher_tpu/losses/yolov5_ota_loss.py`; reference
models/loss/loss.py `ComputeLoss.ota_loss` and the assigner's
build_ota_targets, models/assigner/yolo_anchor_assigner.py:104-234).

The reference runs two passes and sums them:
  1. SimOTA: the find-3-positive candidates pooled over the scales; per
     image dynamic k, cost = BCE(sqrt(sigmoid(cls) * sigmoid(obj')),
     one-hot) + 3 * -log IoU, k from the top-`top_k` IoU sums, a candidate
     claimed twice goes to its cheapest GT. Matched candidates take CIoU
     box and class BCE; this pass's objectness BCE reads the last channel
     (`pi[..., -1]`, the reference's 'p_obj_e2e'), and so does obj' in the
     cost.
  2. the classic build_targets loss (`yolov5_loss.compute_loss`) on top.
As in JAX, the SimOTA cost scales the GT boxes by the true image size (the
reference hard-codes 640).

The matching is batched over images: (B, M, K) cost and IoU tensors. The
class cost is summed in a decomposed form, sum_c log1p(-q_c) per
candidate once and the GT class's term gathered per GT, where JAX sums a
(M, K, nc) tensor per image: the same value up to float32 rounding, with
no (B, M, K, nc) tensor. Dynamic k picks its top-k in `jax.lax.top_k`'s
order (`assigners/topk.py`). The matching carries no gradient. Raw maps
are the port's (B, na, ny, nx, no); `flat_cell` indexes them flattened
(`assigners/yolo_anchor.py`).

`ota_candidates`, `simota_match` and `ota_box_targets` are shared with the
SSOD OTA loss (`losses/ssod_loss.py compute_ssod_ota_loss`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..assigners.topk import topk_lower_index_first
from ..assigners.yolo_anchor import DenseAssignment, assign_all_scales
from ..ops.boxes import bbox_ciou, bbox_iou
from .common import (batch_mean, batch_scale, bce_with_logits, loss_dtype,
                     masked_mean, smooth_bce)
from .yolov5_loss import (YoloV5LossConfig, _gather_positives, _scatter_max,
                          compute_loss, decode_pred_boxes)


class OTACandidates(NamedTuple):
    """The candidate slots of every scale, pooled."""

    ps_all: List[torch.Tensor]         # per scale (B, K_i, no) raw preds
    pbox_grid_all: List[torch.Tensor]  # per scale (B, K_i, 4), cell-relative
    pbox_px: torch.Tensor              # (B, K, 4) xywh in image pixels
    ps: torch.Tensor                   # (B, K, no)
    k_sizes: List[int]                 # K_i per scale


def _cell_xy(asn: DenseAssignment, ny: int, nx: int) -> torch.Tensor:
    """(B, K, 2) float (gi, gj) of each slot's cell."""
    gi = asn.flat_cell % nx
    gj = (asn.flat_cell // nx) % ny
    return torch.stack([gi, gj], -1).to(asn.txy.dtype)


def ota_candidates(preds: Sequence[torch.Tensor],
                   assignments: Sequence[DenseAssignment],
                   strides) -> OTACandidates:
    """Every candidate slot decoded to image pixels (the 'pre_gen_gains'
    pooling of reference loss.py:219-227)."""
    ps_all, grid_all, px_all, k_sizes = [], [], [], []
    for i, (p, asn) in enumerate(zip(preds, assignments)):
        p = loss_dtype(p)
        ps = _gather_positives(p, asn)
        pbox = decode_pred_boxes(ps, asn.anchor_wh)   # grid units
        cell = _cell_xy(asn, p.shape[2], p.shape[3])
        s = float(strides[i])
        px_all.append(torch.cat([(pbox[..., :2] + cell) * s,
                                 pbox[..., 2:4] * s], -1))
        ps_all.append(ps)
        grid_all.append(pbox)
        k_sizes.append(asn.valid.shape[1])
    return OTACandidates(ps_all=ps_all, pbox_grid_all=grid_all,
                         pbox_px=torch.cat(px_all, 1),
                         ps=torch.cat(ps_all, 1), k_sizes=k_sizes)


@torch.no_grad()
def simota_match(gt_box_px: torch.Tensor, gt_cls: torch.Tensor,
                 gt_mask: torch.Tensor, cand: OTACandidates,
                 cand_valid: torch.Tensor, nc: int, top_k: int = 10,
                 cost_obj: torch.Tensor | None = None):
    """SimOTA dynamic-k matching over the pooled candidates, per image
    (reference build_ota_targets' SimOTA core). gt_box_px (B, M, 4) xywh
    pixels, gt_cls (B, M) int, gt_mask (B, M), cand_valid (B, K).
    `cost_obj`: the logits multiplied into the class cost, the objectness
    channel by default (build_ota_targets_with_score, :440-470); the
    supervised loss passes the last channel. Returns (fg (B, K) bool,
    matched (B, K) int64 GT index)."""
    b, k_total = cand_valid.shape
    m = gt_mask.shape[1]
    kk = min(top_k, k_total)
    ps = cand.ps.detach()
    if cost_obj is None:
        cost_obj = ps[..., 4]
    iou = bbox_iou(gt_box_px[:, :, None, :], cand.pbox_px.detach()[:, None],
                   x1y1x2y2=False)                              # (B, M, K)
    iou = torch.where(gt_mask[:, :, None] & cand_valid[:, None, :], iou, 0.0)

    p = torch.sigmoid(ps[..., 5:5 + nc]) \
        * torch.sigmoid(cost_obj.detach())[..., None]           # (B, K, nc)
    q = torch.sqrt(p.clamp(1e-12, 1.0))
    neg = torch.log1p(-q.clamp(0.0, 1.0 - 1e-7))
    # BCE against the one-hot GT class, summed over the classes:
    # -(log q_g + sum_{c != g} log1p(-q_c))
    # (a class outside [0, nc) has an all-zero one-hot, as in JAX)
    gain = (torch.log(q) - neg).transpose(1, 2)                 # (B, nc, K)
    gt_cls = gt_cls.long()
    in_range = ((gt_cls >= 0) & (gt_cls < nc))[..., None]
    pos = gain.gather(1, gt_cls.clamp(0, nc - 1)[..., None]
                      .expand(-1, -1, k_total))                 # (B, M, K)
    pos = torch.where(in_range, pos, 0.0)
    cost = -(neg.sum(-1)[:, None, :] + pos) \
        + 3.0 * -torch.log(iou + 1e-8)
    cost = cost + 1e9 * (~cand_valid)[:, None, :] \
        + 1e12 * (~gt_mask)[:, :, None]

    dyn_k = torch.topk(iou, kk, -1).values.sum(-1).int().clamp(1, kk)
    _, top_idx = topk_lower_index_first(-cost, kk)              # (B, M, kk)
    rank = torch.arange(kk, device=iou.device)
    chosen = (rank < dyn_k[..., None]) & gt_mask[..., None]
    mm = torch.zeros((b, m, k_total), dtype=torch.bool, device=iou.device)
    mm.scatter_(2, top_idx, chosen)
    claims = mm.sum(1)                                          # (B, K)
    best = torch.where(mm, cost, float("inf")).argmin(1)        # first min
    gt_idx = torch.arange(m, device=iou.device)[None, :, None]
    mm &= (claims <= 1)[:, None, :] | (gt_idx == best[:, None, :])
    return mm.any(1), mm.int().argmax(1)                        # first True


def ota_box_targets(labels: torch.Tensor, matched: torch.Tensor,
                    asn: DenseAssignment, ny: int, nx: int) -> torch.Tensor:
    """The matched GT's box in grid units, xy relative to the slot's cell
    (reference loss.py:230-238 selected_tbox): (B, K_i, 4)."""
    scale = torch.tensor([nx, ny], dtype=labels.dtype, device=labels.device)
    idx = matched[..., None].expand(-1, -1, 2)
    gxy = labels[..., 1:3].gather(1, idx) * scale
    gwh = labels[..., 3:5].gather(1, idx) * scale
    return torch.cat([gxy - _cell_xy(asn, ny, nx), gwh], -1)


def _slices(x: torch.Tensor, sizes: Sequence[int]):
    return torch.split(x, list(sizes), dim=1)


def compute_ota_loss(preds: Sequence[torch.Tensor], labels: torch.Tensor,
                     label_mask: torch.Tensor, anchors_grid, strides,
                     img_size: int, lc: YoloV5LossConfig, top_k: int = 10):
    """preds: per-scale raw maps (B, na, ny, nx, no); labels (B, M, 5)
    [cls, cx, cy, w, h] normalised; label_mask (B, M). Returns (loss * B,
    parts), the SimOTA pass plus the classic loss."""
    grid_shapes = [(p.shape[2], p.shape[3]) for p in preds]
    assignments = assign_all_scales(labels, label_mask, grid_shapes,
                                    anchors_grid, lc.anchor_t,
                                    lc.single_targets)
    nc = lc.nc
    cand = ota_candidates(preds, assignments, strides)
    valid = torch.cat([a.valid for a in assignments], 1)
    gt_cls = labels[..., 0].long()
    # the supervised build_ota_targets multiplies its class cost by the
    # last channel ('p_obj_e2e', yolo_anchor_assigner.py:156-200)
    fg, matched = simota_match(labels[..., 1:5] * float(img_size), gt_cls,
                               label_mask, cand, valid, nc, top_k,
                               cost_obj=cand.ps[..., -1])
    cp, cn = smooth_bce(lc.label_smoothing)
    lbox = lobj = lcls = 0.0
    for i, (p, asn, fg_i, mt_i) in enumerate(zip(
            preds, assignments, _slices(fg, cand.k_sizes),
            _slices(matched, cand.k_sizes))):
        p = loss_dtype(p)
        bsz, _, ny, nx, _ = p.shape
        ncell = p[..., -1].numel() // bsz
        iou = bbox_ciou(cand.pbox_grid_all[i],
                        ota_box_targets(labels, mt_i, asn, ny, nx))
        lbox = lbox + masked_mean(1.0 - iou, fg_i)
        tobj = _scatter_max((1.0 - lc.gr) + lc.gr * iou.detach().clamp(
            min=0.0), asn.flat_cell, fg_i, ncell)
        # the reference's OTA pass reads pi[..., -1] for objectness
        obji = batch_mean(bce_with_logits(p[..., -1].reshape(bsz, ncell),
                                          tobj, lc.obj_pw))
        lobj = lobj + obji * lc.balance[i]
        if nc > 1:
            onehot = F.one_hot(gt_cls.gather(1, mt_i), nc).to(p.dtype)
            t = onehot * cp + (1.0 - onehot) * cn
            ce = bce_with_logits(cand.ps_all[i][..., 5:5 + nc], t,
                                 lc.cls_pw).mean(-1)
            lcls = lcls + masked_mean(ce, fg_i)
    lbox = lbox * lc.box_w
    lobj = lobj * lc.obj_w
    lcls = lcls * lc.cls_w
    # pass 2: the classic loss on top
    _, classic = compute_loss(preds, labels, label_mask, anchors_grid, lc)
    lbox = lbox + classic["box"]
    lobj = lobj + classic["obj"]
    lcls = lcls + classic["cls"]
    loss = (lbox + lobj + lcls) * batch_scale(preds[0].shape[0])
    return loss, {"box": lbox, "obj": lobj, "cls": lcls, "loss": loss}

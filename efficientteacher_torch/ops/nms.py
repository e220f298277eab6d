"""Batched fixed-shape non-maximum suppression (counterpart of
`efficientteacher_tpu/ops/nms.py`).

Replaces the reference's host loop over `torchvision.ops.nms`
(reference utils/general.py:994-1098 `non_max_suppression`,
:887-992 `non_max_suppression_ssod`) with a fixed-shape on-device program:
gate -> candidate selection (top max_nms) -> score-sorted, class-offset,
tile-padded candidates -> greedy keep mask -> the first max_det kept rows.
The JAX version's `vmap`s are a batch dimension written out here.

Semantics parity notes (vs reference non_max_suppression):
  - candidate gate: obj > conf AND max cls prob > conf (general.py:1005)
  - conf = obj_conf * cls_conf (general.py:1049)
  - multi-label expansion over classes above threshold (general.py:1058)
  - class-offset trick with max_wh = 7680 (general.py:1080)
  - outputs capped at max_det = 300, sorted by confidence

The two kernels of this path: candidate selection through
`select_cuda.threshold_compact_cuda` (multi-label, large lattices) and the
keep mask through `nms_cuda.greedy_nms_keep_cuda`. `use_kernels=False`
runs their plain PyTorch versions instead on any device: the reference the
kernels are compared with.

Equal scores are ordered as JAX's plain route orders them
(`jax.lax.top_k`): lowest flat index first, here through
`assigners/topk.topk_lower_index_first` in the single-label path, in the
"exact" selection and in the selection engines' last top-k
(`select_cuda.py`). The greedy sweep keeps the first of equal-score
boxes, so the order of ties decides which are kept.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..assigners.topk import topk_lower_index_first
from .boxes import xywh2xyxy
from .nms_cuda import greedy_nms_keep, greedy_nms_keep_cuda
from .select_cuda import exact_topk_elems, exact_topk_rows

MAX_WH = 7680.0  # class-offset magnitude (reference general.py:1035)


class NMSOutput(NamedTuple):
    """Fixed-shape detections: rows beyond `valid` are zero padding."""

    detections: torch.Tensor  # (B, max_det, C) - [xyxy, conf, cls, ...]
    valid: torch.Tensor       # (B, max_det) bool


def _gate_and_extras(pred, nc, conf_thres, ssod, n_extra, obj_gate, classes):
    """Shared candidate gating over (B, N, no) predictions: boxes, per-(row,
    class) confidences, the row gate, optional extra columns, and the
    `classes` filter mask (reference general.py:1049-1051, applied before
    the max_nms cap). `obj_gate` is the landmark variant's obj-only gate
    (general.py:791); `n_extra` trailing columns ride along
    (general.py:778)."""
    obj = pred[..., 4]
    clsp = pred[..., 5 : 5 + nc]
    boxes_xyxy = xywh2xyxy(pred[..., :4])
    conf_mat = clsp * obj[..., None]  # conf = obj_conf * cls_conf
    if ssod or obj_gate:
        gate = obj > conf_thres
    else:
        gate = (obj > conf_thres) & (clsp.amax(-1) > conf_thres)
    if ssod:
        # [obj_conf, cls_conf] columns (general.py:887 ssod variant)
        extra_mat = torch.stack([obj, clsp.amax(-1)], -1)
    elif n_extra:
        extra_mat = pred[..., 5 + nc : 5 + nc + n_extra]
    else:
        extra_mat = None
    allowed = None
    if classes is not None:
        allowed = torch.zeros(nc, dtype=torch.bool, device=pred.device)
        allowed[list(classes)] = True
    return boxes_xyxy, conf_mat, gate, extra_mat, allowed


def _pair_scores(pred, nc, conf_thres, ssod, n_extra, obj_gate, classes):
    """Multi-label (anchor, class) pair lattice: masked flat scores
    (B, N * nc), non-candidates -1, candidates > 0 (general.py:1058)."""
    boxes_xyxy, conf_mat, gate, extra_mat, allowed = _gate_and_extras(
        pred, nc, conf_thres, ssod, n_extra, obj_gate, classes)
    keep_pair = gate[..., None] & (conf_mat > conf_thres)
    if allowed is not None:
        keep_pair &= allowed
    score = torch.where(keep_pair, conf_mat, -1.0)
    return score.flatten(1), boxes_xyxy, extra_mat


def _finish_candidates(top_scores, cand_boxes, cls, extra, agnostic, tile):
    """Score-sorted candidates (B, k_eff, ...) -> tile-padded class-offset
    boxes, validity and output rows."""
    k_eff = cand_boxes.shape[1]
    cand_valid = top_scores > 0
    tile = min(tile, max(128, 1 << (k_eff - 1).bit_length()))
    pad = -(-k_eff // tile) * tile - k_eff
    if pad:
        f = torch.nn.functional.pad
        cand_boxes = f(cand_boxes, (0, 0, 0, pad))
        cls = f(cls, (0, pad))
        top_scores = f(top_scores, (0, pad), value=-1.0)
        cand_valid = f(cand_valid, (0, pad))
        if extra is not None:
            extra = f(extra, (0, 0, 0, pad))
    offset = 0.0 if agnostic else MAX_WH
    nms_boxes = cand_boxes + (cls * offset)[..., None]
    cols = [cand_boxes, top_scores[..., None], cls[..., None]]
    if extra is not None:
        cols.append(extra)
    return nms_boxes.contiguous(), cand_valid.contiguous(), torch.cat(cols, -1)


def _gather_rows(x, idx):
    """x (B, N, C), idx (B, k) -> (B, k, C)."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _finish_pairs(top_scores, top_idx, boxes_xyxy, extra_mat, nc, agnostic,
                  tile):
    """Gather selected (anchor, class) pairs into candidate rows."""
    anchor = top_idx // nc
    cls = (top_idx % nc).float()
    cand_boxes = _gather_rows(boxes_xyxy, anchor)
    extra = _gather_rows(extra_mat, anchor) if extra_mat is not None else None
    return _finish_candidates(top_scores, cand_boxes, cls, extra, agnostic,
                              tile)


def _prep_candidates_single(pred, nc, conf_thres, max_nms, ssod, tile,
                            agnostic, n_extra=0, obj_gate=False,
                            classes=None):
    """Single-label path (best class per row, reference general.py:1061):
    raw predictions (B, N, no) -> score-sorted padded candidates."""
    boxes_xyxy, conf_mat, gate, extra_mat, allowed = _gate_and_extras(
        pred, nc, conf_thres, ssod, n_extra, obj_gate, classes)
    best_idx = conf_mat.argmax(-1)  # first maximum, as jnp.argmax
    best_conf = conf_mat.gather(-1, best_idx[..., None])[..., 0]
    keep_row = gate & (best_conf > conf_thres)
    if allowed is not None:
        # the reference filters rows by their argmax class; it does not
        # re-argmax over the allowed subset (general.py:1049-1051)
        keep_row &= allowed[best_idx]
    score = torch.where(keep_row, best_conf, -1.0)
    k_eff = min(max_nms, score.shape[1])
    top_scores, top_idx = topk_lower_index_first(score, k_eff)
    cand_boxes = _gather_rows(boxes_xyxy, top_idx)
    cls = best_idx.gather(1, top_idx).float()
    extra = _gather_rows(extra_mat, top_idx) if extra_mat is not None else None
    return _finish_candidates(top_scores, cand_boxes, cls, extra, agnostic,
                              tile)


def _compact_keep(rows, keep, max_det: int):
    """Scatter kept rows (already score-ordered) into (B, max_det, C)."""
    b, _, c = rows.shape
    slots = torch.cumsum(keep, 1) - 1
    slots = torch.where(keep & (slots < max_det), slots, max_det)
    out = rows.new_zeros((b, max_det + 1, c))  # the last slot takes drops
    out.scatter_(1, slots[..., None].expand(-1, -1, c), rows)
    n = keep.sum(1).clamp(max=max_det)
    valid = torch.arange(max_det, device=rows.device)[None, :] < n[:, None]
    return out[:, :max_det].contiguous(), valid


def batched_nms(prediction: torch.Tensor, *, nc: int,
                conf_thres: float = 0.25, iou_thres: float = 0.45,
                multi_label: bool = False, agnostic: bool = False,
                max_nms: int = 30000, max_det: int = 300, ssod: bool = False,
                tile: int = 256, n_extra: int = 0, obj_gate: bool = False,
                classes: tuple | None = None, selection: str | None = None,
                use_kernels: bool = True) -> NMSOutput:
    """Batched NMS over raw decoded predictions (B, N, 5+nc+n_extra).

    Returns a fixed-shape `NMSOutput`:
      ssod=False -> detections (B, max_det, 6) = [x1 y1 x2 y2, conf, cls]
                    (reference non_max_suppression, general.py:994)
      ssod=True  -> detections (B, max_det, 8) = [..., obj_conf, cls_conf]
                    (reference non_max_suppression_ssod, general.py:887)
      n_extra>0  -> detections (B, max_det, 6+n_extra): trailing prediction
                    columns ride along (general.py:778); obj_gate=True is
                    that variant's obj-only gate

    `selection` picks the multi-label max_nms engine; the names are the
    JAX package's, whose kernels were Pallas:
      "pallas" / "pallas_rows" — exact_topk_rows (row compaction, with
                  exact_topk_elems as its dense tail)
      "pallas_elems" — exact_topk_elems (element compaction + bisection)
      "exact"  — a top-k over the whole lattice
      "approx" — exact selection (the JAX package's approximate top-k has
                 no counterpart here)
      None     — "pallas" for CUDA tensors when the lattice holds at least
                 4 * max_nms pairs, else "exact".
    Every engine returns the exact top-k (select_cuda's contract), with
    equal scores lowest index first, so every engine keeps the same
    rows.

    `use_kernels=False` runs the plain PyTorch versions of both kernels on
    any device. With True, CUDA tensors go through the kernels and CPU
    tensors through the plain versions.
    """
    prediction = prediction.float()
    if multi_label and nc > 1:
        flat, boxes_xyxy, extra_mat = _pair_scores(
            prediction, nc, conf_thres, ssod, n_extra, obj_gate, classes)
        k_eff = min(max_nms, flat.shape[1])
        if selection is None:
            selection = ("pallas" if flat.is_cuda
                         and flat.shape[1] >= 4 * k_eff else "exact")
        if selection in ("pallas", "pallas_rows", "pallas_elems"):
            engine = (exact_topk_elems if selection == "pallas_elems"
                      else exact_topk_rows)
            top_scores, top_idx = engine(flat, k_eff, use_kernel=use_kernels)
        elif selection in ("exact", "approx"):
            top_scores, top_idx = topk_lower_index_first(flat, k_eff)
        else:
            raise ValueError(f"unknown selection {selection!r}")
        nms_boxes, cand_valid, rows = _finish_pairs(
            top_scores, top_idx, boxes_xyxy, extra_mat, nc, agnostic, tile)
    else:
        nms_boxes, cand_valid, rows = _prep_candidates_single(
            prediction, nc, conf_thres, max_nms, ssod, tile, agnostic,
            n_extra, obj_gate, classes)
    eff_tile = min(tile, nms_boxes.shape[1])
    nms = greedy_nms_keep_cuda if use_kernels else greedy_nms_keep
    keep = nms(nms_boxes, cand_valid, iou_thres, tile=eff_tile,
               stop_at=max_det)
    return NMSOutput(*_compact_keep(rows, keep, max_det))


def non_max_suppression(prediction, conf_thres=0.25, iou_thres=0.45,
                        classes=None, agnostic=False, multi_label=False,
                        max_det=300, max_nms=30000):
    """Reference-shaped convenience wrapper (returns NMSOutput)."""
    return batched_nms(
        prediction, nc=prediction.shape[2] - 5, conf_thres=float(conf_thres),
        iou_thres=float(iou_thres), multi_label=bool(multi_label),
        agnostic=bool(agnostic), max_nms=max_nms, max_det=max_det,
        classes=tuple(classes) if classes is not None else None)


def non_max_suppression_lmk_and_bbox(prediction, conf_thres=0.25,
                                     iou_thres=0.45, agnostic=False,
                                     num_points=0, multi_label=False,
                                     max_det=300, max_nms=30000):
    """Keypoint/landmark NMS (reference utils/general.py:778-885): layout
    [xywh, obj, nc cls cols, 2*num_points keypoint cols, 1 trailing col];
    kept rows are [xyxy, conf, cls, keypoints..., trailing]; obj-only gate
    (general.py:791)."""
    return batched_nms(
        prediction, nc=prediction.shape[2] - 5 - num_points * 2 - 1,
        conf_thres=float(conf_thres), iou_thres=float(iou_thres),
        multi_label=bool(multi_label), agnostic=bool(agnostic),
        max_nms=max_nms, max_det=max_det, n_extra=num_points * 2 + 1,
        obj_gate=True)


def non_max_suppression_ssod(prediction, conf_thres=0.25, iou_thres=0.45,
                             agnostic=False, multi_label=False, max_det=300,
                             max_nms=2048):
    """SSOD pseudo-label NMS carrying [xyxy, conf, cls, obj_conf, cls_conf]."""
    return batched_nms(
        prediction, nc=prediction.shape[2] - 5, conf_thres=float(conf_thres),
        iou_thres=float(iou_thres), multi_label=bool(multi_label),
        agnostic=bool(agnostic), max_nms=max_nms, max_det=max_det, ssod=True)

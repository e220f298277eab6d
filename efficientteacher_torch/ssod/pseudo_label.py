"""FairPseudoLabel: teacher detections -> strong-view pseudo labels, on the
device (counterpart of `efficientteacher_tpu/ssod/pseudo_label.py`;
reference utils/self_supervised_utils.py:194-245 and :414-454).

Per image, with the batch written out:
  1. the teacher's decoded predictions on the WEAK view -> class-aware NMS
     keeping [xyxy, conf, cls, obj_conf, cls_conf] (`batched_nms`,
     ssod=True, max_nms 2048: on CUDA tensors the keep mask is the
     `greedy_nms_keep_cuda` kernel at (B, 2048))
  2. each box's 4 corners warped by the recorded M (weak -> strong), the
     enclosing box clipped to the image
  3. box_candidates (w, h > 2 px, area ratio > 0.1 against the s-scaled
     original, aspect < 20; reference augmentations.py:417)
  4. normalized xywh, with the flips (ud: y -> 1 - y, lr: x -> 1 - x)

With extra teachers (`create_pseudo_labels_multi`; reference
self_supervised_utils.py:249-313), each teacher's set comes from its own
NMS, the extra teachers' classes are remapped into the main class space,
and the sets are merged by a class-agnostic re-NMS before the warp: on
CUDA tensors the merge's keep mask is `greedy_nms_keep_cuda` at
(B, max(128, next_pow2(D_total))), 256 for two teachers at max_pl 100.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.nms import _compact_keep, batched_nms
from ..ops.nms_cuda import greedy_nms_keep, greedy_nms_keep_cuda


class PseudoLabels(NamedTuple):
    labels: torch.Tensor   # (B, max_pl, 8) [cls, cx, cy, w, h, conf, obj, cls]
    mask: torch.Tensor     # (B, max_pl) bool
    invalid: torch.Tensor  # () bool: no label survived in the whole batch
    # the NMS detections before the warp (LabelMatch harvests every one,
    # reference utils/labelmatch.py:283-299)
    nms_conf: torch.Tensor   # (B, max_pl)
    nms_cls: torch.Tensor    # (B, max_pl)
    nms_valid: torch.Tensor  # (B, max_pl) bool


def _warp_one_image(det: torch.Tensor, valid: torch.Tensor,
                    m_s: torch.Tensor, img_size: float):
    """det (B, D, 8) [xyxy, conf, cls, obj_conf, cls_conf] in weak-view
    pixels, valid (B, D), m_s (B, 13) [idx, M (9), s, ud, lr]. Returns
    labels (B, D, 8) [cls, xywhn, conf, obj_conf, cls_conf] and their keep
    mask. (The JAX function maps one image; this one takes the batch.)"""
    M = m_s[:, 1:10].reshape(-1, 1, 3, 3)
    s = m_s[:, 10:11]
    flip_ud = m_s[:, 11:12] > 0.5
    flip_lr = m_s[:, 12:13] > 0.5

    x1, y1, x2, y2 = det[..., 0], det[..., 1], det[..., 2], det[..., 3]
    ones = torch.ones_like(x1)
    corners = torch.stack([
        torch.stack([x1, y1, ones], -1), torch.stack([x2, y2, ones], -1),
        torch.stack([x1, y2, ones], -1), torch.stack([x2, y1, ones], -1),
    ], 2)                                                    # (B, D, 4, 3)
    warped = corners @ M.transpose(-1, -2)
    wxy = warped[..., :2] / warped[..., 2:3].clamp(min=1e-9)
    nx1 = wxy[..., 0].amin(-1).clamp(0, img_size)
    ny1 = wxy[..., 1].amin(-1).clamp(0, img_size)
    nx2 = wxy[..., 0].amax(-1).clamp(0, img_size)
    ny2 = wxy[..., 1].amax(-1).clamp(0, img_size)

    ow, oh = (x2 - x1) * s, (y2 - y1) * s
    nw, nh = nx2 - nx1, ny2 - ny1
    ar = torch.maximum(nw / (nh + 1e-16), nh / (nw + 1e-16))
    keep = (valid & (nw > 2) & (nh > 2)
            & (nw * nh / (ow * oh + 1e-16) > 0.1) & (ar < 20))

    cx = (nx1 + nx2) / 2 / img_size
    cy = (ny1 + ny2) / 2 / img_size
    cx = torch.where(flip_lr, 1.0 - cx, cx)
    cy = torch.where(flip_ud, 1.0 - cy, cy)
    labels = torch.stack([det[..., 5], cx, cy, nw / img_size, nh / img_size,
                          det[..., 4], det[..., 6], det[..., 7]], -1)
    return labels, keep


def create_pseudo_labels(teacher_decoded: torch.Tensor, m_s: torch.Tensor,
                         *, img_size: int, nc: int, conf_thres: float = 0.3,
                         iou_thres: float = 0.6, max_pl: int = 100,
                         multi_label: bool = False,
                         use_kernels: bool = True) -> PseudoLabels:
    """teacher_decoded (B, N, 5 + nc): the teacher's decoded predictions on
    the weak view; m_s (B, 13): the weak -> strong transform records.
    `use_kernels=False` runs the NMS's plain PyTorch versions (the
    reference the CUDA path is held to)."""
    out = batched_nms(teacher_decoded, nc=nc, conf_thres=conf_thres,
                      iou_thres=iou_thres, multi_label=multi_label,
                      max_det=max_pl, max_nms=2048, ssod=True,
                      use_kernels=use_kernels)
    labels, keep = _warp_one_image(out.detections, out.valid, m_s.float(),
                                   float(img_size))
    labels = torch.where(keep[..., None], labels, 0.0)
    return PseudoLabels(labels=labels, mask=keep, invalid=~keep.any(),
                        nms_conf=out.detections[..., 4],
                        nms_cls=out.detections[..., 5],
                        nms_valid=out.valid)


def class_agnostic_merge(dets, valids, max_pl: int, iou_thres: float,
                         use_kernels: bool = True):
    """Merge per-teacher detection sets (B, D_t, 8) [xyxy, conf, cls, obj,
    cls_conf] with their valid masks: concatenated, sorted by confidence
    (stable: equal scores keep their order, as JAX's argsort), padded to
    k = max(128, next_pow2(D_total)) rows and re-suppressed class-agnostic
    at tile min(256, k); the first max_pl kept rows in order, the rest
    dropped (not clipped into the last slot). Returns (B, max_pl, 8) and
    the valid mask."""
    merged = torch.cat(dets, 1)
    valid = torch.cat(valids, 1)
    b, d, c = merged.shape
    score = torch.where(valid, merged[..., 4], -1.0)
    k = max(128, 1 << (d - 1).bit_length())
    score_s, order = torch.sort(score, dim=1, descending=True, stable=True)
    det_s = merged.gather(1, order[..., None].expand(-1, -1, c))
    valid_s = score_s > 0
    if k > d:
        det_s = torch.nn.functional.pad(det_s, (0, 0, 0, k - d))
        valid_s = torch.nn.functional.pad(valid_s, (0, k - d))
    nms = greedy_nms_keep_cuda if use_kernels else greedy_nms_keep
    keep = nms(det_s[..., :4].contiguous(), valid_s.contiguous(), iou_thres,
               tile=min(256, k))
    return _compact_keep(det_s, keep, max_pl)


def create_pseudo_labels_multi(teacher_decoded_list, class_maps,
                               m_s: torch.Tensor, *, img_size: int, nc: int,
                               conf_thres: float = 0.3,
                               iou_thres: float = 0.6, max_pl: int = 100,
                               multi_label: bool = False,
                               use_kernels: bool = True) -> PseudoLabels:
    """Multi-teacher FairPseudoLabel. teacher_decoded_list[0] is the main
    (EMA) teacher's (B, N, 5 + nc), the others the extra teachers' with
    their own class counts; class_maps[i] (nc_i,) int maps a teacher's
    class into the main class space, -1 dropping it (None: identity).
    Each set is NMS'd alone (max_nms 2048), remapped, then merged
    (`class_agnostic_merge`) and warped as `create_pseudo_labels` does.
    The NMS outputs kept for LabelMatch are the merged set's."""
    dets, valids = [], []
    for decoded, cmap in zip(teacher_decoded_list, class_maps):
        out = batched_nms(decoded, nc=decoded.shape[-1] - 5,
                          conf_thres=conf_thres, iou_thres=iou_thres,
                          multi_label=multi_label, max_det=max_pl,
                          max_nms=2048, ssod=True, use_kernels=use_kernels)
        det, valid = out.detections, out.valid
        if cmap is not None:
            cmap = torch.as_tensor(cmap, dtype=torch.long,
                                   device=det.device)
            cls = det[..., 5].long().clamp(0, cmap.shape[0] - 1)
            new_cls = cmap[cls]
            valid = valid & (new_cls >= 0)
            det = torch.cat([det[..., :5], new_cls[..., None].to(det.dtype),
                             det[..., 6:]], -1)
        dets.append(det)
        valids.append(valid)
    merged, mvalid = class_agnostic_merge(dets, valids, max_pl, iou_thres,
                                          use_kernels)
    labels, keep = _warp_one_image(merged, mvalid, m_s.float(),
                                   float(img_size))
    labels = torch.where(keep[..., None], labels, 0.0)
    return PseudoLabels(labels=labels, mask=keep, invalid=~keep.any(),
                        nms_conf=merged[..., 4], nms_cls=merged[..., 5],
                        nms_valid=mvalid)

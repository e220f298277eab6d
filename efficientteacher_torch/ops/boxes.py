"""Box geometry primitives (counterpart of
`efficientteacher_tpu/ops/boxes.py`).

Only what the eval and training slices run is ported so far. Same
arithmetic, in the same order, as the JAX functions, so NMS decisions match
bit for bit:
  - xywh2xyxy: reference utils/general.py:575
  - box_iou (pairwise NxM): reference utils/metrics.py:252-274
  - bbox_iou (elementwise IoU / GIoU / DIoU / CIoU / SIoU): reference
    utils/metrics.py:207-249 and the SIoU of models/loss/loss.py:726-859;
    bbox_ciou is its xywh CIoU, the form the YOLOv5 losses call
  - iou_loss: 1 - bbox_iou by name (the anchor-free losses' dispatch)
  - scale_coords_landmarks: reference utils/general.py:717-750
"""

from __future__ import annotations

import math

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


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, x1y1x2y2: bool = True,
             GIoU: bool = False, DIoU: bool = False, CIoU: bool = False,
             SIoU: bool = False, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU between broadcastable boxes (..., 4), xyxy or (with
    x1y1x2y2=False) xywh: the JAX `bbox_iou` (ops/boxes.py:140). As the
    reference: `+eps` on the heights only, and CIoU's alpha a constant to
    autograd, with the JAX function's NaN guard where iou rounds to
    1 + eps."""
    if x1y1x2y2:
        b1_x1, b1_y1, b1_x2, b1_y2 = (box1[..., i] for i in range(4))
        b2_x1, b2_y1, b2_x2, b2_y2 = (box2[..., i] for i in range(4))
    else:
        b1_x1 = box1[..., 0] - box1[..., 2] / 2
        b1_x2 = box1[..., 0] + box1[..., 2] / 2
        b1_y1 = box1[..., 1] - box1[..., 3] / 2
        b1_y2 = box1[..., 1] + box1[..., 3] / 2
        b2_x1 = box2[..., 0] - box2[..., 2] / 2
        b2_x2 = box2[..., 0] + box2[..., 2] / 2
        b2_y1 = box2[..., 1] - box2[..., 3] / 2
        b2_y2 = box2[..., 1] + box2[..., 3] / 2

    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1))
             .clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1))
             .clamp(min=0))
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (GIoU or DIoU or CIoU or SIoU):
        return iou

    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    if CIoU or DIoU:
        c2 = cw ** 2 + ch ** 2 + eps
        rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2
                + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
        if DIoU:
            return iou - rho2 / c2
        v = (4 / math.pi ** 2) * (torch.atan(w2 / h2)
                                  - torch.atan(w1 / h1)) ** 2
        den = v - iou + (1 + eps)
        den = torch.where(den.abs() < 1e-12, 1e-12, den)
        alpha = (v / den).detach()
        return iou - (rho2 / c2 + v * alpha)
    if SIoU:
        s_cw = (b2_x1 + b2_x2 - b1_x1 - b1_x2) * 0.5
        s_ch = (b2_y1 + b2_y2 - b1_y1 - b1_y2) * 0.5
        sigma = torch.sqrt(s_cw ** 2 + s_ch ** 2) + eps
        sin_alpha_1 = s_cw.abs() / sigma
        sin_alpha_2 = s_ch.abs() / sigma
        threshold = 2 ** 0.5 / 2
        sin_alpha = torch.where(sin_alpha_1 > threshold, sin_alpha_2,
                                sin_alpha_1)
        angle_cost = torch.cos(torch.arcsin(sin_alpha) * 2 - math.pi / 2)
        rho_x = (s_cw / (cw + eps)) ** 2
        rho_y = (s_ch / (ch + eps)) ** 2
        gamma = angle_cost - 2
        distance_cost = 2 - torch.exp(gamma * rho_x) - torch.exp(gamma * rho_y)
        omiga_w = (w1 - w2).abs() / torch.maximum(w1, w2)
        omiga_h = (h1 - h2).abs() / torch.maximum(h1, h2)
        shape_cost = ((1 - torch.exp(-omiga_w)) ** 4
                      + (1 - torch.exp(-omiga_h)) ** 4)
        return iou - 0.5 * (distance_cost + shape_cost)
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area  # GIoU


def bbox_ciou(box1: torch.Tensor, box2: torch.Tensor,
              eps: float = 1e-7) -> torch.Tensor:
    """Elementwise CIoU of broadcastable xywh boxes (..., 4), the form the
    YOLOv5 losses call."""
    return bbox_iou(box1, box2, x1y1x2y2=False, CIoU=True, eps=eps)


_IOU_KIND = {"giou": {"GIoU": True}, "diou": {"DIoU": True},
             "ciou": {"CIoU": True}, "siou": {"SIoU": True}, "iou": {}}


def iou_loss(pred: torch.Tensor, target: torch.Tensor, iou_type: str = "giou",
             x1y1x2y2: bool = True) -> torch.Tensor:
    """1 - bbox_iou of the named kind (JAX ops/boxes.py:248)."""
    return 1.0 - bbox_iou(pred, target, x1y1x2y2=x1y1x2y2,
                          **_IOU_KIND[iou_type])


def scale_coords_landmarks(img1_shape, coords: torch.Tensor, img0_shape,
                           num_points: int, ratio_pad=None) -> torch.Tensor:
    """Interleaved landmark columns [x0 y0 x1 y1 ...] from the letterboxed
    `img1_shape` (h, w) to the native `img0_shape`: each coordinate
    pad-shifted, divided by the gain, and clamped to the native image on
    its own (landmarks clamp per coordinate, boxes per corner). Columns
    past 2 num_points pass through."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0],
                   img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    n2 = num_points * 2
    pts = coords[..., :n2].reshape(coords.shape[:-1] + (num_points, 2))
    shift = torch.tensor([pad[0], pad[1]], dtype=coords.dtype,
                         device=coords.device)
    hi = torch.tensor([img0_shape[1], img0_shape[0]], dtype=coords.dtype,
                      device=coords.device)
    pts = torch.minimum(((pts - shift) / gain).clamp(min=0.0), hi)
    out = pts.reshape(coords.shape[:-1] + (n2,))
    if coords.shape[-1] > n2:
        out = torch.cat([out, coords[..., n2:]], -1)
    return out

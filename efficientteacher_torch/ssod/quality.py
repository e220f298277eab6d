"""Pseudo-label quality telemetry (a copy of
`efficientteacher_tpu/ssod/quality.py`, numpy only).

Parity with reference utils/self_supervised_utils.py:481-609
(check_pseudo_label_with_gt / check_pseudo_label): per-batch TP rate,
class-mistake rate (fp_cls), localization-mistake rate (fp_loc), and
pseudo/GT counts, logged by the SSOD trainer each step so a broken
pseudo-label path is visible immediately (SURVEY.md §4.2)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def _xywhn2xyxy(x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x)
    out[:, 0] = x[:, 0] - x[:, 2] / 2
    out[:, 1] = x[:, 1] - x[:, 3] / 2
    out[:, 2] = x[:, 0] + x[:, 2] / 2
    out[:, 3] = x[:, 1] + x[:, 3] / 2
    return out


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-16)


def check_pseudo_label_with_gt(
    pseudo_labels: np.ndarray,  # (B, Mp, >=5) [cls, xywhn, ...]
    pseudo_mask: np.ndarray,
    gt_labels: np.ndarray,      # (B, M, 5) [cls, xywhn]
    gt_mask: np.ndarray,
    iou_thres: float = 0.5,
) -> Dict[str, float]:
    tp = fp_cls = fp_loc = pse = gt = 0
    for bi in range(pseudo_labels.shape[0]):
        pl = pseudo_labels[bi][pseudo_mask[bi].astype(bool)]
        g = gt_labels[bi][gt_mask[bi].astype(bool)]
        pse += len(pl)
        gt += len(g)
        if len(pl) == 0:
            continue
        if len(g) == 0:
            fp_loc += len(pl)
            continue
        iou = _iou(_xywhn2xyxy(pl[:, 1:5]), _xywhn2xyxy(g[:, 1:5]))
        best = iou.argmax(1)
        best_iou = iou[np.arange(len(pl)), best]
        loc_ok = best_iou > iou_thres
        cls_ok = pl[:, 0] == g[best, 0]
        tp += int((loc_ok & cls_ok).sum())
        fp_cls += int((loc_ok & ~cls_ok).sum())
        fp_loc += int((~loc_ok).sum())
    n = max(pse, 1)
    return {
        "tp": tp / n,
        "fp_cls": fp_cls / n,
        "fp_loc": fp_loc / n,
        "pse_num": float(pse),
        "gt_num": float(gt),
    }


def check_pseudo_label(
    pseudo_labels: np.ndarray,  # (B, Mp, >=8) [cls, xywhn, conf, obj, clsc]
    pseudo_mask: np.ndarray,
    conf_thres: float = 0.5,
) -> Dict[str, float]:
    """No-GT proxy statistics (reference check_pseudo_label,
    utils/self_supervised_utils.py:587-609): counts and the fraction of
    pseudo labels whose obj/cls confidences agree above a threshold —
    a cheap precision proxy when the target set has no annotations."""
    mask = pseudo_mask.astype(bool)
    n = int(mask.sum())
    if n == 0:
        return {"pse_num": 0.0, "conf_agree": 0.0, "mean_conf": 0.0}
    rows = pseudo_labels[mask]
    conf = rows[:, 5]
    obj_c = rows[:, 6] if rows.shape[1] > 6 else conf
    cls_c = rows[:, 7] if rows.shape[1] > 7 else conf
    agree = float(((obj_c > conf_thres) & (cls_c > conf_thres)).mean())
    return {
        "pse_num": float(n),
        "conf_agree": agree,
        "mean_conf": float(conf.mean()),
    }

"""mAP engine: AP per class, TP matching, fitness, confusion matrix (a copy
of `efficientteacher_tpu/eval/metrics.py`, numpy only).

Numpy host-side (runs once per epoch on gathered detections); parity with
reference utils/metrics.py:
  - fitness = 0.1*mAP50 + 0.9*mAP (metrics.py:16-19)
  - ap_per_class: per-class PR curves sampled on a 1000-pt conf grid,
    101-point COCO interpolated AP, best-F1 global conf index, and the
    per-class best-F1 thresholds `cls_thr` the SSOD loop feeds back
    (metrics.py:22-98)
  - compute_ap precision envelope + interp (metrics.py:100-126)
  - process_batch greedy IoU@[.5:.95] TP matrix with per-label/per-detection
    dedup by IoU order (val.py:123-145)
  - with `plot_dir`, the PR / F1 / P / R curve family (utils/plots.py,
    matplotlib; reference plot_pr_curve / plot_mc_curve, metrics.py:312-360)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# numpy < 2 names it trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def fitness(results: np.ndarray) -> np.ndarray:
    """results rows [P, R, mAP50, mAP]; weights (0, 0, 0.1, 0.9)."""
    w = np.array([0.0, 0.0, 0.1, 0.9])
    return (results[:, :4] * w).sum(1)


def box_iou_np(box1: np.ndarray, box2: np.ndarray) -> np.ndarray:
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    lt = np.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = np.minimum(box1[:, None, 2:4], box2[None, :, 2:4])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    return inter / (area1[:, None] + area2[None, :] - inter + 1e-16)


def process_batch(detections: np.ndarray, labels: np.ndarray,
                  iouv: np.ndarray) -> np.ndarray:
    """TP matrix for one image.

    detections (N, 6): x1 y1 x2 y2 conf cls (already conf-sorted desc).
    labels (M, 5): cls x1 y1 x2 y2.
    Returns bool (N, len(iouv)).
    """
    correct = np.zeros((detections.shape[0], iouv.shape[0]), bool)
    if len(labels) == 0 or len(detections) == 0:
        return correct
    iou = box_iou_np(labels[:, 1:5], detections[:, :4])
    correct_class = labels[:, 0:1] == detections[None, :, 5]
    for i in range(len(iouv)):
        li, di = np.where((iou >= iouv[i]) & correct_class)
        if len(li):
            matches = np.stack([li, di, iou[li, di]], 1)
            if len(li) > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


def compute_ap(recall: np.ndarray, precision: np.ndarray):
    """101-point COCO-interp AP with precision envelope."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = _trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(
    tp: np.ndarray,
    conf: np.ndarray,
    pred_cls: np.ndarray,
    target_cls: np.ndarray,
    plot_dir=None,
    names=(),
):
    """Per-class AP. Returns (p, r, ap, f1, unique_classes, cls_thr) with
    p/r/f1 at the global best-F1 confidence and ap (nc, n_iou).

    plot_dir: write the PR/F1/P/R curve family there (reference
    ap_per_class(plot=True, save_dir), utils/metrics.py:25-80), named by
    `names`; ImportError without matplotlib."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes = np.unique(target_cls)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    py = []  # per-class precision over the recall grid (PR curve)
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l = (target_cls == c).sum()
        n_p = sel.sum()
        if n_p == 0 or n_l == 0:
            py.append(np.zeros_like(px))
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        r[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if j == 0:
                py.append(np.interp(px, mrec, mpre))

    f1 = 2 * p * r / (p + r + 1e-16)
    i = f1.mean(0).argmax()
    cls_thr = [float(px[f1[ci].argmax()]) for ci in range(nc)]
    if plot_dir is not None:
        from pathlib import Path

        from ..utils.plots import plot_mc_curve, plot_pr_curve

        d = Path(plot_dir)
        cls_names = [
            (names[int(c)] if int(c) < len(names) else str(int(c)))
            for c in unique_classes
        ]
        plot_pr_curve(px, py, ap, d / "PR_curve.png", cls_names)
        plot_mc_curve(px, f1, d / "F1_curve.png", cls_names, ylabel="F1")
        plot_mc_curve(px, p, d / "P_curve.png", cls_names,
                      ylabel="Precision")
        plot_mc_curve(px, r, d / "R_curve.png", cls_names, ylabel="Recall")
    return (
        p[:, i], r[:, i], ap, f1[:, i],
        unique_classes.astype(np.int32), cls_thr,
    )


class ConfusionMatrix:
    """Detection confusion matrix (reference utils/metrics.py:129-205)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray):
        if detections is None or len(detections) == 0:
            for gc in labels[:, 0].astype(int):
                self.matrix[self.nc, gc] += 1  # background FN
            return
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        det_classes = detections[:, 5].astype(int)
        iou = box_iou_np(labels[:, 1:5], detections[:, :4])
        li, di = np.where(iou > self.iou_thres)
        if len(li):
            matches = np.stack([li, di, iou[li, di]], 1)
            if len(li) > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))
        n = len(matches) > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and sum(j) == 1:
                self.matrix[det_classes[m1[j]][0], gc] += 1  # correct
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        if n:
            for i, dc in enumerate(det_classes):
                if not any(m1 == i):
                    self.matrix[dc, self.nc] += 1  # background FP


class AverageMeter:
    """Rolling scalar average (reference utils/metrics.py:352-368)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class MetricMeter:
    """Dict of AverageMeters (reference utils/metrics.py:370-416)."""

    def __init__(self, delimiter: str = " "):
        self.meters: Dict[str, AverageMeter] = {}
        self.delimiter = delimiter

    def update(self, input_dict: Dict[str, float]):
        for k, v in input_dict.items():
            self.meters.setdefault(k, AverageMeter()).update(float(v))

    def __str__(self):
        return self.delimiter.join(
            f"{k} {m.avg:.4f}" for k, m in self.meters.items()
        )

"""Keypoint evaluation: OKS (object keypoint similarity) AP (counterpart
of `efficientteacher_tpu/eval/keypoint_metrics.py`, a numpy copy).

The reference's val_kp branch (val.py:80-96 process_batch_oks): the OKS of
every detection against every ground-truth keypoint set, then the boxes'
101-point AP over OKS thresholds [.5:.95]. OKS is the reference's
`oks_iou` (utils/metrics.py:453-482): sigmas 0.1 per keypoint, vars =
(2 sigmas)^2, the scale the area of the ground truth's keypoint hull box
(poly2hbb, metrics.py:424-451), e = d^2 / vars / (area + eps) / 2, and the
unmasked mean over the keypoints: an invisible (-1, -1) ground-truth point
adds its raw distance, as upstream computes it.
"""

from __future__ import annotations

import numpy as np

from .metrics import ap_per_class


def oks(pred_kps: np.ndarray, gt_kps: np.ndarray,
        sigmas: np.ndarray | None = None) -> np.ndarray:
    """(G, P) OKS of (P, np, 2) predicted against (G, np, 2) ground-truth
    keypoints, in pixels."""
    npk = gt_kps.shape[1]
    if sigmas is None:
        sigmas = np.full(npk, 0.1)
    vars_ = (2.0 * sigmas) ** 2
    x, y = gt_kps[..., 0], gt_kps[..., 1]
    area = (x.max(-1) - x.min(-1)) * (y.max(-1) - y.min(-1))      # (G,)
    d2 = ((gt_kps[:, None] - pred_kps[None]) ** 2).sum(-1)        # (G, P, np)
    e = d2 / vars_[None, None, :] / (area[:, None, None] + np.spacing(1)) / 2
    return np.exp(-e).mean(-1)


def process_batch_kp(pred_kps: np.ndarray, pred_conf: np.ndarray,
                     pred_cls: np.ndarray, gt_kps: np.ndarray,
                     gt_cls: np.ndarray, thresholds: np.ndarray
                     ) -> np.ndarray:
    """(P, T) true positives by greedy OKS matching, each ground truth and
    each detection matched once, best OKS first."""
    correct = np.zeros((len(pred_kps), len(thresholds)), bool)
    if len(gt_kps) == 0 or len(pred_kps) == 0:
        return correct
    sim = oks(pred_kps, gt_kps)
    cls_ok = gt_cls[:, None] == pred_cls[None, :]
    for t in range(len(thresholds)):
        gi, pi = np.where((sim >= thresholds[t]) & cls_ok)
        if len(gi):
            matches = np.stack([gi, pi, sim[gi, pi]], 1)
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), t] = True
    return correct


def kp_ap(stats) -> float:
    """mAP over the OKS thresholds from accumulated (correct, conf, cls,
    target_cls) tuples."""
    stats = [np.concatenate(x, 0) for x in zip(*stats)]
    if not len(stats) or not stats[0].any():
        return 0.0
    _, _, ap, _, _, _ = ap_per_class(*stats)
    return float(ap.mean())

"""AutoAnchor: best-possible-recall check + k-means anchor evolution (a
numpy copy of `efficientteacher_tpu/data/autoanchor.py`, which the port
does not import).

The random draws are the JAX module's, in its order: `dataset_wh` jitters
the label sizes from numpy's global generator, `kmean_anchors` draws from
`np.random.default_rng(seed)`, so the same global state and seed evolve
the same anchors.

Parity with reference utils/autoanchor.py:16-163:
  - check_anchor_order: anchor areas must increase with stride (:16-24)
  - check_anchors: BPR = fraction of labels whose best anchor ratio passes
    1/anchor_t; re-evolve anchors when BPR < 0.98 (:26-49)
  - kmean_anchors: k-means on wh (scipy-free Lloyd iterations) followed by a
    mutation-based genetic refinement of the fitness metric (:51-163)
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np

LOGGER = logging.getLogger(__name__)


def _wh_metric(wh: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Best symmetric wh-ratio per label (N,) in (0, 1]."""
    r = wh[:, None, :] / anchors[None, :, :]
    x = np.minimum(r, 1.0 / r).min(2)  # (N, K)
    return x.max(1)


def check_anchor_order(anchors: np.ndarray, strides) -> np.ndarray:
    """Reorder (nl, na, 2) anchors so mean area increases with stride."""
    areas = anchors.prod(-1).mean(-1)
    da = areas[-1] - areas[0]
    ds = strides[-1] - strides[0]
    if np.sign(da) != np.sign(ds):
        LOGGER.info("reversing anchor order")
        anchors = anchors[::-1].copy()
    return anchors


def dataset_wh(dataset, img_size: int) -> np.ndarray:
    """Label wh in pixels at train scale, jittered like the reference
    (autoanchor.py:33-36 uniform 0.9-1.1 scale)."""
    whs = []
    shapes = dataset.shapes  # (N, 2) w, h
    scale = img_size / shapes.max(1, keepdims=True)
    for lb, s in zip(dataset.labels, shapes * scale):
        if len(lb):
            whs.append(lb[:, 3:5] * s[None])
    if not whs:
        return np.zeros((0, 2))
    wh = np.concatenate(whs, 0)
    wh = wh * np.random.uniform(0.9, 1.1, (len(wh), 1))
    return wh[(wh >= 2.0).any(1)]


def kmean_anchors(
    wh: np.ndarray, n: int = 9, anchor_t: float = 4.0, gen: int = 1000,
    seed: int = 0,
) -> np.ndarray:
    """k-means + genetic refinement over label wh. Returns (n, 2) sorted by
    area."""
    rng = np.random.default_rng(seed)
    thr = 1.0 / anchor_t

    def fitness(k):
        r = wh[:, None, :] / k[None, :, :]
        x = np.minimum(r, 1.0 / r).min(2).max(1)
        return (x * (x > thr)).mean()

    # Lloyd k-means on std-normalized wh (sample with replacement when the
    # dataset has fewer labels than anchors; jitter breaks duplicates)
    s = np.maximum(wh.std(0), 1e-3)
    k = wh[rng.choice(len(wh), n, replace=len(wh) < n)] / s
    if len(wh) < n:
        k = k * rng.uniform(0.9, 1.1, k.shape)
    pts = wh / s
    for _ in range(30):
        d = ((pts[:, None, :] - k[None, :, :]) ** 2).sum(-1)
        assign = d.argmin(1)
        for ci in range(n):
            sel = pts[assign == ci]
            if len(sel):
                k[ci] = sel.mean(0)
    k = k * s

    # genetic evolution (reference autoanchor.py:141-159)
    best_f, best_k = fitness(k), k.copy()
    shape = k.shape
    mp, sigma = 0.9, 0.1
    for _ in range(gen):
        v = np.ones(shape)
        while (v == 1).all():
            v = ((rng.random(shape) < mp) * rng.normal(0, sigma, shape)
                 * rng.random() + 1).clip(0.3, 3.0)
        kg = (best_k * v).clip(2.0, None)
        fg = fitness(kg)
        if fg > best_f:
            best_f, best_k = fg, kg.copy()
    return best_k[np.argsort(best_k.prod(1))]


def check_anchors(dataset, anchors_px: np.ndarray, strides, img_size: int,
                  anchor_t: float = 4.0) -> Tuple[np.ndarray, float]:
    """BPR check; returns (possibly evolved (nl, na, 2) anchors, bpr)."""
    nl, na = anchors_px.shape[0], anchors_px.shape[1]
    wh = dataset_wh(dataset, img_size)
    if len(wh) == 0:
        return anchors_px, 1.0
    flat = anchors_px.reshape(-1, 2)
    metric = _wh_metric(wh, flat)
    bpr = float((metric > 1.0 / anchor_t).mean())
    LOGGER.info("autoanchor BPR = %.4f", bpr)
    if bpr > 0.98:
        return anchors_px, bpr
    LOGGER.info("BPR < 0.98: evolving anchors with k-means + GA")
    new = kmean_anchors(wh, n=nl * na, anchor_t=anchor_t)
    new_bpr = float((_wh_metric(wh, new) > 1.0 / anchor_t).mean())
    if new_bpr > bpr:
        out = check_anchor_order(new.reshape(nl, na, 2), strides)
        return out, new_bpr
    return anchors_px, bpr

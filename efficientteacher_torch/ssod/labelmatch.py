"""LabelMatch: per-class pseudo-label thresholds refreshed every epoch
(counterpart of `efficientteacher_tpu/ssod/labelmatch.py`; reference
utils/labelmatch.py:56-354).

  - every SSOD step's NMS detections (conf, class), before the warp, are
    collected per class (score_list_epoch, :283-299);
  - thr_high per class from a two-component Gaussian mixture of the
    epoch's scores, the 'high' policy (gmm_policy, :138-189): the least
    score of the positive component at or above its most likely member;
  - thr_low per class = max(ignore_thres_low, the score at a resample
    position capped by the running per-epoch class budget
    cls_num_total / (epoch + 1)) (:191-240).

JAX fits sklearn's `GaussianMixture(2, weights_init, means_init,
precisions_init)`; the card's machine has no sklearn, so `GaussianMixture1D`
is that fit written out for one feature and two components with sklearn's
defaults (tol 1e-3, max_iter 100, reg_covar 1e-6, full covariances): with
every initial value given, sklearn skips its k-means start and the fit is
deterministic, EM steps until the mean log-likelihood changes by less
than tol, and `predict` / `score_samples` read the final parameters.

The scores are kept per class as arrays (the JAX class appends Python
floats one by one); `state_dict` / `load_state_dict` carry the thresholds,
the class totals and the scores not yet consumed, for an exact resume.
Under DDP each rank collects its own steps' scores and `gather` unites
them before a refresh (JAX needs none: its step output is global).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..parallel.distributed import gather_objects


class GaussianMixture1D:
    """sklearn's GaussianMixture fit, for (n, 1) float64 data and two
    components with all initial values given."""

    def __init__(self, weights_init, means_init, precisions_init,
                 tol: float = 1e-3, max_iter: int = 100,
                 reg_covar: float = 1e-6):
        self.weights = np.asarray(weights_init, np.float64).reshape(-1)
        self.means = np.asarray(means_init, np.float64).reshape(-1)
        # the Cholesky factor of a 1x1 precision is its square root
        self.prec_chol = np.sqrt(np.asarray(precisions_init,
                                            np.float64).reshape(-1))
        self.tol, self.max_iter, self.reg_covar = tol, max_iter, reg_covar
        self.converged = False
        self.n_iter = 0

    def _weighted_log_prob(self, x: np.ndarray) -> np.ndarray:
        """(n, 2) log N(x | mu_k, sigma_k) + log w_k (sklearn's
        _estimate_log_gaussian_prob with n_features 1)."""
        y = x[:, None] * self.prec_chol - self.means * self.prec_chol
        log_prob = -0.5 * (math.log(2 * math.pi) + y * y) \
            + np.log(self.prec_chol)
        return log_prob + np.log(self.weights)

    @staticmethod
    def _logsumexp(a: np.ndarray) -> np.ndarray:
        m = a.max(1, keepdims=True)
        m = np.where(np.isfinite(m), m, 0.0)
        return np.log(np.exp(a - m).sum(1)) + m[:, 0]

    def _e_step(self, x):
        wlp = self._weighted_log_prob(x)
        norm = self._logsumexp(wlp)
        return norm.mean(), wlp - norm[:, None]

    def _m_step(self, x, log_resp):
        resp = np.exp(log_resp)
        nk = resp.sum(0) + 10 * np.finfo(resp.dtype).eps
        self.means = (resp.T @ x) / nk
        cov = np.array([(resp[:, k] * (x - self.means[k])) @
                        (x - self.means[k]) / nk[k]
                        for k in range(2)]) + self.reg_covar
        self.weights = nk / nk.sum()
        self.prec_chol = 1.0 / np.sqrt(cov)

    def fit(self, x) -> "GaussianMixture1D":
        x = np.asarray(x, np.float64).reshape(-1)
        lower = -np.inf
        for n_iter in range(1, self.max_iter + 1):
            prev = lower
            lower, log_resp = self._e_step(x)
            self._m_step(x, log_resp)
            self.n_iter = n_iter
            if abs(lower - prev) < self.tol:
                self.converged = True
                break
        return self

    def predict(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64).reshape(-1)
        return self._weighted_log_prob(x).argmax(1)

    def score_samples(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64).reshape(-1)
        return self._logsumexp(self._weighted_log_prob(x))


def gmm_policy(scores: np.ndarray, given_gt_thr: float = 0.0,
               policy: str = "high") -> float:
    """Two-component GMM threshold selection (JAX labelmatch.py:25)."""
    if len(scores) < 4:
        return given_gt_thr
    s = np.asarray(scores, np.float64).reshape(-1)
    gmm = GaussianMixture1D([0.5, 0.5], [s.min(), s.max()], [1.0, 1.0])
    gmm.fit(s)
    assign = gmm.predict(s)
    if not (assign == 1).any():
        return given_gt_thr
    if policy == "high":
        loglik = gmm.score_samples(s)
        loglik[assign == 0] = -np.inf
        anchor = np.argmax(loglik)
        pos = (assign == 1) & (s >= s[anchor])
        return max(given_gt_thr, float(s[pos].min()))
    return max(given_gt_thr, float(s[assign == 1].min()))


class LabelMatch:
    """The per-class thresholds and the epoch's collected scores. `cfg`
    is any attribute tree with the config's SSOD layout."""

    def __init__(self, cfg, target_data_len: int, label_num_per_img: float,
                 cls_ratio_gt: np.ndarray):
        self.nc = len(cls_ratio_gt)
        self.cls_ratio_gt = np.asarray(cls_ratio_gt)
        self.ignore_thres_high = float(cfg.SSOD.ignore_thres_high)
        self.ignore_thres_low = float(cfg.SSOD.ignore_thres_low)
        self.resample_high_percent = float(cfg.SSOD.resample_high_percent)
        self.resample_low_percent = float(cfg.SSOD.resample_low_percent)
        self.target_data_len = target_data_len
        self.anno_num_per_img = label_num_per_img * 3
        self.cls_thr_high = np.full(self.nc, self.ignore_thres_high,
                                    np.float32)
        self.cls_thr_low = np.full(self.nc, self.ignore_thres_low, np.float32)
        self.cls_num_total = np.zeros(self.nc)
        self.score_list_epoch: List[List[np.ndarray]] = [
            [] for _ in range(self.nc)]

    def collect(self, scores: np.ndarray, cls: np.ndarray) -> None:
        """Add one batch of (conf, class) pairs; scores <= 0 are padding."""
        scores = np.asarray(scores, np.float32).reshape(-1)
        cls = np.asarray(cls).reshape(-1).astype(np.int64)
        keep = scores > 0
        scores, cls = scores[keep], cls[keep]
        for c in np.unique(cls):
            self.score_list_epoch[int(c)].append(scores[cls == c])

    def _scores(self, c: int) -> np.ndarray:
        parts = self.score_list_epoch[c]
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)

    def gather(self) -> None:
        """Under DDP every rank's collected scores, per class in rank order,
        on every rank (the reference's all_gather of the score lists,
        utils/labelmatch.py:100-117), so that each derives the same
        thresholds; a no-op in one process. A collective."""
        ranks = gather_objects([self._scores(c) for c in range(self.nc)])
        if len(ranks) > 1:
            self.score_list_epoch = [
                [r[c] for r in ranks if len(r[c])] for c in range(self.nc)]

    def drop_scores(self) -> None:
        """Forget the collected scores (a DDP rank past 0 after `gather`:
        rank 0 holds them all)."""
        self.score_list_epoch = [[] for _ in range(self.nc)]

    def update_epoch_cls_thr(self, epoch: int) -> None:
        """Refresh both thresholds of every class from the collected
        scores, then forget them (JAX labelmatch.py:83)."""
        for c in range(self.nc):
            scores = np.sort(self._scores(c).astype(np.float64))[::-1]
            self.cls_num_total[c] += len(scores)
            max_num = int(self.cls_num_total[c] / (epoch + 1))
            if not len(scores):
                self.cls_thr_high[c] = self.ignore_thres_high
                self.cls_thr_low[c] = self.ignore_thres_low
                continue
            self.cls_thr_high[c] = gmm_policy(scores, given_gt_thr=0.0,
                                              policy="high")
            pos_low = min(max_num,
                          int(len(scores) * self.resample_low_percent))
            pos_low = min(pos_low, len(scores) - 1)
            self.cls_thr_low[c] = max(self.ignore_thres_low,
                                      scores[pos_low])
        self.score_list_epoch = [[] for _ in range(self.nc)]

    def state_dict(self) -> dict:
        """Tensors only (a weights-only checkpoint loads them)."""
        return {
            "cls_thr_high": torch.from_numpy(self.cls_thr_high.copy()),
            "cls_thr_low": torch.from_numpy(self.cls_thr_low.copy()),
            "cls_num_total": torch.from_numpy(self.cls_num_total.copy()),
            "scores": [torch.from_numpy(self._scores(c))
                       for c in range(self.nc)]}

    def load_state_dict(self, sd: dict) -> None:
        self.cls_thr_high = sd["cls_thr_high"].numpy().astype(np.float32)
        self.cls_thr_low = sd["cls_thr_low"].numpy().astype(np.float32)
        self.cls_num_total = sd["cls_num_total"].numpy().astype(np.float64)
        self.score_list_epoch = [[s.numpy()] if s.numel() else []
                                 for s in sd["scores"]]

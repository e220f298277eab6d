"""The port's numpy metrics (`efficientteacher_torch/eval/metrics.py`) and
pseudo-label quality meters (`ssod/quality.py`) against the JAX
package's, on seeded inputs. Tolerance: none, the results are bit-equal
(the same numpy arithmetic in the same order)."""

import numpy as np
import pytest

from efficientteacher_tpu.eval import metrics as jax_metrics
from efficientteacher_tpu.ssod import quality as jax_quality
from efficientteacher_torch.eval import metrics
from efficientteacher_torch.ssod import quality


def _boxes(rng, n, img=320.0):
    xy = rng.uniform(0, img * 0.8, (n, 2))
    wh = rng.uniform(4, img * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _image(rng, n_det, n_lab, nc):
    """Detections (n_det, 6) sorted by conf, half of them near a label;
    labels (n_lab, 5) [cls, xyxy]."""
    lab = np.zeros((n_lab, 5), np.float32)
    lab[:, 0] = rng.integers(0, nc, n_lab)
    lab[:, 1:] = _boxes(rng, n_lab)
    det = np.zeros((n_det, 6), np.float32)
    det[:, :4] = _boxes(rng, n_det)
    near = min(n_lab, n_det // 2)
    det[:near, :4] = lab[:near, 1:] + rng.normal(0, 6, (near, 4))
    det[:near, 5] = np.where(rng.uniform(size=near) < 0.8, lab[:near, 0],
                             rng.integers(0, nc, near))
    det[near:, 5] = rng.integers(0, nc, n_det - near)
    det[:, 4] = rng.uniform(0.001, 1, n_det)
    return det[np.argsort(-det[:, 4])], lab


@pytest.mark.parametrize("seed", range(4))
def test_process_batch_and_ap_per_class_bit_equal(seed):
    rng = np.random.default_rng(seed)
    nc = 5
    iouv = np.linspace(0.5, 0.95, 10)
    stats_j, stats_p = [], []
    for n_det, n_lab in ((40, 12), (0, 3), (7, 0), (25, 25), (60, 4)):
        det, lab = _image(rng, n_det, n_lab, nc)
        cj = jax_metrics.process_batch(det, lab, iouv)
        cp = metrics.process_batch(det, lab, iouv)
        np.testing.assert_array_equal(cp, cj)
        for stats, c in ((stats_j, cj), (stats_p, cp)):
            stats.append((c, det[:, 4], det[:, 5], lab[:, 0]))
    assert sum(s[0].sum() for s in stats_p) > 10
    cat = [np.concatenate(x, 0) for x in zip(*stats_p)]
    want = jax_metrics.ap_per_class(*cat)
    got = metrics.ap_per_class(*cat)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_compute_ap_and_fitness_bit_equal():
    rng = np.random.default_rng(7)
    for n in (1, 5, 200):
        recall = np.sort(rng.uniform(0, 1, n))
        precision = rng.uniform(0, 1, n)
        for a, b in zip(metrics.compute_ap(recall, precision),
                        jax_metrics.compute_ap(recall, precision)):
            np.testing.assert_array_equal(a, b)
    results = rng.uniform(0, 1, (6, 7))
    np.testing.assert_array_equal(metrics.fitness(results),
                                  jax_metrics.fitness(results))
    a, b = _boxes(rng, 9), _boxes(rng, 11)
    np.testing.assert_array_equal(metrics.box_iou_np(a, b),
                                  jax_metrics.box_iou_np(a, b))


def test_confusion_matrix_bit_equal():
    rng = np.random.default_rng(3)
    nc = 4
    cm_j, cm_p = jax_metrics.ConfusionMatrix(nc), metrics.ConfusionMatrix(nc)
    for n_det, n_lab in ((30, 10), (0, 5), (12, 12), (8, 1)):
        det, lab = _image(rng, n_det, n_lab, nc)
        cm_j.process_batch(det, lab)
        cm_p.process_batch(det, lab)
    np.testing.assert_array_equal(cm_p.matrix, cm_j.matrix)
    assert cm_p.matrix.sum() > 0


def test_meters_and_pseudo_label_quality_equal():
    rng = np.random.default_rng(5)
    mj, mp = jax_metrics.MetricMeter(), metrics.MetricMeter()
    for _ in range(5):
        d = {"box": float(rng.uniform()), "obj": float(rng.uniform())}
        mj.update(d)
        mp.update(d)
    assert str(mp) == str(mj)
    pl = rng.uniform(0, 1, (3, 10, 8)).astype(np.float32)
    pl[..., 0] = rng.integers(0, 3, (3, 10))
    pl[..., 3:5] *= 0.3
    pmask = rng.uniform(size=(3, 10)) < 0.6
    gt = pl[:, :6, :5].copy()
    gt[..., 1:3] += rng.normal(0, 0.02, (3, 6, 2))
    gmask = rng.uniform(size=(3, 6)) < 0.7
    assert quality.check_pseudo_label(pl, pmask) == \
        jax_quality.check_pseudo_label(pl, pmask)
    assert quality.check_pseudo_label_with_gt(pl, pmask, gt, gmask) == \
        jax_quality.check_pseudo_label_with_gt(pl, pmask, gt, gmask)


def test_ap_per_class_plots_are_not_ported(tmp_path):
    """The curve plots are ported: `plot_dir` writes the PR / F1 / P / R
    family, as JAX's does (tests/test_observability.py), and the results
    stay bit-equal to JAX's with and without it."""
    rng = np.random.default_rng(0)
    tp = rng.random((200, 10)) > 0.4
    conf = rng.random(200)
    pred_cls = rng.integers(0, 3, 200)
    target_cls = rng.integers(0, 3, 50)
    names = ["a", "b", "c"]
    got = metrics.ap_per_class(tp, conf, pred_cls, target_cls,
                               plot_dir=tmp_path / "port", names=names)
    want = jax_metrics.ap_per_class(tp, conf, pred_cls, target_cls,
                                    plot_dir=tmp_path / "jax", names=names)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for g, w in zip(metrics.ap_per_class(tp, conf, pred_cls, target_cls),
                    got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    curves = ("PR_curve.png", "F1_curve.png", "P_curve.png", "R_curve.png")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir()) == sorted(curves)

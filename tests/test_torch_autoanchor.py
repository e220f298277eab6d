"""Autoanchor in the PyTorch port (`efficientteacher_torch/data/autoanchor.py`,
`Trainer.autoanchor`), mirroring tests/test_autoanchor.py and held to the
JAX package's module on the same draws: the anchor order, k-means + GA
(equal to JAX's under one seed), the BPR check and its evolved anchors
(equal under one numpy global state: `dataset_wh` jitters from it), and
the trainer's wiring: a mis-anchored config's evolved anchors enter the
spec, the decode anchors of the student and its EMA, and `anchors_grid`,
skipped on resume and with noautoanchor, and the trainer still trains.
numpy only, so every comparison is exact."""

import types

import numpy as np
import pytest
import torch

from efficientteacher_tpu.data import autoanchor as jax_aa
from efficientteacher_torch.data import autoanchor as aa

from test_torch_trainer_resume import PortSup, _sup_cfg
from torch_port_helpers import one_torch_thread  # noqa: F401

BAD = [[200, 200, 250, 250, 300, 300], [320, 320, 340, 340, 360, 360],
       [380, 380, 400, 400, 420, 420]]


def test_anchor_order_is_jaxs():
    a = np.array([[[100, 100]] * 3, [[50, 50]] * 3, [[10, 10]] * 3],
                 np.float32)
    out = aa.check_anchor_order(a, [8, 16, 32])
    assert out[0].prod(-1).mean() < out[-1].prod(-1).mean()
    np.testing.assert_array_equal(out, jax_aa.check_anchor_order(a, [8, 16,
                                                                     32]))
    np.testing.assert_array_equal(aa.check_anchor_order(out, [8, 16, 32]),
                                  out)


@pytest.mark.parametrize("n_labels", [900, 5])
def test_kmeans_is_jaxs_and_recovers_clusters(n_labels):
    rng = np.random.default_rng(0)
    centers = np.array([[10, 12], [40, 30], [120, 100]])
    wh = np.concatenate([c * rng.uniform(0.9, 1.1, (300, 2))
                         for c in centers])[:n_labels]
    k = aa.kmean_anchors(wh, n=3 if n_labels > 5 else 9, gen=200, seed=3)
    want = jax_aa.kmean_anchors(wh, n=3 if n_labels > 5 else 9, gen=200,
                                seed=3)
    np.testing.assert_array_equal(k, want)
    if n_labels > 5:
        assert (aa._wh_metric(centers.astype(float), k) > 0.7).all()


def _dataset(seed, n=24, empty_every=5):
    """The attributes autoanchor reads: per-image labels (n, 5) [cls, xywh
    normalised] and native (w, h) shapes; small boxes, some images
    without labels."""
    rng = np.random.default_rng(seed)
    labels, shapes = [], []
    for i in range(n):
        k = 0 if i % empty_every == 0 else int(rng.integers(1, 6))
        lb = np.zeros((k, 5), np.float32)
        lb[:, 1:3] = rng.uniform(0.2, 0.8, (k, 2))
        lb[:, 3:5] = rng.uniform(0.03, 0.15, (k, 2))
        labels.append(lb)
        shapes.append(rng.choice([(640, 480), (480, 640), (500, 375)]))
    return types.SimpleNamespace(labels=labels, shapes=np.array(shapes,
                                                                np.float64),
                                 mosaic=True)


@pytest.mark.parametrize("anchors,adopted", [(BAD, True), (None, False)])
def test_check_anchors_is_jaxs(anchors, adopted):
    ds = _dataset(1)
    if anchors is None:  # anchors that fit these boxes: BPR > 0.98
        wh = aa.dataset_wh(ds, 128)
        anchors = np.tile(np.median(wh, 0), (3, 3, 1)).reshape(3, 6)
    px = np.asarray(anchors, np.float32).reshape(3, 3, 2)
    out = {}
    for name, mod in (("port", aa), ("jax", jax_aa)):
        np.random.seed(7)
        out[name] = mod.check_anchors(ds, px, (8, 16, 32), 128)
    (got, bpr), (want, jbpr) = out["port"], out["jax"]
    np.testing.assert_array_equal(got, want)
    assert bpr == jbpr
    assert (not np.allclose(got, px)) == adopted
    if adopted:
        assert bpr > 0.9


class AnchorSup(PortSup):
    """PortSup's in-memory batches, with `_dataset`'s labels for the
    anchor check."""

    def build_dataloader(self, cfg):
        super().build_dataloader(cfg)
        self.dataset = self.train_loader.ds = _dataset(2, n=32)


def test_trainer_adopts_evolved_anchors(tmp_path):
    cfg = _sup_cfg(tmp_path, "aa", noautoanchor=False, epochs=1)
    cfg.Model.anchors = BAD
    np.random.seed(11)
    t = AnchorSup(cfg, compute_dtype=torch.float32, device="cpu")
    np.random.seed(11)
    want, bpr = jax_aa.check_anchors(
        t.dataset, np.asarray(BAD, np.float32).reshape(3, 3, 2),
        t.spec.strides, t.img_size, anchor_t=float(cfg.Loss.anchor_t))
    assert t.anchor_check == {"bpr": bpr, "adopted": True}
    evolved = np.asarray(t.spec.anchors, np.float32).reshape(3, 3, 2)
    np.testing.assert_array_equal(evolved, want.astype(np.float32))
    s = np.asarray(t.spec.strides, np.float32)[:, None, None]
    np.testing.assert_array_equal(t.anchors_grid.numpy(), evolved / s)
    for module in (t.state.model, t.state.ema.module):
        np.testing.assert_array_equal(module.head.anchors_px.numpy(),
                                      evolved)
    # the loss was built on the evolved lattice
    cells = [c.cell_contents for c in t.detection_loss.__closure__]
    assert any(c is t.anchors_grid for c in cells)
    t.train()
    assert t.state.opt_step == 1


def test_trainer_skips_the_check_with_noautoanchor_and_on_resume(tmp_path):
    for kw in ({"noautoanchor": True}, {"noautoanchor": False,
                                        "resume": True}):
        cfg = _sup_cfg(tmp_path, "skip", **kw)
        cfg.Model.anchors = BAD
        t = AnchorSup(cfg, compute_dtype=torch.float32, device="cpu")
        assert not hasattr(t, "anchor_check")
        np.testing.assert_array_equal(
            t.state.model.head.anchors_px.numpy(),
            np.asarray(BAD, np.float32).reshape(3, 3, 2))

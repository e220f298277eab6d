"""The anchor OTA losses of the PyTorch port
(`efficientteacher_torch/losses/yolov5_ota_loss.py` and
`losses/ssod_loss.py compute_ssod_ota_loss`) against the JAX package's on
the same numpy-seeded raw maps and labels (64 px, grids 8/4/2, 3 anchors).

Held exactly: the SimOTA matching (fg and the matched GT per candidate
slot; the slots are the (M, 5, na) lattice in both packages), tie-prone
inputs included (all-zero maps: every cost ties, dynamic k picks in
`jax.lax.top_k`'s order). Held to a tolerance: the loss parts rtol 1e-5
(float32; the class cost's sum over classes is ordered differently,
measured <= 3e-7), and the gradients in float64 within 1e-6 of their
largest entry. JAX's losses cast the maps to float32, so its float64 run
swaps the loss modules' `jnp.float32` for float64 (`_jax_float64`, the
JAX package untouched on disk)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.assigners import yolo_anchor as jax_yolo_anchor
from efficientteacher_tpu.losses import common as jax_common
from efficientteacher_tpu.losses import ssod_loss as jax_ssod_loss
from efficientteacher_tpu.losses import yolov5_loss as jax_yolov5_loss
from efficientteacher_tpu.losses import yolov5_ota_loss as jax_ota
from efficientteacher_tpu.ops import boxes as jax_boxes
from efficientteacher_torch.assigners.yolo_anchor import assign_all_scales
from efficientteacher_torch.losses import yolov5_ota_loss as ota
from efficientteacher_torch.losses.ssod_loss import (SSODLossConfig,
                                                     compute_ssod_ota_loss)
from efficientteacher_torch.losses.yolov5_loss import YoloV5LossConfig

from torch_port_helpers import ANCHORS_GRID, make_labels
from torch_port_helpers import one_torch_thread  # noqa: F401

IMG, NA = 64, 3
STRIDES = (8.0, 16.0, 32.0)
GRIDS = (8, 4, 2)


def _maps(rng, b, nc, kind="normal", dtype=np.float32):
    """Port-layout raw maps (B, na, ny, nx, 5 + nc)."""
    out = []
    for g in GRIDS:
        shape = (b, NA, g, g, 5 + nc)
        m = (np.zeros(shape) if kind == "zeros"
             else rng.normal(0.0, 1.0, shape))
        out.append(m.astype(dtype))
    return out


def _jax(maps):
    return [jnp.asarray(m.transpose(0, 2, 3, 1, 4)) for m in maps]


def _port(maps, grad=False):
    return [torch.tensor(m, requires_grad=grad) for m in maps]


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=atol, err_msg=what)


class _Jnp64:
    """jax.numpy with float32 read as float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@contextlib.contextmanager
def _jax_float64():
    """JAX's loss modules in float64 for the block: x64 on, and each
    module's `jnp.float32` casts made float64 (restored after)."""
    mods = (jax_ota, jax_yolov5_loss, jax_ssod_loss, jax_yolo_anchor,
            jax_common, jax_boxes)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for mod in mods:
            mp.setattr(mod, "jnp", _Jnp64())
        yield


def _labels(rng, b, m, nc, n_per_img):
    labels, mask = make_labels(rng, b, m, n_per_img, nc=nc)
    return labels, mask


# -- the matching -------------------------------------------------------------

@pytest.mark.parametrize("kind", ["normal", "zeros"])
@pytest.mark.parametrize("nc,top_k,last_channel", [
    (4, 10, True), (4, 1, False), (1, 13, True), (4, 13, False)])
def test_simota_match_is_jax(kind, nc, top_k, last_channel):
    rng = np.random.default_rng(nc * 10 + top_k)
    maps = _maps(rng, 3, nc, kind)
    labels, mask = _labels(rng, 3, 8, nc, [5, 0, 8])
    jasn = jax.jit(lambda lb, m: jax_yolo_anchor.assign_all_scales(
        lb, m, [(g, g) for g in GRIDS], ANCHORS_GRID, 4.0, False))(
            jnp.asarray(labels), jnp.asarray(mask))
    jcand = jax.jit(lambda ps, a: jax_ota.ota_candidates(ps, a, STRIDES))(
        _jax(maps), jasn)
    jvalid = jnp.concatenate([a.valid for a in jasn], 1)
    pl, pm = torch.from_numpy(labels), torch.from_numpy(mask)
    pasn = assign_all_scales(pl, pm, [(g, g) for g in GRIDS], ANCHORS_GRID,
                             4.0, False)
    pcand = ota.ota_candidates(_port(maps), pasn, STRIDES)
    pvalid = torch.cat([a.valid for a in pasn], 1)
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    _close(pcand.pbox_px.numpy(), np.asarray(jcand.pbox_px), 1e-6, "boxes")
    box = labels[..., 1:5] * IMG
    jfg, jmt = jax.jit(lambda bx, c, m, cand, v: jax_ota.simota_match(
        bx, c, m, cand, v, nc, top_k,
        cost_obj=cand.ps[..., -1] if last_channel else None))(
            jnp.asarray(box), jnp.asarray(labels[..., 0].astype(np.int32)),
            jnp.asarray(mask), jcand, jvalid)
    pfg, pmt = ota.simota_match(
        torch.from_numpy(box), pl[..., 0].long(), pm, pcand, pvalid, nc,
        top_k, cost_obj=pcand.ps[..., -1] if last_channel else None)
    np.testing.assert_array_equal(pfg.numpy(), np.asarray(jfg))
    np.testing.assert_array_equal(pmt.numpy()[pfg.numpy()],
                                  np.asarray(jmt)[np.asarray(jfg)])
    assert pfg.any()


# -- the supervised OTA loss ---------------------------------------------------

@pytest.mark.parametrize("nc,top_k,n_per_img", [
    (4, 10, [3, 6]), (4, 13, [8, 1]), (1, 10, [4, 4]), (4, 10, [0, 0])])
def test_ota_loss_matches_jax(nc, top_k, n_per_img):
    rng = np.random.default_rng(7 + top_k)
    maps = _maps(rng, 2, nc)
    labels, mask = _labels(rng, 2, 8, nc, n_per_img)
    jlc = jax_yolov5_loss.YoloV5LossConfig(nc=nc)
    lc = YoloV5LossConfig(nc=nc)
    _, jparts = jax.jit(lambda ps, lb, m: jax_ota.compute_ota_loss(
        ps, lb, m, ANCHORS_GRID, STRIDES, IMG, jlc, top_k=top_k))(
            _jax(maps), jnp.asarray(labels), jnp.asarray(mask))
    loss, parts = ota.compute_ota_loss(
        _port(maps), torch.from_numpy(labels), torch.from_numpy(mask),
        ANCHORS_GRID, STRIDES, IMG, lc, top_k=top_k)
    assert set(parts) == set(jparts) == {"box", "obj", "cls", "loss"}
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)
    if not sum(n_per_img):  # zero targets: only the objectness terms
        assert float(parts["box"]) == float(parts["cls"]) == 0.0
        assert float(parts["obj"]) > 0.0


@pytest.mark.parametrize("nc,top_k", [(4, 10), (1, 13)])
def test_ota_loss_gradients_match_jax_in_float64(nc, top_k):
    rng = np.random.default_rng(11)
    maps = _maps(rng, 2, nc, dtype=np.float64)
    labels, mask = _labels(rng, 2, 8, nc, [5, 3])
    labels = labels.astype(np.float64)
    with _jax_float64():
        jlc = jax_yolov5_loss.YoloV5LossConfig(nc=nc)
        jgrads = jax.jit(jax.grad(lambda ps: jax_ota.compute_ota_loss(
            ps, jnp.asarray(labels), jnp.asarray(mask), ANCHORS_GRID,
            STRIDES, IMG, jlc, top_k=top_k)[0]))(_jax(maps))
        jgrads = [np.asarray(g) for g in jgrads]
    assert jgrads[0].dtype == np.float64
    pm = _port(maps, grad=True)
    loss, _ = ota.compute_ota_loss(
        pm, torch.from_numpy(labels), torch.from_numpy(mask), ANCHORS_GRID,
        STRIDES, IMG, YoloV5LossConfig(nc=nc), top_k=top_k)
    assert loss.dtype == torch.float64
    loss.backward()
    for i, (p, jg) in enumerate(zip(pm, jgrads)):
        _close(p.grad.numpy(), jg.transpose(0, 3, 1, 2, 4), 1e-6,
               f"scale {i}")
        assert np.abs(jg).max() > 0


# -- the SSOD OTA loss --------------------------------------------------------

def _pseudo(rng, b, m, nc, n_per_img):
    """Pseudo labels (B, M, 8) [cls, xywh, conf, obj, cls_conf], a spread
    of scores around the thresholds, some obj / cls scores >= 0.99."""
    labels, mask = make_labels(rng, b, m, n_per_img, nc=nc, extra=3)
    labels[..., 5:] = rng.uniform(0.05, 1.0, labels[..., 5:].shape)
    labels[..., 6][labels[..., 6] > 0.8] = 0.995
    return labels.astype(np.float32), mask


SSOD_CASES = {
    "plain": {},
    "ignore_obj": {"ignore_obj": True},
    "with_obj": {"pseudo_label_with_obj": True},
    "focal_uncertain_aug": {"focal_loss": 1.5, "uncertain_aug": True},
}


@pytest.mark.parametrize("case", list(SSOD_CASES))
@pytest.mark.parametrize("top_k", [1, 10])
def test_ssod_ota_loss_matches_jax(case, top_k):
    nc = 4
    rng = np.random.default_rng(top_k)
    maps = _maps(rng, 2, nc)
    pseudo, mask = _pseudo(rng, 2, 10, nc, [7, 4])
    thr_high = rng.uniform(0.4, 0.7, nc).astype(np.float32)
    thr_low = rng.uniform(0.1, 0.3, nc).astype(np.float32)
    kw = dict(nc=nc, box_w=0.05, cls_w=0.3, **SSOD_CASES[case])
    jlc = jax_ssod_loss.SSODLossConfig(**kw)
    _, jparts = jax.jit(lambda *a: jax_ssod_loss.compute_ssod_ota_loss(
        *a, ANCHORS_GRID, STRIDES, IMG, jlc, top_k=top_k))(
            _jax(maps), jnp.asarray(pseudo), jnp.asarray(mask),
            jnp.asarray(thr_high), jnp.asarray(thr_low))
    _, parts = compute_ssod_ota_loss(
        _port(maps), torch.from_numpy(pseudo), torch.from_numpy(mask),
        torch.from_numpy(thr_high), torch.from_numpy(thr_low), ANCHORS_GRID,
        STRIDES, IMG, SSODLossConfig(**kw), top_k=top_k)
    assert set(parts) == set(jparts) == {"ss_box", "ss_obj", "ss_cls"}
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)
    assert float(parts["ss_box"]) > 0 and float(parts["ss_obj"]) > 0


@pytest.mark.parametrize("case", ["plain", "ignore_obj"])
def test_ssod_ota_loss_gradients_match_jax_in_float64(case):
    nc = 4
    rng = np.random.default_rng(5)
    maps = _maps(rng, 2, nc, dtype=np.float64)
    pseudo, mask = _pseudo(rng, 2, 10, nc, [6, 5])
    pseudo = pseudo.astype(np.float64)
    thr_high = np.full(nc, 0.55)
    thr_low = np.full(nc, 0.2)
    kw = dict(nc=nc, box_w=0.05, cls_w=0.3, **SSOD_CASES[case])
    with _jax_float64():
        jlc = jax_ssod_loss.SSODLossConfig(**kw)
        jgrads = jax.jit(jax.grad(
            lambda ps: jax_ssod_loss.compute_ssod_ota_loss(
                ps, jnp.asarray(pseudo), jnp.asarray(mask),
                jnp.asarray(thr_high), jnp.asarray(thr_low), ANCHORS_GRID,
                STRIDES, IMG, jlc, top_k=1)[0]))(_jax(maps))
        jgrads = [np.asarray(g) for g in jgrads]
    pm = _port(maps, grad=True)
    loss, _ = compute_ssod_ota_loss(
        pm, torch.from_numpy(pseudo), torch.from_numpy(mask),
        torch.from_numpy(thr_high), torch.from_numpy(thr_low), ANCHORS_GRID,
        STRIDES, IMG, SSODLossConfig(**kw), top_k=1)
    loss.backward()
    for i, (p, jg) in enumerate(zip(pm, jgrads)):
        _close(p.grad.numpy(), jg.transpose(0, 3, 1, 2, 4), 1e-6,
               f"scale {i}")


def test_ssod_ota_loss_zero_pseudo_labels_match_jax():
    nc = 4
    rng = np.random.default_rng(2)
    maps = _maps(rng, 2, nc)
    pseudo = np.zeros((2, 10, 8), np.float32)
    mask = np.zeros((2, 10), bool)
    thr = np.full(nc, 0.5, np.float32)
    jlc = jax_ssod_loss.SSODLossConfig(nc=nc)
    _, jparts = jax.jit(lambda *a: jax_ssod_loss.compute_ssod_ota_loss(
        *a, ANCHORS_GRID, STRIDES, IMG, jlc, top_k=1))(
            _jax(maps), jnp.asarray(pseudo), jnp.asarray(mask),
            jnp.asarray(thr), jnp.asarray(thr))
    _, parts = compute_ssod_ota_loss(
        _port(maps), torch.from_numpy(pseudo), torch.from_numpy(mask),
        torch.from_numpy(thr), torch.from_numpy(thr), ANCHORS_GRID, STRIDES,
        IMG, SSODLossConfig(nc=nc), top_k=1)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)
    assert float(parts["ss_box"]) == 0.0 and float(parts["ss_obj"]) > 0.0

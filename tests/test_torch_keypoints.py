"""The port's keypoint path (`Dataset.np`) against the JAX package: the
wing and landmark losses, `compute_loss` with its landmark term (values
and gradients), `scale_coords_landmarks`, the OKS metrics, `validator.run`
with `num_points` / `val_kp` on the same decoded outputs, the
dataset's keypoint columns read from disk, and three supervised steps at
np 5 from the warmup's start (bias lr 0.1) in float64.

Tolerances: the losses and their gradients 1e-5 relative (float32 on both
sides, sums in another order), the box and metric arithmetic exactly or
to float32 rounding, the validator's results to 1e-6, the steps' states
as `test_supervised_steps_match_jax_in_float64` says.
"""

import copy

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.data.datasets import \
    LoadImagesAndLabels as JaxDataset
from efficientteacher_tpu.eval import keypoint_metrics as jax_kpm
from efficientteacher_tpu.eval import validator as jax_validator
from efficientteacher_tpu.losses import common as jax_common
from efficientteacher_tpu.losses.yolov5_loss import (
    YoloV5LossConfig as JaxLossConfig, compute_loss as jax_compute_loss)
from efficientteacher_tpu.ops.boxes import \
    scale_coords_landmarks as jax_scale_landmarks
from efficientteacher_tpu.train import optim as jax_optim
from efficientteacher_tpu.train import train_state as jax_ts
from efficientteacher_tpu.train.supervised import (
    Schedule as JaxSchedule, make_supervised_train_step as jax_sup_step)
from efficientteacher_torch.data.datasets import LoadImagesAndLabels
from efficientteacher_torch.eval import keypoint_metrics as kpm
from efficientteacher_torch.eval import validator
from efficientteacher_torch.losses import common
from efficientteacher_torch.losses.yolov5_loss import (YoloV5LossConfig,
                                                       compute_loss)
from efficientteacher_torch.ops.boxes import scale_coords_landmarks
from efficientteacher_torch.train import optim
from efficientteacher_torch.train.from_jax import train_state_from_jax
from efficientteacher_torch.train.supervised import (
    Schedule, make_supervised_train_step)

from torch_port_helpers import (anchors_grid_of, assert_states, images_u8,
                                jax_and_port_models, make_labels, port_tensor,
                                yolov5_cfg)
from torch_port_helpers import one_torch_thread  # noqa: F401

ANCHORS_GRID = np.array(
    [[[1.25, 1.625], [2.0, 3.75], [4.125, 2.875]],
     [[1.875, 3.8125], [3.875, 2.8125], [3.6875, 7.4375]],
     [[3.625, 2.8125], [4.875, 6.1875], [11.65625, 10.1875]]], np.float32)
NPK = 5


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def _kp_labels(rng, b, m, n_per_img, nc=8):
    """Labels with NPK keypoints per box, inside it; a fifth invisible."""
    labels, mask = make_labels(rng, b, m, n_per_img, nc=nc, extra=2 * NPK)
    cxy, wh = labels[..., None, 1:3], labels[..., None, 3:5]
    kp = cxy + (rng.uniform(-0.5, 0.5, (b, m, NPK, 2)) * wh)
    kp[rng.uniform(size=(b, m, NPK)) < 0.2] = -1.0
    labels[..., 5:] = np.where(mask[..., None], kp.reshape(b, m, -1), 0.0)
    return labels.astype(np.float32), mask


def test_wing_and_landmarks_loss_match_jax():
    rng = np.random.default_rng(0)
    # both branches of the wing loss: |d| below and above w = 10
    pred = rng.normal(0, 8, (4, 6, NPK, 2)).astype(np.float32)
    target = rng.normal(0, 2, pred.shape).astype(np.float32)
    vis = rng.uniform(size=pred.shape) < 0.7
    _close(common.wing_loss(port_tensor(pred), port_tensor(target)),
           jax_common.wing_loss(jnp.asarray(pred), jnp.asarray(target)),
           1e-6, "wing")
    p = port_tensor(pred).requires_grad_()
    got = common.landmarks_loss(p, port_tensor(target), port_tensor(vis))
    want, jg = jax.value_and_grad(jax_common.landmarks_loss)(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(vis))
    _close(float(got.detach()), float(want), 1e-6, "landmarks")
    (pg,) = torch.autograd.grad(got, p)
    _close(pg.numpy(), jg, 1e-6, "landmarks grad")


@pytest.mark.parametrize("n_per_img", [[4, 7], [0, 0]],
                         ids=["targets", "zero_targets"])
def test_compute_loss_with_keypoints_matches_jax(n_per_img):
    """compute_loss at np 5, its parts (the landmark term "kp" apart) and
    the gradients of the maps, against JAX's (B, ny, nx, na, no) maps."""
    rng = np.random.default_rng(3)
    nc, b = 8, len(n_per_img)
    labels, mask = _kp_labels(rng, b, 16, n_per_img, nc)
    maps = [rng.normal(0, 1, (b, g, g, 3, 5 + nc + 2 * NPK)).astype(
        np.float32) for g in (8, 4, 2)]
    lc = dict(nc=nc, box_w=0.05, obj_w=0.7, cls_w=0.3 * nc / 80,
              num_keypoints=NPK, kp_w=10.0)

    def jax_loss(ms):
        return jax_compute_loss(ms, jnp.asarray(labels), jnp.asarray(mask),
                                ANCHORS_GRID, JaxLossConfig(**lc))

    jl, jp = jax_loss([jnp.asarray(m) for m in maps])
    pmaps = [port_tensor(m.transpose(0, 3, 1, 2, 4)).requires_grad_()
             for m in maps]
    pl_, pp = compute_loss(pmaps, port_tensor(labels), port_tensor(mask),
                           ANCHORS_GRID, YoloV5LossConfig(**lc))
    assert set(pp) == set(jp) == {"box", "obj", "cls", "kp", "loss"}
    for k in pp:
        _close(float(pp[k]), float(jp[k]), 1e-5, k)
    if sum(n_per_img):
        assert float(pp["kp"]) > 0
    else:
        assert float(pp["kp"]) == 0.0
    jg = jax.grad(lambda ms: jax_loss(ms)[0])([jnp.asarray(m) for m in maps])
    for g_j, g_p in zip(jg, torch.autograd.grad(pl_, pmaps)):
        _close(g_p.numpy(), np.asarray(g_j).transpose(0, 3, 1, 2, 4), 1e-5,
               "grad")


@pytest.mark.parametrize("ratio_pad", [None, ((0.5, 0.5), (3.0, 17.0))],
                         ids=["recomputed", "given"])
def test_scale_coords_landmarks_matches_jax(ratio_pad):
    rng = np.random.default_rng(5)
    coords = rng.uniform(-10, 300, (2, 7, 2 * NPK + 3)).astype(np.float32)
    got = scale_coords_landmarks((256, 256), port_tensor(coords), (300, 500),
                                 NPK, ratio_pad=ratio_pad)
    want = jax_scale_landmarks((256, 256), jnp.asarray(coords), (300, 500),
                               NPK, ratio_pad=ratio_pad)
    _close(got.numpy(), want, 1e-7)
    np.testing.assert_array_equal(got[..., 2 * NPK:].numpy(),
                                  coords[..., 2 * NPK:])


def test_oks_metrics_match_jax():
    rng = np.random.default_rng(6)
    gt = rng.uniform(0, 100, (5, NPK, 2))
    gt[1, 2] = -1.0                                   # an invisible point
    pred = np.concatenate([gt + rng.normal(0, 2, gt.shape),
                           rng.uniform(0, 100, (4, NPK, 2))])
    np.testing.assert_array_equal(kpm.oks(pred, gt), jax_kpm.oks(pred, gt))
    conf = rng.uniform(size=len(pred))
    pcls = rng.integers(0, 2, len(pred)).astype(np.float64)
    gcls = rng.integers(0, 2, len(gt)).astype(np.float64)
    iouv = np.linspace(0.5, 0.95, 10)
    got = kpm.process_batch_kp(pred, conf, pcls, gt, gcls, iouv)
    want = jax_kpm.process_batch_kp(pred, conf, pcls, gt, gcls, iouv)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    stats = [(got, conf, pcls, gcls)]
    assert kpm.kp_ap(stats) == jax_kpm.kp_ap(stats) > 0


class _FixedPort(torch.nn.Module):
    """A detector whose decoded output is fixed per batch; the batch's
    index is the images' first pixel."""

    def __init__(self, decoded):
        super().__init__()
        self.decoded = torch.from_numpy(decoded)
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x, decode=True):
        idx = (x[:, 0, 0, 0] * 255.0).round().long()
        return self.decoded[idx], None


class _FixedJax:
    def __init__(self, decoded):
        self.decoded = jnp.asarray(decoded)

    def apply(self, variables, x, train=False):
        idx = jnp.round(x[:, 0, 0, 0] * 255.0).astype(jnp.int32)
        return self.decoded[idx], None


def _val_batches(rng, n_batch, b, img, nc):
    """Loader batches and, per image, decoded predictions: noisy copies
    of each ground-truth box and its keypoints, plus clutter."""
    batches, decoded = [], []
    n_pred = 12
    for bi in range(n_batch):
        labels, mask = _kp_labels(rng, b, 6, rng.integers(1, 5, b), nc)
        images = np.zeros((b, img, img, 3), np.uint8)
        images[:, 0, 0, 0] = np.arange(bi * b, (bi + 1) * b)
        batches.append({"images": images, "labels": labels, "mask": mask,
                        "shapes": [(img - 16, img)] * b})
        for j in range(b):
            d = np.zeros((n_pred, 5 + nc + 2 * NPK), np.float32)
            d[:, 0:2] = rng.uniform(0, img, (n_pred, 2))
            d[:, 2:4] = rng.uniform(4, img / 3, (n_pred, 2))
            d[:, 4] = rng.uniform(0.01, 0.5, n_pred)
            d[:, 5:5 + nc] = rng.uniform(0, 1, (n_pred, nc))
            d[:, 5 + nc:] = rng.uniform(0, img, (n_pred, 2 * NPK))
            for k, row in enumerate(labels[j][mask[j]]):
                d[k, 0:4] = row[1:5] * img + rng.normal(0, 1, 4)
                d[k, 4] = rng.uniform(0.6, 1.0)
                d[k, 5 + int(row[0])] = 1.0
                d[k, 5 + nc:] = np.where(row[5:] >= 0, row[5:] * img
                                         + rng.normal(0, 1.5, 2 * NPK), 0.0)
            decoded.append(d)
    return batches, np.stack(decoded)


@pytest.mark.parametrize("val_kp", [False, True], ids=["boxes", "oks"])
def test_validator_keypoints_match_jax(val_kp):
    """validator.run with num_points 5 on the same decoded outputs: the
    landmark NMS (obj-gated, single label), keypoints scaled to native
    pixels, and with val_kp the OKS true positives."""
    rng = np.random.default_rng(8)
    nc, img = 3, 64
    batches, decoded = _val_batches(rng, 3, 4, img, nc)
    kw = dict(nc=nc, num_points=NPK, val_kp=val_kp)
    got, gmaps, _ = validator.run(_FixedPort(decoded), batches,
                                  compute_dtype=torch.float32, **kw)
    want, wmaps, _ = jax_validator.run(_FixedJax(decoded), {}, batches,
                                       compute_dtype=jnp.float32, **kw)
    _close(got, want, 1e-6, "P R mAP50 mAP")
    _close(gmaps, wmaps, 1e-6, "maps")
    assert got[2] > 0.1


def test_dataset_keypoint_columns_match_jax(tmp_path):
    """The dataset's keypoint columns read from disk, visible and
    invisible (tests/test_keypoints.py:40)."""
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    img = np.full((100, 120, 3), 90, np.uint8)
    cv2.imwrite(str(tmp_path / "images" / "a.png"), img)
    (tmp_path / "labels" / "a.txt").write_text(
        "0 0.5 0.5 0.4 0.4 0.5 0.5 -1 -1\n"
        "1 0.3 0.6 0.2 0.3 0.25 0.55 0.35 0.7\n")
    kw = dict(img_size=64, nc=2, max_targets=4, num_keypoints=2)
    _, pl, pm, ps = LoadImagesAndLabels(str(tmp_path / "images"), **kw)[0]
    _, jl, jm, js = JaxDataset(str(tmp_path / "images"), **kw)[0]
    assert pl.shape == (4, 9)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-7)
    assert tuple(ps) == tuple(js)
    assert (pl[pm][0, 7:] < 0).all()


@pytest.mark.parametrize("family", ["yolov5", "yolov7l"])
def test_keypoint_heads_match_jax(family):
    """The anchor heads at np 5 carry 2 np keypoint channels (JAX
    heads/yolov5.py, heads/yolov7.py:43-46: no = nc + 2 np + 5; the
    port's YoloV7Detect takes `no` from YoloV5Detect), decoded as JAX
    decodes them: eval outputs within 1e-5 of the largest entry."""
    from torch_zoo_cases import zoo_cfg
    from torch_port_helpers import jax_and_port_models, yolov5_cfg

    cfg = yolov5_cfg() if family == "yolov5" else zoo_cfg(family)
    cfg.Dataset.np = NPK
    jm, variables, port = jax_and_port_models(cfg)
    x = np.random.default_rng(11).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jd, jraw = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        pd, praw = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    no = 5 + cfg.Dataset.nc + 2 * NPK
    assert pd.shape[-1] == no and praw[0].shape[-1] == no
    _close(pd.numpy(), jd, 1e-5, "decoded")


# the warmup's first iterations (JAX optim.py): the bias lr falls from 0.1,
# the others rise from 0, the momentum from 0.8; every step fires
WARMUP = [(0.1, 0.0, 0.8, 1), (0.0955, 0.0005, 0.8069, 1),
          (0.091, 0.001, 0.8137, 1)]
# the state after each step, of max(1, each tensor's largest entry)
STEP_TOL = [2e-6, 1e-4, 1e-3]


def test_supervised_steps_match_jax_in_float64():
    """Three supervised steps at np 5 from the warmup's start (bias lr 0.1,
    the landmark term at kp_w 10), width 0.25 / nc 8 / 64 px, B = 4, both
    packages in float64 from the same state: each step's loss parts
    (rtol 1e-5; 1.9e-6 measured at the third) and the whole state after
    each step (STEP_TOL; 2.3e-7, 1.2e-5, 1.5e-4 measured). The gap grows
    step by step because the steps themselves do: the landmark term's
    gradients, times B and kp_w, move the weights far at the warmup's
    start, so the float32 rounding of JAX's losses (it casts the maps to
    float32 in float64 runs too) is amplified. In float32 neither package
    holds its own float64 run past the first step (measured: 0.06 of a
    tensor's largest entry for the port, 0.17 for JAX, after the first;
    above 1 after the second), so these steps are held in float64."""
    cfg = yolov5_cfg()
    cfg.Dataset.np = NPK
    jm, variables, port = jax_and_port_models(cfg)
    anchors = anchors_grid_of(cfg)
    oc_kw = dict(lr0=0.01, weight_decay=5e-4, epochs=10)
    rng = np.random.default_rng(5)
    batches = [(images_u8(rng, 4, 64),) + _kp_labels(rng, 4, 8, [3, 1, 0, 5])
               for _ in WARMUP]
    lc = YoloV5LossConfig.from_cfg(cfg)
    step = make_supervised_train_step(
        optim.OptimizerConfig(**oc_kw),
        lambda raw, labels, mask: compute_loss(raw, labels, mask, anchors,
                                               lc),
        compute_dtype=torch.float64)
    with jax.enable_x64(True):
        jm = type(jm)(spec=jm.spec, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        jstate = jax_ts.create_train_state(
            v64["params"], v64["batch_stats"],
            jax_optim.OptimizerConfig(**oc_kw), with_ema=True)
        state = train_state_from_jax(
            jax.tree_util.tree_map(np.asarray, jstate), port.double())
        jstep = jax_sup_step(jm, JaxLossConfig.from_cfg(cfg), anchors,
                             jax_optim.OptimizerConfig(**oc_kw),
                             compute_dtype=jnp.float64)
        for it, ((images, labels, mask), sched, tol) in enumerate(
                zip(batches, WARMUP, STEP_TOL)):
            jstate, jparts = jstep(jstate, jnp.asarray(images),
                                   jnp.asarray(labels), jnp.asarray(mask),
                                   JaxSchedule.make(*sched))
            state, parts = step(state, port_tensor(images),
                                port_tensor(labels).double(),
                                port_tensor(mask), Schedule.make(*sched))
            assert set(parts) == set(jparts) == {"box", "obj", "cls", "kp",
                                                 "loss"}
            for k in parts:
                np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                           rtol=1e-5, err_msg=f"step {it} {k}")
            ref = train_state_from_jax(
                jax.tree_util.tree_map(np.array, jstate),
                copy.deepcopy(state.model))
            assert_states(state, ref, tol=tol)
    assert (state.step, state.opt_step) == (3, 3)

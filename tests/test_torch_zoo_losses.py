"""The anchor-free families' assigners and losses in the PyTorch port
(`efficientteacher_torch/assigners/{simota,tal,topk}.py`,
`losses/{yolox_loss,tal_loss}.py`, the IoU family of `ops/boxes.py`)
against the JAX package on the same numpy-seeded inputs, float32.

Tolerances: the assignments (fg, matched GT, labels) are held exactly,
tie-prone inputs included (constant logits, boxes with no overlap, GTs
with no candidate anchor); matched IoUs and target boxes 1e-6, target
scores 1e-5 of their largest entry (TAL's IoU**6 is a pow whose last bit
differs between XLA and PyTorch); the losses rtol 1e-5 and their
gradients 1e-5 of the largest entry, which is as close as two float32
summation orders over the anchors come (measured ~1e-7 to 2e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.assigners.simota import simota_assign as jax_simota
from efficientteacher_tpu.assigners.tal import tal_assign as jax_tal
from efficientteacher_tpu.losses import tal_loss as jax_tal_loss
from efficientteacher_tpu.losses import yolox_loss as jax_yolox_loss
from efficientteacher_tpu.ops import boxes as jax_boxes
from efficientteacher_torch.assigners.simota import class_cost, simota_assign
from efficientteacher_torch.assigners.tal import tal_assign
from efficientteacher_torch.assigners.topk import topk_lower_index_first
from efficientteacher_torch.losses import tal_loss, yolox_loss
from efficientteacher_torch.ops import boxes

from torch_port_helpers import make_labels
from torch_port_helpers import one_torch_thread  # noqa: F401

IMG, NC = 64, 8
STRIDES = (8.0, 16.0, 32.0)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=atol, err_msg=what)


# -- top-k order -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_topk_lower_index_first_is_jax_top_k(seed):
    rng = np.random.default_rng(seed)
    # few distinct values (ties everywhere), both signs, +-0, large and tiny
    pool = np.array([0.0, -0.0, 1.0, -1.0, 1e9, -1e12, 3.5e-39, 2.0, 2.0],
                    np.float32)
    x = pool[rng.integers(0, len(pool), (6, 40))]
    x[:, ::7] = rng.normal(size=x[:, ::7].shape)
    for k in (1, 5, 13, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        v, i = topk_lower_index_first(_t(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


# -- IoU family ----------------------------------------------------------------

@pytest.mark.parametrize("xyxy", [True, False])
@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou", "siou"])
def test_bbox_iou_and_iou_loss_match_jax(kind, xyxy):
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 50, (64, 4)).astype(np.float32)
    b = rng.uniform(0, 50, (64, 4)).astype(np.float32)
    if xyxy:  # well-formed corners
        a[:, 2:] = a[:, :2] + rng.uniform(1, 30, (64, 2))
        b[:, 2:] = b[:, :2] + rng.uniform(1, 30, (64, 2))
    b[:8] = a[:8]  # identical pairs: CIoU's guarded denominator
    flags = {"giou": {"GIoU": True}, "diou": {"DIoU": True},
             "ciou": {"CIoU": True}, "siou": {"SIoU": True}, "iou": {}}[kind]
    want = jax_boxes.bbox_iou(jnp.asarray(a), jnp.asarray(b), x1y1x2y2=xyxy,
                              **flags)
    got = boxes.bbox_iou(_t(a), _t(b), x1y1x2y2=xyxy, **flags)
    _close(got.numpy(), want, 1e-6, kind)
    want_l = jax_boxes.iou_loss(jnp.asarray(a), jnp.asarray(b), kind, xyxy)
    _close(boxes.iou_loss(_t(a), _t(b), kind, xyxy).numpy(), want_l, 1e-6)


def test_box_iou_pairwise_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 40, (7, 4)).astype(np.float32)
    b = rng.uniform(0, 40, (9, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b[:, 2:] += b[:, :2]
    _close(boxes.box_iou(_t(a), _t(b)).numpy(),
           jax_boxes.box_iou(jnp.asarray(a), jnp.asarray(b)), 1e-7)


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou", "siou"])
def test_yolox_iou_loss_variant_matches_jax(kind):
    rng = np.random.default_rng(5)
    p = rng.uniform(1, 40, (50, 4)).astype(np.float32)
    t = rng.uniform(1, 40, (50, 4)).astype(np.float32)
    t[:5] = p[:5]
    want = jax_yolox_loss._iou_loss(jnp.asarray(p), jnp.asarray(t), kind)
    got = yolox_loss._iou_loss(_t(p), _t(t), kind)
    _close(got.numpy(), want, 1e-6, kind)


# -- SimOTA --------------------------------------------------------------------

def _grids_np(img=IMG, strides=STRIDES):
    centers, strd = [], []
    for s in strides:
        n = int(img // s)
        gy, gx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        c = (np.stack([gx.ravel(), gy.ravel()], -1) + 0.5) * s
        centers.append(c)
        strd.append(np.full(n * n, s))
    return (np.concatenate(centers).astype(np.float32),
            np.concatenate(strd).astype(np.float32))


def _simota_inputs(seed, case):
    rng = np.random.default_rng(seed)
    centers, strides = _grids_np()
    n = len(centers)
    b, m = 3, 6
    labels, mask = make_labels(rng, b, m, [4, 0, 6], nc=NC)
    gt_boxes = labels[..., 1:5] * IMG
    gt_cls = labels[..., 0].astype(np.int32)
    xy = centers[None] + rng.normal(0, 4, (b, n, 2))
    wh = np.exp(rng.normal(2.5, 0.6, (b, n, 2)))
    pred = np.concatenate([xy, wh], -1).astype(np.float32)
    cls = rng.normal(-1, 1.5, (b, n, NC)).astype(np.float32)
    obj = rng.normal(-1, 1.5, (b, n, 1)).astype(np.float32)
    if case == "constant":
        # the collapsed init: one logit everywhere, boxes far from every
        # GT (IoU 0): every cost ties within its band
        cls[:] = -4.6
        obj[:] = -4.6
        pred[..., :2] = -500.0
    if case == "no_candidates":
        # strides of one pixel: the GTs' centre squares hold no anchor and
        # small GTs no anchor centre, so their cost is the 1e9 band alone
        strides = np.ones_like(strides)
        gt_boxes[..., 2:4] = 1.0
        gt_boxes[..., :2] = np.floor(gt_boxes[..., :2] / 8) * 8 + 0.25
    return (gt_boxes.astype(np.float32), gt_cls, mask, pred, cls, obj,
            centers, strides)


@pytest.mark.parametrize("case", ["random", "constant", "no_candidates"])
def test_simota_assign_matches_jax(case):
    args = _simota_inputs(11, case)
    want = jax_simota(*map(jnp.asarray, args), nc=NC)
    a = [_t(x) for x in args]
    a[1] = a[1].long()
    got = simota_assign(*a, nc=NC)
    fg = np.asarray(want.fg_mask)
    np.testing.assert_array_equal(got.fg_mask.numpy(), fg)
    np.testing.assert_array_equal(got.matched_gt.numpy()[fg],
                                  np.asarray(want.matched_gt)[fg])
    _close(got.matched_iou.numpy(), want.matched_iou, 1e-6)
    assert int(got.num_fg) == int(want.num_fg)
    if case != "random":
        assert fg.sum() > 0  # the ties were resolved into assignments
    assert not fg[1].any()   # the image without GTs


def test_simota_class_cost_equals_jax_broadcast_form():
    """The (M, N) gather against JAX's one-hot broadcast summed over the
    classes (simota.py:72-76), float32, including saturated and vanishing
    scores where the clips bite."""
    gt_boxes, gt_cls, mask, _, cls, obj, _, _ = _simota_inputs(12, "random")
    cls[0, :5] = 30.0
    cls[0, 5:10] = -40.0
    obj[0, :3] = 30.0
    p = jax.nn.sigmoid(cls) * jax.nn.sigmoid(obj)
    q = jnp.sqrt(jnp.clip(p, 1e-12, 1.0))[:, None]
    y = jax.nn.one_hot(gt_cls, NC)[:, :, None, :]
    want = -(y * jnp.log(q) + (1.0 - y)
             * jnp.log1p(-jnp.clip(q, 0, 1 - 1e-7))).sum(-1)
    got = class_cost(_t(cls), _t(obj), _t(gt_cls).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=1e-5)


# -- TAL -----------------------------------------------------------------------

def _tal_inputs(seed, case):
    rng = np.random.default_rng(seed)
    anc, _ = _grids_np()
    n = len(anc)
    b, m = 3, 6
    labels, mask = make_labels(rng, b, m, [5, 0, 3], nc=NC)
    cxy, wh = labels[..., 1:3] * IMG, labels[..., 3:5] * IMG
    gt = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    pc = anc[None] + rng.normal(0, 3, (b, n, 2))
    pwh = np.exp(rng.normal(2.3, 0.5, (b, n, 2)))
    pred = np.concatenate([pc - pwh / 2, pc + pwh / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n, NC)).astype(np.float32)
    if case == "zero_metric":
        # boxes that overlap no GT: the metric is 0 in and out of the GTs,
        # so the top-k is decided by index alone
        pred[..., :] = np.array([-900, -900, -890, -890], np.float32)
    if case == "overlapping_gts":
        # nested GTs: anchors in several top-k lists, resolved by the
        # argmax over all rows
        gt[0, 1] = gt[0, 0] + np.array([-2, -2, 2, 2], np.float32)
        gt[0, 2] = gt[0, 0] + np.array([1, 1, -1, -1], np.float32)
    return (scores, pred, anc, labels[..., 0].astype(np.int32), gt, mask)


@pytest.mark.parametrize("case", ["random", "zero_metric", "overlapping_gts"])
def test_tal_assign_matches_jax(case):
    args = _tal_inputs(13, case)
    want = jax_tal(*map(jnp.asarray, args), nc=NC)
    a = [_t(x) for x in args]
    a[3] = a[3].long()
    got = tal_assign(*a, nc=NC)
    fg = np.asarray(want.fg_mask)
    np.testing.assert_array_equal(got.fg_mask.numpy(), fg)
    np.testing.assert_array_equal(got.target_labels.numpy(),
                                  np.asarray(want.target_labels))
    _close(got.target_bboxes.numpy()[fg], np.asarray(want.target_bboxes)[fg],
           1e-6)
    _close(got.target_scores.numpy(), want.target_scores, 1e-5)
    assert fg.sum() > 0 and not fg[1].any()


# -- decode and the losses -------------------------------------------------------

def _raw_maps(rng, b, no, scale=1.0, bias=0.0):
    """Port-layout raw maps (B, 1, ny, nx, no) at IMG, and JAX's."""
    port = []
    for s in STRIDES:
        n = int(IMG // s)
        port.append((rng.normal(0, scale, (b, 1, n, n, no)) + bias)
                    .astype(np.float32))
    return port, [jnp.asarray(p.transpose(0, 2, 3, 1, 4)) for p in port]


def test_dfl_project_matches_jax():
    rng = np.random.default_rng(6)
    reg = rng.normal(0, 2, (2, 30, 4 * 17)).astype(np.float32)
    _close(tal_loss.dfl_project(_t(reg), 16).numpy(),
           jax_tal_loss.dfl_project(jnp.asarray(reg), 16), 1e-6)


@pytest.mark.parametrize("use_l1", [False, True])
@pytest.mark.parametrize("iou_obj", [False, True])
def test_yolox_loss_and_gradients_match_jax(use_l1, iou_obj):
    rng = np.random.default_rng(7)
    b = 3
    port, jraw = _raw_maps(rng, b, 5 + NC, scale=0.6)
    for p, j in zip(port, jraw):
        p[..., 4:] -= 1.5
    jraw = [jnp.asarray(p.transpose(0, 2, 3, 1, 4)) for p in port]
    labels, mask = make_labels(rng, b, 6, [4, 0, 6], nc=NC)
    lc = dict(nc=NC, strides=STRIDES, use_l1=use_l1, iou_obj=iou_obj)

    def jloss(maps):
        return jax_yolox_loss.compute_yolox_loss(
            maps, jnp.asarray(labels), jnp.asarray(mask), IMG,
            jax_yolox_loss.YoloXLossConfig(**lc))

    (jl, jparts), jgrads = jax.value_and_grad(jloss, has_aux=True)(jraw)
    maps = [_t(p).requires_grad_() for p in port]
    pl, pparts = yolox_loss.compute_yolox_loss(
        maps, _t(labels), _t(mask), IMG, yolox_loss.YoloXLossConfig(**lc))
    pl.backward()
    assert set(pparts) == set(jparts)
    for k in jparts:
        np.testing.assert_allclose(float(pparts[k].detach()),
                                   float(jparts[k]),
                                   rtol=1e-5, err_msg=k)
    for m, g in zip(maps, jgrads):
        _close(m.grad.numpy().transpose(0, 2, 3, 1, 4), g, 1e-5)


@pytest.mark.parametrize("use_dfl", [True, False])
@pytest.mark.parametrize("iou_type", ["giou", "ciou"])
def test_tal_loss_and_gradients_match_jax(use_dfl, iou_type):
    rng = np.random.default_rng(8)
    b, reg_max = 3, 7
    nbins = 4 * (reg_max + 1)
    port, _ = _raw_maps(rng, b, nbins + NC, scale=1.0)
    for p in port:
        p[..., nbins:] -= 2.0
        if not use_dfl:  # the first 4 bins are the distances themselves
            p[..., :4] = np.abs(p[..., :4]) + 0.5
    jraw = [jnp.asarray(p.transpose(0, 2, 3, 1, 4)) for p in port]
    labels, mask = make_labels(rng, b, 6, [5, 0, 3], nc=NC)
    lc = dict(nc=NC, reg_max=reg_max, use_dfl=use_dfl, strides=STRIDES,
              iou_type=iou_type)

    def jloss(maps):
        return jax_tal_loss.compute_tal_loss(
            maps, jnp.asarray(labels), jnp.asarray(mask), IMG,
            jax_tal_loss.TALLossConfig(**lc))

    (jl, jparts), jgrads = jax.value_and_grad(jloss, has_aux=True)(jraw)
    maps = [_t(p).requires_grad_() for p in port]
    pl, pparts = tal_loss.compute_tal_loss(
        maps, _t(labels), _t(mask), IMG, tal_loss.TALLossConfig(**lc))
    pl.backward()
    assert set(pparts) == set(jparts)
    for k in jparts:
        np.testing.assert_allclose(float(pparts[k].detach()),
                                   float(jparts[k]),
                                   rtol=1e-5, err_msg=k)
    for m, g in zip(maps, jgrads):
        _close(m.grad.numpy().transpose(0, 2, 3, 1, 4), g, 1e-5)

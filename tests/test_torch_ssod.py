"""PyTorch port, the SSOD slice against the JAX package: pseudo labels
(NMS, the M-warp, box_candidates, flips), the SSOD loss's threshold split
and its gradients, and the mean-teacher steps end to end (one burn-in
step, the teacher seeded from the EMA, two SSOD steps: held, then fired).

float32 on both sides, on the CPU; the JAX side's NMS takes its plain
`greedy_nms_keep`, the port's its plain version (CPU tensors). Tolerances:
  - pseudo labels from identical predictions: row for row, rtol 1e-6 /
    atol 1e-6 (the same arithmetic; NMS keeps the same rows);
  - the SSOD loss: rtol 1e-5, its gradients atol 1e-6 of the largest entry
    (sums in another order);
  - the steps: see `test_ssod_steps_match_jax`.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.losses.ssod_loss import (
    SSODLossConfig as JaxSSODLossConfig, compute_ssod_loss as jax_ssod_loss)
from efficientteacher_tpu.losses.yolov5_loss import \
    YoloV5LossConfig as JaxLossConfig
from efficientteacher_tpu.ssod.pseudo_label import \
    create_pseudo_labels as jax_pseudo_labels
from efficientteacher_tpu.train import optim as jax_optim
from efficientteacher_tpu.train.ssod_step import (
    create_ssod_train_state as jax_create_state,
    make_burn_in_train_step as jax_burn_in_step,
    make_ssod_train_step as jax_ssod_step,
    seed_teacher_from_ema as jax_seed)
from efficientteacher_tpu.train.supervised import Schedule as JaxSchedule
from efficientteacher_torch.losses.ssod_loss import (SSODLossConfig,
                                                     compute_ssod_loss)
from efficientteacher_torch.losses.yolov5_loss import YoloV5LossConfig
from efficientteacher_torch.models import spec_from_cfg
from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
from efficientteacher_torch.ssod.pseudo_label import create_pseudo_labels
from efficientteacher_torch.train import optim
from efficientteacher_torch.train.ssod_step import (make_burn_in_train_step,
                                                    make_ssod_train_step,
                                                    seed_teacher_from_ema)
from efficientteacher_torch.train.supervised import Schedule
from efficientteacher_torch.train.from_jax import train_state_from_jax

from torch_port_helpers import (ANCHORS_GRID, anchors_grid_of, assert_states,
                                images_u8, jax_and_port_models, make_labels,
                                port_tensor, to_jax_variables, yolov5_cfg)
from torch_port_helpers import one_torch_thread  # noqa: F401


# --- pseudo labels ---------------------------------------------------------

def _teacher_pred(boxes_conf, n=400, nc=4, img=128, seed=0):
    """Decoded (1, n, 5 + nc): a few strong boxes over a noise floor
    (test_ssod.py's generator)."""
    rng = np.random.default_rng(seed)
    pred = np.zeros((1, n, 5 + nc), np.float32)
    pred[0, :, 0:2] = rng.uniform(0, img, (n, 2))
    pred[0, :, 2:4] = rng.uniform(4, 30, (n, 2))
    pred[0, :, 4] = 0.01
    pred[0, :, 5:] = 0.1
    for i, (cx, cy, w, h, conf, cls) in enumerate(boxes_conf):
        pred[0, i] = 0
        pred[0, i, 0:4] = [cx, cy, w, h]
        pred[0, i, 4] = conf
        pred[0, i, 5 + cls] = 0.95
    return pred


def _m_s(M, s, ud=0.0, lr=0.0):
    return np.concatenate([[0.0], np.asarray(M, np.float32).reshape(-1),
                           [s, ud, lr]]).astype(np.float32)


def _random_field(seed, b=2, n=600, nc=4, img=128):
    """Spread scores over many overlapping boxes: dozens of labels."""
    rng = np.random.default_rng(seed)
    pred = np.zeros((b, n, 5 + nc), np.float32)
    pred[..., 0:2] = rng.uniform(0, img, (b, n, 2))
    pred[..., 2:4] = rng.uniform(3, 40, (b, n, 2))
    pred[..., 4] = rng.uniform(0, 1, (b, n))
    pred[..., 5:] = rng.uniform(0, 1, (b, n, nc))
    return pred


PL_CASES = {
    "identity": (_teacher_pred([(64, 64, 40, 30, 0.9, 1),
                                (30, 100, 20, 20, 0.8, 2)]),
                 [_m_s(np.eye(3), 1.0)], 2),
    "affine_flip": (_teacher_pred([(40, 40, 30, 24, 0.9, 0)]),
                    [_m_s(np.diag([1.5, 1.5, 1.0]), 1.5, lr=1.0)], 1),
    "empty": (_teacher_pred([]),
              [_m_s(np.eye(3), 1.0)], 0),
    # translation + scale with both flips, and one box pushed past the
    # edge (the clip and box_candidates drop some)
    "random_batch": (_random_field(3),
                     [_m_s([[0.7, 0, 20], [0, 0.7, -10], [0, 0, 1]], 0.7,
                           ud=1.0, lr=1.0),
                      _m_s([[1.3, 0.1, -30], [0, 1.3, 5], [0, 0, 1]], 1.3)],
                     None),
}


@pytest.mark.parametrize("case", list(PL_CASES))
def test_pseudo_labels_match_jax_row_for_row(case):
    pred, m_s, n_want = PL_CASES[case]
    m_s = np.stack(m_s)
    kw = dict(img_size=128, nc=4, conf_thres=0.3, iou_thres=0.5, max_pl=20)
    want = jax_pseudo_labels(jnp.asarray(pred), jnp.asarray(m_s), **kw)
    got = create_pseudo_labels(port_tensor(pred), port_tensor(m_s), **kw)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.nms_valid.numpy(),
                                  np.asarray(want.nms_valid))
    assert bool(got.invalid) == bool(want.invalid)
    for name in ("labels", "nms_conf", "nms_cls"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    n = int(got.mask.sum())
    if n_want is not None:
        assert n == n_want
    else:  # the warp dropped some NMS rows, and kept dozens
        assert 20 <= n < int(got.nms_valid.sum())
    if case == "affine_flip":  # the warped centre (60, 60), x flipped
        np.testing.assert_allclose(got.labels[0, 0, 1:4].numpy(),
                                   [1 - 60 / 128, 60 / 128, 45 / 128],
                                   atol=1e-5)


# --- the SSOD loss ---------------------------------------------------------

def _pseudo_batch():
    """2 images; labels spanning reliable / uncertain / below-low
    (test_ssod.py's rows), padded to 8 slots."""
    rows = [(0, 0.5, 0.5, 0.2, 0.2, 0.9, 0.95, 0.995),    # reliable
            (1, 0.3, 0.3, 0.15, 0.2, 0.45, 0.995, 0.5),   # uncertain + obj
            (2, 0.7, 0.7, 0.2, 0.15, 0.44, 0.5, 0.995),   # uncertain + cls
            (3, 0.2, 0.8, 0.1, 0.1, 0.1, 0.2, 0.2),       # below low
            (1, 0.31, 0.3, 0.15, 0.2, 0.95, 0.9, 0.99)]   # reliable, same cell
    labels = np.zeros((2, 8, 8), np.float32)
    mask = np.zeros((2, 8), bool)
    for bi in range(2):
        labels[bi, :len(rows)] = rows
        mask[bi, :len(rows) - bi] = True
    return labels, mask


@pytest.mark.parametrize("flags", [
    dict(pseudo_label_with_obj=True, pseudo_label_with_bbox=True,
         pseudo_label_with_cls=True, uncertain_aug=True),
    dict(pseudo_label_with_obj=True, pseudo_label_with_bbox=True,
         uncertain_aug=True),          # the YOLOv5l SSOD config's flags
    dict(ignore_obj=True),
    dict(),
])
def test_ssod_loss_and_gradients_match_jax(flags):
    rng = np.random.default_rng(3)
    nc = 4
    maps = [rng.normal(0, 1, (2, g, g, 3, 5 + nc)).astype(np.float32)
            for g in (8, 4, 2)]
    labels, mask = _pseudo_batch()
    thr = (np.full(nc, 0.6, np.float32), np.full(nc, 0.35, np.float32))
    kw = dict(nc=nc, box_w=0.05, obj_w=0.7, cls_w=0.3 * nc / 80, **flags)

    def jax_loss(ms):
        return jax_ssod_loss(ms, jnp.asarray(labels), jnp.asarray(mask),
                             *map(jnp.asarray, thr), ANCHORS_GRID,
                             JaxSSODLossConfig(**kw))

    (jl, jp), jg = jax.value_and_grad(jax_loss, has_aux=True)(
        [jnp.asarray(m) for m in maps])
    pmaps = [port_tensor(m.transpose(0, 3, 1, 2, 4)).requires_grad_()
             for m in maps]
    pl_, pp = compute_ssod_loss(pmaps, port_tensor(labels),
                                port_tensor(mask), *map(port_tensor, thr),
                                ANCHORS_GRID, SSODLossConfig(**kw))
    for k in ("ss_box", "ss_obj", "ss_cls"):
        np.testing.assert_allclose(float(pp[k]), float(jp[k]), rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    assert float(pp["ss_box"]) > 0 and float(pp["ss_obj"]) > 0
    for g_j, g_p in zip(jg, torch.autograd.grad(pl_, pmaps)):
        g_j = np.asarray(g_j).transpose(0, 3, 1, 2, 4)
        np.testing.assert_allclose(g_p.numpy(), g_j, rtol=0,
                                   atol=1e-6 * np.abs(g_j).max())


def test_ssod_loss_config_from_cfg_matches_jax():
    cfg = yolov5_cfg()
    s = cfg.SSOD
    s.box_loss_weight, s.obj_loss_weight, s.cls_loss_weight = 0.05, 0.7, 0.3
    s.uncertain_aug = s.pseudo_label_with_obj = True
    s.pseudo_label_with_bbox = True
    assert vars(SSODLossConfig.from_cfg(cfg)) == vars(
        JaxSSODLossConfig.from_cfg(cfg))


# --- the mean-teacher steps ------------------------------------------------

def _ssod_cfg():
    """Width 0.25 / depth 0.33 / nc 8 / 64 px SSOD model with the YOLOv5l
    SSOD config's loss weights and flags (yolov5l_coco_ssod_10_percent)."""
    cfg = yolov5_cfg()
    cfg.Model.Backbone.activation = cfg.Model.Neck.activation = "SiLU"
    cfg.SSOD.train_domain = True
    cfg.Loss.cls, cfg.Loss.obj = 0.3, 0.7
    s = cfg.SSOD
    s.box_loss_weight, s.obj_loss_weight, s.cls_loss_weight = 0.05, 0.7, 0.3
    s.uncertain_aug = s.pseudo_label_with_obj = True
    s.pseudo_label_with_bbox = True
    return cfg


@pytest.fixture(scope="module")
def ssod_models():
    """(cfg, JAX model, its variables, port model) of `_ssod_cfg`; tests
    copy the port model before changing it."""
    cfg = _ssod_cfg()
    return (cfg, *jax_and_port_models(cfg))


def test_ssod_steps_match_jax(ssod_models):
    """One burn-in step (fired), `seed_teacher_from_ema`, then two SSOD
    steps at accumulate 2 (held, fired), on identical batches from one
    state: per-step losses, the pseudo labels of both steps, and every
    tensor of the state after the burn-in and after the steps.

    The network: the SiLU model with every conv kernel x1.6, objectness
    biases +4 and class biases +2.5. The fresh SiLU init collapses in eval
    mode (a head level's scores agree to ~1e-7, so NMS order is rounding);
    x1.6 keeps the eval-mode activations at scale (scores spread by
    0.02-0.14 in logits, boxes within 2e-4 px of JAX's), and the shifts
    give the teacher ~60 candidates per image at conf 0.1. (The ReLU
    variant of test_torch_slice.py is well posed in eval mode but not in
    train mode at this size: its updates differ by up to 30% between
    XLA and PyTorch, the SiLU model's by under 2%.)

    Tolerances, measured: flax computes train-mode batch variance as
    E[x^2] - E[x]^2, ~6e-5 from float64 on unit-scale outputs where a
    channel's mean is large against its spread (PyTorch's two-pass
    variance: 8e-7). Through the steps that gives ~1e-4 relative on the
    losses and ~5e-4 on running variances, and up to ~0.6% of a tensor's
    largest entry in the gradient-made buffers, which a fired step passes
    on to the parameters as lr times that. Hence: losses rtol 1e-3;
    parameters, statistics and EMAs 1e-3, momentum and accumulators
    2e-2, of max(1, each tensor's largest entry). The teacher runs in
    eval mode: its pseudo labels are held row for row (the same rows and
    classes; boxes and scores within 1e-4)."""
    cfg, jm, variables, port = ssod_models
    port = copy.deepcopy(port)
    with torch.no_grad():
        for k, v in port.state_dict().items():
            if k.endswith("conv.weight"):
                v.mul_(1.6)
            if k.startswith("head.m.") and k.endswith("bias"):
                v.view(-1, 13)[:, 4] += 4.0
                v.view(-1, 13)[:, 5:] += 2.5
    variables = to_jax_variables(port.state_dict(), variables)
    spec = spec_from_cfg(cfg)
    anchors = anchors_grid_of(cfg)
    oc_kw = dict(lr0=0.01, weight_decay=5e-4, epochs=10)
    nms = dict(nms_conf_thres=0.1, nms_iou_thres=0.65, max_pl=30,
               multi_label=False, teacher_loss_weight=3.0,
               da_loss_weight=0.01, with_da_loss=False)
    jstate = jax_create_state(variables["params"], variables["batch_stats"],
                              jax_optim.OptimizerConfig(**oc_kw))
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 port)
    sup_j, sup_p = JaxLossConfig.from_cfg(cfg), YoloV5LossConfig.from_cfg(cfg)
    ss_j, ss_p = (JaxSSODLossConfig.from_cfg(cfg),
                  SSODLossConfig.from_cfg(cfg))
    j_burn = jax_burn_in_step(jm, sup_j, anchors,
                              jax_optim.OptimizerConfig(**oc_kw),
                              compute_dtype=jnp.float32)
    p_burn = make_burn_in_train_step(sup_p, anchors,
                                     optim.OptimizerConfig(**oc_kw),
                                     compute_dtype=torch.float32)
    j_ssod = jax_ssod_step(jm, sup_j, ss_j, anchors,
                           jax_optim.OptimizerConfig(**oc_kw), spec,
                           compute_dtype=jnp.float32, **nms)
    p_ssod = make_ssod_train_step(sup_p, ss_p, anchors,
                                  optim.OptimizerConfig(**oc_kw), spec,
                                  compute_dtype=torch.float32, **nms)
    rng = np.random.default_rng(0)
    sup = images_u8(rng, 2, 64)
    labels, mask = make_labels(rng, 2, 6, [3, 2])
    weak = images_u8(rng, 2, 64)
    m_s = np.stack([_m_s(np.eye(3), 1.0),
                    _m_s([[0.8, 0, 6], [0, 0.8, 4], [0, 0, 1]], 0.8,
                         lr=1.0)])
    strong = images_u8(rng, 2, 64)
    thr = (np.full(8, 0.3, np.float32), np.full(8, 0.1, np.float32))
    j, p = jnp.asarray, port_tensor

    jstate, jparts = j_burn(jstate, j(sup), j(labels), j(mask), j(weak),
                            JaxSchedule.make(0.05, 0.01, 0.9, 1), None)
    state, parts = p_burn(state, p(sup), p(labels), p(mask), p(weak),
                          Schedule.make(0.05, 0.01, 0.9, 1))
    _close_parts(parts, jparts, 1e-4, "burn-in")
    jstate, state = jax_seed(jstate), seed_teacher_from_ema(state)
    _check_state(state, jstate, port)

    counts = []
    for it in range(2):
        sched = (0.01, 0.01, 0.937, 2)
        jstate, jout = j_ssod(jstate, j(sup), j(labels), j(mask), j(strong),
                              j(weak), j(m_s), *map(j, thr),
                              JaxSchedule.make(*sched), jnp.float32(0.999))
        state, out = p_ssod(state, p(sup), p(labels), p(mask), p(strong),
                            p(weak), p(m_s), *map(p, thr),
                            Schedule.make(*sched), 0.999)
        np.testing.assert_array_equal(out.pseudo_mask.numpy(),
                                      np.asarray(jout.pseudo_mask))
        np.testing.assert_array_equal(out.nms_valid.numpy(),
                                      np.asarray(jout.nms_valid))
        jl = np.asarray(jout.pseudo_labels)
        np.testing.assert_array_equal(out.pseudo_labels[..., 0].numpy(),
                                      jl[..., 0])
        np.testing.assert_allclose(out.pseudo_labels[..., 1:].numpy(),
                                   jl[..., 1:], rtol=0, atol=1e-4)
        _close_parts(out.metrics, jout.metrics, 1e-3, f"ssod step {it}")
        counts.append(int(out.pseudo_count))
    assert min(counts) >= 10, counts
    assert state.semi_ema.updates == 1 and state.opt_step == 2
    _check_state(state, jstate, port)


def _close_parts(got, want, rtol, what):
    assert set(got) == set(want), what
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   atol=1e-7, err_msg=f"{what} {k}")


def _check_state(state, jstate, port):
    ref = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                               copy.deepcopy(port))
    assert_states(state, ref, tol=1e-3, grad_tol=2e-2)


def test_ssod_step_counts_no_kernel_launch_on_cpu():
    """On CPU tensors the pseudo-label NMS takes the plain version."""
    before = greedy_nms_keep_cuda.launches
    pred, m_s, _ = PL_CASES["random_batch"]
    create_pseudo_labels(port_tensor(pred), port_tensor(np.stack(m_s)),
                         img_size=128, nc=4, conf_thres=0.3, max_pl=20)
    assert greedy_nms_keep_cuda.launches == before


def test_burn_in_step_with_domain_losses_matches_jax(ssod_models):
    """with_da_loss=True (the reference's train_without_unlabeled_da): the
    student runs on labelled + target images, the gradient-reversed
    discriminators add the domain losses * 0.01. One fired step; the
    tolerances of test_ssod_steps_match_jax."""
    cfg, jm, variables, port = ssod_models
    port = copy.deepcopy(port)
    anchors = anchors_grid_of(cfg)
    oc_kw = dict(lr0=0.01, weight_decay=5e-4, epochs=10)
    jstate = jax_create_state(variables["params"], variables["batch_stats"],
                              jax_optim.OptimizerConfig(**oc_kw))
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 port)
    da = dict(with_da_loss=True, da_loss_weight=0.01)
    j_burn = jax_burn_in_step(jm, JaxLossConfig.from_cfg(cfg), anchors,
                              jax_optim.OptimizerConfig(**oc_kw),
                              compute_dtype=jnp.float32, **da)
    p_burn = make_burn_in_train_step(YoloV5LossConfig.from_cfg(cfg), anchors,
                                     optim.OptimizerConfig(**oc_kw),
                                     compute_dtype=torch.float32, **da)
    rng = np.random.default_rng(1)
    sup, target = images_u8(rng, 2, 64), images_u8(rng, 2, 64)
    labels, mask = make_labels(rng, 2, 6, [2, 4])
    sched = (0.05, 0.01, 0.9, 1)
    jstate, jparts = j_burn(jstate, *map(jnp.asarray, (sup, labels, mask,
                                                       target)),
                            JaxSchedule.make(*sched), None)
    state, parts = p_burn(state, *map(port_tensor, (sup, labels, mask,
                                                    target)),
                          Schedule.make(*sched))
    assert {"d_loss", "t_loss"} <= set(parts)
    _close_parts(parts, jparts, 1e-3, "burn-in with domain losses")
    _check_state(state, jstate, port)

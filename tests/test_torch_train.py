"""PyTorch port, the supervised training slice against the JAX package:
BatchNorm's running statistics, the box IoU, the loss primitives, the
anchor assigner, `compute_loss` and its gradients, the domain losses, the
optimizer's groups and schedules, the accumulated SGD + EMA + semi-EMA
chain, the train-state bridge, and three supervised steps end to end.

Everything runs in float32 on the CPU, on inputs made from numpy seeds.
Tolerances, and why:
  - elementwise functions (IoU, BCE, schedules): rtol 1e-6 / atol 1e-7,
    float32 rounding of the same arithmetic (XLA may fuse a multiply-add);
  - losses: rtol 1e-5, sums of up to ~10^4 terms in another order;
  - gradients of the loss: atol 1e-6 * max|g| (the same sums, backwards);
  - the optimizer chain on identical gradients: 1e-6 of max(1, each
    state tensor's largest entry);
  - after model steps (the SiLU network of the YOLOv5l config): losses
    rtol 1e-4; parameters, statistics and EMAs 1e-4, and the
    gradient-made buffers (momentum, accumulators) 2e-3, of max(1, each
    tensor's largest entry). Train-mode BatchNorm over few values per
    channel (16 at P5: a 2x2 map, batch 4) amplifies float32 rounding:
    one step's gradients differ by up to ~5e-4 of a tensor's largest entry
    between XLA and PyTorch. In float64 they agree to ~2e-7
    (`test_model_gradients_match_jax_in_float64`), so the gap is rounding.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.assigners.yolo_anchor import \
    assign_scale as jax_assign_scale
from efficientteacher_tpu.losses import common as jax_common
from efficientteacher_tpu.losses.domain_loss import (
    domain_loss as jax_domain_loss, target_loss as jax_target_loss)
from efficientteacher_tpu.losses.yolov5_loss import (
    YoloV5LossConfig as JaxLossConfig, compute_loss as jax_compute_loss)
from efficientteacher_tpu.models.common import ConvBase as JaxConvBase
from efficientteacher_tpu.ops.boxes import bbox_iou as jax_bbox_iou
from efficientteacher_tpu.train import optim as jax_optim
from efficientteacher_tpu.train import train_state as jax_ts
from efficientteacher_tpu.train.ssod_step import \
    create_ssod_train_state as jax_create_ssod_state
from efficientteacher_tpu.train.supervised import (
    Schedule as JaxSchedule, make_supervised_train_step as jax_sup_step)
from efficientteacher_torch.assigners.yolo_anchor import assign_scale
from efficientteacher_torch.losses import common
from efficientteacher_torch.losses.domain_loss import domain_loss, target_loss
from efficientteacher_torch.losses.yolov5_loss import (YoloV5LossConfig,
                                                       compute_loss)
from efficientteacher_torch.models.common import ConvBase
from efficientteacher_torch.ops.boxes import bbox_ciou
from efficientteacher_torch.train import optim
from efficientteacher_torch.train.from_jax import train_state_from_jax
from efficientteacher_torch.train.supervised import (
    Schedule, make_supervised_train_step)
from efficientteacher_torch.train.train_state import (
    apply_gradients_accumulating, bn_stats, cosine_ema_decay)
from efficientteacher_torch.utils.jax_import import (params_from_jax,
                                                     state_dict_from_jax)

from torch_port_helpers import (ANCHORS_GRID, anchors_grid_of, assert_states,
                                images_u8, jax_and_port_models, make_labels,
                                port_tensor, yolov5_cfg)
from torch_port_helpers import one_torch_thread  # noqa: F401


# --- BatchNorm -------------------------------------------------------------

@pytest.mark.parametrize("momentum", [0.03, None])
def test_bn_running_var_is_flax_biased_update(momentum):
    """One train-mode forward at n = 8 (a 2x2 map, batch 2): the running
    variance equals flax's (biased batch variance; PyTorch's own would be
    8/7 of it). momentum=None is calibrate_bn's cumulative average: one
    batch gives its biased variance exactly."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 2.0, (2, 2, 2, 3)).astype(np.float32)
    jm = JaxConvBase(4, k=1)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(np.asarray, v)
    _, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    want = np.asarray(mut["batch_stats"]["bn"]["var"])

    port = ConvBase(3, 4, 1).train()
    with torch.no_grad():
        port.conv.weight.copy_(port_tensor(
            v["params"]["conv"]["kernel"].transpose(3, 2, 0, 1)))
    if momentum is None:
        port.bn.reset_running_stats()
        port.bn.momentum = None
    y = port.conv(port_tensor(x).permute(0, 3, 1, 2))
    biased = y.var((0, 2, 3), unbiased=False).detach()
    port(port_tensor(x).permute(0, 3, 1, 2))
    got = port.bn.running_var.detach()
    if momentum is None:
        np.testing.assert_allclose(got.numpy(), biased.numpy(), rtol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got.numpy(), 0.97 + 0.03 * biased.numpy(),
                                   rtol=1e-6)


# --- boxes and loss primitives ---------------------------------------------

def test_ciou_matches_jax():
    rng = np.random.default_rng(1)
    b1 = np.concatenate([rng.uniform(0, 2, (64, 2)),
                         rng.uniform(0.1, 3, (64, 2))], -1).astype(np.float32)
    b2 = np.concatenate([rng.uniform(0, 2, (64, 2)),
                         rng.uniform(0.1, 3, (64, 2))], -1).astype(np.float32)
    b2[0] = b1[0]  # identical boxes: the NaN guard's case
    want = np.asarray(jax_bbox_iou(jnp.asarray(b1), jnp.asarray(b2),
                                   x1y1x2y2=False, CIoU=True))
    got = bbox_ciou(port_tensor(b1), port_tensor(b2)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_loss_primitives_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 3, (256,)).astype(np.float32)
    t = rng.uniform(0, 1, (256,)).astype(np.float32)
    m = rng.uniform(size=256) > 0.5
    jx, jt, px, pt = jnp.asarray(x), jnp.asarray(t), port_tensor(x), \
        port_tensor(t)
    for pw in (1.0, 2.5):
        np.testing.assert_allclose(
            common.bce_with_logits(px, pt, pw).numpy(),
            np.asarray(jax_common.bce_with_logits(jx, jt, pw)), rtol=1e-6,
            atol=1e-7)
        np.testing.assert_allclose(
            common.focal_bce_with_logits(px, pt, 1.5, 0.25, pw).numpy(),
            np.asarray(jax_common.focal_bce_with_logits(jx, jt, 1.5, 0.25,
                                                        pw)),
            rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(common.masked_mean(px, port_tensor(m))),
        float(jax_common.masked_mean(jx, jnp.asarray(m))), rtol=1e-6)
    assert float(common.masked_mean(px, torch.zeros(256, dtype=bool))) == 0.0
    assert common.smooth_bce(0.1) == jax_common.smooth_bce(0.1)


def test_domain_losses_match_jax():
    rng = np.random.default_rng(3)
    maps = [rng.normal(0, 2, (2, g, g, 2)).astype(np.float32)
            for g in (8, 4, 2)]
    jm = [jnp.asarray(f) for f in maps]
    pm = [port_tensor(f).permute(0, 3, 1, 2) for f in maps]  # NCHW
    for ours, theirs in ((domain_loss, jax_domain_loss),
                         (target_loss, jax_target_loss)):
        np.testing.assert_allclose(float(ours(pm)), float(theirs(jm)),
                                   rtol=1e-6)


# --- assigner and compute_loss ----------------------------------------------

def _assigned(valid, flat, cols, cell_of):
    """{(image, gj, gi, anchor, slot columns...)} over the valid slots."""
    out = set()
    for bi, k in zip(*np.nonzero(valid)):
        cell = cell_of(int(flat[bi, k]))
        out.add((int(bi), *cell) + tuple(round(float(c), 5)
                                         for c in cols[bi, k]))
    return out


@pytest.mark.parametrize("single_targets", [False, True])
def test_assignment_matches_jax_by_image_cell_anchor(single_targets):
    """The same positives, compared by (image, cell, anchor): the port's
    flat index is (a * ny + gj) * nx + gi over its (B, na, ny, nx) maps,
    the JAX one (gj * nx + gi) * na + a. Slot for slot, the targets and
    the validity are equal."""
    rng = np.random.default_rng(5)
    labels, mask = make_labels(rng, 3, 16, [5, 0, 16], extra=2)
    na = 3
    for si, (ny, nx) in enumerate([(12, 10), (6, 5), (3, 3)]):
        ja = jax_assign_scale(jnp.asarray(labels), jnp.asarray(mask),
                              (ny, nx), jnp.asarray(ANCHORS_GRID[si]), 4.0,
                              single_targets)
        pa = assign_scale(port_tensor(labels), port_tensor(mask), (ny, nx),
                          port_tensor(ANCHORS_GRID[si]), 4.0, single_targets)
        np.testing.assert_array_equal(pa.valid.numpy(), np.asarray(ja.valid))
        for name in ("txy", "twh", "tcls", "anchor_wh", "extra"):
            np.testing.assert_allclose(getattr(pa, name).numpy(),
                                       np.asarray(getattr(ja, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
        cols = np.concatenate([np.asarray(ja.txy), np.asarray(ja.twh)], -1)
        want = _assigned(np.asarray(ja.valid), np.asarray(ja.flat_cell), cols,
                         lambda c: (c // (na * nx), (c // na) % nx, c % na))
        got = _assigned(pa.valid.numpy(), pa.flat_cell.numpy(), cols,
                        lambda c: ((c // nx) % ny, c % nx, c // (ny * nx)))
        assert got == want and len(got) > 0, si


def _loss_inputs(seed, n_per_img, dup=False):
    rng = np.random.default_rng(seed)
    b, nc = len(n_per_img), 8
    labels, mask = make_labels(rng, b, 16, n_per_img)
    if dup:  # two targets in one cell: the scatter's max decides
        labels[0, 1] = labels[0, 0]
        labels[0, 1, 3:5] *= 1.1
    maps = [rng.normal(0, 1, (b, g, g, 3, 5 + nc)).astype(np.float32)
            for g in (8, 4, 2)]
    return maps, labels, mask


@pytest.mark.parametrize("case", ["targets", "duplicate_cells",
                                  "zero_targets"])
def test_compute_loss_and_gradients_match_jax(case):
    maps, labels, mask = _loss_inputs(
        7, [0, 0] if case == "zero_targets" else [4, 7],
        dup=case == "duplicate_cells")
    lc = dict(nc=8, box_w=0.05, obj_w=0.7, cls_w=0.3 * 8 / 80)
    jl, jp = jax_compute_loss([jnp.asarray(m) for m in maps],
                              jnp.asarray(labels), jnp.asarray(mask),
                              ANCHORS_GRID, JaxLossConfig(**lc))
    pmaps = [port_tensor(m.transpose(0, 3, 1, 2, 4)).requires_grad_()
             for m in maps]
    pl_, pp = compute_loss(pmaps, port_tensor(labels), port_tensor(mask),
                           ANCHORS_GRID, YoloV5LossConfig(**lc))
    for k in ("box", "obj", "cls", "loss"):
        np.testing.assert_allclose(float(pp[k]), float(jp[k]), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    if case == "zero_targets":
        assert float(pp["box"]) == 0.0 and float(pp["cls"]) == 0.0
        assert float(pp["obj"]) > 0.0
    jg = jax.grad(lambda ms: jax_compute_loss(
        ms, jnp.asarray(labels), jnp.asarray(mask), ANCHORS_GRID,
        JaxLossConfig(**lc))[0])([jnp.asarray(m) for m in maps])
    pg = torch.autograd.grad(pl_, pmaps)
    for g_j, g_p in zip(jg, pg):
        g_j = np.asarray(g_j).transpose(0, 3, 1, 2, 4)
        np.testing.assert_allclose(g_p.numpy(), g_j, rtol=0,
                                   atol=1e-6 * np.abs(g_j).max())


def test_loss_config_from_cfg_matches_jax():
    cfg = yolov5_cfg()
    cfg.Loss.cls, cfg.Loss.obj = 0.3, 0.7
    assert vars(YoloV5LossConfig.from_cfg(cfg)) == \
        vars(JaxLossConfig.from_cfg(cfg))
    # with keypoints (Dataset.np) the config carries them as JAX's does;
    # the landmark term itself is held in tests/test_torch_keypoints.py
    cfg.Dataset.np = 5
    assert vars(YoloV5LossConfig.from_cfg(cfg)) == \
        vars(JaxLossConfig.from_cfg(cfg))


# --- optimizer -------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """The width-0.25 YOLOv5 of test_torch_model.py, nc 8, 64 px, as an
    SSOD model (train_domain: its discriminators are parameters too)."""
    cfg = yolov5_cfg()
    cfg.SSOD.train_domain = True
    return cfg, *jax_and_port_models(cfg)


def test_ssod_model_domain_logits_match_jax(small):
    """SSODModel: the discriminators' logits per scale equal the JAX
    model's (fp32, the forward's tolerance of test_torch_model.py), and
    grad_reverse negates the gradient that reaches the neck."""
    from efficientteacher_torch.models.detector import (SSODModel,
                                                        grad_reverse)
    _, jm, variables, port = small
    assert isinstance(port, SSODModel)
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    (_, jdom) = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        _, pdom = port(port_tensor(x).permute(0, 3, 1, 2))
    for j, t in zip(jdom, pdom):
        j = np.asarray(j).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(j).max()))
    z = torch.randn(3, requires_grad=True)
    g, = torch.autograd.grad((grad_reverse(z) * torch.arange(3.0)).sum(), z)
    assert torch.equal(g, -torch.arange(3.0))


def test_param_groups_match_jax_labels(small):
    """Grouped by module type: BN scales (PyTorch `weight`) go to `bn`."""
    _, _, variables, port = small
    code = {g: i for i, g in enumerate(optim.GROUPS)}
    jlabels = jax.tree_util.tree_map_with_path(  # the label, as a number
        lambda path, x: np.full(np.shape(x),
                                code[jax_optim.param_group_label(path, x)]),
        variables["params"])
    by_name = state_dict_from_jax(jlabels, {})
    want = [optim.GROUPS[int(by_name[n].flatten()[0])]
            for n, _ in port.named_parameters()]
    assert optim.param_group_labels(port) == want
    assert set(want) == set(optim.GROUPS)
    assert "bn" == dict(zip([n for n, _ in port.named_parameters()],
                            want))["backbone.stage1.bn.weight"]


def test_schedules_match_jax():
    for kw in (dict(lr0=0.01, warmup_epochs=3, epochs=100),
               dict(lr0=0.01, lrf=0.2, linear_lr=True, epochs=30),
               dict(multi_step=True, milestones=(10, 20))):
        ours, theirs = optim.OptimizerConfig(**kw), \
            jax_optim.OptimizerConfig(**kw)
        for ni, ep in ((0, 0), (50, 0.5), (100, 1), (300, 25.0)):
            assert ours.schedule(ni, ep, 100) == pytest.approx(
                theirs.schedule(ni, ep, 100), rel=1e-12)
    assert optim.one_cycle(1.0, 0.01, 100)(37) == pytest.approx(
        jax_optim.one_cycle(1.0, 0.01, 100)(37))
    assert cosine_ema_decay(3, 50, 0.999) == jax_ts.cosine_ema_decay(3, 50,
                                                                     0.999)
    cfg = yolov5_cfg()
    cfg.SSOD.multi_step_lr = True
    assert vars(optim.OptimizerConfig.from_cfg(cfg, 5e-4)) == vars(
        jax_optim.OptimizerConfig.from_cfg(cfg, 5e-4))


def test_sgd_matches_torch_nesterov():
    """Two fired steps of the port's chain = torch.optim.SGD(nesterov)."""
    rng = np.random.default_rng(0)
    lin = torch.nn.Linear(3, 4, bias=False)
    w0 = rng.normal(0, 1, (4, 3)).astype(np.float32)
    g = port_tensor(rng.normal(0, 1, (4, 3)).astype(np.float32))
    ref = torch.nn.Parameter(port_tensor(w0.copy()))
    opt = torch.optim.SGD([ref], lr=0.01, momentum=0.9, nesterov=True,
                          weight_decay=5e-4)
    with torch.no_grad():
        lin.weight.copy_(port_tensor(w0))
    from efficientteacher_torch.train.train_state import create_train_state
    state = create_train_state(lin, optim.OptimizerConfig(
        momentum=0.9, weight_decay=5e-4), with_ema=False)
    for _ in range(2):
        ref.grad = g.clone()
        opt.step()
        apply_gradients_accumulating(
            state, [g], optim.OptimizerConfig(weight_decay=5e-4),
            lr_bias=0.01, lr_rest=0.01, momentum=0.9, accumulate=1,
            ema_decay=0.9999)
    np.testing.assert_allclose(lin.weight.detach().numpy(),
                               ref.detach().numpy(), atol=1e-6)


@pytest.mark.parametrize("accumulate", [1, 2, 3])
def test_sgd_ema_semi_chain_matches_jax(small, accumulate):
    """Five micro-steps of identical gradients and BatchNorm statistics
    through both chains (held and fired steps; the semi-EMA on), from one
    JAX SSOD state carried across by the bridge; every tensor compared."""
    _, _, variables, port = small
    rng = np.random.default_rng(10 + accumulate)
    oc_kw = dict(lr0=0.01, weight_decay=5e-4, epochs=10)
    jstate = jax_create_ssod_state(variables["params"],
                                   variables["batch_stats"],
                                   jax_optim.OptimizerConfig(**oc_kw))
    model = copy.deepcopy(port)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 model)
    stats = bn_stats(model)
    for it in range(5):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(0, 0.01, p.shape).astype(np.float32),
            variables["params"])
        new_bs = jax.tree_util.tree_map(
            lambda s: (s + rng.uniform(0, 0.1, s.shape)).astype(np.float32),
            variables["batch_stats"])
        kw = dict(lr_bias=0.05, lr_rest=0.01, momentum=0.9,
                  accumulate=accumulate, ema_decay=0.9999)
        jstate = jax_ts.apply_gradients_accumulating(
            jstate, grads, jax_optim.OptimizerConfig(**oc_kw),
            new_batch_stats=jax.tree_util.tree_map(jnp.asarray, new_bs),
            semi_decay=jnp.float32(0.996),
            **{k: jnp.float32(v) if k != "accumulate" else jnp.int32(v)
               for k, v in kw.items()})
        # the port reads the statistics from its model, as a forward
        # would have left them
        ref = train_state_from_jax(
            jax.tree_util.tree_map(np.asarray, jstate),
            copy.deepcopy(port))
        with torch.no_grad():
            torch._foreach_copy_(stats, bn_stats(ref.model))
        apply_gradients_accumulating(state, params_from_jax(model, grads),
                                     optim.OptimizerConfig(**oc_kw),
                                     semi_decay=0.996, **kw)
        assert_states(state, ref, tol=1e-6)
    assert state.opt_step == 5 // accumulate
    assert state.ema.updates == state.semi_ema.updates == 5 // accumulate


def test_held_step_changes_only_the_accumulators(small):
    _, _, _, port = small
    model = copy.deepcopy(port)
    from efficientteacher_torch.train.ssod_step import create_ssod_train_state
    state = create_ssod_train_state(model, optim.OptimizerConfig())
    before = [p.detach().clone() for p in model.parameters()]
    ema = [p.clone() for p in state.ema.params]
    grads = [torch.full_like(p, 0.1) for p in model.parameters()]
    apply_gradients_accumulating(state, grads, optim.OptimizerConfig(),
                                 lr_bias=0.05, lr_rest=0.01, momentum=0.9,
                                 accumulate=4, ema_decay=0.9999,
                                 semi_decay=0.99)
    for a, b in zip(model.parameters(), before):
        assert torch.equal(a, b)
    for a, b in zip(state.ema.params, ema):
        assert torch.equal(a, b)
    assert all(torch.allclose(a, torch.tensor(0.1)) for a in state.acc_grads)
    assert (state.acc_count, state.opt_step, state.ema.updates,
            state.semi_ema.updates) == (1, 0, 0, 0)


# --- the bridge ------------------------------------------------------------

def test_train_state_bridge_round_trips_an_ssod_state(small):
    """A JAX SSODTrainState with every tensor distinct: the port's state
    holds each one, strict=True, discriminators det_8/16/32 included."""
    _, _, variables, port = small
    rng = np.random.default_rng(4)
    noise = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: rng.normal(0, 1, np.shape(x)).astype(np.float32), t)
    js = jax_create_ssod_state(variables["params"], variables["batch_stats"],
                               jax_optim.OptimizerConfig())
    ema = jax_ts.EMAState(noise(js.params), noise(js.batch_stats), 7)
    semi = jax_ts.EMAState(noise(js.params), noise(js.batch_stats), 3)
    js = js.replace(opt=js.opt.replace(momentum_buf=noise(js.params),
                                       step=5),
                    acc_grads=noise(js.params), ema=ema, semi_ema=semi,
                    acc_count=1, step=11)
    js = jax.tree_util.tree_map(np.asarray, js)
    state = train_state_from_jax(js, copy.deepcopy(port))
    keys = [n for n, _ in state.model.named_parameters()]
    assert {"det_8.conv1.weight", "det_16.conv2.weight",
            "det_32.conv1.weight"} <= set(keys)
    for tree, got in ((js.opt.momentum_buf, state.momentum_buf),
                      (js.acc_grads, state.acc_grads),
                      (js.ema.params, state.ema.params),
                      (js.semi_ema.params, state.semi_ema.params)):
        sd = state_dict_from_jax(tree, {})
        for k, t in zip(keys, got):
            np.testing.assert_array_equal(t.numpy(), sd[k].numpy(), k)
    sd = state_dict_from_jax(js.semi_ema.params, js.semi_ema.batch_stats)
    for k, v in state.semi_ema.module.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), k)
    assert (state.opt_step, state.acc_count, state.step, state.ema.updates,
            state.semi_ema.updates) == (5, 1, 11, 7, 3)


# --- three supervised steps ------------------------------------------------

def silu_cfg():
    """The test model with the YOLOv5l config's SiLU activations and loss
    weights (the default test config has LeakyReLU / ReLU)."""
    cfg = yolov5_cfg()
    cfg.Model.Backbone.activation = cfg.Model.Neck.activation = "SiLU"
    cfg.Loss.cls, cfg.Loss.obj = 0.3, 0.7
    return cfg


def test_three_supervised_steps_match_jax():
    """Width 0.25 / depth 0.33 / nc 8 / 64 px, B = 4, float32, accumulate
    2 (held, fired, held): per-step losses and the whole state after."""
    cfg = silu_cfg()
    jm, variables, port = jax_and_port_models(cfg)
    anchors = anchors_grid_of(cfg)
    oc_kw = dict(lr0=0.01, weight_decay=5e-4, epochs=10)
    jstate = jax_ts.create_train_state(variables["params"],
                                       variables["batch_stats"],
                                       jax_optim.OptimizerConfig(**oc_kw))
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 port)
    jstep = jax_sup_step(jm, JaxLossConfig.from_cfg(cfg), anchors,
                         jax_optim.OptimizerConfig(**oc_kw),
                         compute_dtype=jnp.float32)
    lc = YoloV5LossConfig.from_cfg(cfg)
    step = make_supervised_train_step(
        optim.OptimizerConfig(**oc_kw),
        lambda raw, labels, mask: compute_loss(raw, labels, mask, anchors,
                                               lc),
        compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    for it in range(3):
        images = images_u8(rng, 4, 64)
        labels, mask = make_labels(rng, 4, 8, [3, 1, 0, 5])
        sched = (0.05, 0.01, 0.9, 2)
        jstate, jparts = jstep(jstate, jnp.asarray(images),
                               jnp.asarray(labels), jnp.asarray(mask),
                               JaxSchedule.make(*sched))
        state, parts = step(state, port_tensor(images), port_tensor(labels),
                            port_tensor(mask), Schedule.make(*sched))
        for k in ("box", "obj", "cls", "loss"):
            np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                       rtol=1e-4, err_msg=f"step {it} {k}")
    ref = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                               copy.deepcopy(port))
    assert_states(state, ref, tol=1e-4, grad_tol=2e-3)
    assert (state.step, state.opt_step, state.acc_count) == (3, 1, 1)


def test_model_gradients_match_jax_in_float64():
    """The gradients of the supervised loss through the whole network, both
    sides in float64 (the losses themselves keep float32, as both packages
    write them): ~2e-7 of each tensor's largest entry apart, so the float32
    gaps above are rounding. Tolerance 1e-5 of the largest entry."""
    cfg = silu_cfg()
    jm32, variables, port = jax_and_port_models(cfg)
    anchors = anchors_grid_of(cfg)
    rng = np.random.default_rng(0)
    x = images_u8(rng, 4, 64).astype(np.float64) / 255.0
    labels, mask = make_labels(rng, 4, 8, [3, 1, 0, 5])
    lc = JaxLossConfig.from_cfg(cfg)
    with jax.enable_x64(True):
        jm = type(jm32)(spec=jm32.spec, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)

        def loss(params):
            raw, _ = jm.apply({"params": params,
                               "batch_stats": v64["batch_stats"]},
                              jnp.asarray(x), train=True, decode=False,
                              mutable=["batch_stats"])
            return jax_compute_loss(raw, jnp.asarray(labels),
                                    jnp.asarray(mask), anchors, lc)[0]

        jgrads = jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(loss))(v64["params"]))
    port = port.double().train()
    raw = port(torch.from_numpy(x).permute(0, 3, 1, 2), decode=False)
    pl_, _ = compute_loss(raw, port_tensor(labels), port_tensor(mask),
                          anchors, YoloV5LossConfig.from_cfg(cfg))
    got = torch.autograd.grad(pl_, list(port.parameters()))
    want = params_from_jax(port.float(), jgrads)
    for (n, _), g, w in zip(port.named_parameters(), got, want):
        w = w.double().numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=n)


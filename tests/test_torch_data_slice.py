"""The data slice as a whole: the same files on disk through two chains,

  JAX:  JAX loaders -> JAX device_augment_batch / device_ssod_views ->
        JAX burn-in step, teacher seeding, two SSOD steps;
  port: port loaders -> the port's transforms fed JAX's draws ->
        the port's steps,

each chain on its own outputs. The SiLU test network and the tolerances
of `tests/test_torch_ssod.py::test_ssod_steps_match_jax` (losses rtol
1e-3; parameters, statistics and EMAs 1e-3, momentum and accumulators
2e-2, of max(1, each tensor's largest entry)); the augmented images agree
within 1 LSB and their labels within 1e-4, as in
`tests/test_torch_augment_device.py`.

The inputs are kept in the regime those step tolerances were measured
in, where flax's one-pass batch variance, E[x^2] - E[x]^2, keeps its
digits (it loses them where a channel's mean is large against its
spread; ROADMAP, Queue 3): the files hold unblurred noise, and both
hyps take the affine scale range of the default hyp, 0.5, for the main
config's 0.9 / 0.8, which shrinks views to as little as a tenth of the
canvas and leaves the rest grey fill. With blurred files, or with the
main config's scales, the augmented inputs stay bit-equal, the losses
within 1e-3 and the state after burn-in within 4e-5, but after the fired
SSOD step the first convs differ by up to 5e-3 (blurred) and 1.9e-3
(scale 0.9) of their largest entry. The main config's hyps are held
exactly on the augmentation alone in `tests/test_torch_augment_device.py`.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.data import datasets as jax_ds
from efficientteacher_tpu.data import datasets_ssod as jax_ssod
from efficientteacher_tpu.losses.ssod_loss import \
    SSODLossConfig as JaxSSODLossConfig
from efficientteacher_tpu.losses.yolov5_loss import \
    YoloV5LossConfig as JaxLossConfig
from efficientteacher_tpu.ops import augment_device as J
from efficientteacher_tpu.train import optim as jax_optim
from efficientteacher_tpu.train.ssod_step import (
    create_ssod_train_state as jax_create_state,
    make_burn_in_train_step as jax_burn_in_step,
    make_ssod_train_step as jax_ssod_step,
    seed_teacher_from_ema as jax_seed)
from efficientteacher_tpu.train.supervised import Schedule as JaxSchedule
from efficientteacher_torch.data import datasets as port_ds
from efficientteacher_torch.data import datasets_ssod as port_ssod
from efficientteacher_torch.losses.ssod_loss import SSODLossConfig
from efficientteacher_torch.losses.yolov5_loss import YoloV5LossConfig
from efficientteacher_torch.models import spec_from_cfg
from efficientteacher_torch.ops import augment_device as T
from efficientteacher_torch.train import optim
from efficientteacher_torch.train.from_jax import train_state_from_jax
from efficientteacher_torch.train.ssod_step import (make_burn_in_train_step,
                                                    make_ssod_train_step,
                                                    seed_teacher_from_ema)
from efficientteacher_torch.train.supervised import Schedule
from test_torch_augment_device import (HYP, SSOD_HYP, assert_images_close,
                                       assert_labels_close, jax_augment_draws,
                                       jax_ssod_draws)
from test_torch_datasets import write_dataset
from test_torch_ssod import _check_state, _close_parts, _ssod_cfg
from torch_port_helpers import (anchors_grid_of, jax_and_port_models,
                                one_torch_thread, to_jax_variables)  # noqa

IMG, B, M = 64, 2, 6
SLICE_HYP = dict(HYP, scale=0.5)
SLICE_SSOD_HYP = dict(SSOD_HYP, scale=0.5)
SIZES = [(48, 64, "jpg"), (64, 48, "png"), (64, 64, "jpg"),
         (40, 60, "png")]


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """(JAX, port) pairs of the first labelled and unlabelled batches."""
    root = tmp_path_factory.mktemp("slice")
    train = write_dataset(root / "l", SIZES, seed=5, name="train",
                          blur=False)
    target = write_dataset(root / "u", SIZES, seed=6, name="target",
                           blur=False)
    kw = dict(img_size=IMG, nc=8, max_targets=M)
    jl = jax_ds.BatchLoader(jax_ds.LoadImagesAndLabels(train, **kw), B,
                            mode="thread", workers=1)
    pl = port_ds.BatchLoader(port_ds.LoadImagesAndLabels(train, **kw), B)
    jt = jax_ssod.SSODBatchLoader(
        jax_ssod.LoadImagesAndFakeLabels(target, **kw), B, mode="thread",
        workers=1)
    pt = port_ssod.SSODBatchLoader(
        port_ssod.LoadImagesAndFakeLabels(target, **kw), B)
    return (next(iter(jl)), next(iter(pl))), (next(iter(jt)),
                                               next(iter(pt)))


def _teacher_ready(port, variables):
    """The SiLU test network of test_ssod_steps_match_jax: conv kernels
    x1.6, objectness biases +4, class biases +2.5 (eval mode well posed,
    ~60 teacher candidates per image at conf 0.1)."""
    port = copy.deepcopy(port)
    with torch.no_grad():
        for k, v in port.state_dict().items():
            if k.endswith("conv.weight"):
                v.mul_(1.6)
            if k.startswith("head.m.") and k.endswith("bias"):
                v.view(-1, 13)[:, 4] += 4.0
                v.view(-1, 13)[:, 5:] += 2.5
    return port, to_jax_variables(port.state_dict(), variables)


def test_loader_augmentation_and_steps_match_jax(batches):
    (jsup, psup), (jtgt, ptgt) = batches
    cfg = _ssod_cfg()
    jm, variables, port = jax_and_port_models(cfg)
    port, variables = _teacher_ready(port, variables)
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
    j_burn = jax_burn_in_step(jm, sup_j, anchors,
                              jax_optim.OptimizerConfig(**oc_kw),
                              compute_dtype=jnp.float32)
    p_burn = make_burn_in_train_step(sup_p, anchors,
                                     optim.OptimizerConfig(**oc_kw),
                                     compute_dtype=torch.float32)
    j_ssod = jax_ssod_step(jm, sup_j, JaxSSODLossConfig.from_cfg(cfg),
                           anchors, jax_optim.OptimizerConfig(**oc_kw), spec,
                           compute_dtype=jnp.float32, **nms)
    p_ssod = make_ssod_train_step(sup_p, SSODLossConfig.from_cfg(cfg),
                                  anchors, optim.OptimizerConfig(**oc_kw),
                                  spec, compute_dtype=torch.float32, **nms)
    thr = (np.full(8, 0.3, np.float32), np.full(8, 0.1, np.float32))

    def jax_labelled(key):
        return J.device_augment_batch(
            key, jnp.asarray(jsup["images"]), jnp.asarray(jsup["labels"]),
            jnp.asarray(jsup["mask"]), SLICE_HYP, max_out=M)

    def port_labelled(key):
        out = T.augment_batch(psup["images"], torch.from_numpy(
            psup["labels"]), torch.from_numpy(psup["mask"]), SLICE_HYP,
            jax_augment_draws(key, B, IMG, SLICE_HYP), max_out=M)
        return out

    # burn-in (the JAX trainer's key: fold_in(PRNGKey(1), ni))
    key = jax.random.fold_in(jax.random.PRNGKey(1), 0)
    js, ps = jax_labelled(key), port_labelled(key)
    assert_images_close(ps[0], js[0])
    assert_labels_close(ps[1], ps[2], js[1], js[2])
    jstate, jparts = j_burn(jstate, *js, jnp.asarray(jtgt["images_ori"]),
                            JaxSchedule.make(0.05, 0.01, 0.9, 1), None)
    state, parts = p_burn(state, *ps, ptgt["images_ori"],
                          Schedule.make(0.05, 0.01, 0.9, 1))
    _close_parts(parts, jparts, 1e-4, "burn-in")
    jstate, state = jax_seed(jstate), seed_teacher_from_ema(state)

    counts = []
    for ni in (1, 2):
        # the SSOD loop's keys: split(fold_in(PRNGKey(2), ni))
        k1, k2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(2),
                                                     ni))
        js, ps = jax_labelled(k1), port_labelled(k1)
        jt = J.device_ssod_views(
            k2, jnp.asarray(jtgt["images_ori"]), jnp.asarray(jtgt["labels"]),
            jnp.asarray(jtgt["mask"]), SLICE_SSOD_HYP, max_out=M)
        pt = T.ssod_views(ptgt["images_ori"], torch.from_numpy(
            ptgt["labels"]), torch.from_numpy(ptgt["mask"]),
            SLICE_SSOD_HYP,
            jax_ssod_draws(k2, B, IMG, SLICE_SSOD_HYP), max_out=M)
        for got, want in ((ps[0], js[0]), (pt[0], jt[0]), (pt[3], jt[3])):
            assert_images_close(got, want)
        np.testing.assert_allclose(pt[4].numpy(), np.asarray(jt[4]),
                                   rtol=1e-5, atol=1e-5)
        sched = (0.01, 0.01, 0.937, 2)
        jstate, jout = j_ssod(jstate, *js, jt[0], jt[3], jt[4],
                              *map(jnp.asarray, thr),
                              JaxSchedule.make(*sched), jnp.float32(0.999))
        state, out = p_ssod(state, *ps, pt[0], pt[3], pt[4],
                            *map(torch.from_numpy, thr),
                            Schedule.make(*sched), 0.999)
        _close_parts(out.metrics, jout.metrics, 1e-3, f"ssod step {ni}")
        counts.append(int(out.pseudo_count))
    assert min(counts) >= 10, counts
    _check_state(state, jstate, port)

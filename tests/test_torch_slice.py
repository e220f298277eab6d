"""PyTorch port, the eval serving slice end to end: uint8 images ->
forward -> decode -> multi-label NMS through the port's `make_infer_fn`,
against the JAX package's `make_infer_fn` with the same weights.

Width 0.25 / depth 0.33, nc 80, 160 px, B=2, max_nms 1000: the lattice is
3 * (400 + 100 + 25) * 80 = 126,000 pairs, large enough that the JAX
compaction kernels run (interpreted on the CPU) and the port's engines
compact. fp32 on both sides.

Tolerance: per image the same number of detections and the same classes in
the same order, and rows within the decode tolerance of
test_torch_model.py: 1e-3 px on boxes, 1e-5 on confidences (the forward
sums in another order).

Random weights make that comparison well posed only where the scores are
spread well beyond the forward's rounding. The fresh SiLU init is not: its
activations shrink layer by layer, the scores of a head level agree to
~1e-7, and which near-tied pair is ranked first is rounding. With its
BatchNorm calibrated it is chaotic instead (rounding grows to 1e-2 px even
in float64). A ReLU variant with He-scaled kernels (x1.3 on every conv)
keeps its activations at scale without amplifying rounding (box error
4e-4 px), so the slice is compared on it. The SiLU forward itself is held
to the JAX one by test_torch_model.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.eval.validator import make_infer_fn as jax_infer_fn
from efficientteacher_torch.eval.validator import (_scale_to_native,
                                                   make_infer_fn)
from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
from efficientteacher_torch.utils.eval_regimes import (
    calibrate_bn, make_density_fn, mid_density, saturate_obj, shift_obj)

from torch_port_helpers import (images_u8, jax_and_port_models, port_tensor,
                                to_jax_variables, yolov5_cfg)
from torch_port_helpers import one_torch_thread  # noqa: F401

KW = dict(nc=80, conf_thres=0.001, iou_thres=0.6, max_det=300, max_nms=1000,
          norm_scale=255.0)


@pytest.fixture(scope="module")
def relu_models():
    cfg = yolov5_cfg(0.25, 0.33, 80, 160)
    cfg.Model.Backbone.activation = "ReLU"
    cfg.Model.Neck.activation = "ReLU"
    jm, variables, port = jax_and_port_models(cfg)
    port.load_state_dict({k: v * 1.3 if k.endswith("conv.weight") else v
                          for k, v in port.state_dict().items()})
    return jm, to_jax_variables(port.state_dict(), variables), port


@pytest.fixture(scope="module")
def jax_infer():
    """One jitted JAX infer function per (model, selection): compiled once
    for the module."""
    cache = {}

    def get(jm, selection):
        if (id(jm), selection) not in cache:
            cache[id(jm), selection] = jax_infer_fn(
                jm, compute_dtype=jnp.float32, selection=selection, **KW)
        return cache[id(jm), selection]

    return get


def _compare(ref, got):
    rv, gv = np.asarray(ref.valid), got.valid.numpy()
    np.testing.assert_array_equal(gv, rv)
    rd, gd = np.asarray(ref.detections), got.detections.numpy()
    for i in range(rv.shape[0]):
        r, g = rd[i][rv[i]], gd[i][gv[i]]
        np.testing.assert_array_equal(g[:, 5], r[:, 5])
        np.testing.assert_allclose(g[:, :4], r[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g[:, 4], r[:, 4], rtol=0, atol=1e-5)


def _run_both(jm, jvars, port, jax_infer, selection, images):
    ref = jax_infer(jm, selection)(jvars, jnp.asarray(images))
    infer = make_infer_fn(port, compute_dtype=torch.float32,
                          selection=selection, **KW)
    got = infer(port_tensor(images))
    _compare(ref, got)
    plain = infer.nms(infer.forward(port_tensor(images)), use_kernels=False)
    assert torch.equal(plain.detections, got.detections)
    return got


@pytest.mark.parametrize("selection", ["pallas", "pallas_elems"])
@pytest.mark.parametrize("shift,min_dets", [(0.0, 0), (2.0, 500),
                                            (10.0, 600)])
def test_infer_matches_jax(relu_models, jax_infer, shift, min_dets,
                           selection):
    """Objectness +0: an empty field; +2: ~3,300 candidates per image;
    +10: all 126,000 pairs (beyond the element buffer, so the element
    engine bisects). Both JAX engines, with the port's counterpart."""
    jm, variables, port = relu_models
    images = images_u8(np.random.default_rng(0), 2, 160)
    saved = {k: v.clone() for k, v in port.state_dict().items()}
    port.load_state_dict(shift_obj(saved, shift))
    try:
        got = _run_both(jm, to_jax_variables(port.state_dict(), variables),
                        port, jax_infer, selection, images)
    finally:
        port.load_state_dict(saved)
    assert int(got.valid.sum()) >= min_dets


def test_infer_counts_no_launch_on_cpu(relu_models):
    _, _, port = relu_models
    before = greedy_nms_keep_cuda.launches
    infer = make_infer_fn(port, compute_dtype=torch.float32, **KW)
    out = infer(port_tensor(images_u8(np.random.default_rng(1), 2, 160)))
    assert out.detections.shape == (2, 300, 6)
    assert greedy_nms_keep_cuda.launches == before
    assert port.training is False


def test_shift_obj_moves_only_objectness(relu_models):
    _, _, port = relu_models
    sd = port.state_dict()
    out = shift_obj(sd, 2.5)
    for k, v in sd.items():
        if k.startswith("head.m.") and k.endswith("bias"):
            d = (out[k] - v).view(-1, 85)
            assert torch.all(d[:, 4] == 2.5) and torch.all(d[:, :4] == 0)
            assert torch.all(d[:, 5:] == 0)
        else:
            assert out[k] is v
    assert set(saturate_obj(port)) == set(sd)


def test_mid_density_calibrates_bn_and_restores_model(relu_models):
    _, _, port = relu_models
    before = {k: v.clone() for k, v in port.state_dict().items()}
    calib = port_tensor(images_u8(np.random.default_rng(5), 4, 160))
    sd = mid_density(port, calib, shift=-1.0, compute_dtype=torch.float32)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
    x = calib.permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        y = port.backbone.stage1.conv(x)
    np.testing.assert_allclose(sd["backbone.stage1.bn.running_mean"].numpy(),
                               y.mean((0, 2, 3)).numpy(), rtol=1e-4,
                               atol=1e-6)
    assert sd["head.m.0.bias"].view(-1, 85)[0, 4] == pytest.approx(
        before["head.m.0.bias"].view(-1, 85)[0, 4].item() - 1.0)
    calibrate_bn(port, calib, torch.float32)  # in place, then restore
    assert not torch.equal(port.backbone.stage1.bn.running_var,
                           before["backbone.stage1.bn.running_var"])
    port.load_state_dict(before)


def test_density_fn_counts_the_lattice(relu_models):
    _, _, port = relu_models
    images = port_tensor(images_u8(np.random.default_rng(2), 2, 160))
    saved = {k: v.clone() for k, v in port.state_dict().items()}
    try:
        port.load_state_dict(saturate_obj(port))
        cands, rows = make_density_fn(port, 80, 0.001, torch.float32)(images)
    finally:
        port.load_state_dict(saved)
    assert cands == 126000.0 and rows == 985


def test_scale_to_native_undoes_letterbox():
    boxes = np.array([[10.0, 80.0, 630.0, 560.0]], np.float32)
    out = _scale_to_native(boxes, (640, 640), (480, 640))
    np.testing.assert_allclose(out, [[10.0, 0.0, 630.0, 480.0]])
    out = _scale_to_native(boxes, (640, 640), (480, 640),
                           ratio_pad=((0.5, 0.5), (0.0, 80.0)))
    np.testing.assert_allclose(out, [[20.0, 0.0, 640.0, 480.0]])

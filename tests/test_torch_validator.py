"""The port's `validator.run` against the JAX package's on the same batches
and weights: P, R, mAP50, mAP, the per-class maps and cls_thr.

Width 0.125 / depth 0.34, nc 1, 128 px, float32 on both sides. The network
is the non-collapsing ReLU variant of test_torch_slice.py (ReLU, every
conv kernel x1.3), whose detections agree with JAX's to 1e-3 px and 1e-5
in confidence. Labels are made from JAX's own detections, moved by a few
pixels, so the mAP is far from 0; two images have none. The batches are
ragged (3, 3, 2) and the last one records a loose letterbox (`shapes`
96 x 128 with `ratio_pad`). Tolerances: the TP matrices and the
confidence order agree, so mAP50, mAP, the per-class maps and cls_thr (a
point of the 1000-step confidence grid) are equal, compared at 1e-9. P
and R are interpolated at the best-F1 confidence between the detections'
own confidences, which differ by up to 1e-5: atol 1e-4 (measured 7e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.eval import validator as jax_validator
from efficientteacher_torch.eval import validator
from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda

from torch_port_helpers import (images_u8, jax_and_port_models,
                                to_jax_variables, yolov5_cfg)
from torch_port_helpers import one_torch_thread  # noqa: F401

IMG = 128


@pytest.fixture(scope="module")
def relu_models():
    cfg = yolov5_cfg(0.125, 0.34, 1, IMG)
    cfg.Model.Backbone.activation = "ReLU"
    cfg.Model.Neck.activation = "ReLU"
    jm, variables, port = jax_and_port_models(cfg)
    port.load_state_dict({k: v * 1.3 if k.endswith("conv.weight") else v
                          for k, v in port.state_dict().items()})
    return jm, to_jax_variables(port.state_dict(), variables), port


def _batches(jm, variables):
    """Three batches (3, 3, 2 images) with labels from JAX's detections."""
    rng = np.random.default_rng(0)
    images = images_u8(rng, 8, IMG)
    infer = jax_validator.make_infer_fn(jm, 1, 0.001, 0.6, 300, 30000, 255.0,
                                        jnp.float32)
    out = infer(variables, jnp.asarray(images))
    dets, valid = np.asarray(out.detections), np.asarray(out.valid)
    labels = np.zeros((8, 6, 5), np.float32)
    mask = np.zeros((8, 6), bool)
    for i in range(8):
        n = [3, 0, 5, 2, 4, 0, 6, 1][i]
        d = dets[i][valid[i]][:n]
        n = len(d)
        xyxy = d[:, :4] + rng.normal(0, 3, (n, 4))
        labels[i, :n, 1] = (xyxy[:, 0] + xyxy[:, 2]) / 2 / IMG
        labels[i, :n, 2] = (xyxy[:, 1] + xyxy[:, 3]) / 2 / IMG
        labels[i, :n, 3] = np.abs(xyxy[:, 2] - xyxy[:, 0]) / IMG
        labels[i, :n, 4] = np.abs(xyxy[:, 3] - xyxy[:, 1]) / IMG
        mask[i, :n] = True
    assert mask.sum() >= 15
    out = []
    for lo, hi in ((0, 3), (3, 6), (6, 8)):
        b = {"images": images[lo:hi], "labels": labels[lo:hi],
             "mask": mask[lo:hi], "shapes": [None] * (hi - lo)}
        if lo == 6:
            b["shapes"] = [(96, 128)] * 2
            b["ratio_pad"] = [((1.0, 1.0), (0.0, 16.0))] * 2
        out.append(b)
    return out


def test_run_matches_jax(relu_models):
    jm, variables, port = relu_models
    batches = _batches(jm, variables)
    want = jax_validator.run(jm, variables, batches, nc=1,
                             compute_dtype=jnp.float32)
    before = greedy_nms_keep_cuda.launches
    got = validator.run(port, batches, nc=1, compute_dtype=torch.float32)
    assert greedy_nms_keep_cuda.launches == before  # CPU: plain versions
    (mp, mr, m50, m), maps, cls_thr = got
    np.testing.assert_allclose([mp, mr], want[0][:2], rtol=0, atol=1e-4)
    np.testing.assert_allclose([m50, m], want[0][2:], rtol=0, atol=1e-9)
    np.testing.assert_allclose(maps, want[1], rtol=0, atol=1e-9)
    np.testing.assert_allclose(cls_thr, want[2], rtol=0, atol=1e-9)
    assert m50 > 0.3 and 0 < m < m50, got[0]
    assert port.training is False


def test_run_confusion_matrix_matches_jax(relu_models):
    jm, variables, port = relu_models
    batches = _batches(jm, variables)
    want = jax_validator.run(jm, variables, batches, nc=1,
                             compute_dtype=jnp.float32, confusion=True)
    got = validator.run(port, batches, nc=1, compute_dtype=torch.float32,
                        confusion=True)
    np.testing.assert_array_equal(got[3].matrix, want[3].matrix)


def test_run_without_detections_or_labels(relu_models):
    """An empty field (objectness far below the gate) gives zeros and
    cls_thr at the conf threshold, as in JAX."""
    jm, variables, port = relu_models
    batches = _batches(jm, variables)
    saved = {k: v.clone() for k, v in port.state_dict().items()}
    try:
        with torch.no_grad():
            for conv in port.head.m:
                conv.bias.view(3, 6)[:, 4] -= 30.0
        results, maps, cls_thr = validator.run(port, batches, nc=1,
                                               compute_dtype=torch.float32)
    finally:
        port.load_state_dict(saved)
    assert results == (0.0, 0.0, 0.0, 0.0)
    assert cls_thr == [0.001] and not maps.any()


def test_run_rejects_what_is_not_ported(relu_models, tmp_path):
    """Nothing of run() is refused any more: keypoint validation
    (tests/test_torch_keypoints.py) and, here, `plots_dir`, which writes
    JAX's PR / F1 / P / R curves and leaves the results as they are."""
    jm, variables, port = relu_models
    batches = _batches(jm, variables)
    want = validator.run(port, batches, nc=1, compute_dtype=torch.float32)
    got = validator.run(port, batches, nc=1, compute_dtype=torch.float32,
                        plots_dir=tmp_path, names=["thing"])
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "F1_curve.png", "PR_curve.png", "P_curve.png", "R_curve.png"]

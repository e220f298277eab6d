"""PyTorch port, NMS: the greedy keep mask (K1's plain version and its
wrapper) and `batched_nms`, against the JAX package on the same numpy
inputs. Masks and kept rows must be equal exactly: both sides do the same
float32 arithmetic in the same order, and IoU uses eps 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.ops.nms import batched_nms as jax_batched_nms
from efficientteacher_tpu.ops.nms import greedy_nms_keep as jax_greedy
from efficientteacher_torch.ops.nms import batched_nms, non_max_suppression
from efficientteacher_torch.ops.nms_cuda import (greedy_nms_keep,
                                                 greedy_nms_keep_cuda)


def _field(rng, k, n_valid, holes):
    """The generator of
    tests/test_nms.py::test_greedy_keep_density_bound_exact."""
    boxes = np.zeros((k, 4), np.float32)
    xy = rng.uniform(0, 300, (n_valid, 2))
    wh = rng.uniform(10, 90, (n_valid, 2))
    boxes[:n_valid] = np.concatenate([xy, xy + wh], -1)
    valid = np.zeros(k, bool)
    valid[:n_valid] = True
    if holes and n_valid > 4:
        valid[rng.choice(n_valid, n_valid // 3, replace=False)] = 0
    return boxes, valid


@pytest.mark.parametrize("tile", [128, 256])
@pytest.mark.parametrize("n_valid", [0, 1, 9, 180, 700])
def test_greedy_keep_matches_jax(n_valid, tile):
    """Whole keep masks equal to JAX greedy_nms_keep at K=2048: prefix and
    holed valid masks, stop_at None and 25 (the early exit at a tile
    boundary leaves later tiles at `valid` on both sides)."""
    rng = np.random.default_rng(7 + n_valid)
    for holes in (False, True):
        boxes, valid = _field(rng, 2048, n_valid, holes)
        for stop_at in (None, 25):
            ref = np.asarray(jax_greedy(jnp.asarray(boxes), jnp.asarray(valid),
                                        0.5, tile=tile, stop_at=stop_at))
            got = greedy_nms_keep(torch.from_numpy(boxes)[None],
                                  torch.from_numpy(valid)[None], 0.5,
                                  tile=tile, stop_at=stop_at)[0]
            np.testing.assert_array_equal(got.numpy(), ref)


def test_greedy_keep_batched_equals_per_image():
    """The batch written out (images stop at different tiles) gives each
    image's own mask."""
    rng = np.random.default_rng(11)
    fields = [_field(rng, 1024, n, True) for n in (0, 40, 600, 1024)]
    boxes = torch.from_numpy(np.stack([f[0] for f in fields]))
    valid = torch.from_numpy(np.stack([f[1] for f in fields]))
    for stop_at in (None, 30):
        batched = greedy_nms_keep(boxes, valid, 0.6, 128, stop_at)
        for i in range(len(fields)):
            one = greedy_nms_keep(boxes[i:i + 1], valid[i:i + 1], 0.6, 128,
                                  stop_at)
            assert torch.equal(batched[i], one[0])


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    rng = np.random.default_rng(3)
    boxes, valid = _field(rng, 512, 300, True)
    b, v = torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None]
    before = greedy_nms_keep_cuda.launches
    got = greedy_nms_keep_cuda(b, v, 0.5, 256, 50)
    assert torch.equal(got, greedy_nms_keep(b, v, 0.5, 256, 50))
    assert greedy_nms_keep_cuda.launches == before


def test_wrapper_refuses_mixed_devices():
    with pytest.raises(ValueError):
        greedy_nms_keep_cuda(torch.zeros(1, 256, 4),
                             torch.zeros(1, 256, dtype=torch.bool,
                                         device="meta"), 0.5)


def _make_pred(rng, b, n, nc):
    """The generator of tests/test_nms.py."""
    pred = np.zeros((b, n, 5 + nc), np.float32)
    pred[..., 0:2] = rng.uniform(50, 600, (b, n, 2))
    pred[..., 2:4] = rng.uniform(10, 60, (b, n, 2))
    pred[..., 4] = rng.uniform(0, 1, (b, n))
    pred[..., 5:] = rng.uniform(0, 1, (b, n, nc))
    return pred


_NMS_CASES = {
    "single": dict(nc=6, conf_thres=0.4, iou_thres=0.5, max_nms=512,
                   max_det=50),
    "multi": dict(nc=6, conf_thres=0.001, iou_thres=0.6, multi_label=True,
                  max_nms=1000, max_det=100),
    "multi_capped": dict(nc=8, conf_thres=0.05, iou_thres=0.6,
                         multi_label=True, max_nms=300, max_det=300),
    "ssod": dict(nc=4, conf_thres=0.3, iou_thres=0.5, max_nms=256,
                 max_det=30, ssod=True),
    "classes_single": dict(nc=6, conf_thres=0.3, iou_thres=0.5, max_nms=256,
                           max_det=30, classes=(1, 3)),
    "classes_multi": dict(nc=6, conf_thres=0.3, iou_thres=0.5, max_nms=256,
                          max_det=30, multi_label=True, classes=(0, 5)),
    "agnostic": dict(nc=6, conf_thres=0.2, iou_thres=0.45, max_nms=512,
                     max_det=60, agnostic=True, multi_label=True),
}


@pytest.mark.parametrize("case", sorted(_NMS_CASES))
def test_batched_nms_matches_jax(case):
    """Rows and valid equal exactly to JAX batched_nms (use_pallas=False)."""
    kw = _NMS_CASES[case]
    pred = _make_pred(np.random.default_rng(len(case)), 2, 3000, kw["nc"])
    ref = jax_batched_nms(jnp.asarray(pred), use_pallas=False, **kw)
    got = batched_nms(torch.from_numpy(pred), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.detections.numpy(),
                                  np.asarray(ref.detections))
    assert got.valid.sum() > 0


def test_use_kernels_false_matches_on_cpu():
    pred = torch.from_numpy(_make_pred(np.random.default_rng(5), 2, 2000, 8))
    kw = _NMS_CASES["multi"] | dict(nc=8, selection="pallas")
    a, b = batched_nms(pred, **kw), batched_nms(pred, use_kernels=False, **kw)
    assert torch.equal(a.detections, b.detections)
    assert torch.equal(a.valid, b.valid)


def test_reference_wrapper_shapes_and_order():
    pred = torch.from_numpy(_make_pred(np.random.default_rng(2), 2, 400, 6))
    out = non_max_suppression(pred, 0.4, 0.5, max_det=50, max_nms=512)
    assert out.detections.shape == (2, 50, 6) and out.valid.shape == (2, 50)
    for det, val in zip(out.detections, out.valid):
        conf = det[val, 4]
        assert (conf[1:] <= conf[:-1]).all()
        assert (det[~val] == 0).all()


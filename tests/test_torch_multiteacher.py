"""Multi-teacher pseudo labels in the PyTorch port
(`efficientteacher_torch/ssod/pseudo_label.py create_pseudo_labels_multi`,
`class_agnostic_merge`) against the JAX package's
(`efficientteacher_tpu/ssod/pseudo_label.py`), float32, exact.

Cases: the two-teacher case of tests/test_repopt_multiteacher.py (a class
remapped, a duplicate suppressed across teachers), and seeded random
teachers (crowded overlapping boxes, equal scores across teachers, the
extra teachers' classes remapped with some dropped) at max_pl 16 and 100:
the merge's padded width k = max(128, next_pow2(D_total)) is 128 and 256,
and more than max_pl boxes survive it, so the slot scatter drops the
overflow. Every output (warped labels, mask, the merged NMS rows) is held
exactly, the warp to 1e-6 of the image size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.ssod.pseudo_label import (
    create_pseudo_labels_multi as jax_multi)
from efficientteacher_torch.ssod.pseudo_label import (
    class_agnostic_merge, create_pseudo_labels_multi)

from torch_port_helpers import one_torch_thread  # noqa: F401


def _identity_m_s(b):
    m_s = np.zeros((b, 13), np.float32)
    m_s[:, 1:10] = np.eye(3).reshape(-1)
    m_s[:, 10] = 1.0
    return m_s


def _warp_m_s(rng, b):
    """Scale, shift and flips, as the strong view records them."""
    m_s = np.zeros((b, 13), np.float32)
    for i in range(b):
        s = rng.uniform(0.7, 1.3)
        m = np.array([[s, 0, rng.uniform(-10, 10)],
                      [0, s, rng.uniform(-10, 10)], [0, 0, 1]], np.float32)
        m_s[i, 1:10] = m.reshape(-1)
        m_s[i, 10] = s
        m_s[i, 11:13] = rng.integers(0, 2, 2)
    return m_s


def _run(decoded, cmaps, m_s, **kw):
    jout = jax.jit(lambda ds, m: jax_multi(ds, cmaps, m, **kw))(
        [jnp.asarray(d) for d in decoded], jnp.asarray(m_s))
    pcm = [None if c is None else torch.from_numpy(c) for c in cmaps]
    out = create_pseudo_labels_multi([torch.from_numpy(d) for d in decoded],
                                     pcm, torch.from_numpy(m_s), **kw)
    return jout, out


def _assert_equal(jout, out, img):
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(jout.mask))
    np.testing.assert_array_equal(out.nms_valid.numpy(),
                                  np.asarray(jout.nms_valid))
    np.testing.assert_array_equal(out.nms_conf.numpy(),
                                  np.asarray(jout.nms_conf))
    np.testing.assert_array_equal(out.nms_cls.numpy(),
                                  np.asarray(jout.nms_cls))
    np.testing.assert_allclose(out.labels.numpy(), np.asarray(jout.labels),
                               rtol=0, atol=1e-6 * img)
    assert bool(out.invalid) == bool(jout.invalid)


def test_repopt_multiteacher_case_matches_jax():
    """tests/test_repopt_multiteacher.py::test_multi_teacher_merge_and_remap
    through both packages."""
    img, nc = 128, 4

    def mk(boxes, nc_t, n=64):
        pred = np.zeros((1, n, 5 + nc_t), np.float32)
        pred[0, :, 0:2] = 200
        pred[0, :, 2:4] = 10
        pred[0, :, 4] = 0.01
        for i, (cx, cy, w, h, conf, cls) in enumerate(boxes):
            pred[0, i, 0:4] = [cx, cy, w, h]
            pred[0, i, 4] = conf
            pred[0, i, 5 + cls] = 0.95
        return pred

    main = mk([(40, 40, 30, 30, 0.9, 1)], nc)
    extra = mk([(90, 90, 24, 24, 0.8, 0), (40, 40, 30, 30, 0.7, 1)], 2)
    cmaps = [None, np.array([3, -1], np.int32)]
    jout, out = _run([main, extra], cmaps, _identity_m_s(1), img_size=img,
                     nc=nc, conf_thres=0.3, iou_thres=0.5, max_pl=16)
    _assert_equal(jout, out, img)
    labels = out.labels[0][out.mask[0]].numpy()
    assert sorted(labels[:, 0].astype(int).tolist()) == [1, 3]


def _teacher(rng, b, n, nc_t, img, base=None):
    """Decoded predictions (B, N, 5 + nc_t): boxes in clusters (heavy
    overlap), scores on a coarse grid (equal scores within and across
    teachers); `base` reuses another teacher's boxes."""
    pred = np.zeros((b, n, 5 + nc_t), np.float32)
    if base is None:
        centres = rng.uniform(20, img - 20, (b, n // 4, 2))
        xy = np.repeat(centres, 4, 1) + rng.normal(0, 3, (b, n, 2))
        wh = rng.uniform(8, 40, (b, n, 2))
        pred[..., :4] = np.concatenate([xy, wh], -1)
    else:
        pred[..., :4] = base[..., :4]
    pred[..., 4] = rng.choice([0.2, 0.5, 0.75, 0.9, 1.0], (b, n))
    cls = rng.integers(0, nc_t, (b, n))
    np.put_along_axis(pred[..., 5:], cls[..., None],
                      rng.choice([0.5, 0.8, 1.0], (b, n, 1)), -1)
    return pred


@pytest.mark.parametrize("max_pl", [16, 100])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_teachers_match_jax(seed, max_pl):
    rng = np.random.default_rng(seed)
    b, n, img, nc = 3, 400, 160, 5
    main = _teacher(rng, b, n, nc, img)
    extra = _teacher(rng, b, n, 4, img, base=main if seed else None)
    third = _teacher(rng, b, n, nc, img)
    cmaps = [None, np.array([4, -1, 0, 2], np.int32),
             np.array([1, 0, 3, 2, -1], np.int32)]
    jout, out = _run([main, extra, third], cmaps, _warp_m_s(rng, b),
                     img_size=img, nc=nc, conf_thres=0.3, iou_thres=0.6,
                     max_pl=max_pl)
    _assert_equal(jout, out, img)
    assert int(out.nms_valid.sum()) > b  # the merge kept boxes
    if max_pl == 16:  # overflow: every image fills its slots
        assert bool(out.nms_valid.all())


def test_merge_drops_the_overflow_and_pads_to_a_power_of_two():
    """More kept boxes than max_pl: the slots hold the first max_pl in
    score order (stable among equal scores), none scattered into the last
    slot; the keep mask runs at k = max(128, next_pow2(D_total))."""
    from efficientteacher_torch.ssod import pseudo_label

    b, d, max_pl = 2, 70, 8
    rng = np.random.default_rng(4)
    det = np.zeros((b, d, 8), np.float32)
    det[..., 0] = np.arange(d) * 20.0          # disjoint boxes
    det[..., 2] = det[..., 0] + 10.0
    det[..., 3] = 10.0
    det[..., 4] = rng.choice([0.4, 0.6, 0.8], (b, d))
    det[..., 5] = np.arange(d)                 # row id, to read the order
    valid = np.ones((b, d), bool)
    valid[:, ::5] = False
    calls = []
    real = pseudo_label.greedy_nms_keep_cuda

    def spy(boxes, v, iou, tile):
        calls.append((tuple(boxes.shape), tile))
        return real(boxes, v, iou, tile=tile)

    pseudo_label.greedy_nms_keep_cuda = spy
    try:
        out, ok = class_agnostic_merge(
            [torch.from_numpy(det[:, :40]), torch.from_numpy(det[:, 40:])],
            [torch.from_numpy(valid[:, :40]), torch.from_numpy(valid[:, 40:])],
            max_pl, 0.5)
    finally:
        pseudo_label.greedy_nms_keep_cuda = real
    assert calls == [((b, 128, 4), 128)]
    assert bool(ok.all())
    for i in range(b):
        score = np.where(valid[i], det[i, :, 4], -1.0)
        order = np.argsort(-score, kind="stable")[:max_pl]
        np.testing.assert_array_equal(out[i, :, 5].numpy(), order)

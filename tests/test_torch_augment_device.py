"""The port's device augmentation (`efficientteacher_torch/ops/
augment_device.py`, run here on the CPU) against the JAX package's on the
same draws: `jax_augment_draws` / `jax_ssod_draws` reproduce the JAX
functions' key splits and draws and hand the values to the port's
deterministic transforms.

Tolerances: images within 1 LSB (both truncate float results to uint8;
the port sums the two nonzero bilinear taps where JAX multiplies by the
whole resample matrix, so values a rounding away from an integer may
truncate to either side), boxes 1e-4 px-normalised, masks exact, M_s
within 1e-5 relative. Properties (hypothesis): a zero hyp is the
identity; a warped label box encloses its warped filled rectangle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from efficientteacher_tpu.ops import augment_device as J
from efficientteacher_torch.ops import augment_device as T
from torch_port_helpers import make_labels, one_torch_thread  # noqa: F401

S, B, M = 32, 4, 6
HYP = {"mosaic": 1.0, "degrees": 0.0, "translate": 0.1, "scale": 0.9,
       "shear": 0.0, "perspective": 0.0, "hsv_h": 0.015, "hsv_s": 0.7,
       "hsv_v": 0.4, "fliplr": 0.5, "flipud": 0.0, "mixup": 0.0}
SSOD_HYP = {"mosaic": 1.0, "cutout": 0.5, "scale": 0.8, "degrees": 0.0,
            "shear": 0.0, "translate": 0.1, "hsv_h": 0.015, "hsv_s": 0.7,
            "hsv_v": 0.4, "fliplr": 0.5, "flipud": 0.0, "perspective": 0.0}
ROTATING = dict(HYP, degrees=10.0, shear=3.0, perspective=0.0005,
                flipud=0.5)


def _u(k, lo, hi, shape=()):
    return float(jax.random.uniform(k, shape, minval=lo, maxval=hi)) \
        if shape == () else np.asarray(
            jax.random.uniform(k, shape, minval=lo, maxval=hi))


def _affine_draws(kw, hyp):
    k = jax.random.split(kw, 8)
    p, d = float(hyp.get("perspective", 0.0)), float(hyp.get("degrees", 0.0))
    sc, sh = float(hyp.get("scale", 0.5)), float(hyp.get("shear", 0.0))
    t = float(hyp.get("translate", 0.1))
    return [_u(k[0], -p, p), _u(k[1], -p, p), _u(k[2], -d, d),
            _u(k[3], 1 - sc, 1 + sc), _u(k[4], -sh, sh), _u(k[5], -sh, sh),
            _u(k[6], 0.5 - t, 0.5 + t), _u(k[7], 0.5 - t, 0.5 + t)]


def _shifts(kperm, b):
    if b == 1:
        return np.zeros(3, np.int64)
    return np.asarray(1 + jax.random.randint(kperm, (3,), 0, b - 1))


def _flag(k, p):
    return bool(jax.random.uniform(k, ()) < p)


def _tensors(d):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = _tensors(v)
        else:
            v = np.array(v)
            out[k] = torch.from_numpy(v.astype(np.float32)
                                      if v.dtype == np.float64 else v)
    return out


def jax_augment_draws(key, b, s, hyp):
    """device_augment_batch's draws for `key`, as the port's dict."""
    kperm, kbatch, khsv = jax.random.split(key, 3)
    d = {"shifts": _shifts(kperm, b), "xc": [], "yc": [], "do_mos": [],
         "affine": [], "do_lr": [], "do_ud": [], "hsv": []}
    p_mos = np.float32(hyp.get("mosaic", 1.0))
    for i in range(b):
        km, kw, _, kfl, kfu, kg = jax.random.split(
            jax.random.fold_in(kbatch, i), 6)
        kx, ky = jax.random.split(km)
        d["xc"].append(_u(kx, 0.5 * s, 1.5 * s))
        d["yc"].append(_u(ky, 0.5 * s, 1.5 * s))
        d["do_mos"].append(bool(jax.random.uniform(kg, ()) < p_mos))
        d["affine"].append(_affine_draws(kw, hyp))
        d["do_lr"].append(_flag(kfl, float(hyp.get("fliplr", 0.0))))
        d["do_ud"].append(_flag(kfu, float(hyp.get("flipud", 0.0))))
        d["hsv"].append(_u(jax.random.fold_in(khsv, i), -1.0, 1.0, (3,)))
    if float(hyp.get("mixup", 0.0)) > 0 and b > 1:
        kmr, kmp = jax.random.split(jax.random.fold_in(kbatch, b))
        d["mix_r"] = np.asarray(jax.random.beta(kmr, 32.0, 32.0,
                                                (b, 1, 1, 1))).reshape(b)
        d["do_mix"] = np.asarray(jax.random.uniform(kmp, (b,))
                                 < float(hyp["mixup"]))
    return _tensors(d)


def jax_cutout_draws(kc2, s):
    n = len(T.CUT_SCALES)
    ks = jax.random.split(kc2, 5)
    sc = jnp.asarray(T.CUT_SCALES, jnp.float32)
    return {
        "mh": np.asarray((jax.random.uniform(ks[0], (n,)) * (sc * s - 1) + 1)
                         .astype(jnp.int32)),
        "mw": np.asarray((jax.random.uniform(ks[1], (n,)) * (sc * s - 1) + 1)
                         .astype(jnp.int32)),
        "cx": np.asarray(jax.random.randint(ks[2], (n,), 0, s + 1)),
        "cy": np.asarray(jax.random.randint(ks[3], (n,), 0, s + 1)),
        "colors": np.asarray(jax.random.randint(ks[4], (n, 3), 64, 192)
                             .astype(jnp.float32)),
    }


def jax_ssod_draws(key, b, s, hyp):
    """device_ssod_views's draws for `key`, as the port's dict."""
    kperm, kbatch = jax.random.split(key)
    d = {"shifts": _shifts(kperm, b), "xc": [], "yc": [], "do_mos": [],
         "affine": [], "do_lr": [], "do_ud": [], "hsv": [], "do_cut": []}
    cuts = []
    for i in range(b):
        km, kg, kw, kh, kfl, kfu, kc = jax.random.split(
            jax.random.fold_in(kbatch, i), 7)
        kx, ky = jax.random.split(km)
        d["xc"].append(_u(kx, 0.5 * s, 1.5 * s))
        d["yc"].append(_u(ky, 0.5 * s, 1.5 * s))
        d["do_mos"].append(_flag(kg, float(hyp["mosaic"])))
        d["affine"].append(_affine_draws(kw, hyp))
        d["do_lr"].append(_flag(kfl, float(hyp.get("fliplr", 0.0))))
        d["do_ud"].append(_flag(kfu, float(hyp.get("flipud", 0.0))))
        d["hsv"].append(_u(kh, -1.0, 1.0, (3,)))
        kc1, kc2 = jax.random.split(kc)
        d["do_cut"].append(_flag(kc1, float(hyp.get("cutout", 0.0))))
        cuts.append(jax_cutout_draws(kc2, s))
    if float(hyp.get("cutout", 0.0)) > 0:
        d["cut"] = {k: np.stack([c[k] for c in cuts]) for k in cuts[0]}
    else:
        del d["do_cut"]
    return _tensors(d)


def batch(seed=0, b=B, s=S, m=M, filled=None):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, s, s, 3), np.uint8)
    labels, mask = make_labels(rng, b, m, filled or [m - 1, 3, 0, m][:b])
    return images, labels, mask


def assert_images_close(got, want, lsb=1):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= lsb, f"max |d| {d.max()} at {np.argwhere(d > lsb)[:3]}"


def assert_labels_close(got_l, got_m, want_l, want_m):
    np.testing.assert_array_equal(np.asarray(got_m), np.asarray(want_m))
    np.testing.assert_allclose(np.asarray(got_l), np.asarray(want_l),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("hyp", [HYP, dict(HYP, mosaic=0.0),
                                 dict(HYP, mosaic=0.5, mixup=0.5),
                                 dict(HYP, mosaic=0.6, flipud=0.5),
                                 ROTATING, dict(ROTATING, mosaic=0.0)],
                         ids=["main", "no-mosaic", "mixup", "flips",
                              "rotating", "rotating-no-mosaic"])
@pytest.mark.parametrize("seed", [0, 1])
def test_device_augment_batch_matches_jax_on_its_draws(hyp, seed):
    images, labels, mask = batch(seed)
    key = jax.random.fold_in(jax.random.PRNGKey(1), seed)
    want = J.device_augment_batch(key, jnp.asarray(images),
                                  jnp.asarray(labels), jnp.asarray(mask),
                                  hyp, max_out=10)
    draws = jax_augment_draws(key, B, S, hyp)
    got = T.augment_batch(torch.from_numpy(images), torch.from_numpy(labels),
                          torch.from_numpy(mask), hyp, draws, max_out=10)
    assert got[0].dtype == torch.uint8 and got[0].shape == (B, S, S, 3)
    assert_images_close(got[0], want[0])
    assert_labels_close(got[1], got[2], want[1], want[2])


@pytest.mark.parametrize("hyp", [SSOD_HYP, dict(SSOD_HYP, mosaic=0.5),
                                 dict(SSOD_HYP, mosaic=0.0, cutout=0.0),
                                 dict(SSOD_HYP, degrees=8.0, shear=2.0,
                                      flipud=0.5)],
                         ids=["main", "half-mosaic", "plain", "rotating"])
@pytest.mark.parametrize("seed", [0, 1])
def test_device_ssod_views_match_jax_on_its_draws(hyp, seed):
    images, labels, mask = batch(seed + 10)
    key = jax.random.fold_in(jax.random.PRNGKey(2), seed)
    want = J.device_ssod_views(key, jnp.asarray(images), jnp.asarray(labels),
                               jnp.asarray(mask), hyp, max_out=12)
    draws = jax_ssod_draws(key, B, S, hyp)
    got = T.ssod_views(torch.from_numpy(images), torch.from_numpy(labels),
                       torch.from_numpy(mask), hyp, draws, max_out=12)
    assert_images_close(got[0], want[0])          # strong
    assert_images_close(got[3], want[3])          # weak
    assert_labels_close(got[1], got[2], want[1], want[2])
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=1e-5, atol=1e-5)


def test_cutout_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (S, S, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = J.cutout_device(key, jnp.asarray(img), S)
    cut = _tensors({k: v[None] for k, v in jax_cutout_draws(key, S).items()})
    got = T.cutout_device(torch.from_numpy(img)[None], cut, S)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_geometry_helpers_match_jax():
    key = jax.random.PRNGKey(5)
    hyp = ROTATING
    draws = torch.tensor([_affine_draws(k, hyp)
                          for k in jax.random.split(key, 3)])
    for w, border in ((S, (0, 0)), (2 * S, (-S // 2, -S // 2))):
        M, sc = T.build_affine_device(draws, w, w, border)
        for i, k in enumerate(jax.random.split(key, 3)):
            Mj, sj = J.build_affine_device(
                k, w, w, hyp["degrees"], hyp["translate"], hyp["scale"],
                hyp["shear"], hyp["perspective"], border)
            np.testing.assert_allclose(M[i].numpy(), np.asarray(Mj),
                                       rtol=1e-5, atol=1e-6)
            assert abs(float(sc[i]) - float(sj)) < 1e-6
    rng = np.random.default_rng(0)
    boxes = np.sort(rng.uniform(0, S, (3, 5, 4)).astype(np.float32)
                    .reshape(3, 5, 2, 2), axis=2).transpose(0, 1, 3, 2) \
        .reshape(3, 5, 4)
    for flips in ((True, False), (False, True), (True, True)):
        lr, ud = (torch.tensor([f] * 3) for f in flips)
        Mf = T._fold_flips(M, lr, ud, S, pixel=False)
        new = T.warp_boxes_device(torch.from_numpy(boxes), Mf, S, S)
        keep = T.box_candidates_device(torch.from_numpy(boxes), new, sc)
        for i in range(3):
            Mfj = J._fold_flips(jnp.asarray(M[i].numpy()), flips[0],
                                flips[1], S, pixel=False)
            np.testing.assert_allclose(Mf[i].numpy(), np.asarray(Mfj),
                                       rtol=1e-6, atol=1e-5)
            nj = J.warp_boxes_device(jnp.asarray(boxes[i]), Mfj, S, S)
            np.testing.assert_allclose(new[i].numpy(), np.asarray(nj),
                                       rtol=1e-5, atol=1e-4)
            kj = J.box_candidates_device(jnp.asarray(boxes[i]), nj,
                                         float(sc[i]))
            np.testing.assert_array_equal(keep[i].numpy(), np.asarray(kj))


def test_warps_match_jax():
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (2, S, S, 3), np.uint8)
    Ms = np.stack([np.array([[0.8, 0, 3.5], [0, -1.2, 30.0], [0, 0, 1]]),
                   np.array([[1.3, 0, -6.0], [0, 0.7, 2.25], [0, 0, 1]])
                   ]).astype(np.float32)
    got = T.warp_scale_translate_device(torch.from_numpy(imgs),
                                        torch.from_numpy(Ms), S, S)
    persp = Ms.copy()
    persp[:, 0, 1], persp[:, 2, 0] = 0.1, 1e-3
    got_g = T.warp_image_device(torch.from_numpy(imgs),
                                torch.from_numpy(persp), S, S)
    for i in range(2):
        want = J.warp_scale_translate_device(jnp.asarray(imgs[i]),
                                             jnp.asarray(Ms[i]), S, S)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-3)
        want_g = J.warp_image_device(jnp.asarray(imgs[i]),
                                     jnp.asarray(persp[i]), S, S)
        np.testing.assert_allclose(got_g[i].numpy(), np.asarray(want_g),
                                   rtol=0, atol=1e-2)


def test_mosaic4_and_hsv_match_jax():
    images, labels, mask = batch(4)
    key = jax.random.PRNGKey(9)
    idx = torch.tensor([[0, 1, 2, 3], [1, 2, 3, 0]])
    xs, ys, canvases, boxes, valids = [], [], [], [], []
    for i in range(2):
        k = jax.random.fold_in(key, i)
        kx, ky = jax.random.split(k)
        xs.append(_u(kx, 0.5 * S, 1.5 * S))
        ys.append(_u(ky, 0.5 * S, 1.5 * S))
        q = idx[i].numpy()
        c, bx, v = J.mosaic4_device(k, jnp.asarray(images[q]),
                                    jnp.asarray(labels[q]),
                                    jnp.asarray(mask[q]), S)
        canvases.append(np.asarray(c))
        boxes.append(np.asarray(bx))
        valids.append(np.asarray(v))
    c, bx, v = T.mosaic4_device(torch.from_numpy(images), idx,
                                torch.from_numpy(labels),
                                torch.from_numpy(mask),
                                torch.tensor(xs), torch.tensor(ys), S)
    np.testing.assert_array_equal(c.float().numpy(), np.stack(canvases))
    np.testing.assert_allclose(bx.numpy(), np.stack(boxes), atol=1e-4)
    np.testing.assert_array_equal(v.numpy(), np.stack(valids))
    # the antialiased halving against jax.image.resize
    half = T._halve(c)
    for i in range(2):
        want = jax.image.resize(jnp.asarray(canvases[i]), (S, S, 3),
                                method="bilinear")
        np.testing.assert_allclose(half[i].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-3)
    img = c[:, :S, :S].float()
    u = torch.tensor([[0.3, -0.8, 0.5], [-1.0, 0.9, -0.2]])
    got = T.hsv_jitter_device(img, u, 0.015, 0.7, 0.4)
    for i in range(2):
        ji = jnp.asarray(img[i].numpy())
        r = u[i].numpy() * np.array([0.015, 0.7, 0.4], np.float32) + 1.0
        hj, sj, vj = J._rgb_to_hsv(ji / 255.0)
        want = J._hsv_to_rgb((hj * r[0]) % 1.0, jnp.clip(sj * r[1], 0, 1),
                             jnp.clip(vj * r[2], 0, 1)) * 255.0
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-3)


def test_port_draws_have_the_jax_ranges():
    g = torch.Generator().manual_seed(T.step_seed(2, 17, 1))
    d = T.draw_ssod(g, 64, S, SSOD_HYP, "cpu")
    a = d["affine"]
    assert ((a[:, 3] >= 0.2) & (a[:, 3] <= 1.8)).all()
    assert ((a[:, 6:] >= 0.4) & (a[:, 6:] <= 0.6)).all()
    assert (a[:, :3] == 0).all() and (a[:, 4:6] == 0).all()
    assert ((d["xc"] >= 0.5 * S) & (d["xc"] < 1.5 * S)).all()
    assert ((d["shifts"] >= 1) & (d["shifts"] < 64)).all()
    assert not d["do_ud"].any() and d["do_lr"].any()
    cut = d["cut"]
    assert ((cut["colors"] >= 64) & (cut["colors"] < 192)).all()
    assert (cut["mh"] >= 1).all() and (cut["mh"][:, 0] <= S // 2).all()
    again = T.draw_ssod(torch.Generator().manual_seed(T.step_seed(2, 17, 1)),
                        64, S, SSOD_HYP, "cpu")
    assert torch.equal(again["affine"], a)
    assert T.step_seed(2, 17, 0) != T.step_seed(2, 17, 1) != \
        T.step_seed(1, 17, 1)
    m = T.draw_augment(g, 64, S, dict(HYP, mixup=0.5), "cpu")["mix_r"]
    assert 0.35 < float(m.mean()) < 0.65 and float(m.std()) < 0.12


ZERO_HYP = {"mosaic": 0.0, "degrees": 0.0, "translate": 0.0, "scale": 0.0,
            "shear": 0.0, "perspective": 0.0, "hsv_h": 0.0, "hsv_s": 0.0,
            "hsv_v": 0.0, "fliplr": 0.0, "flipud": 0.0, "cutout": 0.0}


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**16))
def test_zero_hyp_is_the_identity(seed):
    images, labels, mask = batch(seed)
    g = torch.Generator().manual_seed(seed)
    out = T.device_augment_batch(g, torch.from_numpy(images),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask), ZERO_HYP,
                                 max_out=M)
    # HSV at gain 0 still goes through float RGB -> HSV -> RGB
    assert_images_close(out[0], images)
    keep = mask & (labels[..., 3] * S > 2) & (labels[..., 4] * S > 2)
    np.testing.assert_array_equal(out[2].numpy().sum(1), keep.sum(1))
    strong, sl, sm, weak, m_s = T.device_ssod_views(
        g, torch.from_numpy(images), torch.from_numpy(labels),
        torch.from_numpy(mask), ZERO_HYP, max_out=M)
    np.testing.assert_array_equal(weak.numpy(), images)
    assert_images_close(strong, images)
    np.testing.assert_allclose(m_s[:, 1:10].numpy(),
                               np.tile(np.eye(3).reshape(9), (B, 1)),
                               atol=1e-6)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**16))
def test_warped_box_encloses_its_warped_rectangle(seed):
    """A filled rectangle (255 on 0, no HSV) warped with the label: every
    pixel the warp left bright lies inside the warped box (1 px slack)."""
    rng = np.random.default_rng(seed)
    s, b = 48, 2
    images = np.zeros((b, s, s, 3), np.uint8)
    labels = np.zeros((b, 1, 5), np.float32)
    for i in range(b):
        x1, y1 = rng.integers(4, 20, 2)
        x2, y2 = x1 + rng.integers(8, 20), y1 + rng.integers(8, 20)
        images[i, y1:y2, x1:x2] = 255
        labels[i, 0, 1:] = [(x1 + x2) / 2 / s, (y1 + y2) / 2 / s,
                            (x2 - x1) / s, (y2 - y1) / s]
    hyp = dict(HYP, mosaic=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0,
               degrees=15.0, shear=5.0, flipud=0.5)
    g = torch.Generator().manual_seed(seed)
    img, lab, keep = T.device_augment_batch(
        g, torch.from_numpy(images), torch.from_numpy(labels),
        torch.ones(b, 1, dtype=torch.bool), hyp, max_out=1)
    for i in range(b):
        if not bool(keep[i, 0]):
            continue
        cx, cy, w, h = (lab[i, 0, 1:] * s).tolist()
        ys, xs = np.nonzero(img[i, ..., 0].numpy() > 200)
        assert (xs >= cx - w / 2 - 1).all() and (xs <= cx + w / 2 + 1).all()
        assert (ys >= cy - h / 2 - 1).all() and (ys <= cy + h / 2 + 1).all()

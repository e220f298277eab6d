"""The port's AutoAugment (`efficientteacher_torch/data/autoaugment.py`)
against the JAX package's cv2 module: every op at several magnitudes,
every sub-policy of every policy table, and the whole entry point, each
fed the same seeded image and boxes and the same `random.Random` state.
The port's images are RGB and the JAX module's BGR, so each port image is
compared with the JAX one's channels reversed. Tolerances: images
byte-equal, boxes within 1e-6 (exact in practice), the generators' states
equal afterwards. Images are 100 x 90: not multiples of cv2's vector
blocks, so its scalar tails run too."""

import random

import numpy as np
import pytest

from efficientteacher_tpu.data import autoaugment as jaa
from efficientteacher_torch.data import autoaugment as paa
from test_torch_host_augment import boxes, photo, rgb

OPS = sorted(set(jaa._IMG_OPS) | set(jaa._GEO_OPS) | set(jaa._BOX_OPS))


def test_the_op_and_policy_tables_are_jaxs():
    assert OPS == sorted(set(paa._IMG_OPS) | set(paa._GEO_OPS)
                         | set(paa._BOX_OPS))
    assert len(OPS) == 25
    assert paa.POLICIES == jaa.POLICIES


@pytest.mark.parametrize("name", OPS)
def test_every_op_matches_jax(name):
    rng = np.random.default_rng(OPS.index(name))
    for level in (0.0, 2.0, 5.0, 10.0):
        for seed in range(3):
            img = photo(rng, 100, 90)
            bx = boxes(rng, int(rng.integers(0, 5)), 90, 100)
            jr, pr = random.Random(seed), random.Random(seed)
            jimg, pimg = img.copy(), rgb(img)
            jb, pb = bx.copy(), bx.copy()
            if "Solarize" in name and "Add" not in name and level == 10:
                # threshold 256: numpy 2.0.2 can crash in the JAX op's
                # `img < 256`; every pixel stays, each box spends a draw
                pimg = (paa._BOX_OPS[name](pimg, level, pb, pr, 3.0)
                        if name in paa._BOX_OPS else
                        paa._IMG_OPS[name](pimg, level, pb, pr))
                np.testing.assert_array_equal(pimg, rgb(img))
                for _ in range(len(bx) if name in jaa._BOX_OPS else 0):
                    jr.random()
                assert pr.getstate() == jr.getstate()
                continue
            if name in jaa._BOX_OPS:
                # prob 3: every box passes its prob/3 gate
                jimg = jaa._BOX_OPS[name](jimg, level, jb, jr, 3.0)
                pimg = paa._BOX_OPS[name](pimg, level, pb, pr, 3.0)
            elif name in jaa._GEO_OPS:
                jimg, jb = jaa._GEO_OPS[name](jimg, level, jb, jr)
                pimg, pb = paa._GEO_OPS[name](pimg, level, pb, pr)
            else:
                jimg = jaa._IMG_OPS[name](jimg, level, jb, jr)
                pimg = paa._IMG_OPS[name](pimg, level, pb, pr)
            np.testing.assert_array_equal(pimg, rgb(jimg),
                                          err_msg=f"{name} {level}")
            np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-6)
            assert pr.getstate() == jr.getstate()


@pytest.mark.parametrize("policy", ["v0", "v1", "v2", "v3", "v4", "v5",
                                    "vtest"])
def test_each_sub_policy_matches_jax(policy, monkeypatch):
    rng = np.random.default_rng(sorted(jaa.POLICIES).index(policy))
    for k, sub in enumerate(jaa.POLICIES[policy]):
        monkeypatch.setitem(jaa.POLICIES, "one", [sub])
        monkeypatch.setitem(paa.POLICIES, "one", [sub])
        for seed in range(4):
            img = photo(rng, 100, 90)
            bx = boxes(rng, int(rng.integers(1, 6)), 90, 100)
            jr, pr = random.Random(seed), random.Random(seed)
            jimg, jb = jaa.distort_image_with_autoaugment(img.copy(),
                                                          bx.copy(), "one",
                                                          jr)
            pimg, pb = paa.distort_image_with_autoaugment(rgb(img), bx.copy(),
                                                          "one", pr)
            np.testing.assert_array_equal(pimg, rgb(jimg),
                                          err_msg=f"{policy}[{k}] {sub}")
            np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-6)
            assert pr.getstate() == jr.getstate()


def test_distort_draws_its_sub_policy_as_jax_does():
    rng = np.random.default_rng(99)
    for seed in range(30):
        img = photo(rng, 100, 90)
        bx = boxes(rng, 4, 90, 100)
        jr, pr = random.Random(seed), random.Random(seed)
        jimg, jb = jaa.distort_image_with_autoaugment(img.copy(), bx.copy(),
                                                      "v5", jr)
        pimg, pb = paa.distort_image_with_autoaugment(rgb(img), bx.copy(),
                                                      "v5", pr)
        np.testing.assert_array_equal(pimg, rgb(jimg))
        np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-6)
        assert pr.getstate() == jr.getstate()
    with pytest.raises(ValueError, match="unknown AutoAugment policy"):
        paa.distort_image_with_autoaugment(rgb(img), bx, "v9",
                                           random.Random(0))

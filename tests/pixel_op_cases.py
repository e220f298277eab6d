"""Fixed cases of the loader core's pixel operations with the sha256 of
cv2 5.0.0's outputs (recorded on an x86-64 host with cv2 5.0.0, the
oracle the JAX package's tests run against), so a machine without that
cv2 can hold the core against it: `chip_smoke.py`'s `[hostaug]` phase on
the card's machine, `test_torch_host_augment.py` here (which also checks
the digests against cv2 itself).

Inputs come from integer arithmetic, not from a seeded generator, so they
are the same under any numpy. Each case is (name, function of the core,
its cv2 call); both take the case's inputs in their own channel order
(the core RGB, cv2 BGR) and the digest is of the output in RGB order.
Imports neither cv2 nor jax."""

import hashlib

import numpy as np


def image(h: int, w: int, k: int) -> np.ndarray:
    """A (h, w, 3) uint8 RGB image, case k: a hashed lattice (noise) over a
    colour gradient that differs per channel."""
    y, x = np.mgrid[0:h, 0:w].astype(np.uint64)
    c = np.arange(3, dtype=np.uint64)
    v = (x[..., None] * np.uint64(7 + 2 * k) + y[..., None] * (13 + c)
         + c * np.uint64(71) + np.uint64(37 * k))
    noise = ((v * np.uint64(2654435761)) >> np.uint64(13)) & np.uint64(63)
    ramp = (x[..., None] * (c + 1) * np.uint64(97) // np.uint64(max(w, 1))
            + y[..., None] * (3 - c) * np.uint64(53) // np.uint64(max(h, 1)))
    return ((noise + ramp) % np.uint64(256)).astype(np.uint8)


def _rgb(a):
    return np.ascontiguousarray(a[..., ::-1]) if a.ndim == 3 else a


def _luts(gains):
    x = np.arange(256.0)
    r = np.asarray(gains)
    return [((x * r[0]) % 180).astype(np.uint8),
            np.clip(x * r[1], 0, 255).astype(np.uint8),
            np.clip(x * r[2], 0, 255).astype(np.uint8)]


_SHARPEN = [[1, 1, 1], [1, 5, 1], [1, 1, 1]]
_MOSAIC = np.array([[0.9, 0.0, -310.0], [0.0, 0.9, -285.0]])
# getRotationMatrix2D((60, 45), 17, 1.1), written out (no libm in the case)
_ROTATE = np.array(
    [[1.051935231559339, 0.32160887519501047, -17.588513277335817],
     [-0.32160887519501047, 1.051935231559339, 16.95944709153037]])
_SHEAR = np.float32([[1, -0.21, 4.5], [0.12, 1, -3.0]])
_PERSP = np.array([[0.95, 0.08, 5.0], [-0.06, 1.02, -7.0],
                   [4e-4, -3e-4, 1.0]])
_GAINS = (1.012, 0.55, 1.31)


def cases():
    """[(name, core(nl, rgb_image), cv2_fn(cv2, bgr_image), image)]."""
    def hsv_core(nl, im):
        out = im.copy()
        nl.augment_hsv(out, *_luts(_GAINS), blue=2)
        return out

    def hsv_cv2(cv2, im):
        h, s, v = cv2.split(cv2.cvtColor(im, cv2.COLOR_BGR2HSV))
        merged = cv2.merge([cv2.LUT(ch, t)
                            for ch, t in zip((h, s, v), _luts(_GAINS))])
        return cv2.cvtColor(merged, cv2.COLOR_HSV2BGR)

    def equalize_core(nl, im):
        from efficientteacher_torch.data.autoaugment import equalize_hist

        return np.stack([equalize_hist(im[..., c]) for c in range(3)], -1)

    def equalize_cv2(cv2, im):
        return np.stack([cv2.equalizeHist(np.ascontiguousarray(im[..., c]))
                         for c in range(3)], -1)

    k = np.float32(_SHARPEN) / 13.0
    return [
        ("warp_affine_mosaic_1280_to_640",
         lambda nl, im: nl.warp(im, _MOSAIC, (640, 640), 114),
         lambda cv2, im: cv2.warpAffine(im, _MOSAIC, (640, 640),
                                        borderValue=(114,) * 3),
         image(1280, 1280, 1)),
        ("warp_affine_rotated",
         lambda nl, im: nl.warp(im, _ROTATE, (171, 133), 128),
         lambda cv2, im: cv2.warpAffine(im, _ROTATE, (171, 133),
                                        borderValue=(128,) * 3),
         image(150, 160, 2)),
        ("warp_affine_sheared_f32",
         lambda nl, im: nl.warp(im, _SHEAR, (131, 97), 128),
         lambda cv2, im: cv2.warpAffine(im, _SHEAR, (131, 97),
                                        borderValue=(128,) * 3),
         image(97, 131, 3)),
        ("warp_perspective",
         lambda nl, im: nl.warp(im, _PERSP, (190, 170), 114),
         lambda cv2, im: cv2.warpPerspective(im, _PERSP, (190, 170),
                                             borderValue=(114,) * 3),
         image(180, 200, 4)),
        ("augment_hsv_640", hsv_core, hsv_cv2, image(640, 640, 5)),
        ("augment_hsv_37_wide", hsv_core, hsv_cv2, image(45, 37, 6)),
        ("gray", lambda nl, im: nl.gray(im, blue=2),
         lambda cv2, im: cv2.cvtColor(im, cv2.COLOR_BGR2GRAY),
         image(100, 90, 7)),
        ("filter2d_sharpness", lambda nl, im: nl.filter3x3(im, _SHARPEN, 13),
         lambda cv2, im: cv2.filter2D(im, -1, k), image(100, 90, 8)),
        ("equalize_hist", equalize_core, equalize_cv2, image(100, 90, 9)),
        ("resize_2s_to_s", lambda nl, im: nl.resize(im, 640, 640),
         lambda cv2, im: cv2.resize(im, (640, 640)), image(1280, 1280, 10)),
        ("resize_2x_up", lambda nl, im: nl.resize(im, 200, 200),
         lambda cv2, im: cv2.resize(im, (200, 200),
                                    interpolation=cv2.INTER_LINEAR),
         image(100, 100, 11)),
    ]


def digest(rgb_out: np.ndarray) -> str:
    a = np.ascontiguousarray(rgb_out)
    return hashlib.sha256(repr(a.shape).encode() + a.tobytes()).hexdigest()


def check_core(nl) -> list:
    """The cases whose core output differs from DIGESTS: (name, digest)."""
    bad = []
    for name, core, _, im in cases():
        got = digest(core(nl, im))
        if got != DIGESTS[name]:
            bad.append((name, got))
    return bad


def cv2_digests(cv2) -> dict:
    """The digests of cv2's outputs (in RGB order) on this machine."""
    return {name: digest(_rgb(fn(cv2, _rgb(im))))
            for name, _, fn, im in cases()}


DIGESTS = {
    "warp_affine_mosaic_1280_to_640":
        "3b2d17c503e1a2dc0bfe78208a3f9e592cdfde26a6f00d4f6b322146ab2e8247",
    "warp_affine_rotated":
        "aebee3f3b95911bb735ea061d09d5821d37bf6e093fbb1b88ea80f48f4a4ccc5",
    "warp_affine_sheared_f32":
        "c2c2b48d53a9e9b76102b90056ea4a10a40aedc51f3dcf2cb19021b4d1d5312d",
    "warp_perspective":
        "79853747ec17677e4559a7b71a7ea9924a6bb8a4cc06ba41ed2e76d6794d0805",
    "augment_hsv_640":
        "44643add6b8349ad854efd77aff9ded6da6f0b53d44a08907d9394d2519b2b48",
    "augment_hsv_37_wide":
        "91ac2474c2cc2de555aea7b6d09b5ebc14c0e3b1461230e8e9e5a9b5b3ab10c2",
    "gray":
        "49bdcb2b4ee4275ec1d7e1fded6cf79defc5c73f71cd31891088181a2cf29f98",
    "filter2d_sharpness":
        "854129d0211904d8d8c9e1e1c01ae315e24f68c7e34b2d8fb9c9dbd3d6ffd99e",
    "equalize_hist":
        "6e0f0c463e3667f7c82a16805078d8a4321d572645bacf29d4e6d392907b28ed",
    "resize_2s_to_s":
        "ccada0a5e6e8d22da2425e60e040acbfb7c2a5881d0e5453b750e020628f7fa3",
    "resize_2x_up":
        "39927f0a21f9f0e7fcdacafb2f3b2081a46c6e2fa48ed6f413084f58b368d994",
}

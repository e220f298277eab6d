"""AutoAugment detection policies v0-v5 without cv2 (counterpart of
`efficientteacher_tpu/data/autoaugment.py`, which fills the role of the
reference's utils/autoaugment_utils.py on the SSOD strong view,
utils/datasets_ssod.py:543). All six policy tables (reference
autoaugment_utils.py:27-169) with the same (op, probability, magnitude
0..10) sub-policy structure: one random sub-policy is applied per call,
each of its ops gated by its probability, drawing from the caller's
`random.Random` exactly as the JAX module draws.

Op families:
  - color ops (Color/Brightness/Contrast/Sharpness/AutoContrast/Equalize/
    Posterize/Solarize/SolarizeAdd/Cutout): pixels only
  - *_BBox full-image geometric ops (TranslateX/Y, ShearX/Y, Rotate): warp
    the whole image with 128-fill and move the box coordinates through the
    same transform (reference translate_bbox/shear_with_bboxes/
    rotate_with_bboxes, autoaugment_utils.py:878-1100)
  - *_Only_BBoxes ops: apply a pixel op inside each box region with
    probability prob/3 (reference _scale_bbox_only_op_probability, :529-541)
  - BBox_Cutout: cutout sized by pad_fraction of one random box, centered
    inside it (reference bbox_cutout, :1306-1350)

Known deviation, kept from the JAX module: the reference's numpy port gates
non-prob ops with a fixed 0.5 coin (`np.floor(rand + 0.5)`, :1532 — a
transcription slip of the TF original's `tf.floor(rand + prob)`); we gate
with the policy's probability as the paper and the TF original do.

The pixel calls are the loader core's (`utils/native_loader.py`): the
affine warp (`warp`), the grey (`gray`) and the 3x3 filter (`filter3x3`),
each bit-equal to the cv2 5.0.0 call of the JAX module; the histogram
equalisation and the LUTs are numpy, in cv2's arithmetic. Images are
uint8 RGB HWC (the JAX module's are BGR: the grey of Color and Contrast
reads the channels reversed; every other op treats the three channels
alike); boxes are (N, 5) [cls, x1, y1, x2, y2] pixels.
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

import numpy as np

from ..utils import native_loader as nl
from .augment import rotation_matrix

_MAX_LEVEL = 10.0
_FILL = 128


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(
        a.astype(np.float32)
        + factor * (b.astype(np.float32) - a.astype(np.float32)),
        0, 255,
    ).astype(np.uint8)


def _enhance_factor(level: float) -> float:
    return level / _MAX_LEVEL * 1.8 + 0.1


# -- color ops (image only) --------------------------------------------------

def op_color(img, level, *_):
    gray = np.repeat(nl.gray(np.ascontiguousarray(img))[..., None], 3, 2)
    return _blend(gray, img, _enhance_factor(level))


def op_brightness(img, level, *_):
    return _blend(np.zeros_like(img), img, _enhance_factor(level))


def op_contrast(img, level, *_):
    mean = int(nl.gray(np.ascontiguousarray(img)).mean() + 0.5)
    return _blend(np.full_like(img, mean), img, _enhance_factor(level))


def op_sharpness(img, level, *_):
    # filter2D with [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13
    smooth = nl.filter3x3(np.ascontiguousarray(img),
                          [[1, 1, 1], [1, 5, 1], [1, 1, 1]], 13)
    return _blend(smooth, img, _enhance_factor(level))


def op_autocontrast(img, *_):
    out = img.copy()
    for c in range(3):
        ch = out[:, :, c]
        lo, hi = int(ch.min()), int(ch.max())
        if hi > lo:
            lut = ((np.arange(256) - lo) * (255.0 / (hi - lo))).clip(0, 255)
            out[:, :, c] = lut.astype(np.uint8)[ch]
    return out


def equalize_hist(ch: np.ndarray) -> np.ndarray:
    """equalizeHist of one uint8 channel, in cv2's arithmetic: the LUT from
    the cumulative histogram past the first occupied bin, scaled in
    float32 by 255 / (total - that bin's count), rounded half to even."""
    hist = np.bincount(ch.ravel(), minlength=256)
    i = int(np.flatnonzero(hist)[0])
    total = ch.size
    if hist[i] == total:
        return np.full_like(ch, i)
    scale = np.float32(255.0) / np.float32(total - hist[i])
    lut = np.zeros(256, np.uint8)
    cum = np.cumsum(hist[i + 1:]).astype(np.float32)
    lut[i + 1:] = np.clip(np.rint(cum * scale), 0, 255)
    return lut[ch]


def op_equalize(img, *_):
    out = img.copy()
    for c in range(3):
        out[:, :, c] = equalize_hist(out[:, :, c])
    return out


def op_posterize(img, level, *_):
    """PIL Posterize: keep `bits` high bits (reference :329-333)."""
    bits = int(level / _MAX_LEVEL * 4)
    shift = 8 - bits
    return np.left_shift(np.right_shift(img, shift), shift)


def _below(img: np.ndarray, thr: int) -> np.ndarray:
    """img < thr for a threshold in [0, 256]: 256 (level 10) keeps every
    pixel. numpy 2.0.2 can crash comparing a large uint8 array with 256, as
    the JAX ops do (no policy table reaches them at level 10 with a
    non-zero probability)."""
    return img < thr if thr <= 255 else np.ones(img.shape, bool)


def op_solarize(img, level, *_):
    # reference level_to_arg: threshold = level/10*256 and solarize inverts
    # pixels >= threshold (autoaugment_utils.py:1448, :321) — HIGHER level
    # means a MILDER effect
    thr = int(level / _MAX_LEVEL * 256)
    return np.where(_below(img, thr), img, 255 - img).astype(np.uint8)


def op_solarize_add(img, level, *_):
    add = int(level / _MAX_LEVEL * 110)
    lifted = np.clip(img.astype(np.int32) + add, 0, 255).astype(np.uint8)
    return np.where(img < 128, lifted, img)


def op_cutout(img, level, boxes, rng):
    size = int(level / _MAX_LEVEL * 100)
    if size <= 0:
        return img
    h, w = img.shape[:2]
    cy, cx = rng.randrange(h), rng.randrange(w)
    y1, y2 = max(0, cy - size // 2), min(h, cy + size // 2)
    x1, x2 = max(0, cx - size // 2), min(w, cx + size // 2)
    img[y1:y2, x1:x2] = 128
    return img


# -- full-image geometric ops that move box coordinates ----------------------

def _warp_boxes(boxes: np.ndarray, m: np.ndarray, w: int, h: int):
    """Map (N, 5) [cls, xyxy] through a 2x3 affine (content transform):
    envelope of the 4 transformed corners, clipped to the image."""
    if len(boxes) == 0:
        return boxes
    xy = np.ones((len(boxes) * 4, 3), np.float32)
    xy[:, :2] = boxes[:, [1, 2, 3, 2, 1, 4, 3, 4]].reshape(-1, 2)
    xy = xy @ m.T  # (4N, 2)
    xy = xy.reshape(len(boxes), 8)
    x = xy[:, [0, 2, 4, 6]]
    y = xy[:, [1, 3, 5, 7]]
    out = boxes.copy()
    out[:, 1] = x.min(1).clip(0, w)
    out[:, 2] = y.min(1).clip(0, h)
    out[:, 3] = x.max(1).clip(0, w)
    out[:, 4] = y.max(1).clip(0, h)
    return out


def _affine_with_boxes(img, boxes, m):
    h, w = img.shape[:2]
    img = nl.warp(img, m, (w, h), _FILL)
    return img, _warp_boxes(boxes, m, w, h)


def _rand_negate(v, rng):
    return -v if rng.random() < 0.5 else v


def op_translate_x_bbox(img, level, boxes, rng):
    """TranslateX_BBox (reference translate_bbox shift_horizontal=True,
    :948-1000): translate_const=250."""
    pix = _rand_negate(level / _MAX_LEVEL * 250.0, rng)
    m = np.float32([[1, 0, -pix], [0, 1, 0]])
    return _affine_with_boxes(img, boxes, m)


def op_translate_y_bbox(img, level, boxes, rng):
    pix = _rand_negate(level / _MAX_LEVEL * 250.0, rng)
    m = np.float32([[1, 0, 0], [0, 1, -pix]])
    return _affine_with_boxes(img, boxes, m)


def op_shear_x_bbox(img, level, boxes, rng):
    """ShearX_BBox (reference shear_with_bboxes, :1052-1100): level
    in +-0.3; PIL AFFINE (1, level, 0, 0, 1, 0) == content x' = x - l*y."""
    lv = _rand_negate(level / _MAX_LEVEL * 0.3, rng)
    m = np.float32([[1, -lv, 0], [0, 1, 0]])
    return _affine_with_boxes(img, boxes, m)


def op_shear_y_bbox(img, level, boxes, rng):
    lv = _rand_negate(level / _MAX_LEVEL * 0.3, rng)
    m = np.float32([[1, 0, 0], [-lv, 1, 0]])
    return _affine_with_boxes(img, boxes, m)


def op_rotate_bbox(img, level, boxes, rng):
    """Rotate_BBox (reference rotate_with_bboxes, :878-892): degrees in
    +-30 about the image center."""
    deg = _rand_negate(level / _MAX_LEVEL * 30.0, rng)
    h, w = img.shape[:2]
    m = rotation_matrix((w / 2.0, h / 2.0), deg, 1.0)
    return _affine_with_boxes(img, boxes, m)


# -- per-box region ops -------------------------------------------------------

def _for_each_box(img, boxes, fn, rng, prob):
    """Apply `fn` to each box's pixel region with probability prob/3
    (reference _scale_bbox_only_op_probability, :529-541)."""
    p = prob / 3.0
    for b in boxes:
        if rng.random() > p:
            continue
        x1, y1, x2, y2 = (int(v) for v in b[1:5])
        x1, y1 = max(0, x1), max(0, y1)
        x2, y2 = min(img.shape[1], x2), min(img.shape[0], y2)
        if x2 - x1 < 2 or y2 - y1 < 2:
            continue
        img[y1:y2, x1:x2] = fn(img[y1:y2, x1:x2])
    return img


def op_translate_x_only_bboxes(img, level, boxes, rng, prob):
    pix = level / _MAX_LEVEL * 120.0

    def shift(patch):
        d = _rand_negate(pix, rng)
        m = np.float32([[1, 0, -d], [0, 1, 0]])
        h, w = patch.shape[:2]
        return nl.warp(patch, m, (w, h), _FILL)

    return _for_each_box(img, boxes, shift, rng, prob)


def op_translate_y_only_bboxes(img, level, boxes, rng, prob):
    pix = level / _MAX_LEVEL * 120.0

    def shift(patch):
        d = _rand_negate(pix, rng)
        m = np.float32([[1, 0, 0], [0, 1, -d]])
        h, w = patch.shape[:2]
        return nl.warp(patch, m, (w, h), _FILL)

    return _for_each_box(img, boxes, shift, rng, prob)


def op_shear_x_only_bboxes(img, level, boxes, rng, prob):
    mag = level / _MAX_LEVEL * 0.3

    def shear(patch):
        h, w = patch.shape[:2]
        m = np.float32([[1, -_rand_negate(mag, rng), 0], [0, 1, 0]])
        return nl.warp(patch, m, (w, h), _FILL)

    return _for_each_box(img, boxes, shear, rng, prob)


def op_shear_y_only_bboxes(img, level, boxes, rng, prob):
    mag = level / _MAX_LEVEL * 0.3

    def shear(patch):
        h, w = patch.shape[:2]
        m = np.float32([[1, 0, 0], [-_rand_negate(mag, rng), 1, 0]])
        return nl.warp(patch, m, (w, h), _FILL)

    return _for_each_box(img, boxes, shear, rng, prob)


def op_rotate_only_bboxes(img, level, boxes, rng, prob):
    deg = level / _MAX_LEVEL * 30.0

    def rot(patch):
        h, w = patch.shape[:2]
        m = rotation_matrix((w / 2.0, h / 2.0), _rand_negate(deg, rng), 1.0)
        return nl.warp(patch, m, (w, h), _FILL)

    return _for_each_box(img, boxes, rot, rng, prob)


def op_flip_only_bboxes(img, level, boxes, rng, prob):
    return _for_each_box(img, boxes, lambda p: p[:, ::-1], rng, prob)


def op_solarize_only_bboxes(img, level, boxes, rng, prob):
    thr = int(level / _MAX_LEVEL * 256)

    def sol(patch):
        return np.where(_below(patch, thr), patch,
                        255 - patch).astype(np.uint8)

    return _for_each_box(img, boxes, sol, rng, prob)


def op_equalize_only_bboxes(img, level, boxes, rng, prob):
    def eq(patch):
        out = patch.copy()
        for c in range(3):
            out[:, :, c] = equalize_hist(out[:, :, c])
        return out

    return _for_each_box(img, boxes, eq, rng, prob)


def op_cutout_only_bboxes(img, level, boxes, rng, prob):
    size = int(level / _MAX_LEVEL * 50)

    def cut(patch):
        h, w = patch.shape[:2]
        if size and h > 2 and w > 2:
            cy, cx = rng.randrange(h), rng.randrange(w)
            y1, y2 = max(0, cy - size // 2), min(h, cy + size // 2)
            x1, x2 = max(0, cx - size // 2), min(w, cx + size // 2)
            patch[y1:y2, x1:x2] = 128
        return patch

    return _for_each_box(img, boxes, cut, rng, prob)


def op_bbox_cutout(img, level, boxes, rng):
    """BBox_Cutout (reference bbox_cutout, :1306-1350): one random box, a
    cutout of pad_fraction * box size centered at a random point inside it,
    applied to the FULL image (can spill outside the box)."""
    pad_fraction = level / _MAX_LEVEL * 0.75
    if len(boxes) == 0 or pad_fraction <= 0:
        return img
    h, w = img.shape[:2]
    b = boxes[rng.randrange(len(boxes))]
    x1, y1 = max(0, int(b[1])), max(0, int(b[2]))
    x2, y2 = min(w, int(b[3])), min(h, int(b[4]))
    if x2 - x1 < 1 or y2 - y1 < 1:
        return img
    ph = int(pad_fraction * (y2 - y1) / 2)
    pw = int(pad_fraction * (x2 - x1) / 2)
    cy = rng.randrange(y1, y2)
    cx = rng.randrange(x1, x2)
    img[max(0, cy - ph):min(h, cy + ph), max(0, cx - pw):min(w, cx + pw)] = 128
    return img


# ops whose function signature is (img, level, boxes, rng) -> img
_IMG_OPS = {
    "Color": op_color,
    "Brightness": op_brightness,
    "Contrast": op_contrast,
    "Sharpness": op_sharpness,
    "AutoContrast": op_autocontrast,
    "Equalize": op_equalize,
    "Posterize": op_posterize,
    "Solarize": op_solarize,
    "SolarizeAdd": op_solarize_add,
    "Cutout": op_cutout,
    "BBox_Cutout": op_bbox_cutout,
}

# ops returning (img, boxes)
_GEO_OPS = {
    "TranslateX_BBox": op_translate_x_bbox,
    "TranslateY_BBox": op_translate_y_bbox,
    "ShearX_BBox": op_shear_x_bbox,
    "ShearY_BBox": op_shear_y_bbox,
    "Rotate_BBox": op_rotate_bbox,
}

# ops taking (img, level, boxes, rng, prob) -> img, self-gated per box
_BOX_OPS = {
    "TranslateX_Only_BBoxes": op_translate_x_only_bboxes,
    "TranslateY_Only_BBoxes": op_translate_y_only_bboxes,
    "ShearX_Only_BBoxes": op_shear_x_only_bboxes,
    "ShearY_Only_BBoxes": op_shear_y_only_bboxes,
    "Rotate_Only_BBoxes": op_rotate_only_bboxes,
    "Flip_Only_BBoxes": op_flip_only_bboxes,
    "Solarize_Only_BBoxes": op_solarize_only_bboxes,
    "Equalize_Only_BBoxes": op_equalize_only_bboxes,
    "Cutout_Only_BBoxes": op_cutout_only_bboxes,
}

SubPolicy = List[Tuple[str, float, int]]

# reference policy_v0 (autoaugment_utils.py:27-40)
POLICY_V0: List[SubPolicy] = [
    [("TranslateX_BBox", 0.6, 4), ("Equalize", 0.8, 10)],
    [("TranslateY_Only_BBoxes", 0.2, 2), ("Cutout", 0.8, 8)],
    [("Sharpness", 0.0, 8), ("ShearX_BBox", 0.4, 0)],
    [("ShearY_BBox", 1.0, 2), ("TranslateY_Only_BBoxes", 0.6, 6)],
    [("Rotate_BBox", 0.6, 10), ("Color", 1.0, 6)],
]

# reference policy_v1 (:42-69)
POLICY_V1: List[SubPolicy] = [
    [("TranslateX_BBox", 0.6, 4), ("Equalize", 0.8, 10)],
    [("TranslateY_Only_BBoxes", 0.2, 2), ("Cutout", 0.8, 8)],
    [("Sharpness", 0.0, 8), ("ShearX_BBox", 0.4, 0)],
    [("ShearY_BBox", 1.0, 2), ("TranslateY_Only_BBoxes", 0.6, 6)],
    [("Rotate_BBox", 0.6, 10), ("Color", 1.0, 6)],
    [("Color", 0.0, 0), ("ShearX_Only_BBoxes", 0.8, 4)],
    [("ShearY_Only_BBoxes", 0.8, 2), ("Flip_Only_BBoxes", 0.0, 10)],
    [("Equalize", 0.6, 10), ("TranslateX_BBox", 0.2, 2)],
    [("Color", 1.0, 10), ("TranslateY_Only_BBoxes", 0.4, 6)],
    [("Rotate_BBox", 0.8, 10), ("Contrast", 0.0, 10)],
    [("Cutout", 0.2, 2), ("Brightness", 0.8, 10)],
    [("Color", 1.0, 6), ("Equalize", 1.0, 2)],
    [("Cutout_Only_BBoxes", 0.4, 6), ("TranslateY_Only_BBoxes", 0.8, 2)],
    [("Color", 0.2, 8), ("Rotate_BBox", 0.8, 10)],
    [("Sharpness", 0.4, 4), ("TranslateY_Only_BBoxes", 0.0, 4)],
    [("Sharpness", 1.0, 4), ("SolarizeAdd", 0.4, 4)],
    [("Rotate_BBox", 1.0, 8), ("Sharpness", 0.2, 8)],
    [("ShearY_BBox", 0.6, 10), ("Equalize_Only_BBoxes", 0.6, 8)],
    [("ShearX_BBox", 0.2, 6), ("TranslateY_Only_BBoxes", 0.2, 10)],
    [("SolarizeAdd", 0.6, 8), ("Brightness", 0.8, 10)],
]

# reference policy_v2 (:135-167)
POLICY_V2: List[SubPolicy] = [
    [("Color", 0.0, 6), ("Cutout", 0.6, 8), ("Sharpness", 0.4, 8)],
    [("Rotate_BBox", 0.4, 8), ("Sharpness", 0.4, 2),
     ("Rotate_BBox", 0.8, 10)],
    [("TranslateY_BBox", 1.0, 8), ("AutoContrast", 0.8, 2)],
    [("AutoContrast", 0.4, 6), ("ShearX_BBox", 0.8, 8),
     ("Brightness", 0.0, 10)],
    [("SolarizeAdd", 0.2, 6), ("Contrast", 0.0, 10), ("AutoContrast", 0.6, 0)],
    [("Cutout", 0.2, 0), ("Solarize", 0.8, 8), ("Color", 1.0, 4)],
    [("TranslateY_BBox", 0.0, 4), ("Equalize", 0.6, 8),
     ("Solarize", 0.0, 10)],
    [("TranslateY_BBox", 0.2, 2), ("ShearY_BBox", 0.8, 8),
     ("Rotate_BBox", 0.8, 8)],
    [("Cutout", 0.8, 8), ("Brightness", 0.8, 8), ("Cutout", 0.2, 2)],
    [("Color", 0.8, 4), ("TranslateY_BBox", 1.0, 6), ("Rotate_BBox", 0.6, 6)],
    [("Rotate_BBox", 0.6, 10), ("Cutout_Only_BBoxes", 1.0, 4),
     ("Cutout", 0.2, 8)],
    [("Rotate_BBox", 0.0, 0), ("Equalize", 0.6, 6), ("ShearY_BBox", 0.6, 8)],
    [("Brightness", 0.8, 8), ("AutoContrast", 0.4, 2),
     ("Brightness", 0.2, 2)],
    [("TranslateY_BBox", 0.4, 8), ("Solarize", 0.4, 6),
     ("SolarizeAdd", 0.2, 10)],
    [("Contrast", 1.0, 10), ("SolarizeAdd", 0.2, 8), ("Equalize", 0.2, 4)],
]

# reference policy_v3 (:169-192)
POLICY_V3: List[SubPolicy] = [
    [("Posterize", 0.8, 2), ("TranslateX_BBox", 1.0, 8)],
    [("BBox_Cutout", 0.2, 10), ("Sharpness", 1.0, 8)],
    [("Rotate_BBox", 0.6, 8), ("Rotate_BBox", 0.8, 10)],
    [("Equalize", 0.8, 10), ("AutoContrast", 0.2, 10)],
    [("SolarizeAdd", 0.2, 2), ("TranslateY_BBox", 0.2, 8)],
    [("Sharpness", 0.0, 2), ("Color", 0.4, 8)],
    [("Equalize", 1.0, 8), ("TranslateY_BBox", 1.0, 8)],
    [("Posterize", 0.6, 2), ("Rotate_BBox", 0.0, 10)],
    [("AutoContrast", 0.6, 0), ("Rotate_BBox", 1.0, 6)],
    [("Equalize", 0.0, 4), ("Cutout", 0.8, 10)],
    [("Brightness", 1.0, 2), ("TranslateY_BBox", 1.0, 6)],
    [("Contrast", 0.0, 2), ("ShearY_BBox", 0.8, 0)],
    [("AutoContrast", 0.8, 10), ("Contrast", 0.2, 10)],
    [("Rotate_BBox", 1.0, 10), ("Cutout", 1.0, 10)],
    [("SolarizeAdd", 0.8, 6), ("Equalize", 0.8, 8)],
]

# reference policy_v4 (:80-104)
POLICY_V4: List[SubPolicy] = [
    [("Color", 0.0, 6), ("Cutout", 0.6, 8), ("Sharpness", 0.4, 8)],
    [("Sharpness", 0.4, 2)],
    [("TranslateY_BBox", 1.0, 8), ("AutoContrast", 0.8, 2)],
    [("AutoContrast", 0.4, 6), ("ShearX_BBox", 0.8, 8),
     ("Brightness", 0.0, 10)],
    [("SolarizeAdd", 0.2, 6), ("Contrast", 0.0, 10), ("AutoContrast", 0.6, 0)],
    [("Cutout", 0.2, 0), ("Solarize", 0.8, 8), ("Color", 1.0, 4)],
    [("Equalize", 0.6, 8), ("Solarize", 0.0, 10)],
    [("Cutout", 0.8, 8), ("Brightness", 0.8, 8), ("Cutout", 0.2, 2)],
    [("Color", 0.8, 4)],
    [("BBox_Cutout", 1.0, 4), ("Cutout", 0.2, 8)],
    [("Equalize", 0.6, 6)],
    [("Brightness", 0.8, 8), ("AutoContrast", 0.4, 2),
     ("Brightness", 0.2, 2)],
    [("Solarize", 0.4, 6), ("SolarizeAdd", 0.2, 10)],
    [("Contrast", 1.0, 10), ("SolarizeAdd", 0.2, 8), ("Equalize", 0.2, 4)],
]

# reference policy_v5 (:106-134) — the shipped default
POLICY_V5: List[SubPolicy] = [
    [("Color", 0.0, 6), ("Cutout", 0.6, 8), ("Sharpness", 0.4, 8)],
    [("TranslateY_Only_BBoxes", 1.0, 8), ("AutoContrast", 0.8, 2)],
    [("AutoContrast", 0.4, 6), ("ShearX_Only_BBoxes", 0.8, 8),
     ("Brightness", 0.0, 10)],
    [("SolarizeAdd", 0.2, 6), ("Contrast", 0.0, 10), ("AutoContrast", 0.6, 0)],
    [("Cutout", 0.2, 0), ("Solarize", 0.8, 8), ("Color", 1.0, 4)],
    [("Equalize", 0.6, 8), ("Solarize", 0.0, 10)],
    [("Cutout", 0.8, 8), ("Brightness", 0.8, 8), ("Cutout", 0.2, 2)],
    [("Color", 0.8, 4), ("TranslateY_Only_BBoxes", 1.0, 6)],
    [("Cutout_Only_BBoxes", 1.0, 1), ("Cutout", 0.2, 1)],
    [("Equalize", 0.6, 6)],
    [("Brightness", 0.8, 8), ("AutoContrast", 0.4, 2),
     ("Brightness", 0.2, 2)],
    [("TranslateY_Only_BBoxes", 0.4, 8), ("Solarize", 0.4, 6),
     ("SolarizeAdd", 0.2, 10)],
    [("Contrast", 1.0, 10), ("SolarizeAdd", 0.2, 8), ("Equalize", 0.2, 4)],
]

# reference policy_vtest (:72-78)
POLICY_VTEST: List[SubPolicy] = [
    [("TranslateX_BBox", 1.0, 4), ("Equalize", 1.0, 10)],
]

POLICIES = {
    "v0": POLICY_V0,
    "v1": POLICY_V1,
    "v2": POLICY_V2,
    "v3": POLICY_V3,
    "v4": POLICY_V4,
    "v5": POLICY_V5,
    "vtest": POLICY_VTEST,
}


def distort_image_with_autoaugment(
    img: np.ndarray,
    boxes: np.ndarray,
    policy: str = "v5",
    rng: Optional[random.Random] = None,
):
    """Apply one random sub-policy of `policy`. Returns (img, boxes) — boxes
    may move (the *_BBox geometric ops). Mirrors the reference entry point
    distort_image_with_autoaugment (autoaugment_utils.py:1586-1608)."""
    rng = rng or random
    table = POLICIES.get(policy)
    if table is None:
        raise ValueError(f"unknown AutoAugment policy {policy!r}; "
                         f"have {sorted(POLICIES)}")
    sub = rng.choice(table)
    for name, prob, level in sub:
        if name in _BOX_OPS:  # self-gated per box at prob/3
            img = _BOX_OPS[name](img, float(level), boxes, rng, prob)
            continue
        if rng.random() > prob:
            continue
        if name in _GEO_OPS:
            img, boxes = _GEO_OPS[name](img, float(level), boxes, rng)
        else:
            img = _IMG_OPS[name](img, float(level), boxes, rng)
    return img, boxes

"""Host-side image augmentation without cv2 (counterpart of
`efficientteacher_tpu/data/augment.py`; reference utils/augmentations.py
and utils/datasets.py):
  - letterbox: reference augmentations.py:92-123
  - HSV jitter: augmentations.py:48-60
  - random_perspective, M = T @ S @ R @ P @ C with the label warp and the
    candidate filter: augmentations.py:125-267, 269-356, 417-422
  - mosaic-4 and mosaic-9: datasets.py:1219-1400; mixup: augmentations.py:
    409-415; cutout: augmentations.py:382-407; copy_paste (boxes only)
The draws are the JAX module's, in its order, from the `random.Random`
the caller passes, so the same generator state gives the same image.

The pixel work is the loader core's (`utils/native_loader.py`,
`csrc/pixel_ops.h`): the resize, warpAffine / warpPerspective and the HSV
round trip, each bit-equal to the cv2 5.0.0 call the JAX module makes.
getRotationMatrix2D's arithmetic is done here in double, as cv2 does it.

Images are RGB (the JAX module's are BGR until its dataset's
`__getitem__` ends): cv2's BGR formulas run on the channels reversed
(`augment_hsv`), and cutout's three colour draws, which JAX assigns to
B, G, R, land on the same channels here. Labels are (N, 5) [cls, x1, y1,
x2, y2] in pixels during augmentation.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Tuple

import numpy as np

from ..utils import native_loader as nl


def letterbox_geometry(shape_hw, new_shape, auto: bool = False,
                       scale_fill: bool = False, scaleup: bool = True,
                       stride: int = 32):
    """The letterbox of an image of `shape_hw` (h, w) into `new_shape`
    (int or (h, w)): ((rh, rw), (dw, dh), (new_w, new_h), (top, bottom,
    left, right)), the numbers of the JAX `letterbox`."""
    h, w = shape_hw
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / h, new_shape[1] / w)
    if not scaleup:
        r = min(r, 1.0)
    ratio = (r, r)
    new_unpad = (int(round(w * r)), int(round(h * r)))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    elif scale_fill:
        dw, dh = 0, 0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / w, new_shape[0] / h)
    dw /= 2
    dh /= 2
    border = (int(round(dh - 0.1)), int(round(dh + 0.1)),
              int(round(dw - 0.1)), int(round(dw + 0.1)))
    return ratio, (dw, dh), new_unpad, border


def letterbox(img: np.ndarray, new_shape=(640, 640), color: int = 114,
              auto: bool = False, scale_fill: bool = False,
              scaleup: bool = True, stride: int = 32,
              out: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, tuple, tuple]:
    """Resize + pad `img` (h, w, 3) uint8 to `new_shape` preserving its
    aspect ratio. Returns (img, (rh, rw), (dw, dh)). The pad is one grey
    value (the JAX version's `color` is always (114, 114, 114)). `out`, if
    given, is the canvas to write into (its shape must be the result's)."""
    ratio, pad, (nw, nh), (top, bottom, left, right) = letterbox_geometry(
        img.shape[:2], new_shape, auto, scale_fill, scaleup, stride)
    shape = (nh + top + bottom, nw + left + right, 3)
    if out is None:
        out = np.empty(shape, np.uint8)
    elif out.shape != shape:
        raise ValueError(f"canvas {out.shape} for a letterbox of {shape}")
    nl.resize_letterbox(np.ascontiguousarray(img), out, top, left, nw, nh,
                        pad_value=int(color))
    return out, ratio, pad


def augment_hsv(img: np.ndarray, hgain=0.5, sgain=0.5, vgain=0.5,
                rng: Optional[random.Random] = None) -> None:
    """In-place random HSV jitter of the RGB `img` (reference
    augmentations.py:48-60): the JAX LUTs, applied by the loader core."""
    rng = rng or random
    if not (hgain or sgain or vgain):
        return
    r = np.array([rng.uniform(-1, 1) for _ in range(3)]) \
        * [hgain, sgain, vgain] + 1
    x = np.arange(0, 256, dtype=r.dtype)
    lut_hue = ((x * r[0]) % 180).astype(img.dtype)
    lut_sat = np.clip(x * r[1], 0, 255).astype(img.dtype)
    lut_val = np.clip(x * r[2], 0, 255).astype(img.dtype)
    nl.augment_hsv(img, lut_hue, lut_sat, lut_val, blue=2)


def box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr=2.0,
                   ar_thr=20.0, area_thr=0.1, eps=1e-16) -> np.ndarray:
    """Keep boxes that survive an affine warp (reference augmentations.py:
    417). box1/box2: (4, N) xyxy before/after."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def rotation_matrix(center, angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center, angle, scale) (2, 3) float64, in
    cv2's arithmetic (the centre as float32, as cv2's Point2f)."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = angle * (math.pi / 180)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def build_affine(width: int, height: int, degrees=0.0, translate=0.1,
                 scale=0.5, shear=0.0, perspective=0.0, border=(0, 0),
                 rng: Optional[random.Random] = None
                 ) -> Tuple[np.ndarray, float]:
    """Random affine M (3x3) and its scale factor s. Composition order
    T @ S @ R @ P @ C mirrors reference augmentations.py:278-303."""
    rng = rng or random
    C = np.eye(3)
    C[0, 2] = -width / 2
    C[1, 2] = -height / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = rotation_matrix((0, 0), a, s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    out_w = width + border[1] * 2
    out_h = height + border[0] * 2
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * out_w
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * out_h
    M = T @ S @ R @ P @ C
    return M, s


def warp_boxes(boxes_xyxy: np.ndarray, M: np.ndarray, width: int,
               height: int, perspective: bool = False) -> np.ndarray:
    """Transform xyxy boxes by 3x3 M, taking the enclosing box of the 4
    warped corners (reference augmentations.py:318-337)."""
    n = len(boxes_xyxy)
    if n == 0:
        return boxes_xyxy
    xy = np.ones((n * 4, 3))
    xy[:, :2] = boxes_xyxy[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
    xy = xy @ M.T
    if perspective:
        xy = (xy[:, :2] / xy[:, 2:3]).reshape(n, 8)
    else:
        xy = xy[:, :2].reshape(n, 8)
    x = xy[:, [0, 2, 4, 6]]
    y = xy[:, [1, 3, 5, 7]]
    new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)],
                   axis=1).astype(boxes_xyxy.dtype)
    new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
    new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
    return new


def warp_image(img: np.ndarray, M: np.ndarray, dsize, perspective: bool,
               border: int = 114) -> np.ndarray:
    """cv2.warpPerspective(img, M, dsize) when `perspective`, else
    cv2.warpAffine(img, M[:2], dsize), with a grey border."""
    return nl.warp(np.ascontiguousarray(img), M if perspective else M[:2],
                   dsize, border)


def random_perspective(img: np.ndarray, targets: np.ndarray, degrees=0.0,
                       translate=0.1, scale=0.5, shear=0.0, perspective=0.0,
                       border=(0, 0), rng: Optional[random.Random] = None,
                       return_M: bool = False):
    """Warp image + labels by a random affine (reference augmentations.py:
    269). border < 0 crops a mosaic canvas down to the train size. With
    return_M, also returns (M, s) for the SSOD transform record."""
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2
    M, s = build_affine(img.shape[1], img.shape[0], degrees, translate,
                        scale, shear, perspective, border, rng)
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        img = warp_image(img, M, (width, height), bool(perspective))
    if len(targets):
        old = targets[:, 1:5].copy()
        new = warp_boxes(old, M, width, height, perspective > 0)
        keep = box_candidates(old.T * s, new.T, area_thr=0.1)
        targets = targets[keep]
        targets[:, 1:5] = new[keep]
    if return_M:
        return img, targets, M, s
    return img, targets


def mosaic4(images: List[np.ndarray], labels: List[np.ndarray],
            img_size: int, rng: Optional[random.Random] = None):
    """Compose 4 images on a 2x2 canvas at a random center (reference
    utils/datasets.py:1219-1313). Returns canvas (2s, 2s, 3) and merged
    pixel-space labels; the caller applies random_perspective with
    border=(-s//2, -s//2) to crop to train size."""
    rng = rng or random
    s = img_size
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    canvas = np.full((s * 2, s * 2, 3), 114, np.uint8)
    out_labels = []
    for i in range(4):
        img = images[i]
        h, w = img.shape[:2]
        (x1a, y1a, x2a, y2a), (x1b, y1b, x2b, y2b) = mosaic4_tile(
            i, xc, yc, w, h, s)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        if len(labels[i]):
            lb = labels[i].copy()
            lb[:, [1, 3]] += padw
            lb[:, [2, 4]] += padh
            out_labels.append(lb)
    if out_labels:
        merged = np.concatenate(out_labels, 0)
        np.clip(merged[:, 1:5], 0, 2 * s, out=merged[:, 1:5])
    else:
        merged = np.zeros((0, 5), np.float32)
    return canvas, merged


def mosaic4_tile(i: int, xc: int, yc: int, w: int, h: int, s: int):
    """Tile i's rectangle on the 2s canvas and the part of its (h, w) image
    that lands there: ((x1a, y1a, x2a, y2a), (x1b, y1b, x2b, y2b))."""
    if i == 0:  # top-left
        a = (max(xc - w, 0), max(yc - h, 0), xc, yc)
        b = (w - (a[2] - a[0]), h - (a[3] - a[1]), w, h)
    elif i == 1:  # top-right
        a = (xc, max(yc - h, 0), min(xc + w, s * 2), yc)
        b = (0, h - (a[3] - a[1]), min(w, a[2] - a[0]), h)
    elif i == 2:  # bottom-left
        a = (max(xc - w, 0), yc, xc, min(s * 2, yc + h))
        b = (w - (a[2] - a[0]), 0, w, min(a[3] - a[1], h))
    else:  # bottom-right
        a = (xc, yc, min(xc + w, s * 2), min(s * 2, yc + h))
        b = (0, 0, min(w, a[2] - a[0]), min(a[3] - a[1], h))
    return a, b


def mixup(img1, labels1, img2, labels2,
          rng: Optional[random.Random] = None):
    """Beta(32, 32) image blend (reference augmentations.py:409-415), drawn
    from `rng` when given (else numpy's global generator, as in JAX)."""
    r = rng.betavariate(32.0, 32.0) if rng is not None \
        else np.random.beta(32.0, 32.0)
    img = (img1 * r + img2 * (1 - r)).astype(np.uint8)
    return img, np.concatenate([labels1, labels2], 0)


def cutout(img: np.ndarray, labels: np.ndarray,
           rng: Optional[random.Random] = None) -> np.ndarray:
    """Random occlusion squares (reference augmentations.py:382-407) on the
    RGB `img`: each square's colour draws are JAX's B, G, R."""
    rng = rng or random
    h, w = img.shape[:2]
    scales = [0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 \
        + [0.03125] * 16
    for sc in scales:
        mask_h = rng.randint(1, int(h * sc))
        mask_w = rng.randint(1, int(w * sc))
        xmin = max(0, rng.randint(0, w) - mask_w // 2)
        ymin = max(0, rng.randint(0, h) - mask_h // 2)
        xmax = min(w, xmin + mask_w)
        ymax = min(h, ymin + mask_h)
        bgr = [rng.randint(64, 191) for _ in range(3)]
        img[ymin:ymax, xmin:xmax] = bgr[::-1]
    return labels


def hflip_labels(labels_xyxy: np.ndarray, width: int) -> np.ndarray:
    out = labels_xyxy.copy()
    out[:, 1] = width - labels_xyxy[:, 3]
    out[:, 3] = width - labels_xyxy[:, 1]
    return out


def vflip_labels(labels_xyxy: np.ndarray, height: int) -> np.ndarray:
    out = labels_xyxy.copy()
    out[:, 2] = height - labels_xyxy[:, 4]
    out[:, 4] = height - labels_xyxy[:, 2]
    return out


def copy_paste(img: np.ndarray, labels: np.ndarray, p: float = 0.5,
               rng: Optional[random.Random] = None):
    """Box-level copy-paste (reference augmentations.py:358-380 without
    segments, as in JAX): horizontally mirrored object patches pasted at
    the mirrored location when their IoA with the existing boxes is
    low."""
    rng = rng or random
    n = len(labels)
    if p <= 0 or n == 0:
        return img, labels
    h, w = img.shape[:2]
    new_rows = []
    for row in labels[rng.sample(range(n), k=max(1, round(p * n)))]:
        cls, x1, y1, x2, y2 = row[:5]
        nx1, nx2 = w - x2, w - x1
        box = np.array([nx1, y1, nx2, y2])
        ioa = bbox_ioa(box, labels[:, 1:5])
        if (ioa < 0.30).all():
            xi1, yi1, xi2, yi2 = (int(v) for v in (x1, y1, x2, y2))
            if xi2 - xi1 < 2 or yi2 - yi1 < 2:
                continue
            patch = img[yi1:yi2, xi1:xi2][:, ::-1]
            di1, di2 = int(nx1), int(nx1) + patch.shape[1]
            if di2 <= w:
                img[yi1:yi1 + patch.shape[0], di1:di2] = patch
                new = row.copy()
                new[1], new[3] = nx1, nx2
                new_rows.append(new)
    if new_rows:
        labels = np.concatenate([labels, np.stack(new_rows)], 0)
    return img, labels


def bbox_ioa(box1: np.ndarray, box2: np.ndarray,
             eps: float = 1e-7) -> np.ndarray:
    """Intersection over box2 area (reference metrics.py:277; JAX
    `bbox_ioa_np`)."""
    ix = (np.minimum(box1[2], box2[:, 2])
          - np.maximum(box1[0], box2[:, 0])).clip(0)
    iy = (np.minimum(box1[3], box2[:, 3])
          - np.maximum(box1[1], box2[:, 1])).clip(0)
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1]) + eps
    return ix * iy / area2


def mosaic9(images: List[np.ndarray], labels: List[np.ndarray],
            img_size: int, rng: Optional[random.Random] = None):
    """Compose 9 images on a 3x3 canvas (reference utils/datasets.py:
    1314-1400 load_mosaic9): images tile around the first, the canvas is
    randomly cropped to 2s x 2s. The caller applies random_perspective with
    border=(-s//2, -s//2) like mosaic-4."""
    rng = rng or random
    s = img_size
    canvas = np.full((s * 3, s * 3, 3), 114, np.uint8)
    out_labels = []
    hp = wp = -1  # previous tile dims
    h0 = w0 = 0
    for i in range(9):
        img = images[i]
        h, w = img.shape[:2]
        if i == 0:      # center
            c = s, s, s + w, s + h
        elif i == 1:    # top
            c = s, s - h, s + w, s
        elif i == 2:    # top right
            c = s + wp, s - h, s + wp + w, s
        elif i == 3:    # right
            c = s + w0, s, s + w0 + w, s + h
        elif i == 4:    # bottom right
            c = s + w0, s + hp, s + w0 + w, s + hp + h
        elif i == 5:    # bottom
            c = s + w0 - w, s + h0, s + w0, s + h0 + h
        elif i == 6:    # bottom left
            c = s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h
        elif i == 7:    # left
            c = s - w, s + h0 - h, s, s + h0
        else:           # top left
            c = s - w, s + h0 - hp - h, s, s + h0 - hp
        padx, pady = c[:2]
        x1, y1, x2, y2 = (max(v, 0) for v in c)
        canvas[y1:y2, x1:x2] = img[y1 - pady:, x1 - padx:][:y2 - y1, :x2 - x1]
        if len(labels[i]):
            lb = labels[i].copy()
            lb[:, [1, 3]] += padx
            lb[:, [2, 4]] += pady
            out_labels.append(lb)
        hp, wp = h, w
        if i == 0:
            h0, w0 = h, w
    yc = int(rng.uniform(0, s))  # random 2s x 2s crop
    xc = int(rng.uniform(0, s))
    canvas = canvas[yc:yc + 2 * s, xc:xc + 2 * s]
    if out_labels:
        merged = np.concatenate(out_labels, 0)
        merged[:, [1, 3]] -= xc
        merged[:, [2, 4]] -= yc
        np.clip(merged[:, 1:5], 0, 2 * s, out=merged[:, 1:5])
        keep = (merged[:, 3] - merged[:, 1] > 2) \
            & (merged[:, 4] - merged[:, 2] > 2)
        merged = merged[keep]
    else:
        merged = np.zeros((0, 5), np.float32)
    return canvas, merged

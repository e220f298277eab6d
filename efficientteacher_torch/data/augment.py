"""Host-side letterbox (counterpart of `letterbox` in
`efficientteacher_tpu/data/augment.py`, reference
utils/augmentations.py:92-123), without cv2: the resize is the loader
core's, bit-equal to cv2.resize INTER_LINEAR (`utils/native_loader.py`).

The JAX module's cv2 augmentations (`random_perspective`, `augment_hsv`,
`mosaic4`, `mixup`, `copy_paste`, `mosaic9`, `cutout`) and
`data/autoaugment.py` are not ported (ROADMAP, "Next, in order" item
2.7): under `Dataset.device_aug` their work runs on the card
(`ops/augment_device.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

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

"""Box, point and label drawing without cv2: the port's counterparts of the
cv2 calls of JAX's `detect.py` and `Detections.render`
(`cv2.rectangle(img, p1, p2, color, 2)`, `cv2.circle(img, p, 3, color,
-1)` and `cv2.putText(img, label, org, FONT_HERSHEY_SIMPLEX, 0.5, color,
1)`). Every pixel is what cv2 5.0.0 draws on the same canvas
(`tests/test_torch_loaders_detect.py`, `tests/test_torch_text.py`).

cv2 draws a thickness-2 rectangle as four 3-pixel bands centred on its
edges, with a 1-pixel round cap at each corner: the box [x0 - 1, x1 + 1] x
[y0 - 1, y1 + 1] less its four corner pixels and less the inside [x0 + 2,
x1 - 2] x [y0 + 2, y1 - 2]. A filled circle of radius 3 is `_DISC`. Both
are clipped to the canvas.

Label text: cv2 5.0 draws no Hershey strokes. Probes of cv2.putText showed
that FONT_HERSHEY_SIMPLEX at scale 0.5 and thickness 1 is its built-in
TrueType font Rubik at 14 px and weight 400 (thickness 2 is heavier), that
the text is anti-aliased (197 colours, black included, in "person 0.87"
drawn white on black; LINE_AA the same as LINE_8) and blended over the
canvas glyph by glyph, and that an integer shift of `org` shifts the
pixels exactly. The port draws it from the same font (`assets/fonts/
Rubik.ttf`, extracted from cv2 by `scripts/extract_fonts.py`) with the
renderer of `csrc/text_render.h`, whose header lists every rule the
probes fixed. A character outside Rubik's cmap comes, as in cv2, from its
second built-in font, WenQuanYi Micro Hei (CJK, Greek, Hangul, ...;
`assets/fonts/WenQuanYiMicroHei.ttf.gz`, the gzip member cv2 stores,
inflated once when first drawn), at 14 px of its own ascender on the same
baseline, advancing by its own metrics; a character neither maps is
Rubik's '?'.
"""

from __future__ import annotations

import functools
import gzip
from pathlib import Path

import numpy as np

from . import native_loader

FONTS = Path(__file__).resolve().parents[1] / "assets" / "fonts"
FONT = FONTS / "Rubik.ttf"
FALLBACK = FONTS / "WenQuanYiMicroHei.ttf.gz"

# cv2.circle(img, c, 3, color, -1): rows dy = -3..3, columns dx = -3..3
_DISC = np.array([[0, 0, 0, 1, 0, 0, 0],
                  [0, 1, 1, 1, 1, 1, 0],
                  [0, 1, 1, 1, 1, 1, 0],
                  [1, 1, 1, 1, 1, 1, 1],
                  [0, 1, 1, 1, 1, 1, 0],
                  [0, 1, 1, 1, 1, 1, 0],
                  [0, 0, 0, 1, 0, 0, 0]], bool)


@functools.cache
def _font() -> np.ndarray:
    return np.frombuffer(FONT.read_bytes(), np.uint8)


@functools.cache
def _fallback() -> np.ndarray:
    return np.frombuffer(gzip.decompress(FALLBACK.read_bytes()), np.uint8)


def color_of(c: int):
    """The class colour of JAX's detect.py / Detections.render."""
    return (37 * c % 255, 17 * c % 255, 29 * c % 255)


def _paint(img: np.ndarray, mask: np.ndarray, top: int, left: int,
           color) -> None:
    """Set the pixels of `mask` placed at (top, left), clipped to img."""
    h, w = img.shape[:2]
    mh, mw = mask.shape
    y0, x0 = max(top, 0), max(left, 0)
    y1, x1 = min(top + mh, h), min(left + mw, w)
    if y0 >= y1 or x0 >= x1:
        return
    sub = mask[y0 - top:y1 - top, x0 - left:x1 - left]
    img[y0:y1, x0:x1][sub] = color


def rectangle(img: np.ndarray, p1, p2, color) -> None:
    """cv2.rectangle(img, p1, p2, color, 2) with LINE_8, in place."""
    (xa, ya), (xb, yb) = p1, p2
    x0, x1 = sorted((int(xa), int(xb)))
    y0, y1 = sorted((int(ya), int(yb)))
    mask = np.ones((y1 - y0 + 3, x1 - x0 + 3), bool)
    mask[3:-3, 3:-3] = False
    mask[[0, 0, -1, -1], [0, -1, 0, -1]] = False
    _paint(img, mask, y0 - 1, x0 - 1, np.asarray(color, img.dtype))


def circle(img: np.ndarray, center, color) -> None:
    """cv2.circle(img, center, 3, color, -1), in place."""
    _paint(img, _DISC, int(center[1]) - 3, int(center[0]) - 3,
           np.asarray(color, img.dtype))


def text(img: np.ndarray, label: str, org, color) -> None:
    """cv2.putText(img, label, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    on the uint8 (h, w, 3) canvas, in place: `org` is the baseline's left
    end, `color` one value per channel in the canvas's order."""
    canvas = img if img.flags.c_contiguous else np.ascontiguousarray(img)
    fallback = None if label.isascii() else _fallback()
    native_loader.put_text(canvas, label, org, color, _font(), fallback)
    if canvas is not img:
        img[...] = canvas


def box_label(img: np.ndarray, xyxy, label: str, color) -> None:
    """One detection as JAX's detect.py draws it: the box, then the label
    4 pixels above its top-left corner."""
    x1, y1 = int(xyxy[0]), int(xyxy[1])
    rectangle(img, (x1, y1), (int(xyxy[2]), int(xyxy[3])), color)
    text(img, label, (x1, y1 - 4), color)

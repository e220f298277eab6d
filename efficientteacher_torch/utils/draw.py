"""Box, point and label drawing without cv2: the port's counterparts of the
cv2 calls of JAX's `detect.py` and `Detections.render`
(`cv2.rectangle(img, p1, p2, color, 2)`, `cv2.circle(img, p, 3, color,
-1)` and `cv2.putText(img, label, org, FONT_HERSHEY_SIMPLEX, 0.5, color,
1)`).

Boxes and points are pixel for pixel what cv2 draws on the same canvas
(`tests/test_torch_loaders_detect.py` holds them against cv2). cv2 draws a
thickness-2 rectangle as four 3-pixel bands centred on its edges, with a
1-pixel round cap at each corner: the box [x0 - 1, x1 + 1] x [y0 - 1,
y1 + 1] less its four corner pixels and less the inside [x0 + 2, x1 - 2] x
[y0 + 2, y1 - 2]. A filled circle of radius 3 is `_DISC`. Both are clipped
to the canvas.

Label text: cv2's Hershey glyph table is not available without cv2, so
the label is drawn in a 3 x 5 pixel font, 4 pixels per character, inside
the box cv2's text of the same label would take (cv2's glyphs are at
least 4 pixels wide at scale 0.5). Those pixels are the one place where a
canvas differs from cv2's (ROADMAP Queue 3, F8).
"""

from __future__ import annotations

import numpy as np

# cv2.circle(img, c, 3, color, -1): rows dy = -3..3, columns dx = -3..3
_DISC = np.array([[0, 0, 0, 1, 0, 0, 0],
                  [0, 1, 1, 1, 1, 1, 0],
                  [0, 1, 1, 1, 1, 1, 0],
                  [1, 1, 1, 1, 1, 1, 1],
                  [0, 1, 1, 1, 1, 1, 0],
                  [0, 1, 1, 1, 1, 1, 0],
                  [0, 0, 0, 1, 0, 0, 0]], bool)

# 3 x 5 glyphs, rows top to bottom, '#' set
_FONT_ROWS = {
    "0": "### #.# #.# #.# ###", "1": ".#. ##. .#. .#. ###",
    "2": "### ..# ### #.. ###", "3": "### ..# .## ..# ###",
    "4": "#.# #.# ### ..# ..#", "5": "### #.. ### ..# ###",
    "6": "### #.. ### #.# ###", "7": "### ..# .#. .#. .#.",
    "8": "### #.# ### #.# ###", "9": "### #.# ### ..# ###",
    "a": ".#. #.# ### #.# #.#", "b": "##. #.# ##. #.# ##.",
    "c": ".## #.. #.. #.. .##", "d": "##. #.# #.# #.# ##.",
    "e": "### #.. ##. #.. ###", "f": "### #.. ##. #.. #..",
    "g": ".## #.. #.# #.# .##", "h": "#.# #.# ### #.# #.#",
    "i": "### .#. .#. .#. ###", "j": "..# ..# ..# #.# .#.",
    "k": "#.# #.# ##. #.# #.#", "l": "#.. #.. #.. #.. ###",
    "m": "#.# ### ### #.# #.#", "n": "##. #.# #.# #.# #.#",
    "o": ".#. #.# #.# #.# .#.", "p": "##. #.# ##. #.. #..",
    "q": ".#. #.# #.# ##. .##", "r": "##. #.# ##. #.# #.#",
    "s": ".## #.. .#. ..# ##.", "t": "### .#. .#. .#. .#.",
    "u": "#.# #.# #.# #.# ###", "v": "#.# #.# #.# #.# .#.",
    "w": "#.# #.# ### ### #.#", "x": "#.# #.# .#. #.# #.#",
    "y": "#.# #.# .#. .#. .#.", "z": "### ..# .#. #.. ###",
    ".": "... ... ... ... .#.", "-": "... ... ### ... ...",
    "_": "... ... ... ... ###", ":": "... .#. ... .#. ...",
    "/": "..# ..# .#. #.. #..", " ": "... ... ... ... ...",
}
_FONT = {ch: np.array([[c == "#" for c in row] for row in rows.split()])
         for ch, rows in _FONT_ROWS.items()}
_UNKNOWN = np.ones((5, 3), bool)


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
    """The label at `org` (its baseline's left end, as cv2.putText's
    origin), in the 3 x 5 font (module docstring), in place."""
    x, y = int(org[0]), int(org[1])
    color = np.asarray(color, img.dtype)
    for i, ch in enumerate(label):
        glyph = _FONT.get(ch.lower(), _UNKNOWN)
        _paint(img, glyph, y - 6, x + 1 + 4 * i, color)


def box_label(img: np.ndarray, xyxy, label: str, color) -> None:
    """One detection as JAX's detect.py draws it: the box, then the label
    4 pixels above its top-left corner."""
    x1, y1 = int(xyxy[0]), int(xyxy[1])
    rectangle(img, (x1, y1), (int(xyxy[2]), int(xyxy[3])), color)
    text(img, label, (x1, y1 - 4), color)

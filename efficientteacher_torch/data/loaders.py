"""Inference-time input loader (counterpart of
`efficientteacher_tpu/data/loaders.py`; reference utils/datasets.py:400-494).

`LoadImages` takes files, directories, globs and `.txt` lists, as the
datasets' `parse_data_path` expands them (every suffix of `IMG_FORMATS`),
reads each image with the port's `image_io.imread` (bit-equal to
cv2.imread on JPEG, PNG, BMP, TIFF and WebP) and letterboxes it with `augment.letterbox` (cv2's INTER_LINEAR,
in the loader core). A file cv2.imread reads nothing of (OSError here) is
skipped, as JAX's skips it. Each item is what JAX's yields: (path,
letterboxed RGB uint8, the image as read in cv2's BGR order, (ratio,
pad)).

Video files need `cv2.VideoCapture` and raise NotImplementedError, and the
streaming `LoadStreams` is not ported (ROADMAP Q1.12).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

from .augment import letterbox
from .datasets import parse_data_path
from .image_io import imread

VID_FORMATS = {"mov", "avi", "mp4", "mpg", "mpeg", "m4v", "wmv", "mkv"}


class LoadImages:
    """Image file iterator (reference datasets.py:400-494)."""

    def __init__(self, path: str, img_size: int = 640, stride: int = 32,
                 auto: bool = False):
        self.img_size = img_size
        self.stride = stride
        self.auto = auto
        p = Path(path)
        if p.is_file() and p.suffix[1:].lower() in VID_FORMATS:
            raise NotImplementedError(
                f"{path}: video needs cv2.VideoCapture, which the port does "
                f"not use (ROADMAP Q1.12); pass its frames as images")
        self.files: List[str] = [f for f, _ in parse_data_path(path)]

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray, np.ndarray, tuple]]:
        for f in self.files:
            try:
                rgb = imread(f)
            except OSError:   # cv2.imread's None: JAX skips the file
                continue
            img, ratio, pad = letterbox(rgb, self.img_size, auto=self.auto,
                                        stride=self.stride)
            # img0 in cv2's BGR order, as JAX yields it
            yield f, img, np.ascontiguousarray(rgb[..., ::-1]), (ratio, pad)

    def __len__(self):
        return len(self.files)

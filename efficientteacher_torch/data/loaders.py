"""Inference-time input loader (counterpart of
`efficientteacher_tpu/data/loaders.py`; reference utils/datasets.py:400-494).

`LoadImages` takes files, directories, globs and `.txt` lists, as the
datasets' `parse_data_path` expands them (every suffix of `IMG_FORMATS`),
reads each image with the port's `image_io.imread` (bit-equal to
cv2.imread on JPEG, PNG, BMP, TIFF and WebP) and letterboxes it with
`augment.letterbox` (cv2's INTER_LINEAR, in the loader core). A file
cv2.imread reads nothing of (OSError here) is skipped, as JAX's skips it.
Video files (a suffix of `VID_FORMATS`: given directly, or in a `.txt`
list or an `a||b` source; directories and globs stay image-only) come
after the images, frame by frame as cv2.VideoCapture reads them
(`video_io.frames`: MP4 / MOV / M4V and AVI; MPEG-4 Part 2, MJPEG, and
H.264's progressive I / P pictures in CAVLC or CABAC, 8-bit 4:2:0), each
frame's path `f"{file}#{index}"`; a codec or tool the port does not decode
yet raises NotImplementedError (`video_io.VideoUnsupported`) naming its
ROADMAP item, after the frames before it. Each item is
what JAX's yields: (path, letterboxed RGB uint8, the image as read in
cv2's BGR order, (ratio, pad)).

The streaming `LoadStreams` is not ported (ROADMAP Q1.13e).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

from .augment import letterbox
from .datasets import parse_data_path
from .image_io import imread
from .video_io import frames

VID_FORMATS = {"mov", "avi", "mp4", "mpg", "mpeg", "m4v", "wmv", "mkv"}


class LoadImages:
    """Image and video file iterator (reference datasets.py:400-494)."""

    def __init__(self, path: str, img_size: int = 640, stride: int = 32,
                 auto: bool = False):
        self.img_size = img_size
        self.stride = stride
        self.auto = auto
        p = Path(path)
        if p.is_file() and p.suffix[1:].lower() in VID_FORMATS:
            self.files: List[str] = [str(p)]
        else:
            self.files = [f for f, _ in parse_data_path(path)]
        self.videos = [f for f in self.files
                       if f.rsplit(".", 1)[-1].lower() in VID_FORMATS]
        videos = set(self.videos)
        self.images = [f for f in self.files if f not in videos]

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray, np.ndarray, tuple]]:
        for f in self.images:
            try:
                rgb = imread(f)
            except OSError:   # cv2.imread's None: JAX skips the file
                continue
            # img0 in cv2's BGR order, as JAX yields it
            yield (f, *self._prep(rgb, np.ascontiguousarray(rgb[..., ::-1])))
        for f in self.videos:
            for idx, bgr in enumerate(frames(f)):
                rgb = np.ascontiguousarray(bgr[..., ::-1])
                yield (f"{f}#{idx}", *self._prep(rgb, bgr))

    def _prep(self, rgb: np.ndarray, bgr: np.ndarray):
        img, ratio, pad = letterbox(rgb, self.img_size, auto=self.auto,
                                    stride=self.stride)
        return img, bgr, (ratio, pad)

    def __len__(self):
        return len(self.images) + len(self.videos)

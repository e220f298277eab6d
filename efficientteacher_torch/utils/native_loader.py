"""ctypes binding of the port's host loader core (`csrc/loader_core.cpp`,
built at first use by `ops/_build.host_library`).

Counterpart of `efficientteacher_tpu/utils/native_loader.py`. Unlike the
JAX binding it never falls back: a JPEG read on a core built without
libjpeg raises `JpegUnsupported`, which the datasets raise when they are
built (`data/image_io.py`). Images are RGB uint8, (h, w, 3), C-contiguous.
Each call releases the interpreter lock while it runs (ctypes does), so
loader threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ..ops._build import host_library

_P, _I, _C = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
_SIGNATURES = {
    "et_has_jpeg": (),
    "et_jpeg_size": (_C, _P, _P),
    # path, expect w/h, canvas, ch, cw, top, left, new_w, new_h, pad,
    # prescale
    "et_jpeg_letterbox": (_C, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I),
    # src, sw, sh, sstride, canvas, ch, cw, top, left, new_w, new_h, pad
    "et_resize_letterbox": (_P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I),
    "et_png_unfilter": (_P, _I, _I, _I, _P),
    "et_jpeg_write": (_C, _P, _I, _I, _I),
}
_ERRORS = {-1: "cannot open the file", -2: "libjpeg cannot decode it",
           -3: "its size differs from the labels cache's",
           -4: "the loader core was built without libjpeg",
           -5: "bad sizes", -6: "unknown PNG filter type"}


class JpegUnsupported(RuntimeError):
    """The core was built without libjpeg (no jpeglib.h on the machine)."""


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = host_library().lib
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def has_jpeg() -> bool:
    return bool(_lib().et_has_jpeg())


def _check(code: int, what: str) -> None:
    if code == -4:
        raise JpegUnsupported(
            f"{what}: {_ERRORS[-4]} ({host_library().log.splitlines()[0]})")
    if code != 0:
        raise OSError(f"{what}: {_ERRORS.get(code, code)}")


def _canvas(canvas: np.ndarray):
    if (canvas.dtype != np.uint8 or canvas.ndim != 3 or canvas.shape[2] != 3
            or not canvas.flags.c_contiguous):
        raise ValueError("canvas must be C-contiguous uint8 (h, w, 3)")
    return canvas.ctypes.data, canvas.shape[0], canvas.shape[1]


def jpeg_size(path: str):
    """(w, h) from the JPEG header."""
    w, h = ctypes.c_int(), ctypes.c_int()
    _check(_lib().et_jpeg_size(os.fsencode(path), ctypes.byref(w),
                               ctypes.byref(h)), path)
    return w.value, h.value


def jpeg_letterbox(path: str, canvas: np.ndarray, top: int, left: int,
                   new_w: int, new_h: int, pad_value: int = 114,
                   expect_wh=(0, 0), prescale: bool = False) -> None:
    """Decode `path`, resize it to (new_w, new_h) (cv2 INTER_LINEAR) and
    write it at (top, left) into `canvas`, filled first with `pad_value`
    (-1: left as it is). `expect_wh` (w, h) is checked against the header.
    `prescale` allows libjpeg's IDCT downscale (Dataset.native_loader)."""
    ptr, ch, cw = _canvas(canvas)
    _check(_lib().et_jpeg_letterbox(
        os.fsencode(path), int(expect_wh[0]), int(expect_wh[1]), ptr, ch, cw,
        int(top), int(left), int(new_w), int(new_h), int(pad_value),
        int(prescale)), path)


def resize_letterbox(src: np.ndarray, canvas: np.ndarray, top: int,
                     left: int, new_w: int, new_h: int,
                     pad_value: int = 114) -> None:
    """`src` (h, w, 3) uint8 resized to (new_w, new_h) (cv2 INTER_LINEAR)
    at (top, left) into `canvas`, filled first with `pad_value` (-1: left
    as it is)."""
    if src.dtype != np.uint8 or src.ndim != 3 or src.shape[2] != 3 \
            or src.strides[1:] != (3, 1):
        raise ValueError("src must be uint8 (h, w, 3) with packed rows")
    ptr, ch, cw = _canvas(canvas)
    _check(_lib().et_resize_letterbox(
        src.ctypes.data, src.shape[1], src.shape[0], src.strides[0], ptr, ch,
        cw, int(top), int(left), int(new_w), int(new_h), int(pad_value)),
        "resize")


def resize(src: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """cv2.resize(src, (new_w, new_h), interpolation=INTER_LINEAR)."""
    out = np.empty((new_h, new_w, 3), np.uint8)
    resize_letterbox(src, out, 0, 0, new_w, new_h, pad_value=-1)
    return out


def png_unfilter(data: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """PNG scanlines (each a filter byte + row_bytes) -> (h, row_bytes)."""
    if len(data) < h * (row_bytes + 1):
        raise OSError("PNG image data is truncated")
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((h, row_bytes), np.uint8)
    _check(_lib().et_png_unfilter(buf.ctypes.data, h, row_bytes, bpp,
                                  out.ctypes.data), "PNG")
    return out


def jpeg_write(path: str, rgb: np.ndarray, quality: int = 90) -> None:
    """Test-data support: write `rgb` (h, w, 3) uint8 as a JPEG."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    _check(_lib().et_jpeg_write(os.fsencode(path), rgb.ctypes.data,
                                rgb.shape[1], rgb.shape[0], int(quality)),
           path)

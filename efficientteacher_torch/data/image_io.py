"""Image files without cv2: the port's counterpart of `cv2.imread`
(`efficientteacher_tpu/data/datasets.py:313`).

JPEG goes through the loader core's own decoder (`csrc/jpeg_decode.h`,
`utils/native_loader.py`): bit-equal to cv2.imread (libjpeg-turbo's
defaults) on baseline, extended and progressive Huffman files, grey or
YCbCr 4:4:4 / 4:2:2 / 4:2:0; other kinds raise `JpegUnsupported` from
`image_size`. PNG is read here: chunks and `zlib` in Python, the row
filters undone by the core (the Average and Paeth filters run along each
row, which numpy cannot vectorise); 8-bit grey, grey + alpha, RGB, RGBA and palette images,
not interlaced. PNG is lossless, so a PNG reads exactly as cv2 reads it
(alpha is dropped, grey is repeated over the three channels). Every other
entry of `IMG_FORMATS`, and any other PNG, raises `NotImplementedError`
from `image_size`, which the datasets call for every file when they are
built, so an unreadable file fails there and not in an epoch.

Images are RGB uint8 (h, w, 3). A JPEG's EXIF orientation is applied as
cv2.imread applies it (`efficientteacher_tpu/data/datasets.py` reads
every image with cv2.imread on its default route), so `image_size` gives
the oriented size and `imread` the oriented pixels. Only the prescale
route (`Dataset.native_loader`, `data/datasets.py`) ignores it, as the JAX
native core does.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..utils import native_loader as nl

IMG_FORMATS = {"bmp", "jpg", "jpeg", "png", "tif", "tiff", "webp"}
JPEG_SUFFIXES = {"jpg", "jpeg"}
_TODO = "ROADMAP Q1.9: image formats other than JPEG and 8-bit PNG"
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples


def suffix(path: str) -> str:
    return path.rsplit(".", 1)[-1].lower()


def _png_chunks(path: str):
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise OSError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _png_header(path: str, ihdr: bytes):
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise NotImplementedError(
            f"{path}: PNG of bit depth {depth}, colour type {ctype}"
            f"{', interlaced' if interlace else ''} is not read ({_TODO})")
    return w, h, ctype


def image_size(path: str):
    """(w, h) of the image at `path` from its header, EXIF orientation
    applied. Raises NotImplementedError for a format this module does not
    read (`native_loader.JpegUnsupported` for a JPEG kind the core's
    decoder refuses), OSError for a missing or corrupt file."""
    ext = suffix(path)
    if ext in JPEG_SUFFIXES:
        w, h, orientation = nl.jpeg_info(path)
        return nl.oriented_size(w, h, orientation)
    if ext == "png":
        for kind, body in _png_chunks(path):
            if kind == b"IHDR":
                return _png_header(path, body)[:2]
        raise OSError(f"{path}: PNG without IHDR")
    raise NotImplementedError(f"{path}: .{ext} images are not read ({_TODO})")


def read_png(path: str) -> np.ndarray:
    """The PNG at `path` as RGB uint8 (h, w, 3)."""
    header = plte = None
    idat = []
    for kind, body in _png_chunks(path):
        if kind == b"IHDR":
            header = _png_header(path, body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise OSError(f"{path}: PNG without IHDR")
    w, h, ctype = header
    bpp = _PNG_CHANNELS[ctype]
    raw = nl.png_unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    px = raw.reshape(h, w, bpp)
    if ctype == 3:
        if plte is None:
            raise OSError(f"{path}: palette PNG without PLTE")
        return np.frombuffer(plte, np.uint8).reshape(-1, 3)[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def imread(path: str) -> np.ndarray:
    """The image at `path` as RGB uint8 (h, w, 3), full resolution, as
    cv2.imread(path)[..., ::-1] reads it."""
    ext = suffix(path)
    if ext in JPEG_SUFFIXES:
        return nl.jpeg_decode(path)
    if ext == "png":
        return read_png(path)
    raise NotImplementedError(f"{path}: .{ext} images are not read ({_TODO})")


def write_png(path: str, rgb: np.ndarray, level: int = 6) -> None:
    """Write `rgb` (h, w, 3) uint8 as an RGB PNG with the None filter on
    every row."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + \
            struct.pack(">I", crc)

    Path(path).write_bytes(
        _PNG_SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
        + chunk(b"IEND", b""))


JPEG_QUALITY = 95   # cv2.imwrite's default IMWRITE_JPEG_QUALITY


def imwrite(path: str, bgr: np.ndarray) -> None:
    """cv2.imwrite's counterpart for the images detect and AutoShape save:
    `bgr` (h, w, 3) uint8 in cv2's channel order, written as `.png`
    (lossless, `write_png`) or `.jpg` / `.jpeg` (the loader core's baseline
    4:2:0 writer at quality 95, cv2's default). Other suffixes raise
    NotImplementedError."""
    rgb = np.ascontiguousarray(np.asarray(bgr, np.uint8)[..., ::-1])
    ext = suffix(str(path))
    if ext == "png":
        write_png(path, rgb)
    elif ext in JPEG_SUFFIXES:
        nl.jpeg_write(str(path), rgb, JPEG_QUALITY)
    else:
        raise NotImplementedError(
            f"{path}: .{ext} images are not written (.png, .jpg, .jpeg)")

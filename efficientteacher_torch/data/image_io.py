"""Image files without cv2: the port's counterpart of `cv2.imread`
(`efficientteacher_tpu/data/datasets.py:313`) and of the `cv2.imwrite`
calls of detect.

What is read, each bit-equal to `cv2.imread(path)[..., ::-1]` (cv2 5.0.0):

* JPEG, through the loader core's own decoder (`csrc/jpeg_decode.h`,
  `utils/native_loader.py`): baseline, extended, progressive and 8-bit
  lossless Huffman files and sequential and progressive arithmetic-coded
  ones; grey, YCbCr, RGB, CMYK and YCCK; every sampling set libjpeg
  decodes (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...), at scale 1 and at the
  reduced scales; truncated and damaged data and the block smoothing of
  progressive files whose scans leave coefficients unrefined, as libjpeg
  decodes them. The kinds libjpeg refuses as cv2 calls it (12-bit,
  hierarchical, arithmetic lossless, lossless grey or YCbCr) raise
  OSError, as cv2.imread returns None.
* PNG: every bit depth and colour type, Adam7 interlacing; 16-bit samples
  as their high byte (libpng's png_set_strip_16), grey of 1-4 bits scaled
  to 0-255, alpha and tRNS dropped, no ancillary chunk applied (cv2 sets
  none of libpng's gamma or background transforms), an eXIf orientation
  applied.
* BMP, as OpenCV's own decoder (grfmt_bmp.cpp) reads it: OS/2 v1 (12-byte)
  and Windows (40, 52, 56, 108, 124-byte) headers; 1/4/8-bit palettes;
  16-bit 5-5-5 and BI_BITFIELDS 5-6-5; 24 bits; 32 bits with or without
  BI_BITFIELDS (alpha dropped); BI_RLE8 / BI_RLE4; bottom-up and top-down.
* TIFF (`data/tiff_io.py`): the first IFD as libtiff's RGBA interface gives
  it to cv2: every photometric and codec it reads (JPEG-in-TIFF, CCITT,
  CMYK, YCbCr, CIELab, SGILog among them); no kind is refused that cv2
  reads.
* WebP (`data/webp_io.py`): VP8L and VP8 bitstreams, simple or VP8X with
  ALPH, EXIF or an animation (its first frame on the canvas), through
  the loader core's decoders (`csrc/webp_decode.h`); no kind is refused.

Headers, chunks and IFDs are parsed here and zlib is Python's; the
per-pixel stages (filters, Adam7, bit unpacking, palettes, RLE, LZW,
PackBits, the TIFF predictor) run in the loader core (`csrc/
raster_decode.h`), so no decode loops over pixels in Python.

`image_size` reads a file's header and raises for a kind that is not read;
the datasets call it for every file when they are built, so such a file
fails there and not in an epoch. A file cv2 cannot read either (corrupt,
truncated, or of a kind cv2 refuses: ROADMAP F10) raises OSError, and the
datasets drop it, as JAX's do.

Images are RGB uint8 (h, w, 3). The EXIF orientation of a JPEG, PNG or
WebP and a TIFF's Orientation tag are applied as cv2.imread applies them,
so `image_size` gives the oriented size and `imread` the oriented pixels.
cv2 5.0.0 fails on a non-square TIFF of Orientation 5-8, and so does the
port (OSError), so the datasets drop it as JAX's do. Only the prescale
route (`Dataset.native_loader`, `data/datasets.py`) ignores a JPEG's
orientation, as the JAX native core does.

`imwrite` writes what detect and AutoShape save under a source's suffix:
`.png`, `.jpg` / `.jpeg`, `.bmp` (byte-equal to cv2.imwrite's), `.tif` /
`.tiff` (LZW with the horizontal predictor in one strip, as cv2.imwrite
writes it) and `.webp` (lossless VP8L, cv2.imwrite's default kind; the
loader core's own encoder, so the bytes differ from libwebp's, the
pixels read back do not).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..utils import native_loader as nl
from . import tiff_io, webp_io
from .tiff_io import exif_orientation, orient

IMG_FORMATS = {"bmp", "jpg", "jpeg", "png", "tif", "tiff", "webp"}
JPEG_SUFFIXES = {"jpg", "jpeg"}
TIFF_SUFFIXES = {"tif", "tiff"}
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}


def suffix(path: str) -> str:
    return path.rsplit(".", 1)[-1].lower()


# ---------------------------------------------------------------- PNG

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
    """(w, h, depth, colour type, interlaced) of a well-formed IHDR."""
    if len(ihdr) != 13:
        raise OSError(f"{path}: PNG IHDR of {len(ihdr)} bytes")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", ihdr)
    if (ctype not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[ctype] or comp
            or filt or interlace > 1 or not w or not h):
        raise OSError(f"{path}: PNG IHDR with colour type {ctype}, depth "
                      f"{depth}, methods {comp}/{filt}/{interlace}")
    return w, h, depth, ctype, bool(interlace)


def _png_parts(path: str):
    """(header, PLTE, orientation, IDAT bytes). The orientation is the
    first eXIf chunk's, before the IDATs or after them (cv2 reads both)."""
    header = plte = orientation = None
    idat = []
    for kind, body in _png_chunks(path):
        if kind == b"IHDR":
            header = _png_header(path, body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"eXIf" and orientation is None:
            orientation = exif_orientation(body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise OSError(f"{path}: PNG without IHDR")
    return header, plte, orientation or 1, b"".join(idat)


def read_png(path: str) -> np.ndarray:
    """The PNG at `path` as RGB uint8 (h, w, 3), as cv2.imread reads it."""
    (w, h, depth, ctype, interlaced), plte, orientation, idat = \
        _png_parts(path)
    try:
        data = zlib.decompress(idat)
    except zlib.error as e:
        raise OSError(f"{path}: PNG image data: {e}") from None
    spp = _PNG_CHANNELS[ctype]
    px = nl.png_decode(data, w, h, depth, spp, interlaced)
    if ctype == 3:
        if plte is None:
            raise OSError(f"{path}: palette PNG without PLTE")
        lut = np.zeros((256, 3), np.uint8)   # libpng: entries past PLTE 0
        pal = np.frombuffer(plte[:len(plte) // 3 * 3], np.uint8).reshape(-1, 3)
        lut[:len(pal)] = pal[:256]
        img = nl.to_rgb(px, lut)
    elif ctype in (0, 4):
        # png_set_expand_gray_1_2_4_to_8: v * 255 / (2^depth - 1)
        levels = (1 << min(depth, 8)) - 1
        ramp = (np.arange(256) * 255 // levels).clip(0, 255).astype(np.uint8)
        img = nl.to_rgb(px, np.repeat(ramp[:, None], 3, 1))
    else:
        img = nl.to_rgb(px)
    return orient(img, orientation)


# ---------------------------------------------------------------- BMP

def _bmp_header(path: str, data: bytes):
    """OpenCV's BmpDecoder::readHeader: (w, h, bottom_up, bpp, rle,
    palette (256, 3) RGB, pixel offset). `bpp` 15 is 5-5-5, 16 5-6-5. A
    kind its decoder does not take, and a corrupt header, raise OSError:
    cv2.imread returns nothing for either, and the datasets drop the file
    as JAX's do."""
    def fail(what):
        raise OSError(f"{path}: corrupt BMP: {what}")

    def refuse(what):
        raise OSError(f"{path}: BMP {what} is not read (cv2.imread reads "
                      f"none either)")
    if len(data) < 26 or data[:2] != b"BM":
        fail("signature or header missing")
    offset, size = struct.unpack("<iI", data[10:18])
    palette = np.zeros((256, 3), np.uint8)
    pos = 14 + size

    def bgr_table(n, step):
        if len(data) < pos + n * step:
            fail("palette truncated")
        t = np.frombuffer(data[pos:pos + n * step], np.uint8).reshape(
            n, step)
        palette[:n] = t[:, 2::-1]

    if size >= 36:
        if len(data) < 50:
            fail("header truncated")
        w, h, _, bpp, rle, clrused = struct.unpack("<iiHHI12xI", data[18:50])
        if w <= 0 or h == 0:
            fail(f"size {w} x {h}")
        if not ((bpp in (1, 4, 8, 24, 32) and rle == 0)
                or (bpp in (16, 32) and rle in (0, 3))
                or (bpp == 4 and rle == 2) or (bpp == 8 and rle == 1)):
            refuse(f"of {bpp} bits with compression {rle}")
        if bpp <= 8:
            if clrused > 256:
                fail(f"palette of {clrused} entries")
            bgr_table(clrused or 1 << bpp, 4)
        elif bpp == 16 and rle == 3:
            if len(data) < pos + 12:
                fail("bit fields truncated")
            r, g, b = struct.unpack("<III", data[pos:pos + 12])
            if (b, g, r) == (0x1F, 0x3E0, 0x7C00):
                bpp = 15
            elif (b, g, r) != (0x1F, 0x7E0, 0xF800):
                refuse(f"of 16-bit fields {r:#x}/{g:#x}/{b:#x} (the ones "
                       f"after the header)")
        elif bpp == 16:
            bpp = 15
        rle = {1: 8, 2: 4}.get(rle, 0)
    elif size == 12:
        w, h, bpp = struct.unpack("<HH2xH", data[18:26])
        if not (w > 0 and h):
            fail(f"size {w} x {h}")
        if bpp not in (1, 4, 8, 24, 32):
            refuse(f"(OS/2) of {bpp} bits")
        if bpp <= 8:
            bgr_table(1 << bpp, 3)
        rle = 0
    else:
        refuse(f"header of {size} bytes")
    if offset < 0:
        fail("pixel offset")
    return w, abs(h), h > 0, bpp, rle, palette, offset


def read_bmp(path: str) -> np.ndarray:
    """The BMP at `path` as RGB uint8 (h, w, 3), as cv2.imread reads it."""
    data = Path(path).read_bytes()
    w, h, bottom_up, bpp, rle, palette, offset = _bmp_header(path, data)
    try:
        return nl.bmp_decode(data, offset, w, h, bottom_up, bpp, rle,
                             palette)
    except OSError:
        raise OSError(f"{path}: corrupt or truncated BMP data") from None


# ---------------------------------------------------------------- dispatch

def _refuse(path: str, ext: str):
    raise NotImplementedError(f"{path}: .{ext} is not an image format "
                              f"({', '.join(sorted(IMG_FORMATS))})")


def image_size(path: str):
    """(w, h) of the image at `path` from its header, orientation applied.
    Raises NotImplementedError for a suffix that is no image format,
    OSError for a file that is missing, corrupt, or of a kind cv2 reads
    nothing of."""
    ext = suffix(path)
    if ext in JPEG_SUFFIXES:
        w, h, orientation = nl.jpeg_info(path)
        return nl.oriented_size(w, h, orientation)
    if ext == "png":
        (w, h, *_), _, orientation, _ = _png_parts(path)
        return nl.oriented_size(w, h, orientation)
    if ext == "bmp":
        data = Path(path).read_bytes()
        return _bmp_header(path, data)[:2]
    if ext in TIFF_SUFFIXES:
        return tiff_io.tiff_size(path)
    if ext == "webp":
        return webp_io.webp_size(path)
    _refuse(path, ext)


def imread(path: str) -> np.ndarray:
    """The image at `path` as RGB uint8 (h, w, 3), full resolution, as
    cv2.imread(path)[..., ::-1] reads it."""
    ext = suffix(path)
    if ext in JPEG_SUFFIXES:
        return nl.jpeg_decode(path)
    if ext == "png":
        return read_png(path)
    if ext == "bmp":
        return read_bmp(path)
    if ext in TIFF_SUFFIXES:
        return tiff_io.read_tiff(path)
    if ext == "webp":
        return webp_io.read_webp(path)
    _refuse(path, ext)


# ---------------------------------------------------------------- writers

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


def write_bmp(path: str, rgb: np.ndarray) -> None:
    """Write `rgb` (h, w, 3) uint8 as cv2.imwrite writes a 3-channel image:
    a 40-byte header, 24-bit BI_RGB, rows bottom-up in B, G, R, each padded
    with zeros to 4 bytes."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    step = (w * 3 + 3) & ~3
    rows = np.zeros((h, step), np.uint8)
    rows[:, :w * 3] = rgb[::-1, :, ::-1].reshape(h, w * 3)
    head = 14 + 40
    Path(path).write_bytes(
        b"BM" + struct.pack("<IIIIiiHHIIIIII", head + step * h, 0, head, 40,
                            w, h, 1, 24, 0, 0, 0, 0, 0, 0)
        + rows.tobytes())


JPEG_QUALITY = 95   # cv2.imwrite's default IMWRITE_JPEG_QUALITY


def imwrite(path: str, bgr: np.ndarray) -> None:
    """cv2.imwrite's counterpart for the images detect and AutoShape save:
    `bgr` (h, w, 3) uint8 in cv2's channel order, written as `.png`
    (lossless, `write_png`), `.jpg` / `.jpeg` (the loader core's baseline
    4:2:0 writer at quality 95, cv2's default), `.bmp` (`write_bmp`),
    `.tif` / `.tiff` (`tiff_io.write_tiff`) or `.webp` (lossless,
    `webp_io.write_webp`). Other suffixes raise NotImplementedError."""
    rgb = np.ascontiguousarray(np.asarray(bgr, np.uint8)[..., ::-1])
    ext = suffix(str(path))
    if ext == "png":
        write_png(path, rgb)
    elif ext in JPEG_SUFFIXES:
        nl.jpeg_write(str(path), rgb, JPEG_QUALITY)
    elif ext == "bmp":
        write_bmp(path, rgb)
    elif ext in TIFF_SUFFIXES:
        tiff_io.write_tiff(path, rgb)
    elif ext == "webp":
        webp_io.write_webp(path, rgb)
    else:
        raise NotImplementedError(
            f"{path}: .{ext} images are not written (.png, .jpg, .jpeg, "
            f".bmp, .tif, .tiff, .webp)")

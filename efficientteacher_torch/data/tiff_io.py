"""TIFF without cv2: the first IFD of a TIFF as `cv2.imread` reads it, and
the file `cv2.imwrite` writes for `.tif`.

cv2.imread reads every 8-bit-output TIFF through libtiff's RGBA interface
(`TIFFReadRGBAStrip` / `TIFFReadRGBATile`, tif_getimage.c), then drops the
alpha. What that interface does, and so what this module does:

* MinIsBlack / MinIsWhite of 1, 8 or 16 bits: a grey map, value * 255 /
  (2^bits - 1), inverted for MinIsWhite; 16-bit samples by their high
  byte. A second sample (alpha) is dropped. Stored as separate planes
  (PlanarConfiguration 2), grey goes the RGB way: no map, 16-bit samples
  rounded, an unassociated alpha premultiplied.
* RGB of 8 or 16 bits, 3 or 4 samples: 16-bit samples rounded, (v + 128) /
  257; a fourth sample is alpha (associated unless ExtraSamples says 2,
  unassociated, which is premultiplied: (v * a + 127) / 255).
* Palette of 1, 4 or 8 bits: the colormap's 16-bit entries taken as
  they are where all are below 256, else by their high byte (checkcmap).
* Compression none, LZW, Deflate (8 and 32946) and PackBits; Predictor 1
  and 2 (8 and 16 bits; libtiff applies it with LZW and Deflate only);
  strips and tiles; either byte order; BigTIFF.
* The Orientation tag applied as cv2 applies it (the EXIF turn of the
  stored image). cv2 5.0.0 fails on a non-square image of Orientation 5-8
  (its imread asserts), and so does this module (OSError), so that the
  datasets drop the file as JAX's do.

Every other kind raises `TiffUnsupported` from `tiff_size`, naming it.
cv2 reads these, the port does not yet (ROADMAP Q1.9c): JPEG-in-TIFF,
CCITT and every other compression, YCbCr, Separated (CMYK), CIELab and
other photometrics, signed samples, FillOrder 2. cv2 5.0.0 reads none of
these either, and the JAX package drops them from a dataset where the port
names them: 2-bit samples, 4-bit ones but a palette's, 10-64-bit and float
samples, a 16-bit palette, the floating-point predictor, RGB of fewer than
3 colours, samples below 8 bits with alpha or in planes.

Headers and IFDs are parsed here and Deflate is Python's zlib; LZW,
PackBits, the predictor, bit unpacking and the maps run in the loader
core (`csrc/raster_decode.h`).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..utils import native_loader as nl

_TODO = "ROADMAP Q1.9c"
_READ_COMPRESSION = {1, 5, 8, 32946, 32773}   # none, LZW, Deflate, PackBits
_REFUSED_COMPRESSION = {2: "CCITT RLE", 3: "CCITT Group 3 fax",
                        4: "CCITT Group 4 fax", 6: "old-style JPEG",
                        7: "JPEG", 32809: "ThunderScan", 34676: "SGI LogLuv",
                        34925: "LZMA", 50000: "Zstandard", 50001: "WebP",
                        34712: "JPEG 2000"}
_PHOTOMETRIC = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "Palette",
                4: "transparency mask", 5: "Separated (CMYK)", 6: "YCbCr",
                8: "CIELab", 9: "ICCLab", 10: "ITULab", 32844: "LogL",
                32845: "LogLuv"}
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}
_UNASSOCIATED = 2


class TiffUnsupported(NotImplementedError):
    """A TIFF of a kind this module does not read (module docstring)."""


def exif_orientation(tiff: bytes) -> int:
    """The Orientation (1-8) in IFD0 of a TIFF-structured block (an Exif
    body after its "Exif\\0\\0", a PNG eXIf chunk), read as a SHORT as
    OpenCV's ExifReader reads it; 1 when it is missing or malformed."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    bo = "<" if tiff[:2] == b"II" else ">"
    if struct.unpack(bo + "H", tiff[2:4])[0] != 42:
        return 1
    ifd = struct.unpack(bo + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    for e in range(struct.unpack(bo + "H", tiff[ifd:ifd + 2])[0]):
        o = ifd + 2 + 12 * e
        if o + 12 > len(tiff):
            return 1
        if struct.unpack(bo + "H", tiff[o:o + 2])[0] == 0x0112:
            v = struct.unpack(bo + "H", tiff[o + 8:o + 10])[0]
            return v if 1 <= v <= 8 else 1
    return 1


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """`img` turned as EXIF orientation 1-8 asks (cv2's
    ApplyExifOrientation): 2 flip x, 3 rotate 180, 4 flip y, 5 transpose,
    6 rotate 90 clockwise, 7 transverse, 8 rotate 90 counter-clockwise."""
    if orientation <= 1 or orientation > 8:
        return img
    turned = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
              4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
              6: lambda a: np.rot90(a, -1),
              7: lambda a: np.rot90(a.swapaxes(0, 1), 2),
              8: lambda a: np.rot90(a, 1)}[orientation](img)
    return np.ascontiguousarray(turned)


class _Ifd:
    """The tags of a TIFF's first IFD that the decode needs."""

    def __init__(self, path: str, data: bytes):
        self.path = path
        if len(data) < 8 or data[:2] not in (b"II", b"MM"):
            raise OSError(f"{path}: not a TIFF file")
        self.bo = "<" if data[:2] == b"II" else ">"
        version = self._u(data, 2, "H")
        if version == 42:
            ifd, count_fmt, entry, inline = self._u(data, 4, "I"), "H", 12, 4
        elif version == 43:
            ifd, count_fmt, entry, inline = self._u(data, 8, "Q"), "Q", 20, 8
        else:
            raise OSError(f"{path}: TIFF version {version}")
        csize = struct.calcsize(count_fmt)
        if ifd + csize > len(data):
            raise OSError(f"{path}: TIFF IFD past the end of the file")
        n = self._u(data, ifd, count_fmt)
        self.tags = {}
        for e in range(n):
            o = ifd + csize + entry * e
            if o + entry > len(data):
                raise OSError(f"{path}: TIFF IFD truncated")
            tag, typ = struct.unpack(self.bo + "HH", data[o:o + 4])
            cnt = self._u(data, o + 4, "I" if version == 42 else "Q")
            fmt = _TYPES.get(typ)
            if fmt is None:
                continue
            size = struct.calcsize(fmt) * cnt
            at = o + 4 + (4 if version == 42 else 8)
            if size > inline:
                at = self._u(data, at, "I" if version == 42 else "Q")
            if at + size > len(data):
                raise OSError(f"{path}: TIFF tag {tag} past the end")
            self.tags[tag] = struct.unpack(f"{self.bo}{cnt * len(fmt)}"
                                           f"{fmt[0]}", data[at:at + size])

    def _u(self, data, at, fmt):
        return struct.unpack(self.bo + fmt, data[at:at + struct.calcsize(fmt)])[0]

    def get(self, tag, default=None):
        v = self.tags.get(tag)
        return default if v is None else v[0]

    def all(self, tag, default=()):
        return self.tags.get(tag, default)


class _Layout:
    """What the decode of one TIFF needs, checked against what is read."""

    def __init__(self, path: str, data: bytes):
        t = _Ifd(path, data)
        self.path, self.le = path, t.bo == "<"
        self.w, self.h = t.get(256, 0), t.get(257, 0)
        if not self.w or not self.h:
            raise OSError(f"{path}: TIFF without its size")
        self.spp = t.get(277, 1)
        bits = set(t.all(258, (1,)))
        self.bits = bits.pop() if len(bits) == 1 else None
        self.compression = t.get(259, 1)
        self.planar = t.get(284, 1)
        # libtiff applies the predictor in its LZW and Deflate codecs only
        self.predictor = t.get(317, 1) if self.compression in (
            5, 8, 32946) else 1
        self.orientation = t.get(274, 1)
        photometric = t.get(262)
        extras = t.all(338)
        if photometric is None:
            photometric = {1: 1, 3: 2}.get(self.spp - len(extras))
        # TIFFReadDirectory: samples past the photometric's colours are
        # extra samples of unspecified meaning
        implied = {0: 1, 1: 1, 2: 3, 3: 1}.get(photometric, self.spp)
        if not extras and self.spp > implied:
            extras = (0,) * (self.spp - implied)
        colour = self.spp - len(extras)
        # TIFFRGBAImageBegin: which extra sample is alpha, and how
        self.alpha = 0
        if extras:
            if extras[0] == 0 and self.spp > 3:
                self.alpha = 1
            elif extras[0] in (1, 2):
                self.alpha = extras[0]
        self.photometric, self.colour = photometric, colour
        self.contig = not (self.planar == 2 and self.spp > 1)
        self.refusal = self._refusal(t)
        if self.refusal:
            return
        self.tiled = 322 in t.tags
        if self.tiled:
            self.cw, self.ch = t.get(322), t.get(323, 0)
            offsets, counts = t.all(324), t.all(325)
        else:
            self.cw = self.w
            self.ch = min(t.get(278, self.h) or self.h, self.h)
            offsets, counts = t.all(273), t.all(279)
        planes = 1 if self.contig else self.spp
        need = -(-self.w // max(self.cw, 1)) * -(-self.h // max(self.ch, 1)) \
            * planes
        if not self.cw or not self.ch or len(offsets) < need or \
                len(counts) != len(offsets):
            raise OSError(f"{path}: TIFF without its strips or tiles")
        self.chunks = list(zip(offsets, counts))
        self.colormap = t.all(320)
        if self.photometric == 3 and len(self.colormap) < 3 << self.bits:
            raise OSError(f"{path}: TIFF palette without its colormap")

    def _refusal(self, t) -> str:
        """Why this module does not read the file ("" when it does). The
        first four cv2 reads through libtiff; the rest cv2 5.0.0 reads
        nothing of either (its readHeader takes 1, 4 (a palette), 8 and
        16 bits; libtiff's RGBA interface refuses the other layouts)."""
        p = self.photometric
        if self.compression not in _READ_COMPRESSION:
            return (f"{_REFUSED_COMPRESSION.get(self.compression, 'an unknown')}"
                    f" compression ({self.compression})")
        if p not in (0, 1, 2, 3):
            return f"photometric {_PHOTOMETRIC.get(p, p)}"
        if t.get(339, 1) != 1:
            return f"sample format {t.get(339)} (signed or float samples)"
        if t.get(266, 1) != 1:
            return "FillOrder 2"
        cv2_too = " (cv2.imread reads none either)"
        if self.bits not in (1, 4, 8, 16) or (self.bits == 4 and p != 3):
            return f"{self.bits or 'mixed'}-bit samples{cv2_too}"
        if self.predictor not in (1, 2) or (self.predictor == 2
                                            and self.bits < 8):
            return f"predictor {self.predictor} at {self.bits} bits{cv2_too}"
        if not 1 <= self.spp <= 4:
            return f"{self.spp} samples per pixel{cv2_too}"
        if p == 2 and (self.colour < 3 or self.bits < 8):
            return f"RGB of {self.colour} colours at {self.bits} bits{cv2_too}"
        if p == 3 and (self.bits > 8 or not self.contig):
            return f"a {self.bits}-bit or planar palette{cv2_too}"
        if self.bits < 8 and (self.spp != 1 or not self.contig):
            return (f"{self.spp} contiguous samples of {self.bits} bits"
                    f"{cv2_too}")
        return ""

    def size(self):
        return (self.h, self.w) if self.orientation >= 5 else (self.w,
                                                               self.h)


def _layout(path: str, data: bytes) -> _Layout:
    lay = _Layout(path, data)
    if lay.refusal:
        raise TiffUnsupported(f"{path}: TIFF with {lay.refusal} is not read "
                              f"({_TODO})")
    if 5 <= lay.orientation <= 8 and lay.w != lay.h:
        raise OSError(f"{path}: a non-square TIFF of Orientation "
                      f"{lay.orientation} (cv2.imread reads none)")
    return lay


def tiff_size(path: str):
    """(w, h) of the TIFF at `path`, its Orientation applied; raises
    TiffUnsupported for a kind that is not read."""
    return _layout(path, Path(path).read_bytes()).size()


def _inflated(lay: _Layout, data: bytes, row_bytes: int):
    """Deflate's chunks, inflated by zlib (which releases the interpreter
    lock), end to end: (bytes, [(offset, count)])."""
    parts, chunks, at = [], [], 0
    down, across = -(-lay.h // lay.ch), -(-lay.w // lay.cw)
    for k, (offset, count) in enumerate(lay.chunks):
        cy = (k // across) % down
        rows = lay.ch if lay.tiled else min(lay.ch, lay.h - cy * lay.ch)
        try:
            part = zlib.decompressobj().decompress(
                data[offset:offset + count], rows * row_bytes)
        except zlib.error as e:
            raise OSError(f"{lay.path}: TIFF Deflate data: {e}") from None
        parts.append(part)
        chunks.append((at, len(part)))
        at += len(part)
    return b"".join(parts), chunks


def read_tiff(path: str) -> np.ndarray:
    """The first image of the TIFF at `path` as RGB uint8 (h, w, 3), as
    cv2.imread(path)[..., ::-1] reads it. One loader-core call decodes
    every strip or tile."""
    data = Path(path).read_bytes()
    lay = _layout(path, data)
    planes = 1 if lay.contig else lay.spp
    per_chunk = lay.spp if lay.contig else 1
    # samples: 16-bit grey of a contiguous file by its high byte, every
    # other 16-bit sample rounded (Bitdepth16To8)
    grey_map = lay.photometric in (0, 1) and lay.contig
    flags = ((0 if lay.le else nl.TIFF_BIG_ENDIAN)
             | (nl.TIFF_PREDICTOR if lay.predictor == 2 else 0)
             | (0 if grey_map else nl.TIFF_DIV257))
    compression, chunks = lay.compression, lay.chunks
    if compression in (8, 32946):
        row_bytes = (lay.cw * per_chunk * lay.bits + 7) // 8
        data, chunks = _inflated(lay, data, row_bytes)
        compression = 1
    try:
        samples = nl.tiff_decode(data, chunks, compression, lay.w, lay.h,
                                 lay.cw, lay.ch, lay.tiled, planes,
                                 per_chunk, lay.bits, flags)
    except OSError:
        raise OSError(f"{path}: corrupt or truncated TIFF data") from None
    return orient(_rgb(lay, samples), lay.orientation)


def _rgb(lay: _Layout, samples: np.ndarray) -> np.ndarray:
    """The RGBA interface's colours of the unpacked samples."""
    if lay.photometric == 3:
        n = 1 << lay.bits
        cmap = np.asarray(lay.colormap[:3 * n], np.uint32).reshape(3, n).T
        if (cmap >= 256).any():
            cmap = cmap >> 8
        lut = np.zeros((256, 3), np.uint8)
        lut[:n] = cmap
        return nl.to_rgb(samples, lut)
    if lay.photometric in (0, 1) and lay.contig:
        levels = (1 << min(lay.bits, 8)) - 1
        ramp = np.arange(256) * 255 // levels
        if lay.photometric == 0:
            ramp = (levels - np.arange(256)) * 255 // levels
        ramp = ramp.clip(0, 255).astype(np.uint8)
        return nl.to_rgb(samples, np.repeat(ramp[:, None], 3, 1))
    alpha = lay.colour if lay.alpha == _UNASSOCIATED else -1
    if lay.colour == 1:   # planar grey: the RGB way, one plane three times
        lut = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        return nl.to_rgb(samples, lut, alpha)
    return nl.to_rgb(samples, None, alpha)


def write_tiff(path: str, rgb: np.ndarray) -> None:
    """Write `rgb` (h, w, 3) uint8 as cv2.imwrite writes a 3-channel
    `.tif`: little-endian, 8-bit RGB, contiguous, LZW (Compression 5) with
    the horizontal predictor (Predictor 2), in strips of as many rows as
    fit 8 KiB (OpenCV's TiffEncoder: 1 << 13 bytes over the row's; one
    strip for an image of up to 8 KiB)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    rows = max(1, min(h, (1 << 13) // (w * 3)))
    diff = rgb.copy()
    diff[:, 1:] -= rgb[:, :-1]   # uint8 wraps: the predictor's differences
    strips = [nl.lzw_encode(diff[y:y + rows]) for y in range(0, h, rows)]
    offsets, at = [], 8
    for strip in strips:
        offsets.append(at)
        at += len(strip)
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]), (259, 3, [5]),
            (262, 3, [2]), (273, 4, offsets), (277, 3, [3]), (278, 4, [rows]),
            (279, 4, [len(s) for s in strips]), (284, 3, [1]), (317, 3, [2]),
            (339, 3, [1, 1, 1])]
    ifd_at = at + (at & 1)
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    entries, extra = [], b""
    for tag, typ, vals in tags:
        body = struct.pack(f"<{len(vals)}{'H' if typ == 3 else 'I'}", *vals)
        if len(body) <= 4:
            entries.append(struct.pack("<HHI", tag, typ, len(vals))
                           + body.ljust(4, b"\0"))
        else:
            entries.append(struct.pack("<HHII", tag, typ, len(vals),
                                       extra_at + len(extra)))
            extra += body
    Path(path).write_bytes(
        b"II*\0" + struct.pack("<I", ifd_at) + b"".join(strips)
        + b"\0" * (at & 1) + struct.pack("<H", len(tags))
        + b"".join(entries) + b"\0\0\0\0" + extra)

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
* Separated (CMYK, InkSet 1) of 4 samples of 8 bits, contiguous or in
  planes: (255 - K) * (255 - C) / 255 in integers
  (putRGBcontig8bitCMYKtile).
* YCbCr of 8 bits: libtiff's TIFFYCbCrToRGB tables (float and 16-bit
  fixed point as tif_color.c builds them) from YCbCrCoefficients and
  ReferenceBlackWhite or their defaults; blocks of 1 x 1, 1 x 2, 2 x 1,
  2 x 2, 4 x 1, 4 x 2 or 4 x 4 Y samples with one Cb, Cr (2 x 2 where
  YCbCrSubsampling is missing), partial blocks cut at the right and the
  foot; in planes only 1 x 1.
* CIELab of 8 or 16 bits: TIFFCIELab16ToXYZ and TIFFXYZToRGB in float
  with tif_getimage.c's display_sRGB, the WhitePoint or D50.
* LogL and LogLuv compressed by SGILog (34676; LogLuv also by SGILog24,
  34677): tif_luv.c's decoders asked for 8-bit output, as the RGBA
  interface asks (L16toGry's grey, Luv32toRGB's and Luv24toRGB's RGB,
  uvcode.h's table; csrc/raster_decode.h), in strips or tiles.
* Compression none, LZW, Deflate (8 and 32946), PackBits, ThunderScan (4
  bits; in tiles libtiff decodes nothing, and cv2 reads zero samples),
  CCITT modified Huffman (2, and 32771 word-aligned), Group 3
  (one- and two-dimensional) and Group 4 with libtiff's recovery from
  damaged data (csrc/raster_decode.h), and JPEG (7): each strip or tile a
  stream after JPEGTables, decoded by the loader core's JPEG decoder as
  libjpeg decodes it for libtiff (contiguous YCbCr converted to RGB with
  libjpeg's fancy upsampling, every other photometric as its raw
  components). Predictor 1 and 2 (libtiff applies it with LZW and Deflate
  only); strips and tiles; either byte order; BigTIFF.
* A strip or tile whose data fail part way is put as libtiff's RGBA
  interface (stop_on_error 0) puts it: what LZW, PackBits or Deflate
  decoded before the fault and zeros after, without the predictor (ZIPDecode
  keeps what zlib wrote before a stream error: `_inflate`); an
  uncompressed one too short is all zeros (DumpModeDecode).
* SampleFormat 2 (signed) read as unsigned, as libtiff's RGBA interface
  reads it; FillOrder 2: every codec's bits reversed first, but JPEG's
  (libjpeg reads bytes) and the fax codecs' (which read them so).
* A compression libtiff knows no decoder of (JPEG 2000 in cv2's build,
  and any unknown code) reads as zero samples through the photometric:
  black RGB, white MinIsWhite, palette entry 0.
* The Orientation tag applied as cv2 applies it (the EXIF turn of the
  stored image).

A file cv2.imread reads nothing of raises OSError (from `tiff_size` too),
so that the datasets drop it as JAX's drop cv2's None: a codec cv2's
libtiff is built without (old-style JPEG, PixarLog, JBIG, LERC, LZMA,
Zstandard, WebP) or that refuses the layout (NeXT, ThunderScan but at 4
bits, SGILog but of one-sample LogL or three-sample LogLuv, SGILog24 of
LogL, LogLuv in planes, CCITT but at 1 bit, JPEG but at 8); photometrics
4, 9, 10, LogL and LogLuv not SGILog-compressed; float or void
samples; 2-bit samples, 4-bit ones but a palette's, 10-64-bit samples, a
16-bit palette, the floating-point predictor, RGB of fewer than 3
colours, samples below 8 bits with alpha or in planes; CMYK, YCbCr and
CIELab in layouts other than those above; a strip or tile of no
bytes or past the file, and a JPEG stream libtiff or libjpeg refuses
(its size, sampling or component count, a 12-bit or hierarchical
stream); and a non-square image of Orientation 5-8 (cv2 5.0.0's imread
asserts; ROADMAP F9).

Every kind cv2 reads is read: no TIFF is refused that cv2.imread reads.

Headers and IFDs are parsed here and Deflate is Python's zlib; LZW,
PackBits, ThunderScan, SGILog, the fax codecs, the JPEG streams, the
predictor,
bit unpacking and the maps run in the loader core (`csrc/raster_decode.h`,
`csrc/jpeg_decode.h`).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..utils import native_loader as nl

# Compressions libtiff decodes; those it is built without (cv2.imread
# returns nothing); the rest it knows no decoder of, and reads as zeros.
_NEXT, _THUNDERSCAN, _SGILOG, _SGILOG24 = 32766, 32809, 34676, 34677
_READ_COMPRESSION = {1, 5, 8, 32946, 32773, 2, 3, 4, 32771, 7,
                     _THUNDERSCAN, _SGILOG, _SGILOG24}
_FAX = {2, 3, 4, 32771}
_NOT_CONFIGURED = {6: "old-style JPEG", 32909: "PixarLog", 34661: "JBIG",
                   34887: "LERC", 34925: "LZMA", 50000: "Zstandard",
                   50001: "WebP"}
_LOGL, _LOGLUV = 32844, 32845
_PHOTOMETRIC = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "Palette",
                4: "transparency mask", 5: "Separated (CMYK)", 6: "YCbCr",
                8: "CIELab", 9: "ICCLab", 10: "ITULab", _LOGL: "LogL",
                _LOGLUV: "LogLuv"}
# tif_getimage.c: the YCbCr subsamplings with a put routine (contiguous)
_YCBCR_SUBSAMPLING = {(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)}
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}
# TIFFDataWidth
_WIDTHS = {1: 1, 2: 1, 6: 1, 7: 1, 3: 2, 8: 2, 4: 4, 9: 4, 11: 4, 13: 4,
           5: 8, 10: 8, 12: 8, 16: 8, 17: 8, 18: 8}
_UNASSOCIATED = 2
# libtiff's defaults: YCbCrCoefficients, the ReferenceBlackWhite of YCbCr,
# and the D50 WhitePoint (tif_aux.c, in float)
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)
_YCBCR_BLACK_WHITE = np.array([0, 255, 128, 255, 128, 255], np.float32)
_D50 = np.array([96.4250, 100.0, 82.4680], np.float32)
_D50_WHITE = np.array([_D50[0] / (_D50[0] + _D50[1] + _D50[2]),
                       _D50[1] / (_D50[0] + _D50[1] + _D50[2])], np.float32)
_REVERSED = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))


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
        # what EstimateStripByteCounts counts: the header and IFD bytes and
        # the tag values stored out of line; None for a type of no width
        self.dir_bytes = (8 + 2 + 12 * n + 4) if version == 42 else (
            16 + 8 + 20 * n + 8)
        for e in range(n):
            o = ifd + csize + entry * e
            if o + entry > len(data):
                raise OSError(f"{path}: TIFF IFD truncated")
            tag, typ = struct.unpack(self.bo + "HH", data[o:o + 4])
            cnt = self._u(data, o + 4, "I" if version == 42 else "Q")
            width = _WIDTHS.get(typ, 0)
            if width == 0:
                self.dir_bytes = None
            elif self.dir_bytes is not None and width * cnt > inline:
                self.dir_bytes += width * cnt
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


def _rationals(vals) -> np.ndarray:
    """RATIONAL values as libtiff reads them into floats: (float)(n / d),
    0 where the denominator is 0."""
    pairs = np.asarray(vals, np.float64).reshape(-1, 2)
    out = np.zeros(len(pairs), np.float64)
    nz = pairs[:, 1] != 0
    out[nz] = pairs[nz, 0] / pairs[nz, 1]
    return out.astype(np.float32)


class _Layout:
    """What the decode of one TIFF needs, checked against what is read.
    `route`: "read", or "zeros" for a compression libtiff has no decoder of
    (its strips read as zero samples); `refusal` names why cv2.imread
    reads nothing of the file."""

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
        self.fill_order = t.get(266, 1)
        self.g3_2d = bool(t.get(292, 0) & 1)
        self.jpeg_tables = bytes(t.all(347)) if 347 in t.tags else None
        photometric = t.get(262)
        extras = t.all(338)
        if photometric is None:
            photometric = {1: 1, 3: 2}.get(self.spp - len(extras))
        # TIFFReadDirectory: samples past the photometric's colours are
        # extra samples of unspecified meaning
        implied = {0: 1, 1: 1, 2: 3, 3: 1, 6: 3, 8: 3}.get(photometric,
                                                           self.spp)
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
        sub = t.all(530)
        self.subsampling = tuple(sub[:2]) if len(sub) >= 2 else None
        self.luma = _rationals(t.all(529)) if len(t.all(529)) >= 6 \
            else _LUMA
        self.black_white = _rationals(t.all(532)) if len(t.all(532)) >= 12 \
            else _YCBCR_BLACK_WHITE
        self.white_point = _rationals(t.all(318)) if len(t.all(318)) >= 4 \
            else _D50_WHITE
        self.refusal = self._refusal(t)
        if self.refusal:
            return
        if self.compression in (_SGILOG, _SGILOG24):
            # the RGBA interface's "little white lies": tif_luv.c decodes
            # to 8-bit grey (LogL) or RGB (LogLuv) samples
            self.photometric = 1 if photometric == _LOGL else 2
            self.bits, self.colour, self.alpha = 8, self.spp, 0
        self.tiled = 322 in t.tags
        # libtiff decodes no ThunderScan tile: cv2 reads zero samples
        self.route = "read" if self.compression in _READ_COMPRESSION and not (
            self.compression == _THUNDERSCAN and self.tiled) else "zeros"
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
        if not self.tiled:
            counts = self._strip_counts(t, len(data), offsets, counts, need)
        if not self.cw or not self.ch or len(offsets) < need or \
                len(counts) != len(offsets):
            raise OSError(f"{path}: TIFF without its strips or tiles")
        self.chunks = list(zip(offsets, counts))
        self.colormap = t.all(320)
        if self.photometric == 3 and len(self.colormap) < 3 << self.bits:
            raise OSError(f"{path}: TIFF palette without its colormap")

    def _refusal(self, t) -> str:
        """Why cv2.imread reads nothing of the file ("" when it reads
        it), in the order cv2.imread's readHeader and libtiff's RGBA
        interface (TIFFRGBAImageOK, the codec's setup, the put routine's
        choice) refuse a file."""
        p, c, bits = self.photometric, self.compression, self.bits
        sample_format = t.get(339, 1)
        if c in (_SGILOG, _SGILOG24) and (p, self.spp) in (
                (_LOGL, 1), (_LOGLUV, 3)) and not (c == _SGILOG24
                                                   and p == _LOGL):
            # readHeader takes three-sample LogLuv for HDR and checks little
            # of it; libtiff's RGBA interface asks tif_luv.c for 8 bits
            if (p == _LOGL and (bits not in (1, 8, 16)
                                or sample_format not in (1, 2))) or (
                    p == _LOGLUV and (bits not in (1, 2, 4, 8, 16)
                                      or sample_format not in (1, 2, 4, 5,
                                                               6))):
                return (f"SGILog {_PHOTOMETRIC[p]} of {bits}-bit samples "
                        f"of format {sample_format}")
            return "" if self.contig else "LogLuv in planes"
        if sample_format not in (1, 2):   # signed samples read as unsigned
            return f"sample format {sample_format} (float or void samples)"
        if bits not in (1, 4, 8, 16) or (bits == 4 and p != 3):
            return f"{bits or 'mixed'}-bit samples"
        if c in (_SGILOG, _SGILOG24):
            return f"SGI LogLuv compression ({c}) of photometric {p} in " \
                   f"{self.spp} samples"
        if p not in (0, 1, 2, 3, 5, 6, 8):
            return f"photometric {_PHOTOMETRIC.get(p, p)}"
        if c in _NOT_CONFIGURED:
            return f"{_NOT_CONFIGURED[c]} compression ({c}), which cv2's " \
                   f"libtiff is built without"
        if c == _NEXT:
            return "NeXT compression at other than 2 bits"
        if c == _THUNDERSCAN and bits != 4:
            return f"ThunderScan compression at {bits} bits"
        if c in _FAX and bits != 1:
            return f"CCITT compression ({c}) of {bits}-bit samples"
        if c == 7 and bits != 8:
            return f"JPEG compression of {bits}-bit samples"
        if self.predictor not in (1, 2) or (self.predictor == 2
                                            and bits < 8):
            return f"predictor {self.predictor} at {bits} bits"
        if not 1 <= self.spp <= 4:
            return f"{self.spp} samples per pixel"
        if p == 2 and (self.colour < 3 or bits < 8):
            return f"RGB of {self.colour} colours at {bits} bits"
        if p == 3 and (bits > 8 or not self.contig):
            return f"a {bits}-bit or planar palette"
        if bits < 8 and (self.spp != 1 or not self.contig):
            return f"{self.spp} contiguous samples of {bits} bits"
        if p == 5 and (t.get(332, 1) != 1 or self.spp != 4 or bits != 8):
            return (f"Separated (CMYK) of InkSet {t.get(332, 1)}, "
                    f"{self.spp} samples of {bits} bits")
        if p == 6:
            if self.spp != 3 or bits != 8:
                return f"YCbCr of {self.spp} samples of {bits} bits"
            sub = self.subsampling or (2, 2)
            if not self.contig and sub != (1, 1):
                return f"YCbCr subsampled {sub[0]} x {sub[1]} in planes"
            if c != 7 and sub not in _YCBCR_SUBSAMPLING:
                return f"YCbCr subsampled {sub[0]} x {sub[1]}"
            if c != 7 and not (self.luma[1] != 0
                               and np.isfinite(self.luma).all()):
                return "YCbCrCoefficients of 0 or NaN"
        if p == 8 and (self.spp != 3 or self.colour != 3
                       or bits not in (8, 16) or not self.contig):
            return (f"CIELab of {self.spp} samples of {bits} bits"
                    + ("" if self.contig else " in planes"))
        if p == 8 and self.white_point[1] == 0:
            return "a WhitePoint of y = 0"
        return ""

    def size(self):
        return (self.h, self.w) if self.orientation >= 5 else (self.w,
                                                               self.h)

    def _scanline(self) -> int:
        """TIFFScanlineSize64: a row's bytes, for subsampled YCbCr a
        block row's over the vertical subsampling."""
        sub = _subsampled(self)
        if sub:
            blocks = -(-self.w // sub[0]) * (sub[0] * sub[1] + 2)
            return (blocks * self.bits + 7) // 8 // sub[1]
        spp = self.spp if self.planar == 1 else 1
        return (self.w * spp * self.bits + 7) // 8

    def _strip_counts(self, t, size, offsets, counts, nstrips):
        """The StripByteCounts libtiff's TIFFReadDirectory goes by: the
        tag's, or EstimateStripByteCounts' where the tag is missing (one
        strip, or one a plane), looks bad for one strip (ByteCountLooksBad:
        0, past the file's end, or short of the rows, uncompressed), or
        differs between strips 0 and 1 of three or more uncompressed
        contiguous ones."""
        contig = self.planar == 1
        if 279 not in t.tags:
            one = nstrips == 1 if contig else nstrips == self.spp
            return self._estimate(t, size, offsets, nstrips) if one else ()
        if nstrips == 1 and counts and offsets and offsets[0]:
            bc, off = counts[0], offsets[0]
            if bc == 0 or self.compression == 1 and (
                    off <= size and bc > size - off
                    or bc < self._scanline() * self.h):
                return self._estimate(t, size, offsets, nstrips)
        if (contig and nstrips > 2 and self.compression == 1
                and len(counts) >= 2 and counts[0] != counts[1]
                and counts[0] and counts[1]):
            return self._estimate(t, size, offsets, nstrips)
        return counts

    def _estimate(self, t, size, offsets, nstrips):
        """tif_dirread.c EstimateStripByteCounts."""
        if self.compression == 1:
            per_plane = nstrips if self.planar == 1 else nstrips // self.spp
            return (self._scanline() * (self.h // per_plane),) * nstrips
        if t.dir_bytes is None or not offsets:
            raise OSError(f"{self.path}: TIFF tag of an unknown type (cv2."
                          f"imread reads none either)")
        space = max(size - t.dir_bytes, 0)
        if self.planar == 2:
            space //= self.spp
        counts = [space] * nstrips
        last = offsets[nstrips - 1] if len(offsets) >= nstrips else 0
        if last + space > size:
            counts[-1] = 0 if last >= size else size - last
        return tuple(counts)


def _layout(path: str, data: bytes) -> _Layout:
    lay = _Layout(path, data)
    if lay.refusal:
        raise OSError(f"{path}: TIFF with {lay.refusal} (cv2.imread reads "
                      f"none either)")
    if 5 <= lay.orientation <= 8 and lay.w != lay.h:
        raise OSError(f"{path}: a non-square TIFF of Orientation "
                      f"{lay.orientation} (cv2.imread reads none)")
    return lay


def tiff_size(path: str):
    """(w, h) of the TIFF at `path`, its Orientation applied; raises
    OSError for a file cv2.imread reads nothing of. What libtiff checks
    before it
    decodes a chunk is checked here too (every chunk in the file, the
    headers of JPEG-in-TIFF's streams), so that the datasets drop such a
    file when they are built, as JAX's drop cv2's None."""
    data = Path(path).read_bytes()
    lay = _layout(path, data)
    _decode(lay, data, check_only=True)
    return lay.size()


def _subsampled(lay: _Layout):
    """The (h, v) YCbCr subsampling of a file stored in blocks, else None."""
    if lay.photometric != 6 or lay.compression == 7 or not lay.contig:
        return None
    sub = lay.subsampling or (2, 2)
    return None if sub == (1, 1) else sub


def _inflate(chunk: bytes, size: int):
    """(bytes, ok) of one Deflate chunk as tif_zip.c ZIPDecode inflates it
    into a strip of `size` bytes: it stops at `size`; data that end early,
    a bad stream or a failed check fail, keeping what zlib wrote before
    (decompressobj's flush returns that output where decompress would
    raise)."""
    try:
        out = zlib.decompressobj().decompress(chunk, size)
    except zlib.error:
        out = None
    if out is not None and len(out) == size:
        return out, True
    d = zlib.decompressobj()
    try:
        out = d.decompress(chunk, 1)
    except zlib.error:
        return b"", False
    try:
        out += d.flush()
    except zlib.error:
        pass
    return out[:size], False


def _inflated(lay: _Layout, data: bytes, per_chunk: int):
    """Deflate's chunks, inflated by zlib (which releases the interpreter
    lock), end to end: (bytes, [(offset, count)]), a count ~k marking a
    chunk whose inflate failed after k bytes (`_inflate`)."""
    parts, chunks, at = [], [], 0
    down, across = -(-lay.h // lay.ch), -(-lay.w // lay.cw)
    sub = _subsampled(lay)
    for k, (offset, count) in enumerate(lay.chunks):
        if offset < 0 or count <= 0 or offset + count > len(data):
            raise OSError(f"{lay.path}: corrupt or truncated TIFF data")
        cy = (k // across) % down
        rows = lay.ch if lay.tiled else min(lay.ch, lay.h - cy * lay.ch)
        if sub:
            size = -(-rows // sub[1]) * -(-lay.cw // sub[0]) * (
                sub[0] * sub[1] + 2)
        else:
            size = rows * ((lay.cw * per_chunk * lay.bits + 7) // 8)
        part, ok = _inflate(data[offset:offset + count], size)
        parts.append(part)
        chunks.append((at, len(part) if ok else ~len(part)))
        at += len(part)
    return b"".join(parts), chunks


def read_tiff(path: str) -> np.ndarray:
    """The first image of the TIFF at `path` as RGB uint8 (h, w, 3), as
    cv2.imread(path)[..., ::-1] reads it. One loader-core call decodes
    every strip or tile; a second converts CMYK, YCbCr or CIELab."""
    data = Path(path).read_bytes()
    lay = _layout(path, data)
    samples = _decode(lay, data)
    return orient(_rgb(lay, samples, lay.compression == 7), lay.orientation)


def _decode(lay: _Layout, data: bytes, check_only: bool = False):
    """The samples of every strip or tile (native_loader.tiff_decode); with
    `check_only`, None once libtiff's checks before decoding pass."""
    planes = 1 if lay.contig else lay.spp
    per_chunk = lay.spp if lay.contig else 1
    p = lay.photometric
    # samples: 16-bit grey of a contiguous file by its high byte, 16-bit
    # CIELab whole, every other 16-bit sample rounded (Bitdepth16To8)
    grey_map = p in (0, 1) and lay.contig
    flags = ((0 if lay.le else nl.TIFF_BIG_ENDIAN)
             | (nl.TIFF_PREDICTOR if lay.predictor == 2 else 0)
             | (0 if grey_map else nl.TIFF_DIV257))
    if p == 8 and lay.bits == 16:
        flags |= nl.TIFF_RAW16
    compression = lay.compression if lay.route == "read" else 0
    chunks = lay.chunks
    if compression in _FAX:   # the fax decoder reverses bits itself
        flags |= 0 if lay.fill_order == 2 else nl.TIFF_FAX_MSB
    elif lay.fill_order == 2 and compression != 7 and not check_only:
        data = data.translate(_REVERSED)   # TIFFReverseBits before decoding
    if compression in (8, 32946) and not check_only:
        data, chunks = _inflated(lay, data, per_chunk)
        compression = 8
    jpeg = None
    if compression == 7:
        # TIFFRGBAImageBegin sets JPEGCOLORMODE_RGB for contiguous YCbCr:
        # libjpeg converts it; every other photometric is decoded as is
        to_rgb = p == 6 and lay.contig
        sampling = (lay.subsampling or (0, 0)) if to_rgb else (1, 1)
        jpeg = (lay.jpeg_tables, nl.JPEG_YCBCR if to_rgb else nl.JPEG_RAW,
                sampling)
    try:
        return nl.tiff_decode(data, chunks, compression, lay.w, lay.h,
                              lay.cw, lay.ch, lay.tiled, planes, per_chunk,
                              lay.bits, flags, lay.g3_2d,
                              _subsampled(lay) or (0, 0), jpeg, check_only)
    except OSError:
        raise OSError(f"{lay.path}: corrupt or truncated TIFF data") \
            from None


def _rgb(lay: _Layout, samples: np.ndarray, jpeg: bool) -> np.ndarray:
    """The RGBA interface's colours of the unpacked samples."""
    p = lay.photometric
    if p == 5:
        return nl.tiff_colour(samples, nl.TIFF_CMYK)
    if p == 6 and not (jpeg and lay.contig):
        return nl.tiff_colour(samples, nl.TIFF_YCBCR,
                              np.concatenate([lay.luma, lay.black_white]))
    if p == 8:
        return nl.tiff_colour(samples, nl.TIFF_LAB16 if lay.bits == 16
                              else nl.TIFF_LAB8, lay.white_point)
    if p == 3:
        n = 1 << lay.bits
        cmap = np.asarray(lay.colormap[:3 * n], np.uint32).reshape(3, n).T
        if (cmap >= 256).any():
            cmap = cmap >> 8
        lut = np.zeros((256, 3), np.uint8)
        lut[:n] = cmap
        return nl.to_rgb(samples, lut)
    if p in (0, 1) and lay.contig:
        levels = (1 << min(lay.bits, 8)) - 1
        ramp = np.arange(256) * 255 // levels
        if p == 0:
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

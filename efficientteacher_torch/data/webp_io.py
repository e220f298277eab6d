"""WebP without cv2: a `.webp` file as `cv2.imread` reads it, and the
lossless file `cv2.imwrite` writes for `.webp` by default (or a lossy one
at a quality).

cv2.imread (cv2 5.0.0, its libwebp built in) reads WebP by these rules,
and so does this module:

* Recognition: the file's first 32 bytes must pass WebPGetFeatures
  (`_headers(..., full=False)`), else cv2 reads nothing: a file under 32
  bytes is never read, nor one whose canvas cv2's size limits refuse
  (a side over 2^20, or over 2^30 pixels).
* A still image (no animation flag) is decoded by WebPDecodeBGR(A)Into
  over the whole file (`_headers(..., full=True)`, libwebp's
  ParseHeadersInternal): a RIFF header whose size fits the file (bytes past
  it are ignored), or a bare VP8 / VP8L bitstream; an optional VP8X chunk
  (exactly 10 bytes; its canvas must equal the bitstream's size); any
  chunks before the bitstream skipped, within the RIFF size, the last ALPH
  among them kept; then the VP8 or VP8L chunk, whose decoder reads to the
  end of the file. A VP8 frame's ALPH is decoded whatever the VP8X flags
  say, and a damaged one fails the file; its values are dropped (cv2
  drops alpha). An ALPH beside a VP8L bitstream is ignored.
* An animation (VP8X with the animation flag) goes through WebPDemux and
  WebPAnimDecoder (`_demux`): the demuxer's rules are strict (the chunks
  must end exactly at the RIFF size, the frames must fit the canvas, no
  reserved flag may be set, ...), the first frame is decoded onto a
  canvas of zeros at its offset (a frame's size is its bitstream's, not
  the one its ANMF header states), and the rest is black.
* The EXIF orientation: the first EXIF chunk the demuxer keeps (VP8X with
  the EXIF flag, and a file the demuxer accepts; otherwise none), its
  payload a bare TIFF header as in a PNG eXIf chunk, applied as cv2
  applies it (`tiff_io.orient`). A simple (non-VP8X) file has none.

Whatever cv2 returns None on raises OSError here; no kind is refused. The
per-pixel work (the VP8L and VP8 decoders, the fancy upsampling to RGB,
the ALPH check, the EXIF turn of a still image, the writers) runs in the
loader core (`csrc/webp_decode.h`, `csrc/webp_encode.h`); the container
is parsed here.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from ..utils import native_loader as nl
from .tiff_io import exif_orientation, orient

_MAX_CHUNK = 0xFFFFFFFF - 8 - 1     # MAX_CHUNK_PAYLOAD
_MAX_AREA = 1 << 32                 # MAX_IMAGE_AREA
_HEADER = 32                        # cv2's WEBP_HEADER_SIZE
_CV_MAX_SIDE, _CV_MAX_PIXELS = 1 << 20, 1 << 30   # cv2's validateInputImageSize
ALPHA_FLAG, ANIMATION_FLAG, EXIF_FLAG = 0x10, 0x02, 0x08
_VALID_FLAGS = 0x3E                 # alpha, animation, EXIF, ICCP, XMP


def _le24(data: bytes, at: int) -> int:
    return data[at] | data[at + 1] << 8 | data[at + 2] << 16


def _le32(data: bytes, at: int) -> int:
    return struct.unpack_from("<I", data, at)[0]


class _Fail(Exception):
    """libwebp returned an error status."""


class Bitstream(NamedTuple):
    lossless: bool
    offset: int                      # the bitstream's first byte
    w: int
    h: int
    alpha: Optional[tuple]           # (offset, length) of an ALPH payload
    animated: bool


def _vp8_info(data: bytes, at: int, end: int, chunk_size: int):
    """VP8GetInfo: the frame header's size, or _Fail."""
    if end - at < 10 or data[at + 3:at + 6] != b"\x9d\x01\x2a":
        raise _Fail
    bits = data[at] | data[at + 1] << 8 | data[at + 2] << 16
    w = (data[at + 6] | data[at + 7] << 8) & 0x3FFF
    h = (data[at + 8] | data[at + 9] << 8) & 0x3FFF
    if (bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1
            or (bits >> 5) >= chunk_size or not w or not h):
        raise _Fail
    return w, h


def _vp8l_signature(data: bytes, at: int, end: int) -> bool:
    return end - at >= 5 and data[at] == 0x2F and data[at + 4] >> 5 == 0


def _vp8l_info(data: bytes, at: int, end: int):
    """VP8LGetInfo: the header's size, or _Fail."""
    if not _vp8l_signature(data, at, end):
        raise _Fail
    v = int.from_bytes(data[at:at + 5], "little")
    return ((v >> 8) & 0x3FFF) + 1, ((v >> 22) & 0x3FFF) + 1


def _headers(data: bytes, start: int, end: int, full: bool) -> Bitstream:
    """libwebp's ParseHeadersInternal over data[start:end]: `full` as
    WebPDecode parses (all the data is there), else as WebPGetFeatures
    parses a header (a VP8X file's canvas may be all it reads)."""
    if end - start < 12:
        raise _Fail
    pos, riff_size = start, 0
    if data[pos:pos + 4] == b"RIFF":                      # ParseRIFF
        if data[pos + 8:pos + 12] != b"WEBP":
            raise _Fail
        size = _le32(data, pos + 4)
        if size < 12 or size > _MAX_CHUNK or (full and size > end - pos - 8):
            raise _Fail
        riff_size = size
        pos += 12
    if end - pos < 8:                                     # ParseVP8X
        raise _Fail
    vp8x, flags, canvas = False, 0, (0, 0)
    if data[pos:pos + 4] == b"VP8X":
        if _le32(data, pos + 4) != 10 or end - pos < 18:
            raise _Fail
        flags = _le32(data, pos + 8)
        canvas = (1 + _le24(data, pos + 12), 1 + _le24(data, pos + 15))
        if canvas[0] * canvas[1] >= _MAX_AREA:
            raise _Fail
        pos += 18
        vp8x = True
    if vp8x and not riff_size:
        raise _Fail
    animated = bool(flags & ANIMATION_FLAG)
    short = Bitstream(False, pos, *canvas, None, animated)
    if vp8x and animated and not full:
        return short
    alpha = None
    try:
        if end - pos < 4:
            raise EOFError
        if (riff_size and vp8x) or (not riff_size and not vp8x
                                    and data[pos:pos + 4] == b"ALPH"):
            total = 4 + 8 + 10                            # ParseOptionalChunks
            while True:
                if end - pos < 8:
                    raise EOFError
                size = _le32(data, pos + 4)
                if size > _MAX_CHUNK:
                    raise _Fail
                disk = (8 + size + 1) & ~1
                total += disk
                if riff_size and total > riff_size:
                    raise _Fail
                if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                    break
                if end - pos < disk:
                    raise EOFError
                if data[pos:pos + 4] == b"ALPH":
                    alpha = (pos + 8, size)
                pos += disk
        if end - pos < 8:                                 # ParseVP8Header
            raise EOFError
        tag = data[pos:pos + 4]
        if tag in (b"VP8 ", b"VP8L"):
            size = _le32(data, pos + 4)
            if riff_size >= 12 and size > riff_size - 12:
                raise _Fail
            if full and size > end - pos - 8:
                raise _Fail
            pos += 8
            lossless = tag == b"VP8L"
        else:
            lossless = _vp8l_signature(data, pos, end)
            size = end - pos
        if size > _MAX_CHUNK:
            raise _Fail
        if lossless:
            if end - pos < 5:
                raise EOFError
            w, h = _vp8l_info(data, pos, end)
        else:
            if end - pos < 10:
                raise EOFError
            w, h = _vp8_info(data, pos, end, size)
    except EOFError:
        if vp8x and not full:
            return short
        raise _Fail from None
    if vp8x and canvas != (w, h):
        raise _Fail
    return Bitstream(lossless, pos, w, h, alpha, animated)


class _Frame:
    def __init__(self):
        self.num = 0
        self.x = self.y = self.w = self.h = 0
        self.alpha = None            # (chunk offset, chunk size)
        self.image = None
        self.complete = False


class Demux(NamedTuple):
    canvas: tuple
    frames: list
    exif: Optional[bytes]


class _Demuxer:
    """libwebp's WebPDemux (demux.c) of a complete VP8X file; _Fail where
    it returns NULL."""

    def __init__(self, data: bytes):
        self.data = data
        if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
            raise _Fail
        riff_size = _le32(data, 4)
        if riff_size < 8 or riff_size > _MAX_CHUNK:
            raise _Fail
        self.end = riff_size + 8                  # bytes past it are cut
        if len(data) < self.end or data[12:16] != b"VP8X":
            raise _Fail                           # partial, or simple
        self.pos = 12
        self.frames, self.exif = [], None

    def left(self) -> int:
        return self.end - self.pos

    def run(self) -> Demux:
        d = self.data
        self.pos += 4
        size = _le32(d, self.pos)
        self.pos += 4
        if size > _MAX_CHUNK or size < 10:
            raise _Fail
        size += size & 1
        if size > self.left():
            raise _Fail
        self.flags = d[self.pos]
        self.canvas = (1 + _le24(d, self.pos + 4), 1 + _le24(d, self.pos + 7))
        if self.canvas[0] * self.canvas[1] >= _MAX_AREA:
            raise _Fail
        self.pos += size
        if self.left() < 8:
            raise _Fail
        self._chunks()
        self._validate()
        return Demux(self.canvas, self.frames, self.exif)

    def _chunks(self):                            # ParseVP8XChunks
        d = self.data
        animation = self.flags & ANIMATION_FLAG
        anim_chunks = 0
        while True:
            start = self.pos
            fourcc, size = d[start:start + 4], _le32(d, start + 4)
            self.pos += 8
            if size > _MAX_CHUNK:
                raise _Fail
            padded = size + (size & 1)
            if padded > self.left():
                raise _Fail
            if fourcc == b"VP8X":
                raise _Fail
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks or animation:
                    raise _Fail
                self.pos = start
                self._single_image()
            elif fourcc == b"ANIM":
                if padded < 6:
                    raise _Fail
                anim_chunks += 1
                self.pos += padded
            elif fourcc == b"ANMF":
                if not anim_chunks:
                    raise _Fail
                self._animation_frame(padded)
            else:
                if (fourcc == b"EXIF" and self.flags & EXIF_FLAG
                        and self.exif is None):
                    self.exif = d[self.pos:self.pos + size]
                self.pos += padded
            if self.pos == self.end:
                return
            if self.left() < 8:
                raise _Fail

    def _store_frame(self, num: int, min_size: int, f: _Frame):
        d = self.data
        if self.left() < 8 or self.left() < min_size:
            raise _Fail
        alpha_chunks = image_chunks = 0
        while True:
            start = self.pos
            fourcc, size = d[start:start + 4], _le32(d, start + 4)
            self.pos += 8
            if size > _MAX_CHUNK:
                raise _Fail
            padded = size + (size & 1)
            if padded > self.left():
                raise _Fail
            done = False
            if fourcc == b"VP8L" and alpha_chunks:
                raise _Fail                       # VP8L has its own alpha
            if fourcc == b"ALPH" and not alpha_chunks:
                alpha_chunks = 1
                f.alpha, f.num = (start, 8 + padded), num
                self.pos += padded
            elif fourcc in (b"VP8 ", b"VP8L") and not image_chunks:
                feats = _headers(d, start, start + 8 + padded, False)
                image_chunks = 1
                f.image, f.num = (start, 8 + padded), num
                f.w, f.h, f.complete = feats.w, feats.h, True
                self.pos += padded
            else:
                self.pos -= 8                     # left for the caller
                done = True
            if self.pos == self.end or done:
                return
            if self.left() < 8:
                raise _Fail

    def _single_image(self):
        if self.frames:
            raise _Fail
        f = _Frame()
        self._store_frame(1, 0, f)
        if not self.flags & ALPHA_FLAG:
            f.alpha = None
        self._add(f)

    def _animation_frame(self, padded: int):
        d = self.data
        if padded < 16 or self.left() < 16:
            raise _Fail
        f = _Frame()
        p = self.pos
        f.x, f.y = 2 * _le24(d, p), 2 * _le24(d, p + 3)
        f.w, f.h = 1 + _le24(d, p + 6), 1 + _le24(d, p + 9)
        self.pos += 16
        if f.w * f.h >= _MAX_AREA:
            raise _Fail
        start = self.pos
        self._store_frame(len(self.frames) + 1, padded - 16, f)
        if self.pos - start > padded - 16:
            raise _Fail
        if self.flags & ANIMATION_FLAG and f.num > 0:
            self._add(f)

    def _add(self, f: _Frame):
        if self.frames and not self.frames[-1].complete:
            raise _Fail
        self.frames.append(f)

    def _validate(self):                          # IsValidExtendedFormat
        animation = self.flags & ANIMATION_FLAG
        cw, ch = self.canvas
        if not self.frames or self.flags & ~_VALID_FLAGS:
            raise _Fail
        for f in self.frames:
            if not animation and f.num > 1:
                raise _Fail
            if not f.complete:
                raise _Fail                       # no partial frame
            if f.alpha and f.alpha[0] > f.image[0]:
                raise _Fail
            if f.w <= 0 or f.h <= 0:
                raise _Fail
            if animation:
                if f.x + f.w > cw or f.y + f.h > ch:
                    raise _Fail
            elif f.x or f.y or (f.w, f.h) != (cw, ch):
                raise _Fail


def _demux(data: bytes) -> Optional[Demux]:
    """The demuxer's view of a VP8X file, None where WebPDemux fails."""
    try:
        return _Demuxer(data).run()
    except (_Fail, IndexError, struct.error):
        return None


def _parse(path: str, data: bytes):
    """(bitstream, demux or None, orientation) as cv2.imread reads the file
    `data`: an animation's bitstream is its first frame's (its offset on
    the canvas in the demux's first frame)."""
    try:
        if len(data) < _HEADER:
            raise _Fail
        feats = _headers(data, 0, _HEADER, False)
        if max(feats.w, feats.h) > _CV_MAX_SIDE or \
                feats.w * feats.h > _CV_MAX_PIXELS:
            raise _Fail
        dm = _demux(data) if data[12:16] == b"VP8X" else None
        if feats.animated:
            if dm is None:
                raise _Fail
            f = dm.frames[0]
            start = f.alpha[0] if f.alpha else f.image[0]
            end = f.image[0] + f.image[1]
            _headers(data, start, end, False)
            bs = _headers(data, start, end, True)
            bs = bs._replace(animated=True)
        else:
            bs = _headers(data, 0, len(data), True)
            if (bs.w, bs.h) != (feats.w, feats.h):
                raise _Fail
    except (_Fail, IndexError, struct.error):
        raise OSError(f"{path}: not a WebP file cv2.imread reads (its "
                      f"RIFF, VP8X or chunk headers are corrupt or "
                      f"truncated)") from None
    orientation = exif_orientation(dm.exif) if dm and dm.exif else 1
    return bs, dm, orientation


def webp_size(path: str):
    """(w, h) of the WebP at `path` from its headers, EXIF orientation
    applied; OSError for a file cv2.imread does not read."""
    bs, dm, orientation = _parse(path, Path(path).read_bytes())
    w, h = dm.canvas if bs.animated else (bs.w, bs.h)
    return (h, w) if orientation >= 5 else (w, h)


def read_webp(path: str) -> np.ndarray:
    """The WebP at `path` as RGB uint8 (h, w, 3), as cv2.imread(path)[...,
    ::-1] reads it."""
    data = Path(path).read_bytes()
    bs, dm, orientation = _parse(path, data)
    if not bs.animated:   # the core applies the orientation
        return nl.webp_decode(data, bs.offset, bs.lossless, bs.w, bs.h,
                              bs.alpha, orientation)
    f = dm.frames[0]
    end = f.image[0] + f.image[1]
    frame = nl.webp_decode(np.frombuffer(data, np.uint8)[:end], bs.offset,
                           bs.lossless, bs.w, bs.h, bs.alpha)
    cw, ch = dm.canvas
    img = np.zeros((ch, cw, 3), np.uint8)
    img[f.y:f.y + bs.h, f.x:f.x + bs.w] = frame
    return orient(img, orientation)


def write_webp(path: str, rgb: np.ndarray, quality=None) -> None:
    """Write `rgb` (h, w, 3) uint8 as a WebP: RIFF and one VP8L chunk
    (lossless, cv2.imwrite's default), or one VP8 chunk at `quality` 0-100
    (the writer's own scale; cv2's IMWRITE_WEBP_QUALITY <= 100 kind). The
    loader core writes the bitstream (`csrc/webp_encode.h`)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    if not (0 < w < 16384 and 0 < h < 16384):
        raise ValueError(f"{path}: WebP holds up to 16383 x 16383 pixels, "
                         f"not {w} x {h}")
    body = nl.webp_encode(rgb, quality)
    tag = b"VP8L" if quality is None else b"VP8 "
    chunk = tag + struct.pack("<I", len(body)) + body \
        + b"\0" * (len(body) & 1)
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", 4 + len(chunk))
                           + b"WEBP" + chunk)

"""ctypes binding of the port's host loader core (`csrc/loader_core.cpp`,
built at first use by `ops/_build.host_library`).

Counterpart of `efficientteacher_tpu/utils/native_loader.py`. The core
decodes JPEG itself (`csrc/jpeg_decode.h`, no libjpeg), bit-equal to
cv2.imread on every JPEG kind libjpeg reads as cv2 calls it (Huffman and
arithmetic, sequential, progressive and 8-bit lossless, every colour space
and sampling set, damaged and truncated data, block smoothing); the kinds
libjpeg refuses (`_REFUSED`) raise OSError from `jpeg_info`, which the
datasets call for every file when they are built (`data/image_io.py`), and
the datasets drop them as JAX's drop cv2's None. Unlike the JAX binding it
never falls back. It also runs the per-pixel stages of PNG, BMP and TIFF
(`csrc/raster_decode.h`: `png_decode`, `to_rgb`, `bmp_decode`,
`tiff_decode` with the CCITT, JPEG-in-TIFF and YCbCr blocks,
`tiff_colour` for CMYK, YCbCr and CIELab, `lzw_encode`),
decodes WebP's two bitstreams, VP8L and VP8 with its ALPH chunk
(`csrc/webp_decode.h`: `webp_decode`; `data/webp_io.py` parses the
container), writes either (`csrc/webp_encode.h`: `webp_encode`), and draws
label text as cv2.putText does (`csrc/text_render.h`: `put_text`).
Images are RGB uint8, (h, w, 3), C-contiguous. Each call releases the
interpreter lock while it runs (ctypes does), so loader threads decode in
parallel.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np

from ..ops._build import host_library

_P, _I, _C, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, \
    ctypes.c_int64
_SIGNATURES = {
    "et_jpeg_info": (_C, _P),
    # path, denom, orient, out, ow, oh
    "et_jpeg_decode": (_C, _I, _I, _P, _I, _I),
    # path, expect w/h, canvas, ch, cw, top, left, new_w, new_h, pad,
    # flags (1 prescale, 2 EXIF orientation)
    "et_jpeg_letterbox": (_C, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I),
    # src, sw, sh, sstride, canvas, ch, cw, top, left, new_w, new_h, pad
    "et_resize_letterbox": (_P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I),
    # data, n, w, h, bits, spp, interlaced, out
    "et_png_decode": (_P, _L, _I, _I, _I, _I, _I, _P),
    # src, n, spp, lut (or null), alpha, out
    "et_to_rgb": (_P, _L, _I, _P, _I, _P),
    # data, n, offset, w, h, bottom_up, bpp, rle, palette, out
    "et_bmp_decode": (_P, _L, _L, _I, _I, _I, _I, _I, _P, _P),
    # src, n, dst, cap, written
    "et_lzw_encode": (_P, _L, _P, _L, _P),
    # data, n, offsets, counts, nchunks, compression, layout (16 ints),
    # tables, ntables, out
    "et_tiff_decode": (_P, _L, _P, _P, _I, _I, _P, _P, _L, _P),
    # src, n, spp, kind, params (floats), out
    "et_tiff_colour": (_P, _L, _I, _I, _P, _P),
    "et_jpeg_write": (_C, _P, _I, _I, _I),
    # data, n, lossless, w, h, alpha, alpha_n, has_alpha, orient, out
    "et_webp_decode": (_P, _L, _I, _I, _I, _P, _L, _I, _I, _P),
    # rgb, w, h, quality (< 0: lossless), dst, cap, written
    "et_webp_encode": (_P, _I, _I, _I, _P, _L, _P),
    # src, sw, sh, sstride, dst, dw, dh, matrix (doubles), border, flags
    "et_warp": (_P, _I, _I, _I, _P, _I, _I, _P, _I, _I),
    # img, h, w, stride, lut_h, lut_s, lut_v, blue
    "et_augment_hsv": (_P, _I, _I, _I, _P, _P, _P, _I),
    "et_gray": (_P, _I, _I, _I, _P, _I),
    # img, h, w, stride, kernel (9 ints), divisor, out
    "et_filter3x3": (_P, _I, _I, _I, _P, _I, _P),
    # font, font_n, fallback font, its n, img, h, w, stride, cps, n, org_x,
    # org_y, color (3 ints)
    "et_put_text": (_P, _L, _P, _L, _P, _I, _I, _I, _P, _I, _I, _I, _P),
    # handle, packet, n, info (w, h, tool)
    "et_video_decode": (_P, _P, _L, _P),
    # handle, out (h, w, 3) BGR
    "et_video_bgr": (_P, _P),
}
# entries that return a handle or nothing: (argtypes, restype)
_HANDLES = {
    # codec (1 MPEG-4 Part 2, 2 MJPEG), extradata, n, flags
    "et_video_open": ((_I, _P, _L, _I), _P),
    "et_video_close": ((_P,), None),
}
_ERRORS = {-1: "cannot open the file",
           -2: "corrupt or truncated image data",
           -3: "its size differs from the labels cache's",
           -4: "a JPEG kind libjpeg refuses too",
           -5: "bad sizes"}
# csrc/jpeg_decode.h etjpeg::Kind: the kinds libjpeg refuses as cv2.imread
# calls it (cv2 returns nothing); the file is corrupt to the datasets
# (OSError), which drop it as JAX's do (ROADMAP F10)
_REFUSED = {1: "arithmetic-coded lossless frames (SOF11)",
            2: "a sample precision the 8-bit API does not read (8, or 2-8 "
               "lossless)",
            3: "a lossless colour conversion (grey or YCbCr to BGR)",
            4: "hierarchical or differential frames (SOF5-7, SOF13-15, DHP, "
               "EXP) or the JPG marker",
            5: "neither 1, 3 nor 4 components",
            6: "sampling factors libjpeg does not decode (a ratio that is "
               "not integral, or more than 10 blocks in an MCU)"}
PRESCALE, ORIENT = 1, 2


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = host_library().lib
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    for name, (argtypes, restype) in _HANDLES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def _check(code: int, what: str) -> None:
    if code != 0:
        raise OSError(f"{what}: {_ERRORS.get(code, code)}")


def _canvas(canvas: np.ndarray):
    if (canvas.dtype != np.uint8 or canvas.ndim != 3 or canvas.shape[2] != 3
            or not canvas.flags.c_contiguous):
        raise ValueError("canvas must be C-contiguous uint8 (h, w, 3)")
    return canvas.ctypes.data, canvas.shape[0], canvas.shape[1]


def _jpeg_header(path: str):
    """(w, h, orientation, scalable) of the JPEG's headers (scalable: 0 for
    a lossless file, which libjpeg reads at full size whatever the scale).
    Raises OSError for a file that is missing, not a JPEG, or of a kind
    libjpeg refuses (`_REFUSED`)."""
    info = np.zeros(5, np.int32)
    code = _lib().et_jpeg_info(os.fsencode(path), info.ctypes.data)
    if code == -4:
        raise OSError(f"{path}: JPEG with {_REFUSED[int(info[3])]}")
    _check(code, path)
    return int(info[0]), int(info[1]), int(info[2]), bool(info[4])


def jpeg_info(path: str):
    """(w, h, orientation) from the JPEG's headers: the size as stored and
    the EXIF orientation (1-8; 1 without a well-formed Exif block). Raises
    OSError for a file that is missing, not a JPEG, or of a kind libjpeg
    refuses (`_REFUSED`)."""
    return _jpeg_header(path)[:3]


def oriented_size(w: int, h: int, orientation: int):
    """(w, h) once the EXIF orientation is applied: 5-8 transpose."""
    return (h, w) if orientation >= 5 else (w, h)


def jpeg_decode(path: str, denom: int = 1, orient: bool = True):
    """The JPEG at `path` as RGB uint8 (h, w, 3), decoded at scale 1/denom
    (1, 2, 4, 8: cv2.imread's IMREAD_REDUCED_COLOR_*; a lossless file comes
    at full size, as libjpeg gives it), with the EXIF orientation applied
    when `orient` (cv2.imread's default)."""
    w, h, o, scalable = _jpeg_header(path)
    if not scalable:
        denom = 1
    ow, oh = -(-w // denom), -(-h // denom)
    if orient:
        ow, oh = oriented_size(ow, oh, o)
    out = np.empty((oh, ow, 3), np.uint8)
    _check(_lib().et_jpeg_decode(os.fsencode(path), int(denom), int(orient),
                                 out.ctypes.data, ow, oh), path)
    return out


def jpeg_letterbox(path: str, canvas: np.ndarray, top: int, left: int,
                   new_w: int, new_h: int, pad_value: int = 114,
                   expect_wh=(0, 0), prescale: bool = False,
                   orient: bool = True) -> None:
    """Decode `path`, resize it to (new_w, new_h) (cv2 INTER_LINEAR) and
    write it at (top, left) into `canvas`, filled first with `pad_value`
    (-1: left as it is). `expect_wh` (w, h) is checked against the
    oriented size (`image_io.image_size`, the labels cache's). `prescale`
    allows the IDCT downscale (Dataset.native_loader); `orient` applies the
    EXIF orientation, as cv2.imread does."""
    ptr, ch, cw = _canvas(canvas)
    flags = (PRESCALE if prescale else 0) | (ORIENT if orient else 0)
    _check(_lib().et_jpeg_letterbox(
        os.fsencode(path), int(expect_wh[0]), int(expect_wh[1]), ptr, ch, cw,
        int(top), int(left), int(new_w), int(new_h), int(pad_value), flags),
        path)


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


def _image(img: np.ndarray, what: str):
    """(pointer, h, w, row stride) of a uint8 (h, w, 3) image whose rows
    are packed (a slice of rows or of columns of a larger image passes)."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 \
            or img.strides[1:] != (3, 1):
        raise ValueError(f"{what} must be uint8 (h, w, 3) with packed rows")
    return img.ctypes.data, img.shape[0], img.shape[1], img.strides[0]


def warp(src: np.ndarray, matrix: np.ndarray, dsize, border: int = 114
         ) -> np.ndarray:
    """cv2.warpAffine(src, matrix, dsize, borderValue=(border,) * 3) for a
    2x3 `matrix`, cv2.warpPerspective for a 3x3 one: INTER_LINEAR, the
    forward map inverted as cv2 inverts it, bit-equal to cv2 5.0.0
    (`csrc/pixel_ops.h`). `dsize` is (w, h); returns (h, w, 3) uint8."""
    m = np.ascontiguousarray(matrix, np.float64)
    if m.shape not in ((2, 3), (3, 3)):
        raise ValueError(f"warp matrix of shape {m.shape}")
    ptr, h, w, stride = _image(src, "src")
    dw, dh = (int(v) for v in dsize)
    out = np.empty((dh, dw, 3), np.uint8)
    _check(_lib().et_warp(ptr, w, h, stride, out.ctypes.data, dw, dh,
                          m.ctypes.data, int(border), int(m.shape[0] == 3)),
           "warp")
    return out


def augment_hsv(img: np.ndarray, lut_h, lut_s, lut_v, blue: int = 2) -> None:
    """In place: cv2's BGR2HSV, the three 256-entry uint8 LUTs, HSV2BGR, as
    JAX `augment_hsv` applies them; `blue` is the channel of blue (2 for
    the port's RGB images, 0 for BGR)."""
    ptr, h, w, stride = _image(img, "img")
    luts = [np.ascontiguousarray(t, np.uint8) for t in (lut_h, lut_s, lut_v)]
    if any(t.shape != (256,) for t in luts):
        raise ValueError("each LUT has 256 entries")
    _check(_lib().et_augment_hsv(ptr, h, w, stride, *(t.ctypes.data
                                                       for t in luts),
                                 int(blue)), "augment_hsv")


def gray(img: np.ndarray, blue: int = 2) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2GRAY) as (h, w) uint8; `blue` as in
    `augment_hsv`."""
    ptr, h, w, stride = _image(img, "img")
    out = np.empty((h, w), np.uint8)
    _check(_lib().et_gray(ptr, h, w, stride, out.ctypes.data, int(blue)),
           "gray")
    return out


def filter3x3(img: np.ndarray, kernel, divisor: int) -> np.ndarray:
    """cv2.filter2D(img, -1, kernel / divisor) for an integer 3x3 `kernel`
    and an odd `divisor` (BORDER_REFLECT_101)."""
    ptr, h, w, stride = _image(img, "img")
    k = np.ascontiguousarray(kernel, np.int32).reshape(9)
    out = np.empty((h, w, 3), np.uint8)
    _check(_lib().et_filter3x3(ptr, h, w, stride, k.ctypes.data,
                               int(divisor), out.ctypes.data), "filter3x3")
    return out


def jpeg_write(path: str, rgb: np.ndarray, quality: int = 90) -> None:
    """Write `rgb` (h, w, 3) uint8 as a baseline JFIF JPEG, 4:2:0,
    libjpeg's quantisation tables at `quality` (`data/image_io.imwrite`
    writes at cv2.imwrite's 95)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    _check(_lib().et_jpeg_write(os.fsencode(path), rgb.ctypes.data,
                                rgb.shape[1], rgb.shape[0], int(quality)),
           path)


def _bytes(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data, np.uint8)


def png_decode(data: bytes, w: int, h: int, bits: int, spp: int,
               interlaced: bool) -> np.ndarray:
    """The inflated IDAT stream of a (w, h) PNG -> (h, w, spp) uint8:
    each sample as its value (1-8 bits) or its high byte (16 bits),
    filters undone, Adam7 passes put in place."""
    buf = _bytes(data)
    out = np.empty((h, w, spp), np.uint8)
    _check(_lib().et_png_decode(buf.ctypes.data, buf.size, w, h, bits, spp,
                                int(interlaced), out.ctypes.data), "PNG")
    return out


def to_rgb(samples: np.ndarray, lut=None, alpha: int = -1) -> np.ndarray:
    """(h, w, spp) uint8 samples -> (h, w, 3) RGB: the first sample
    through `lut` (256 x 3 uint8) when given, else samples 0-2; each
    channel premultiplied by sample `alpha` when it is >= 0."""
    s = np.ascontiguousarray(samples, np.uint8)
    h, w, spp = s.shape
    out = np.empty((h, w, 3), np.uint8)
    table = None if lut is None else np.ascontiguousarray(lut, np.uint8)
    if table is not None and table.shape != (256, 3):
        raise ValueError("lut must be (256, 3) uint8")
    _check(_lib().et_to_rgb(s.ctypes.data, h * w, spp,
                            None if table is None else table.ctypes.data,
                            int(alpha), out.ctypes.data), "to_rgb")
    return out


def bmp_decode(data: bytes, offset: int, w: int, h: int, bottom_up: bool,
               bpp: int, rle: int, palette: np.ndarray) -> np.ndarray:
    """A BMP's pixels as OpenCV's BmpDecoder reads them: `bpp` 1/4/8/15
    (5-5-5)/16 (5-6-5)/24/32, `rle` 0/8/4, `palette` (256, 3) RGB ->
    (h, w, 3) RGB, top row first."""
    buf = _bytes(data)
    pal = np.ascontiguousarray(palette, np.uint8)
    if pal.shape != (256, 3):
        raise ValueError("palette must be (256, 3) uint8")
    out = np.empty((h, w, 3), np.uint8)
    _check(_lib().et_bmp_decode(buf.ctypes.data, buf.size, offset, w, h,
                                int(bottom_up), bpp, rle, pal.ctypes.data,
                                out.ctypes.data), "BMP")
    return out


# tiff_decode's flags: 16-bit samples big-endian; the horizontal predictor
# (Predictor 2); 16-bit samples reduced as (v + 128) / 257 (else the high
# byte); 16-bit samples kept whole (two bytes, low first); CCITT data of
# FillOrder 1
TIFF_BIG_ENDIAN, TIFF_PREDICTOR, TIFF_DIV257, TIFF_RAW16, TIFF_FAX_MSB = \
    1, 2, 4, 8, 16
# tiff_colour's kinds
TIFF_CMYK, TIFF_YCBCR, TIFF_LAB8, TIFF_LAB16 = 1, 2, 3, 4
# the colour spaces a JPEG chunk is decoded as (csrc/jpeg_decode.h Colour)
JPEG_YCBCR, JPEG_RAW = 1, 5


def tiff_decode(data, chunks, compression: int, w: int, h: int, cw: int,
                ch: int, tiled: bool, planes: int, per_chunk: int, bits: int,
                flags: int = 0, g3_2d: bool = False, subsampling=(0, 0),
                jpeg=None, check_only: bool = False):
    """The strips or tiles of a TIFF image -> (h, w, per_chunk * planes)
    uint8 samples ((h, w, spp, 2) with TIFF_RAW16: each 16-bit sample's
    low then high byte): `chunks` (offset, byte count) into `data`,
    compressed by `compression` (1 none, 8 Deflate already inflated: a
    count ~k marks a chunk whose inflate failed after k bytes, 5 LZW,
    32773 PackBits, 2 / 32771
    CCITT modified Huffman, 3 Group 3 (`g3_2d`: two-dimensional), 4 Group
    4, 7 JPEG, 0 none that decodes: zeros), in the file's order (plane,
    then chunk rows, then across); `flags` of `TIFF_*`; `subsampling`
    (h, v) of a subsampled YCbCr file (its samples come back as Y, Cb, Cr
    per pixel); `jpeg` (tables bytes or None, colour JPEG_*,
    (h, v) sampling libtiff expects of component 0, (0, 0): the first
    chunk's). With `check_only` nothing is decoded and None is returned:
    what libtiff checks before it decodes a chunk (that it lies in the
    data, a JPEG chunk's headers) raises as the decode would."""
    buf = _bytes(data)
    table = np.ascontiguousarray(np.asarray(chunks, np.int64).reshape(-1, 2).T)
    tables, colour, (jh, jv) = jpeg or (None, JPEG_RAW, (1, 1))
    layout = np.array([w, h, cw, ch, int(tiled), planes, per_chunk,
                       per_chunk * planes, bits, flags, int(g3_2d),
                       subsampling[0], subsampling[1], colour, jh, jv],
                      np.int32)
    shape = (h, w, per_chunk * planes) + ((2,) if flags & TIFF_RAW16 else ())
    out = None if check_only else np.empty(shape, np.uint8)
    tab = None if tables is None else _bytes(tables)
    code = _lib().et_tiff_decode(buf.ctypes.data, buf.size,
                                 table[0].ctypes.data, table[1].ctypes.data,
                                 table.shape[1], compression,
                                 layout.ctypes.data,
                                 None if tab is None else tab.ctypes.data,
                                 0 if tab is None else tab.size,
                                 None if out is None else out.ctypes.data)
    _check(code, "TIFF")
    return out


def tiff_colour(samples: np.ndarray, kind: int, params=()) -> np.ndarray:
    """(h, w, spp) samples ((h, w, spp, 2) for TIFF_LAB16) of a TIFF's
    CMYK, YCbCr or CIELab image -> (h, w, 3) RGB as libtiff's RGBA
    interface converts them; `params` the floats `kind` needs (csrc/
    raster_decode.h tiff_colour)."""
    s = np.ascontiguousarray(samples, np.uint8)
    h, w, spp = s.shape[:3]
    p = np.zeros(9, np.float32)
    p[:len(params)] = params
    out = np.empty((h, w, 3), np.uint8)
    _check(_lib().et_tiff_colour(s.ctypes.data, h * w, spp, kind,
                                 p.ctypes.data, out.ctypes.data),
           "TIFF colour")
    return out


def lzw_encode(data) -> bytes:
    """`data` as one TIFF LZW stream."""
    buf = _bytes(data)
    cap = buf.size * 2 + 64
    out = np.empty(cap, np.uint8)
    n = ctypes.c_int64(0)
    _check(_lib().et_lzw_encode(buf.ctypes.data, buf.size, out.ctypes.data,
                                cap, ctypes.byref(n)), "LZW")
    return out[:n.value].tobytes()


def webp_decode(data, offset: int, lossless: bool, w: int, h: int,
                alpha=None, orientation: int = 1) -> np.ndarray:
    """A WebP bitstream -> RGB uint8: `data` from byte `offset` on (the
    VP8L or VP8 chunk's payload, then whatever followed it in what libwebp
    was given), of size (w, h), turned as EXIF `orientation` asks ((h, w,
    3) for 1-4, (w, h, 3) for 5-8). `alpha` (offset, length) of a VP8
    frame's ALPH payload in `data`, or None; the alpha must decode, and is
    dropped."""
    buf = _bytes(data)
    if not 0 <= offset <= buf.size:
        raise ValueError("offset outside the data")
    base = buf.ctypes.data
    a_ptr, a_len = (None, 0) if alpha is None else (base + alpha[0],
                                                     alpha[1])
    ow, oh = oriented_size(w, h, orientation)
    out = np.empty((oh, ow, 3), np.uint8)
    _check(_lib().et_webp_decode(base + offset, buf.size - offset,
                                 int(lossless), w, h, a_ptr, a_len,
                                 int(alpha is not None), int(orientation),
                                 out.ctypes.data), "WebP")
    return out


def webp_encode(rgb: np.ndarray, quality=None) -> bytes:
    """`rgb` (h, w, 3) uint8 as the payload of a VP8L chunk (lossless, when
    `quality` is None) or of a VP8 chunk at `quality` 0-100 (the writer's
    own scale, `csrc/webp_encode.h`)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    cap = h * w * 5 + 4096
    out = np.empty(cap, np.uint8)
    n = ctypes.c_int64(0)
    _check(_lib().et_webp_encode(rgb.ctypes.data, w, h,
                                 -1 if quality is None else int(quality),
                                 out.ctypes.data, cap, ctypes.byref(n)),
           "WebP writer")
    return out[:n.value].tobytes()


def put_text(canvas: np.ndarray, label: str, org, color, font: np.ndarray,
             fallback: Optional[np.ndarray] = None) -> None:
    """cv2.putText(canvas, label, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    into `canvas` (h, w, 3) uint8, C-contiguous, in place, with the bytes
    of cv2's TrueType font `font` and of its fallback font `fallback`
    (`csrc/text_render.h`); `color` one value per channel in the canvas's
    order."""
    ptr, h, w = _canvas(canvas)
    # cv2 takes the label as a C string: it ends at the first NUL
    cps = np.array([ord(ch) for ch in label.split("\0")[0]], np.uint32)
    col = np.array([int(v) for v in color[:3]], np.int32)
    uni = fallback if fallback is not None else np.zeros(1, np.uint8)
    _check(_lib().et_put_text(font.ctypes.data, font.size, uni.ctypes.data,
                              0 if fallback is None else uni.size, ptr, h, w,
                              w * 3, cps.ctypes.data, cps.size, int(org[0]),
                              int(org[1]), col.ctypes.data), "putText")

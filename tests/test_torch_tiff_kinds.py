"""The TIFF kinds of ROADMAP Q1.9c's TIFF half (`efficientteacher_torch/
data/tiff_io.py`, `csrc/raster_decode.h`, `csrc/jpeg_decode.h`) against
cv2.imread (cv2 5.0.0, its libtiff 4.7.1 built in): JPEG-in-TIFF, CCITT
modified Huffman, Group 3 and Group 4, CMYK, CIELab, YCbCr in every
subsampling libtiff draws, signed samples and FillOrder 2; and Q1.9d's:
SGILog LogL and LogLuv, SGILog24 LogLuv (well-formed and damaged, every
depth and sample format cv2 takes) and ThunderScan in tiles; the files cv2
reads nothing of (ROADMAP F10: the port raises OSError, the datasets drop
them as JAX's do) and those it reads as zero samples (a compression
libtiff has no decoder of); and the port's datasets and LoadImages on a
split of them against the JAX package's.

Tolerance: exact everywhere. Every kind (`KINDS`) is written by this
module's own writers (numpy and the port's JPEG writer only, so that
chip_smoke.py writes them on the card's machine too), by Pillow (its
libtiff writes JPEG-in-TIFF and the fax codecs) or by hand, then read by
the port and by `cv2.imread(p)[..., ::-1]`: the two are equal, as are
`image_size` and cv2's shape. Damaged fax streams (random data, seeded
bit flips, truncations, zeroed runs) decode as libtiff decodes them.

`FIXTURES` are small files of these kinds (base64) with the SHA-256 of
cv2.imread's RGB output, the oracle on the card's machine
(`check_fixtures`, called by chip_smoke.py and tests/test_torch_cuda.py).
Regenerate them with `PYTHONPATH=. python tests/test_torch_tiff_kinds.py`
(it prints the dict; needs cv2 and Pillow). This module imports no JAX,
cv2 or Pillow at import time: the tests that compare against them import
them.
"""

import base64
import hashlib
import io
import os
import struct
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

from efficientteacher_torch.data import datasets as port_ds
from efficientteacher_torch.data import image_io, loaders, tiff_io
from efficientteacher_torch.utils import native_loader as nl

from test_torch_image_formats import (  # noqa: F401
    SIZES, one_torch_thread, tiff_bytes, tiff_file)


def rgb_digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _cv2():
    return pytest.importorskip("cv2")


def _cv2_read(path):
    img = _cv2().imread(str(path))
    return None if img is None else np.ascontiguousarray(img[..., ::-1])


def _pil():
    return pytest.importorskip("PIL.Image")


def smooth(rng, h, w, c=3):
    """A blurred random image: runs for the fax and JPEG codecs."""
    x = rng.integers(0, 256, (h + 4, w + 4, c)).astype(np.float64)
    for axis in (0, 1):
        x = (np.roll(x, 1, axis) + 2 * x + np.roll(x, -1, axis)) / 4
    return x[2:-2, 2:-2].round().clip(0, 255).astype(np.uint8)


# -- writers ------------------------------------------------------------------

_REV = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))


def fill_order_2(data: bytes) -> bytes:
    """A single-IFD file of tiff_bytes with FillOrder 2: the bits of its
    strips (between the header and the IFD) reversed, the tag added."""
    ifd = struct.unpack("<I", data[4:8])[0]
    return data[:8] + data[8:ifd].translate(_REV) + data[ifd:]


def ycc(rgb: np.ndarray):
    """RGB -> the JFIF YCbCr planes (uint8), which libtiff's default
    YCbCrCoefficients and ReferenceBlackWhite turn back into about `rgb`."""
    x = rgb.astype(np.float64)
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    cb = 128 + (x[..., 2] - y) * 0.564
    cr = 128 + (x[..., 0] - y) * 0.713
    return np.stack([np.rint(c).clip(0, 255) for c in (y, cb, cr)],
                    -1).astype(np.uint8)


def ycbcr_blocks(rgb: np.ndarray, sub, rows: int) -> list:
    """The strips (`rows` rows each, a multiple of sub[1]) of a
    subsampled YCbCr image: blocks of sub[0] x sub[1] Y samples then the
    block's mean Cb and Cr, edge pixels repeated into partial blocks."""
    hs, vs = sub
    h, w = rgb.shape[:2]
    p = ycc(rgb)
    ph, pw = -(-h // vs) * vs, -(-w // hs) * hs
    p = np.pad(p, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    blocks = p.reshape(ph // vs, vs, pw // hs, hs, 3).transpose(0, 2, 1, 3, 4)
    y = blocks[..., 0].reshape(ph // vs, pw // hs, vs * hs)
    chroma = blocks[..., 1:].reshape(ph // vs, pw // hs, -1, 2).mean(2)
    flat = np.concatenate([y, np.rint(chroma).astype(np.uint8)], 2)
    return [flat[r // vs:(r + rows) // vs].tobytes()
            for r in range(0, ph, rows)]


def cmyk(rgb: np.ndarray) -> np.ndarray:
    """RGB -> CMYK with K = 255 - max(R, G, B)."""
    x = rgb.astype(np.int64)
    m = x.max(2, keepdims=True)
    c = 255 - (x * 255 + np.maximum(m, 1) // 2) // np.maximum(m, 1)
    return np.concatenate([c, 255 - m], 2).clip(0, 255).astype(np.uint8)


def cielab(rgb: np.ndarray, bits: int = 8) -> np.ndarray:
    """RGB -> CIELab samples (L 0-100 on 0-2^bits-1, a* b* signed) that
    libtiff's display_sRGB turns back into about `rgb`: each gun's value
    v is the luminance 1 + 99 (v / 255)^2.4, the D50 white."""
    lum = 1 + 99 * (rgb.astype(np.float64) / 255) ** 2.4
    m = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                  [0.0556, -0.2040, 1.0570]])
    xyz = lum @ np.linalg.inv(m).T / np.array([96.425, 100.0, 82.468])

    def f(t):
        return np.where(t > 0.008856, np.cbrt(t), 7.787 * t + 16 / 116)

    fx, fy, fz = (f(xyz[..., k]) for k in range(3))
    L, a, b = 116 * fy - 16, 500 * (fx - fy), 200 * (fy - fz)
    if bits == 8:
        out = np.stack([np.rint(L * 2.55).clip(0, 255),
                        np.rint(a).clip(-128, 127) % 256,
                        np.rint(b).clip(-128, 127) % 256], -1)
        return out.astype(np.uint8)
    out = np.stack([np.rint(L * 655.35).clip(0, 65535),
                    np.rint(a * 256).clip(-32768, 32767) % 65536,
                    np.rint(b * 256).clip(-32768, 32767) % 65536], -1)
    return out.astype(np.uint16)


def jpeg_stream(rgb: np.ndarray, quality: int = 90) -> bytes:
    """A baseline 4:2:0 JFIF stream of `rgb` from the port's writer."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "a.jpg")
        nl.jpeg_write(path, np.ascontiguousarray(rgb), quality)
        return Path(path).read_bytes()


def split_tables(stream: bytes):
    """(tables-only stream, abbreviated stream): a JPEG's DQT and DHT
    segments moved out, as a TIFF's JPEGTables holds them."""
    tables, image, i = [b"\xff\xd8"], [stream[:2]], 2
    while stream[i + 1] != 0xDA:
        n = struct.unpack(">H", stream[i + 2:i + 4])[0]
        (tables if stream[i + 1] in (0xDB, 0xC4) else image).append(
            stream[i:i + 2 + n])
        i += 2 + n
    return b"".join(tables) + b"\xff\xd9", b"".join(image) + stream[i:]


def jpeg_tiff(rgb: np.ndarray, rows: int = 0, tile=None, tables=True,
              sub_tag=True, quality: int = 90) -> bytes:
    """JPEG-in-TIFF (Compression 7) of YCbCr 2 x 2: each strip or tile a
    stream of the port's JPEG writer; with `tables` their DQT / DHT in
    JPEGTables and the streams abbreviated; without `sub_tag` no
    YCbCrSubsampling (libtiff takes the first stream's sampling)."""
    h, w = rgb.shape[:2]
    cw, ch = tile or (w, rows or h)
    chunks, shared = [], None
    for y in range(0, h, ch):
        for x in range(0, w, cw):
            part = rgb[y:y + ch, x:x + cw]
            if tile:   # whole tiles, the edge repeated
                part = np.pad(part, ((0, ch - part.shape[0]),
                                     (0, cw - part.shape[1]), (0, 0)),
                              mode="edge")
            stream = jpeg_stream(part, quality)
            if tables:
                shared, stream = split_tables(stream)
            chunks.append(stream)
    tags = [(530, 3, [2, 2])] if sub_tag else []
    if shared is not None:
        tags.append((347, 7, list(shared)))
    return tiff_file(rgb.shape, chunks, photometric=6, compression=7,
                     rows_per_strip=rows, tile=tile, tags=tags)


# T.4 codes, MSB first, as csrc/raster_decode.h lists them (the decoder's
# tables are held to Pillow's libtiff by the fax tests below)
def _fax_codes():
    src = (Path(__file__).resolve().parents[1]
           / "efficientteacher_torch/csrc/raster_decode.h").read_text()
    import re

    def arr(name):
        body = re.search(name + r"\[\d+\] = \{(.*?)\};", src, re.S).group(1)
        return re.findall(r'"([01]+)"', body)
    return {k: arr(k) for k in ("kTermWhite", "kTermBlack", "kMakeWhite",
                                "kMakeBlack", "kMakeBoth")}


FAX_EOL = "000000000001"


def mh_row(row: np.ndarray, codes=None) -> str:
    """One row (True = black) in modified Huffman codes, as bits."""
    codes = codes or _fax_codes()
    runs, colour, n = [], False, 0
    for v in row:
        if v == colour:
            n += 1
        else:
            runs.append(n)
            colour, n = v, 1
    runs.append(n)
    out = []
    for i, run in enumerate(runs):
        white = i % 2 == 0
        while run >= 2560 + 64:
            out.append(codes["kMakeBoth"][-1])
            run -= 2560
        if run >= 1792:
            k = (run - 1792) // 64
            out.append(codes["kMakeBoth"][k])
            run -= 1792 + 64 * k
        elif run >= 64:
            k = run // 64 - 1
            out.append(codes["kMakeWhite" if white else "kMakeBlack"][k])
            run -= 64 * (k + 1)
        out.append(codes["kTermWhite" if white else "kTermBlack"][run])
    return "".join(out)


def _bits_to_bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def fax_strip(bilevel: np.ndarray, scheme: int, eol: bool = True) -> bytes:
    """Rows (True = black) as CCITT modified Huffman, byte-aligned per row
    (scheme 2), or as Group 3 one-dimensional (3): an EOL before each row
    (none with `eol` False)."""
    codes = _fax_codes()
    if scheme == 2:
        return b"".join(_bits_to_bytes(mh_row(r, codes)) for r in bilevel)
    return _bits_to_bytes("".join((FAX_EOL if eol else "") + mh_row(r, codes)
                                  for r in bilevel))


def fax_tiff(bilevel: np.ndarray, scheme: int, rows: int = 0,
             eol: bool = True, photometric: int = 0) -> bytes:
    h, w = bilevel.shape
    chunks = [fax_strip(bilevel[y:y + (rows or h)], scheme, eol)
              for y in range(0, h, rows or h)]
    return tiff_file((h, w, 1), chunks, 1, photometric, scheme,
                     rows_per_strip=rows)


# -- SGILog (Q1.9d) -------------------------------------------------------------

# libtiff's XYZtoRGB24 primaries: RGB = M XYZ
_XYZ_TO_RGB = np.array([[2.690, -1.276, -0.414], [-1.022, 1.978, 0.044],
                        [0.061, -0.224, 1.163]])


def sgilog_codes(rgb: np.ndarray, kind: str) -> np.ndarray:
    """(h, w) uint32 SGILog pixels of about `rgb` (the inverse of libtiff's
    2.0 gamma and primaries): 16-bit LogL ("l16"), 32-bit LogLuv (L16, u
    and v bytes, "luv32") or 24-bit LogLuv (L10 and a 14-bit (u', v') cell
    index, "luv24"; the index a coarse stand-in for uvcode.h's, some of
    them past its 16289 cells, which decode to the neutral colour)."""
    lin = (rgb.astype(np.float64) / 256.0) ** 2
    xyz = lin @ np.linalg.inv(_XYZ_TO_RGB).T
    y = np.maximum(xyz[..., 1], 1e-9)
    den = np.maximum(xyz[..., 0] + 15 * xyz[..., 1] + 3 * xyz[..., 2], 1e-9)
    u, v = 4 * xyz[..., 0] / den, 9 * xyz[..., 1] / den
    if kind == "l16":
        le = np.floor(256 * (np.log2(y) + 64)).clip(0, 0x7fff)
        return np.where(xyz[..., 1] > 0, le, 0).astype(np.uint32)
    if kind == "luv32":
        le = np.floor(256 * (np.log2(y) + 64)).clip(1, 0x7fff).astype(
            np.uint32)
        ue = np.floor(410 * u).clip(0, 255).astype(np.uint32)
        ve = np.floor(410 * v).clip(0, 255).astype(np.uint32)
        return le << 16 | ue << 8 | ve
    le = np.floor(64 * (np.log2(y) + 12)).clip(1, 1023).astype(np.uint32)
    vi = np.floor((v - 0.01694) / 0.0035).clip(0, 162)
    ui = np.floor(u / 0.0035).clip(0, 180)
    return le << 14 | (vi * 101 + ui).astype(np.uint32) % 16384


def sgilog_chunk(codes: np.ndarray, kind: str, seg: int = 32) -> bytes:
    """Rows of SGILog pixels as one chunk: 24-bit pixels as 3 bytes each;
    16- and 32-bit ones as tif_luv.c's byte planes (high byte first, per
    row), each cut in `seg`-byte pieces, a constant one a run (a byte of
    126 + its length, then the value), any other literal (its length,
    then its bytes)."""
    h, w = codes.shape
    if kind == "luv24":
        b = np.stack([codes >> 16, codes >> 8, codes], -1) & 0xff
        return b.astype(np.uint8).tobytes()
    nb = 2 if kind == "l16" else 4
    planes = np.stack([(codes >> (8 * (nb - 1 - k))) & 0xff
                       for k in range(nb)], 1).astype(np.uint8)
    planes = planes.reshape(h * nb, w)
    parts = []
    for x in range(0, w, seg):
        p = planes[:, x:x + seg]
        n = p.shape[1]
        run = (p == p[:, :1]).all(1) & (n >= 2)
        block = np.zeros((len(p), n + 1), np.int16)
        block[:, 0] = np.where(run, 126 + n, n)
        block[:, 1:] = p
        block[run, 2:] = -1   # a run is two bytes
        parts.append(block)
    out = np.concatenate(parts, 1).ravel()
    return out[out >= 0].astype(np.uint8).tobytes()


def sgilog_tiff(codes: np.ndarray, kind: str, rows: int = 0, tile=None,
                bits: int = 16, seg: int = 32, tags=()) -> bytes:
    """A LogL (kind "l16") or LogLuv TIFF of SGILog pixels `codes`,
    Compression 34676 (34677 for "luv24"), in strips of `rows` rows (0:
    one) or tiles (tw, th)."""
    h, w = codes.shape
    chunks = []
    if tile:
        tw, th = tile
        for y in range(0, h, th):
            for x in range(0, w, tw):
                full = np.zeros((th, tw), np.uint32)
                part = codes[y:y + th, x:x + tw]
                full[:part.shape[0], :part.shape[1]] = part
                chunks.append(sgilog_chunk(full, kind, seg))
    else:
        rows = rows or h
        chunks = [sgilog_chunk(codes[y:y + rows], kind, seg)
                  for y in range(0, h, rows)]
    spp = 1 if kind == "l16" else 3
    return tiff_file((h, w, spp), chunks, bits,
                     32844 if kind == "l16" else 32845,
                     34677 if kind == "luv24" else 34676,
                     rows_per_strip=rows, tile=tile, tags=tags)


def thunderscan_tiles(rgb: np.ndarray, tile=(16, 16)) -> bytes:
    """A 4-bit palette TIFF of `rgb`'s grey levels, ThunderScan in tiles
    (raw-pixel codes): libtiff decodes no ThunderScan tile, so cv2 reads
    palette entry 0 everywhere."""
    h, w = rgb.shape[:2]
    idx = (rgb.astype(np.int64).sum(2) // 48).clip(0, 15)
    tw, th = tile
    chunks = []
    for y in range(0, h, th):
        for x in range(0, w, tw):
            full = np.zeros((th, tw), np.int64)
            part = idx[y:y + th, x:x + tw]
            full[:part.shape[0], :part.shape[1]] = part
            chunks.append((0xC0 | full).astype(np.uint8).tobytes())
    ramp = list(np.arange(16) * 4369)
    return tiff_file((h, w, 1), chunks, 4, 3, 32809, tile=tile,
                     tags=[(320, 3, ramp + ramp[::-1] + ramp)])


# -- the kinds, written without cv2 or Pillow --------------------------------

def write_kind(kind: str, rgb: np.ndarray) -> bytes:
    """The RGB image `rgb` as the TIFF kind `kind`, each decoding to about
    `rgb` (its bilevel threshold for the fax kinds). Numpy and the port's
    JPEG writer only: chip_smoke.py writes these on the card's machine."""
    h, w = rgb.shape[:2]
    if kind == "tifjpeg":   # strips of 16 rows, JPEGTables, no 530 tag
        return jpeg_tiff(rgb, 16, tables=True, sub_tag=False)
    if kind == "tifjpegtiles":
        return jpeg_tiff(rgb, tile=(32, 16), tables=True)
    if kind == "tifjpegself":   # self-contained streams, one strip
        return jpeg_tiff(rgb, tables=False)
    if kind.startswith("tifycc"):   # tifycc22, tifycc42_lzw, ...
        sub = (int(kind[6]), int(kind[7]))
        lzw = kind.endswith("_lzw")
        rows = 8 * sub[1]
        chunks = ycbcr_blocks(rgb, sub, rows)
        if lzw:
            chunks = [nl.lzw_encode(c) for c in chunks]
        tags = [] if sub == (2, 2) else [(530, 3, list(sub))]
        return tiff_file((h, w, 3), chunks, photometric=6,
                         compression=5 if lzw else 1, rows_per_strip=rows,
                         tags=tags)
    if kind == "tifcmyk":
        return tiff_bytes(cmyk(rgb), compression=5, predictor=2,
                          photometric=5, rows_per_strip=8)
    if kind == "tifcmykplanar":
        return tiff_bytes(cmyk(rgb), photometric=5, planar=2)
    if kind == "tiflab":
        return tiff_bytes(cielab(rgb), photometric=8, compression=5)
    if kind == "tiflab16":
        return tiff_bytes(cielab(rgb, 16), 16, photometric=8, compression=5,
                          predictor=2, big_endian=True)
    if kind == "tifsigned":
        return tiff_bytes(rgb, compression=5,
                          tags=[(339, 3, [2, 2, 2])])
    if kind.startswith("tiffill2"):   # tiffill2_lzw, _packbits, _deflate
        comp = {"none": 1, "lzw": 5, "packbits": 32773,
                "deflate": 8}[kind.split("_")[1]]
        return fill_order_2(tiff_bytes(rgb, compression=comp,
                                       rows_per_strip=8,
                                       tags=[(266, 3, [2])]))
    if kind == "tifsgilogl":   # LogL, strips of 8 rows
        return sgilog_tiff(sgilog_codes(rgb, "l16"), "l16", rows=8)
    if kind == "tifsgiloguv":   # LogLuv, 16 x 16 tiles
        return sgilog_tiff(sgilog_codes(rgb, "luv32"), "luv32",
                           tile=(16, 16))
    if kind == "tifsgilog24":   # LogLuv, SGILog24, strips of 8 rows
        return sgilog_tiff(sgilog_codes(rgb, "luv24"), "luv24", rows=8)
    if kind == "tifthundertiles":
        return thunderscan_tiles(rgb)
    if kind in ("tifrle", "tifg3", "tifg3noeol"):
        grey = rgb.astype(np.int64).sum(2)
        bilevel = grey < 3 * 128
        scheme = 2 if kind == "tifrle" else 3
        return fax_tiff(bilevel, scheme, rows=8, eol=kind != "tifg3noeol")
    raise KeyError(kind)


# the kinds chip_smoke.py writes its val split in, and whose decode rate
# it measures
SPLIT_KINDS = ("tifjpeg", "tifycc22", "tifcmyk", "tiflab", "tiffill2_lzw",
               "tifg3", "tifjpegtiles", "tifycc42_lzw", "tiflab16",
               "tifsigned")
# the last kinds cv2 reads (ROADMAP Q1.9d): chip_smoke.py's Q1.9d split
Q19D_KINDS = ("tifsgilogl", "tifsgiloguv", "tifsgilog24", "tifthundertiles")
KINDS = SPLIT_KINDS + ("tifjpegself", "tifycc21", "tifycc41", "tifycc44",
                       "tifycc12", "tifycc11", "tifcmykplanar",
                       "tiffill2_none", "tiffill2_packbits",
                       "tiffill2_deflate", "tifrle", "tifg3noeol")


def _write(root: Path, kind: str, h: int, w: int, seed: int = 0) -> Path:
    rng = np.random.default_rng([seed, h, w, len(kind)])
    path = Path(root) / f"{kind}_{h}x{w}.tif"
    path.write_bytes(write_kind(kind, smooth(rng, h, w)))
    return path


def _equal_to_cv2(path):
    want = _cv2_read(path)
    assert want is not None, f"cv2 does not read {Path(path).name}"
    np.testing.assert_array_equal(image_io.imread(str(path)), want,
                                  err_msg=Path(path).name)
    assert image_io.image_size(str(path)) == (want.shape[1], want.shape[0])
    return want


@pytest.mark.parametrize("kind", KINDS)
def test_kind_reads_as_cv2_imread(kind, tmp_path):
    for h, w in SIZES:
        want = _equal_to_cv2(_write(tmp_path, kind, h, w))
        if kind in ("tifsigned",) or kind.startswith("tiffill2"):
            rng = np.random.default_rng([0, h, w, len(kind)])
            np.testing.assert_array_equal(want, smooth(rng, h, w))


def test_writers_decode_to_about_their_images(tmp_path):
    """What the kinds hold, on a smooth image: the lossless ones decode to
    it, the fax ones to its threshold, the rest near it (the colour
    conversions round, the subsampled ones average chroma)."""
    yy, xx = np.mgrid[0:41, 0:64].astype(np.float64)
    rgb = np.stack([xx * 4, yy * 6, 128 + 60 * np.sin((xx + yy) / 9)],
                   -1).round().clip(0, 255).astype(np.uint8)
    for kind in KINDS:
        path = tmp_path / f"{kind}.tif"
        path.write_bytes(write_kind(kind, rgb))
        got = image_io.imread(str(path)).astype(int)
        if kind in ("tifrle", "tifg3", "tifg3noeol"):
            want = np.where(rgb.astype(int).sum(2) < 384, 0, 255)
            np.testing.assert_array_equal(got[..., 0], want, err_msg=kind)
            continue
        err = np.abs(got - rgb).mean()
        if kind == "tifsigned" or kind.startswith("tiffill2"):
            assert err == 0, kind
        else:
            assert err < 5, (kind, err)


# -- Pillow's files (its libtiff) ---------------------------------------------

def _pil_tiff(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format="TIFF", **kw)
    return buf.getvalue()


PIL_KINDS = ["jpeg_RGB", "jpeg_YCbCr", "jpeg_CMYK", "jpeg_L", "jpeg_RGB_q40",
             "jpeg_RGB_strips", "jpeg_RGB_fill2", "ccitt_2", "ccitt_3",
             "ccitt_3_2d", "ccitt_4", "ccitt_4_fill2", "ccitt_3_fill2",
             "ccitt_2_fill2", "cmyk_raw", "cmyk_lzw", "cmyk_packbits",
             "lab_raw", "ycbcr_raw", "ycbcr_lzw"]


def pil_kind(kind: str, rgb: np.ndarray) -> bytes:
    Image = _pil()
    im = Image.fromarray(rgb)
    parts = kind.split("_")
    if parts[0] == "jpeg":
        kw = {"compression": "jpeg", "tiffinfo": {}}
        if "q40" in parts:
            kw["quality"] = 40
        if "strips" in parts:
            kw["tiffinfo"][278] = 8
        if "fill2" in parts:
            kw["tiffinfo"][266] = 2
        return _pil_tiff(im.convert(parts[1]), **kw)
    if parts[0] == "ccitt":
        comp = {"2": "tiff_ccitt", "3": "group3", "4": "group4"}[parts[1]]
        info = {}
        if "2d" in parts:
            info[292] = 1
        if "fill2" in parts:
            info[266] = 2
        return _pil_tiff(im.convert("1"), compression=comp, tiffinfo=info)
    mode = {"cmyk": "CMYK", "lab": "LAB", "ycbcr": "YCbCr"}[parts[0]]
    comp = {"raw": None, "lzw": "tiff_lzw", "packbits": "packbits"}[parts[1]]
    return _pil_tiff(im.convert(mode), compression=comp)


@pytest.mark.parametrize("kind", PIL_KINDS)
def test_pillow_files_read_as_cv2(kind, tmp_path):
    rng = np.random.default_rng(len(kind))
    for h, w in SIZES + [(8, 1728)]:
        path = tmp_path / f"{kind}_{h}x{w}.tif"
        try:
            path.write_bytes(pil_kind(kind, smooth(rng, h, w)))
        except (OSError, ValueError, KeyError) as e:
            pytest.fail(f"Pillow cannot write {kind}: {e}")
        _equal_to_cv2(path)


# -- damaged fax streams --------------------------------------------------------

def _strip_of(data: bytes):
    t = tiff_io._Ifd("x", data)
    return t.get(273), t.get(279)


def _damaged(good: bytes, rng, i: int) -> bytes:
    """Seeded damage to a one-strip file: bit flips, a byte overwritten,
    the strip cut short (its byte count), a run zeroed (false EOLs)."""
    off, cnt = _strip_of(good)
    b = bytearray(good)
    kind = i % 4
    if kind == 0:
        for _ in range(int(rng.integers(1, 4))):
            b[off + int(rng.integers(0, cnt))] ^= 1 << int(rng.integers(0, 8))
    elif kind == 1:
        b[off + int(rng.integers(0, cnt))] = int(rng.integers(0, 256))
    elif kind == 2:
        b = bytearray(bytes(b).replace(
            struct.pack("<HHII", 279, 4, 1, cnt),
            struct.pack("<HHII", 279, 4, 1, int(rng.integers(0, cnt)))))
    else:
        at, n = off + int(rng.integers(0, cnt)), int(rng.integers(1, 6))
        b[at:at + n] = bytes(len(b[at:at + n]))
    return bytes(b)


def _random_fax(scheme: int, fill: int, g3_2d: bool, rows: int) -> bytes:
    """Random bits labelled as a fax stream (libtiff's recovery decides
    every row)."""
    rng = np.random.default_rng([scheme, fill, g3_2d, rows])
    bits = rng.integers(0, 2, (23, 37, 1))
    tags = [(266, 3, [fill])] + ([(292, 4, [int(g3_2d)])] if scheme == 3
                                 else [])
    return tiff_bytes(bits, 1, photometric=0 if rows else 1,
                      compression=scheme, rows_per_strip=rows, tags=tags)


FAX_DAMAGE = ["ccitt_2", "ccitt_3", "ccitt_3_2d", "ccitt_4", "ccitt_4_fill2",
              "rlew"]


@pytest.mark.parametrize("kind", FAX_DAMAGE)
def test_damaged_fax_streams_read_as_cv2(kind, tmp_path):
    """Random data of every scheme, then 40 seeded damages of a good
    stream: each file decodes as cv2.imread decodes it."""
    rng = np.random.default_rng(7)
    if kind == "rlew":
        scheme, fills, two_d = 32771, (1, 2), (False,)
    else:
        scheme = int(kind.split("_")[1])
        fills = (1, 2)
        two_d = (False, True) if scheme == 3 else (False,)
    files = [_random_fax(scheme, f, d, r) for f in fills for d in two_d
             for r in (0, 4)]
    if kind != "rlew":
        im = _pil().fromarray(smooth(rng, 41, 64)).convert("1")
        good = pil_kind(kind, np.asarray(im.convert("RGB")))
        files += [_damaged(good, rng, i) for i in range(40)]
    for i, data in enumerate(files):
        path = tmp_path / f"{kind}_{i}.tif"
        path.write_bytes(data)
        _equal_to_cv2(path)


def test_group3_without_eols_and_after_garbage(tmp_path):
    """Group 3 data with no EOL (libtiff reads the strip again from its
    start without them), with an EOL only late in the data, with one only
    first, and with garbage before the first EOL."""
    codes = _fax_codes()
    img = np.zeros((6, 20), bool)
    for y in range(6):
        img[y, y:2 * y + 3] = True
    rows = [mh_row(r, codes) for r in img]
    streams = {"eol_each": "".join(FAX_EOL + r for r in rows),
               "no_eol": "".join(rows),
               "eol_late": "".join(rows) + "0" * 11 + "1" + rows[0],
               "eol_first_only": FAX_EOL + "".join(rows),
               "garbage_first": "1011" + "".join(FAX_EOL + r for r in rows)}
    for name, bits in streams.items():
        path = tmp_path / f"{name}.tif"
        path.write_bytes(tiff_file((6, 20, 1), [_bits_to_bytes(bits)], 1, 0,
                                   3))
        _equal_to_cv2(path)
    np.testing.assert_array_equal(
        image_io.imread(str(tmp_path / "no_eol.tif"))[..., 0],
        np.where(img, 0, 255))


# -- JPEG-in-TIFF's own rules ----------------------------------------------------

def test_jpeg_in_tiff_layouts(tmp_path):
    """Strips and tiles, with and without JPEGTables and the subsampling
    tag; a stream taller than its last strip (cut), one shorter or
    narrower than its strip (the rest zero); one wider, of other sampling
    than the tag's, of RGB photometric with 4:2:0, or no JPEG at all
    (cv2 reads none: OSError, also from image_size)."""
    rng = np.random.default_rng(2)
    rgb = smooth(rng, 23, 37)
    for rows, tile in ((0, None), (8, None), (16, None), (0, (16, 16)),
                       (0, (32, 16))):
        for tables in (False, True):
            for sub_tag in (True, False):
                path = tmp_path / f"j{rows}{tile}{tables}{sub_tag}.tif"
                path.write_bytes(jpeg_tiff(rgb, rows, tile, tables, sub_tag))
                _equal_to_cv2(path)
    whole = jpeg_stream(rgb)
    sub = [(530, 3, [2, 2])]
    read = {"taller_last": ((23, 37, 3), [jpeg_stream(rgb[:16]), whole], 16),
            "shorter": ((30, 37, 3), [whole], 30),
            "narrower": ((23, 40, 3), [whole], 23)}
    for name, (shape, chunks, rows) in read.items():
        path = tmp_path / f"{name}.tif"
        path.write_bytes(tiff_file(shape, chunks, photometric=6,
                                   compression=7, rows_per_strip=rows,
                                   tags=sub))
        _equal_to_cv2(path)
    refused = {"wider": ((23, 30, 3), [whole], 6, sub),
               "other_sampling": ((23, 37, 3), [whole], 6,
                                  [(530, 3, [1, 1])]),
               "rgb_420": ((23, 37, 3), [whole], 2, []),
               "no_jpeg": ((23, 37, 3), [bytes(range(256))], 6, sub),
               "garbage": ((23, 37, 3), [b"\xff\xd8" + bytes(range(256))], 6,
                           sub)}
    for name, (shape, chunks, photometric, tags) in refused.items():
        path = tmp_path / f"{name}.tif"
        path.write_bytes(tiff_file(shape, chunks, photometric=photometric,
                                   compression=7, rows_per_strip=23,
                                   tags=tags))
        assert _cv2_read(path) is None, name
        with pytest.raises(OSError):
            image_io.image_size(str(path))
        with pytest.raises(OSError):
            image_io.imread(str(path))


def test_jpeg_in_tiff_planes(tmp_path):
    """Planar JPEG-in-TIFF: one grey stream per plane; RGB reads, YCbCr
    reads at 1 x 1 through libtiff's own conversion and not at its 2 x 2
    default (cv2 reads none)."""
    Image = _pil()
    rng = np.random.default_rng(4)
    rgb = smooth(rng, 23, 37)

    def grey(a):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(a)).save(buf, format="JPEG",
                                                      quality=90)
        return buf.getvalue()

    cases = {"rgb": (rgb, 2, []), "ycc11": (ycc(rgb), 6, [(530, 3, [1, 1])]),
             "ycc22": (ycc(rgb), 6, [])}
    for name, (planes, photometric, tags) in cases.items():
        path = tmp_path / f"{name}.tif"
        path.write_bytes(tiff_file(
            (23, 37, 3), [grey(planes[..., k]) for k in range(3)],
            photometric=photometric, compression=7, planar=2, tags=tags))
        if name == "ycc22":
            assert _cv2_read(path) is None
            with pytest.raises(OSError):
                image_io.image_size(str(path))
            continue
        _equal_to_cv2(path)


# -- colour-space edges --------------------------------------------------------

def test_colour_space_tags_and_edges(tmp_path):
    """YCbCr with its own coefficients and ReferenceBlackWhite, the
    predictor on subsampled blocks (where libtiff's pieces do and do not
    divide by 3), CIELab with its own WhitePoint, CMYK with an unspecified
    extra sample; and the layouts cv2 reads none of."""
    rng = np.random.default_rng(6)
    rgb = smooth(rng, 23, 37)
    rat = lambda *v: [x for f in v for x in (int(f * 10000), 10000)]  # noqa
    read = {
        "ycc_coeffs": tiff_file((23, 37, 3), [ycc(rgb).tobytes()],
                                photometric=6,
                                tags=[(530, 3, [1, 1]),
                                      (529, 5, rat(0.2126, 0.7152, 0.0722)),
                                      (532, 5, rat(16, 235, 128, 240, 128,
                                                   240))]),
        "lab_white": tiff_file((23, 37, 3), [cielab(rgb).tobytes()],
                               photometric=8,
                               tags=[(318, 5, rat(0.3127, 0.329))]),
        "cmyk_extra": tiff_bytes(cmyk(rgb), photometric=5, extras=[0]),
    }
    for w in (37, 38, 40, 41):
        for sub in ((2, 2), (2, 1), (1, 2), (4, 2), (4, 4), (4, 1)):
            read[f"ycc_pred_{w}_{sub}"] = tiff_bytes(
                smooth(rng, 23, w), photometric=6, compression=5,
                predictor=2, tags=[(530, 3, list(sub))])
    none = {
        "ycc_sub_1_4": tiff_bytes(rgb, photometric=6, tags=[(530, 3, [1, 4])]),
        "ycc_sub_3_3": tiff_bytes(rgb, photometric=6, tags=[(530, 3, [3, 3])]),
        "ycc_planar_22": tiff_bytes(rgb, photometric=6, planar=2),
        "ycc_16": tiff_bytes(rgb.astype(np.uint16) * 257, 16, photometric=6,
                             tags=[(530, 3, [1, 1])]),
        "cmyk_inkset_2": tiff_bytes(cmyk(rgb), photometric=5,
                                    tags=[(332, 3, [2])]),
        "cmyk_5": tiff_bytes(np.dstack([cmyk(rgb), rgb[..., :1]]),
                             photometric=5),
        "cmyk_16": tiff_bytes(cmyk(rgb).astype(np.uint16) * 257, 16,
                              photometric=5),
        "cmyk_3": tiff_bytes(rgb, photometric=5),
        "lab_4": tiff_bytes(cmyk(rgb), photometric=8),
        "lab_planar": tiff_bytes(cielab(rgb), photometric=8, planar=2),
    }
    for name, data in {**read, **none}.items():
        path = tmp_path / f"{name}.tif"
        path.write_bytes(data)
        if name in none:
            assert _cv2_read(path) is None, name
            with pytest.raises(OSError, match="cv2.imread reads none"):
                image_io.image_size(str(path))
            continue
        _equal_to_cv2(path)


# -- the three routes: read, zeros, OSError -------------------------------------

# compressions libtiff has no decoder of: cv2 reads their strips as zero
# samples, through the photometric (black RGB, white MinIsWhite, palette
# entry 0, a YCbCr or CMYK colour)
ZERO_KINDS = {"c9_rgb": dict(compression=9),
              "thunderscan_tiles": dict(compression=32809, photometric=3,
                                        bits=4, spp=1, tile=(16, 16)),
              "c10_grey": dict(compression=10, photometric=1, spp=1),
              "c32908_white": dict(compression=32908, photometric=0, bits=1,
                                   spp=1),
              "jpeg2000_rgb": dict(compression=34712),
              "c65000_palette": dict(compression=65000, photometric=3, bits=4,
                                     spp=1),
              "jpeg2000_ycbcr": dict(compression=34712, photometric=6),
              "jpeg2000_cmyk": dict(compression=34712, photometric=5, spp=4)}
# what cv2 returns None for (libtiff built without the codec, or refusing
# the layout); the port raises OSError naming it
NONE_KINDS = {"old_jpeg": dict(compression=6), "pixarlog":
              dict(compression=32909), "jbig": dict(compression=34661),
              "lerc": dict(compression=34887), "lzma": dict(compression=34925),
              "zstd": dict(compression=50000), "webp": dict(compression=50001),
              "next_8": dict(compression=32766),
              "thunderscan_8": dict(compression=32809),
              "sgilog_rgb": dict(compression=34676),
              "ccitt_8": dict(compression=3),
              "jpeg_16": dict(compression=7, bits=16),
              "mask": dict(photometric=4, spp=1),
              "icclab": dict(photometric=9), "itulab": dict(photometric=10),
              "logl": dict(photometric=32844, spp=1),
              "logluv": dict(photometric=32845),
              "void": dict(tags=[(339, 3, [4, 4, 4])]),
              "float_8": dict(tags=[(339, 3, [3, 3, 3])])}
# SGILog of random bytes (ROADMAP Q1.9d): read as libtiff decodes them
SGILOG_KINDS = {"sgilog_logl": dict(compression=34676, photometric=32844,
                                    bits=16, spp=1),
                "sgilog_logluv": dict(compression=34676, photometric=32845,
                                      bits=16),
                "sgilog24_logluv": dict(compression=34677,
                                        photometric=32845, bits=16)}


def route_file(kind: str) -> bytes:
    spec = dict({**ZERO_KINDS, **NONE_KINDS, **SGILOG_KINDS}[kind])
    bits, spp = spec.pop("bits", 8), spec.pop("spp", 3)
    rng = np.random.default_rng(len(kind))
    samples = rng.integers(0, 1 << bits, (23, 37, spp))
    if spec.get("photometric") == 3:
        spec["colormap"] = rng.integers(0, 65536, 3 << bits)
    return tiff_bytes(samples.astype(np.uint16 if bits == 16 else np.uint8),
                      bits, **spec)


@pytest.mark.parametrize("kind", sorted(ZERO_KINDS) + sorted(NONE_KINDS)
                         + sorted(SGILOG_KINDS))
def test_routes_follow_cv2(kind, tmp_path):
    path = tmp_path / f"{kind}.tif"
    path.write_bytes(route_file(kind))
    if kind in ZERO_KINDS:
        want = _equal_to_cv2(path)
        assert (want == want[0, 0]).all()
        return
    if kind in NONE_KINDS:
        assert _cv2_read(path) is None
        with pytest.raises(OSError, match="cv2.imread reads none"):
            image_io.image_size(str(path))
        assert port_ds.verify_image_label(str(path), None, 8) is None
        return
    _equal_to_cv2(path)


def thunderscan_row(width: int, rng) -> bytes:
    """A ThunderScan row of exactly `width` pixels: runs, 2- and 3-bit
    deltas (skips among them) and raw pixels, drawn from `rng`."""
    out, n = [], 0
    while n < width:
        k = int(rng.integers(0, 4))
        if k == 0 and width - n > 1:
            out.append(int(rng.integers(0, min(63, width - n - 1) + 1)))
            n += out[-1]
        elif k == 1 and width - n >= 3:
            out.append(0x40 | int(rng.integers(0, 64)))
            n += sum((out[-1] >> sh) & 3 != 2 for sh in (4, 2, 0))
        elif k == 2 and width - n >= 2:
            out.append(0x80 | int(rng.integers(0, 64)))
            n += sum((out[-1] >> sh) & 7 != 4 for sh in (3, 0))
        else:
            out.append(0xC0 | int(rng.integers(0, 16)))
            n += 1
    return bytes(out)


@pytest.mark.parametrize("fill", [1, 2])
def test_thunderscan_reads_as_cv2(fill, tmp_path):
    """ThunderScan (Compression 32809) of a 4-bit palette, the only
    layout cv2 reads it in: well-formed rows, and random bytes (rows that
    end early or overshoot end their strip, as in libtiff); FillOrder 2
    reverses its bytes' bits first."""
    rng = np.random.default_rng(fill)
    for trial in range(30):
        w, h = int(rng.integers(1, 80)), int(rng.integers(1, 20))
        rows = int(rng.integers(1, h + 1))
        chunks = []
        for y in range(0, h, rows):
            if trial % 3 == 0:
                chunk = rng.integers(0, 256, int(rng.integers(1, 200)),
                                     np.uint8).tobytes()
            else:
                chunk = b"".join(thunderscan_row(w, rng)
                                 for _ in range(min(rows, h - y)))
            chunks.append(chunk if fill == 1 else chunk.translate(_REV))
        path = tmp_path / f"t{trial}.tif"
        path.write_bytes(tiff_file(
            (h, w, 1), chunks, 4, 3, 32809, rows_per_strip=rows,
            tags=[(320, 3, list(rng.integers(0, 65536, 48))),
                  (266, 3, [fill])]))
        _equal_to_cv2(path)


@pytest.mark.parametrize("kind", Q19D_KINDS)
def test_q19d_kinds_read_as_cv2_imread(kind, tmp_path):
    """The kinds chip_smoke.py writes its Q1.9d split in."""
    for h, w in SIZES:
        _equal_to_cv2(_write(tmp_path, kind, h, w))


def _cut(data: bytes, rng) -> bytes:
    return data[:int(rng.integers(0, len(data)))]


def _flip(data: bytes, rng) -> bytes:
    b = bytearray(data)
    for _ in range(3):
        b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
    return bytes(b)


@pytest.mark.parametrize("kind", ["l16", "luv32", "luv24"])
def test_sgilog_reads_as_cv2(kind, tmp_path):
    """SGILog LogL and LogLuv, SGILog24 LogLuv, each in strips and tiles,
    runs and literals of several lengths, FillOrder 2, and damaged chunks
    (cut short, bits flipped, random bytes): a row whose data run out ends
    its chunk, zeros after, as libtiff's decoders leave it."""
    rng = np.random.default_rng(len(kind))
    for trial in range(24):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 60))
        rgb = smooth(rng, h, w)
        rgb[rng.random((h, w)) < 0.05] = 0   # LogL 0 and black pixels
        codes = sgilog_codes(rgb, kind)
        if trial % 4 == 3:
            codes = rng.integers(0, 1 << 32, (h, w), dtype=np.uint64) \
                .astype(np.uint32)
        seg = int(rng.integers(1, 40))
        tile = (16, 16) if trial % 3 == 2 else None
        rows = int(rng.integers(1, h + 1))
        data = sgilog_tiff(codes, kind, rows=0 if tile else rows, tile=tile,
                           seg=seg)
        path = tmp_path / f"s{trial}.tif"
        path.write_bytes(data)
        _equal_to_cv2(path)
        if trial % 2 == 0:   # the same file, FillOrder 2
            spp = 1 if kind == "l16" else 3
            chunks = [sgilog_chunk(codes[y:y + rows], kind, seg)
                      .translate(_REV) for y in range(0, h, rows)]
            path.write_bytes(tiff_file(
                (h, w, spp), chunks, 16, 32844 if kind == "l16" else 32845,
                34677 if kind == "luv24" else 34676, rows_per_strip=rows,
                tags=[(266, 3, [2])]))
            _equal_to_cv2(path)
        damage = (_cut, _flip, lambda d, r: r.integers(
            0, 256, int(r.integers(1, 2 * len(d) + 2)), np.uint8).tobytes())
        chunks = [damage[trial % 3](sgilog_chunk(codes[y:y + rows], kind,
                                                 seg), rng) or b"\x80"
                  for y in range(0, h, rows)]
        path.write_bytes(tiff_file(
            (h, w, 1 if kind == "l16" else 3), chunks, 16,
            32844 if kind == "l16" else 32845,
            34677 if kind == "luv24" else 34676, rows_per_strip=rows))
        _equal_to_cv2(path)


@pytest.mark.parametrize("kind", ["l16", "luv32", "luv24"])
def test_sgilog_depths_and_sample_formats_follow_cv2(kind, tmp_path):
    """cv2 reads SGILog LogL of 1, 8 or 16 bits, uint or int, and LogLuv
    of 1, 2, 4, 8 or 16 bits of any sample format but IEEE float (its
    readHeader takes three-sample LogLuv for HDR and checks little): the
    port reads what cv2 reads, equal to it, and raises OSError for the
    rest, which the datasets drop."""
    codes = sgilog_codes(smooth(np.random.default_rng(3), 6, 9), kind)
    for bits in (1, 2, 4, 8, 16, 32):
        for fmt in range(8):
            path = tmp_path / f"b{bits}f{fmt}.tif"
            path.write_bytes(sgilog_tiff(codes, kind, rows=4, bits=bits,
                                         tags=[(339, 3, [fmt] * (
                                             1 if kind == "l16" else 3))]))
            if _cv2_read(path) is None:
                with pytest.raises(OSError, match="cv2.imread reads none"):
                    image_io.image_size(str(path))
            else:
                _equal_to_cv2(path)
    path = tmp_path / "planes.tif"   # LogLuv in planes: refused
    spp = 1 if kind == "l16" else 3
    path.write_bytes(tiff_file((6, 9, spp), [sgilog_chunk(codes, kind)] * spp,
                               16, 32844 if kind == "l16" else 32845,
                               34677 if kind == "luv24" else 34676, planar=2))
    if kind == "l16":
        _equal_to_cv2(path)
    else:
        assert _cv2_read(path) is None
        with pytest.raises(OSError, match="LogLuv in planes"):
            image_io.image_size(str(path))


def test_thunderscan_tiles_read_as_palette_zero(tmp_path):
    """libtiff decodes no ThunderScan tile: whatever the tiles hold, cv2
    reads palette entry 0 everywhere, and so does the port."""
    rng = np.random.default_rng(9)
    for trial in range(12):
        tw, th = (16, 16) if trial % 2 else (32, 16)
        w, h = int(rng.integers(1, 70)), int(rng.integers(1, 40))
        n = -(-w // tw) * -(-h // th)
        chunks = [rng.integers(0, 256, int(rng.integers(1, 300)),
                               np.uint8).tobytes() if trial % 3 else
                  b"".join(thunderscan_row(w, rng) for _ in range(th))
                  for _ in range(n)]
        cmap = rng.integers(0, 65536, 48)
        path = tmp_path / f"t{trial}.tif"
        path.write_bytes(tiff_file((h, w, 1), chunks, 4, 3, 32809,
                                   tile=(tw, th), tags=[(320, 3, list(cmap))]))
        want = _equal_to_cv2(path)
        assert (want == cmap.reshape(3, 16)[:, 0] >> 8).all()


# -- a split against the JAX package ---------------------------------------------

MIXED = [("tifjpeg", 48, 64), ("tifycc22", 41, 37), ("tifcmyk", 40, 40),
         ("tiflab", 33, 50), ("tiffill2_lzw", 45, 30), ("tifg3", 40, 64),
         ("zero:jpeg2000_rgb", 30, 30), ("zero:c32908_white", 30, 30),
         ("none:lzma", 30, 30), ("none:old_jpeg", 30, 30),
         ("none:logl", 30, 30), ("pil:ccitt_4", 41, 64),
         ("pil:jpeg_CMYK", 41, 64), ("tifsigned", 35, 35),
         ("tifsgilogl", 33, 41), ("tifsgiloguv", 40, 35),
         ("tifsgilog24", 38, 44), ("tifthundertiles", 30, 30)]


def write_mixed(root: Path, nc: int = 8) -> Path:
    """A split of the new kinds, files cv2 reads as zeros and files it
    reads nothing of, each with a label file; returns its list file."""
    rng = np.random.default_rng(11)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    paths = []
    for i, (kind, h, w) in enumerate(MIXED):
        path = root / "images" / f"{i:02d}_{kind.replace(':', '_')}.tif"
        route, _, name = kind.rpartition(":")
        if route in ("zero", "none"):
            data = route_file(name)
        elif route == "pil":
            data = pil_kind(name, smooth(rng, h, w))
        else:
            data = write_kind(kind, smooth(rng, h, w))
        path.write_bytes(data)
        n = int(rng.integers(1, 4))
        rows = np.column_stack([rng.integers(0, nc, n),
                                rng.uniform(0.3, 0.7, (n, 2)),
                                rng.uniform(0.1, 0.3, (n, 2))])
        (root / "labels" / f"{path.stem}.txt").write_text(
            "".join(f"{int(r[0])} {r[1]:.4f} {r[2]:.4f} {r[3]:.4f} "
                    f"{r[4]:.4f}\n" for r in rows))
        paths.append(path)
    lst = root / "list.txt"
    lst.write_text("".join(f"{p}\n" for p in paths))
    return lst


def test_mixed_split_equals_jax(tmp_path):
    """verify_image_label, LoadImagesAndLabels (items and load_image) and
    LoadImages of both packages on the split: the same files kept (those
    cv2 reads nothing of dropped, the zero ones kept), the same shapes,
    labels, letterboxed and decoded images, bit for bit."""
    jax_ds = pytest.importorskip("efficientteacher_tpu.data.datasets")
    jax_loaders = pytest.importorskip("efficientteacher_tpu.data.loaders")
    lst = write_mixed(tmp_path / "mixed")
    files = lst.read_text().split()
    for f in files:
        label = f.replace("/images/", "/labels/").rsplit(".", 1)[0] + ".txt"
        got = port_ds.verify_image_label(f, label, 8)
        want = jax_ds.verify_image_label(f, label, 8)
        assert (got is None) == (want is None) == ("none_" in f), f
        if got is not None:
            np.testing.assert_array_equal(got[0], want[0])
            assert tuple(got[1]) == tuple(want[1]), f
    port = port_ds.LoadImagesAndLabels(str(lst), img_size=64, nc=8)
    ref = jax_ds.LoadImagesAndLabels(str(lst), img_size=64, nc=8)
    assert port.img_files == ref.img_files
    assert len(port) == sum(not k.startswith("none:") for k, _, _ in MIXED)
    np.testing.assert_array_equal(port.shapes, ref.shapes)
    for i in range(len(port)):
        got, want = port[i], ref[i]
        np.testing.assert_array_equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        img, hw0, hw = port.load_image(i)
        img_j, hw0_j, hw_j = ref.load_image(i)
        np.testing.assert_array_equal(img, img_j[:, :, ::-1])
        assert (tuple(hw0), tuple(hw)) == (tuple(hw0_j), tuple(hw_j))
    folder = str(tmp_path / "mixed" / "images")
    got = list(loaders.LoadImages(folder, 64))
    want = list(jax_loaders.LoadImages(folder, 64))
    assert [g[0] for g in got] == [w[0] for w in want] == port.img_files
    for (p, rgb, img0, rp), (jp, jrgb, jimg0, jrp) in zip(got, want):
        assert rp == jrp
        np.testing.assert_array_equal(rgb, jrgb)
        np.testing.assert_array_equal(img0, jimg0)


# -- fixtures: cv2's digests for the card's machine ------------------------------

FIXTURE_SIZE = (11, 13)
FIXTURE_KINDS = (
    ["kind:" + k for k in ("tifjpeg", "tifjpegtiles", "tifycc22", "tifycc21",
                           "tifycc42_lzw", "tifycc44", "tifcmyk", "tiflab",
                           "tiflab16", "tifsigned", "tiffill2_lzw",
                           "tiffill2_deflate", "tifrle", "tifg3")
                          + Q19D_KINDS]
    + ["pil:" + k for k in ("jpeg_RGB", "jpeg_YCbCr", "jpeg_CMYK", "ccitt_2",
                            "ccitt_3", "ccitt_3_2d", "ccitt_4", "cmyk_raw",
                            "cmyk_lzw", "lab_raw", "ycbcr_raw")]
    + ["random:" + k for k in ("2_1", "3_1", "3_2d", "4_2", "32771_1")]
    + ["zero:jpeg2000_ycbcr", "zero:c65000_palette"])


def fixture_bytes(name: str) -> bytes:
    """The file of fixture `name` (needs Pillow for the "pil:" ones)."""
    route, kind = name.split(":")
    h, w = FIXTURE_SIZE
    rng = np.random.default_rng([len(name), h, w])
    if route == "kind":
        return write_kind(kind, smooth(rng, h, w))
    if route == "pil":
        return pil_kind(kind, smooth(rng, h, w))
    if route == "random":
        scheme, opt = kind.split("_")
        return _random_fax(int(scheme), 2 if opt == "2" else 1, opt == "2d",
                           4)
    return route_file(kind)


def write_fixtures(root) -> dict:
    """FIXTURES as files under `root`: {name: path}."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (b64, _) in FIXTURES.items():
        path = root / f"{name.replace(':', '_')}.tif"
        path.write_bytes(base64.b64decode(b64))
        paths[name] = str(path)
    return paths


def check_fixtures(root) -> list:
    """Decode every fixture with the port; returns the mismatches against
    cv2's digests as (name, shape, digest)."""
    bad = []
    for name, path in write_fixtures(root).items():
        shape, digest = FIXTURES[name][1]
        got = image_io.imread(path)
        if got.shape != shape or rgb_digest(got) != digest \
                or image_io.image_size(path) != (shape[1], shape[0]):
            bad.append((name, got.shape, rgb_digest(got)))
    return bad


def test_fixtures_are_the_listed_kinds():
    assert list(FIXTURES) == FIXTURE_KINDS


@pytest.mark.parametrize("name", FIXTURE_KINDS)
def test_fixtures_decode_to_cv2s_digests(name, tmp_path):
    path = write_fixtures(tmp_path)[name]
    shape, digest = FIXTURES[name][1]
    got = image_io.imread(path)
    assert (got.shape, rgb_digest(got)) == (shape, digest)
    want = _cv2_read(path)
    assert (want.shape, rgb_digest(want)) == (shape, digest)


def _print_fixtures():
    """The FIXTURES dict, with cv2's digests (needs cv2 and Pillow)."""
    import textwrap

    import cv2

    with tempfile.TemporaryDirectory() as tmp:
        print("FIXTURES = {")
        for name in FIXTURE_KINDS:
            path = Path(tmp) / "f.tif"
            path.write_bytes(fixture_bytes(name))
            want = np.ascontiguousarray(cv2.imread(str(path))[..., ::-1])
            lines = textwrap.wrap(base64.b64encode(path.read_bytes())
                                  .decode(), 66)
            digest = rgb_digest(want)
            print(f'    "{name}": (\n'
                  + "".join(f'        "{line}"\n' for line in lines[:-1])
                  + f'        "{lines[-1]}",\n'
                  f"        ({want.shape}, \"{digest[:32]}\"\n"
                  f"                      \"{digest[32:]}\")),")
        print("}")


# name: (base64 file, ((h, w, 3), sha256 of cv2.imread's RGB bytes))
FIXTURES = {
    "kind:tifjpeg": (
        "SUkqALIAAAD/2P/gABBKRklGAAEBAAABAAEAAP/AABEIAAsADQMBIgACEQEDEQH/2g"
        "AMAwEAAhEDEQA/AEeyk1HRbxpLEWscWIYXAwnJ6g96v3OgXM6wrHdxW0KoNkCsAV46"
        "n64rL0XWr28+H97HNcM6RhHUHHBLcmqvha6k1OXUZroiaXzQu9lGcYqqUZ4qMo0nyx"
        "i3ZPXW0dWnfV+p6GIj7Ca9rBStfrp11ta1+5//2QsAAAEEAAEAAAANAAAAAQEEAAEA"
        "AAALAAAAAgEDAAMAAAA8AQAAAwEDAAEAAAAHAAAABgEDAAEAAAAGAAAAEQEEAAEAAA"
        "AIAAAAFQEDAAEAAAADAAAAFgEEAAEAAAAQAAAAFwEEAAEAAACqAAAAHAEDAAEAAAAB"
        "AAAAWwEHAD4CAABCAQAAAAAAAAgACAAIAP/Y/9sAQwADAgIDAgIDAwMDBAMDBAUIBQ"
        "UEBAUKBwcGCAwKDAwLCgsLDQ4SEA0OEQ4LCxAWEBETFBUVFQwPFxgWFBgSFBUU/9sA"
        "QwEDBAQFBAUJBQUJFA0LDRQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFB"
        "QUFBQUFBQUFBQUFBQUFBQU/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL"
        "/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwR"
        "VS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZn"
        "aGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxM"
        "XGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEB"
        "AQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBh"
        "JBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNE"
        "RUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoq"
        "OkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3"
        "+Pn6/9k=",
        ((11, 13, 3), "a2ce064bed9d9f9583790e03a5bf7d83"
                      "4104ddee6c04fcc235cc39f59c8ceee9")),
    "kind:tifjpegtiles": (
        "SUkqAPYAAAD/2P/gABBKRklGAAEBAAABAAEAAP/AABEIABAAIAMBIgACEQEDEQH/2g"
        "AMAwEAAhEDEQA/AMHxlYTr9q0dbq1tI4wszqR+7kHXDe9GjC8s9Pjkhto2tpuUjiZS"
        "E9eTWV4bJ1D4eT3N0TcXEjNumlO5zjpyea0Z7iS10bRxC5jDW+Tt4ya9ypWnFww0LL"
        "v5uzTb7v3fLpv09CpgJY7NJ4Gn7jik0031W/Wza0dvvtoaX22+/wCfH/0H/Cj7bff8"
        "+P8A6D/hWD/aV1/z3f8AOj+0rr/nu/51XLU7r/wH/gnq/wCqOM/6CX/4E/8AI//ZDQ"
        "AAAQQAAQAAAA0AAAABAQQAAQAAAAsAAAACAQMAAwAAAJgBAAADAQMAAQAAAAcAAAAG"
        "AQMAAQAAAAYAAAAVAQMAAQAAAAMAAAAcAQMAAQAAAAEAAABCAQQAAQAAACAAAABDAQ"
        "QAAQAAABAAAABEAQQAAQAAAAgAAABFAQQAAQAAAO4AAABbAQcAPgIAAJ4BAAASAgMA"
        "AgAAAAIAAgAAAAAACAAIAAgA/9j/2wBDAAMCAgMCAgMDAwMEAwMEBQgFBQQEBQoHBw"
        "YIDAoMDAsKCwsNDhIQDQ4RDgsLEBYQERMUFRUVDA8XGBYUGBIUFRT/2wBDAQMEBAUE"
        "BQkFBQkUDQsNFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFB"
        "QUFBQUFBQUFBT/xAAfAAABBQEBAQEBAQAAAAAAAAAAAQIDBAUGBwgJCgv/xAC1EAAC"
        "AQMDAgQDBQUEBAAAAX0BAgMABBEFEiExQQYTUWEHInEUMoGRoQgjQrHBFVLR8CQzYn"
        "KCCQoWFxgZGiUmJygpKjQ1Njc4OTpDREVGR0hJSlNUVVZXWFlaY2RlZmdoaWpzdHV2"
        "d3h5eoOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0t"
        "PU1dbX2Nna4eLj5OXm5+jp6vHy8/T19vf4+fr/xAAfAQADAQEBAQEBAQEBAAAAAAAA"
        "AQIDBAUGBwgJCgv/xAC1EQACAQIEBAMEBwUEBAABAncAAQIDEQQFITEGEkFRB2FxEy"
        "IygQgUQpGhscEJIzNS8BVictEKFiQ04SXxFxgZGiYnKCkqNTY3ODk6Q0RFRkdISUpT"
        "VFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqCg4SFhoeIiYqSk5SVlpeYmZqio6Slpqeoqa"
        "qys7S1tre4ubrCw8TFxsfIycrS09TV1tfY2dri4+Tl5ufo6ery8/T19vf4+fr/2Q==",
        ((11, 13, 3), "1d0699fb95ed7a708f05a3ce59173784"
                      "f7ffd40346f13051dd795e40806aa479")),
    "kind:tifycc22": (
        "SUkqAAQBAAByhoyYdox7S3lWgXw+ZFVrknh+dXx2f35tcXJ2hp59kXaDi5CZmYmJko"
        "SRj3Z4fJB8coaDg3p8hYSBiHOGhHh+m356cHxzjJJtd3WAcJB9fYWFm3RzaZR+eIZ8"
        "g3NveJZ1amdnpJBwhXiJroePj5yojHGIhZSGgZCIiJiYjH6lnJKRfm+CbIaFhpNobn"
        "xqn3p9fXN2jY6QpoCOe4yMf4F0k2qYmHh4iXR5jmeOio+TlZGDfnOAY3doiXxkeGqE"
        "hpR9foV+h4WIg4yOdmJ5eY2Nemted153kZ1zbnNuhpJzaXNpg3psgGyAcI+BhIGEdI"
        "iEfoR+fYCKioqKhYEKAAABBAABAAAADQAAAAEBBAABAAAACwAAAAIBAwADAAAAggEA"
        "AAMBAwABAAAAAQAAAAYBAwABAAAABgAAABEBBAABAAAACAAAABUBAwABAAAAAwAAAB"
        "YBBAABAAAAEAAAABcBBAABAAAA/AAAABwBAwABAAAAAQAAAAAAAAAIAAgACAA=",
        ((11, 13, 3), "4670a865f806e69b87538403031d2403"
                      "cf0bcd4c9cb0cbbf14dc148d7c4e454a")),
    "kind:tifycc21": (
        "SUkqADwBAAByhniEe0t+dj5klHh+dXiAbXGInH2RjJiZmYuGjJh0knlWhIJVa5B4fH"
        "aGfHJ2hJ92g4qIiYmYgZGPfJF8coKCfIWCcIaEkHh6cIOcbXd2g319n3F2eHyQhoOE"
        "coSBjnZ4fqaEfHOUiHWAap2FhZd3c2l4jHyDfIZ1aqKJcIW1g4+PmXCIhXaciIiQfZ"
        "R+eX5zb3SmZ2emlniJqIqcqIBylIaLhJiYiIClnHxugmyEnGhupIJ9fY6UkKZwhIx/"
        "lXKYmIWBkpGBcIaFiop8app0c3aNhoCOhpSBdJFieHiNaHmOhoOTlX5ygGOKf2R4kI"
        "19fo6KiIN8WHl5fl1njo6ckYN9dHdoiHlqhHubhX5/gIyOcWqNjXd5XneRnXNuhpJz"
        "aYN6bIBwj4GEdIiEfn2AioqFgQsAAAEEAAEAAAANAAAAAQEEAAEAAAALAAAAAgEDAA"
        "MAAADGAQAAAwEDAAEAAAABAAAABgEDAAEAAAAGAAAAEQEEAAIAAADMAQAAFQEDAAEA"
        "AAADAAAAFgEEAAEAAAAIAAAAFwEEAAIAAADUAQAAHAEDAAEAAAABAAAAEgIDAAIAAA"
        "ACAAEAAAAAAAgACAAIAAgAAADoAAAA4AAAAFQAAAA=",
        ((11, 13, 3), "089168582235d3504da231e35600036c"
                      "a20e687c91ce7cd424493d4018a9954a")),
    "kind:tifycc42_lzw": (
        "SUkqAPsAAACAG01ndBoBAINBohCpNClkloY5Fgwo9AFQunVAGsynFBpg3n6QH5DyND"
        "opEoNCIA9Hw+nU4opDm8rlA0G0tEgopc9H05mQ0mo5mgzpE6nyjHw90k9pI2IY+G43"
        "plMHo2oxRHeelk4H9EnhRIiJGw2GY2Ho9oI/G61G41201os0JpPH0yplLHUyI1HmhA"
        "IQ5Gs4mUvIY+ms9IlHF01IBGIhBUo9oHJIE+QY/mo2lAqF8+JFLHY3mQvIxCm8rIbB"
        "G5AoUuH5Fn48n4/7M/nLbHJHookE82IXd71GqFEoA5mLh8VCGwvHpGHzl81AIa3dM1"
        "o5WwELAAABBAABAAAADQAAAAEBBAABAAAACwAAAAIBAwADAAAAhQEAAAMBAwABAAAA"
        "BQAAAAYBAwABAAAABgAAABEBBAABAAAACAAAABUBAwABAAAAAwAAABYBBAABAAAAEA"
        "AAABcBBAABAAAA8wAAABwBAwABAAAAAQAAABICAwACAAAABAACAAAAAAAIAAgACAA=",
        ((11, 13, 3), "4a0e8378d87c3a5bd5ea2845bbdf7055"
                      "154fba323b433361438cdee64aa6483f")),
    "kind:tifycc44": (
        "SUkqAOAAAAByhntLjJh5VpGPfHJ2eIaDfoQ+ZH51VWt8dnyFhoSEgXh+jXptcX2Rcn"
        "Z2g3pwbXd8c3WAg5SZmZmZiYmJiX19fX2FhYWFlnxzaXyDlH5zb6WcgmySkYaFfYd1"
        "anCFZ2d4iWhufX18anN2oIiPj4iFnKiUhpCmjH+AjoF0h36IiIiImJiYmJiYmJh4eH"
        "h4inp5jpOVZ46Rg153c25ed3NuiIyAY2R4d2hqhHNpbIBzaWyAgIZ9foiDhX6MjoGE"
        "hH6BhIR+e3x5eXl5jY2NjYqKioqKioqKgHYLAAABBAABAAAADQAAAAEBBAABAAAACw"
        "AAAAIBAwADAAAAagEAAAMBAwABAAAAAQAAAAYBAwABAAAABgAAABEBBAABAAAACAAA"
        "ABUBAwABAAAAAwAAABYBBAABAAAAIAAAABcBBAABAAAA2AAAABwBAwABAAAAAQAAAB"
        "ICAwACAAAABAAEAAAAAAAIAAgACAA=",
        ((11, 13, 3), "893fbffe9affb1a3f0579589259eb14b"
                      "e7bf96ffdd228044225090b7c6d968be")),
    "kind:tifcmyk": (
        "SUkqAHUCAACAAAnjg7i0Csh3PtjAAABNzCAGNoAOgLOslAhziQXvB0h0FAB/shxgAN"
        "vdcggFEpwidygYAP58ukAAsMAAQhQ5AAAu58ABwkB/Bd+h4DukEMwIAAdPJzDEjOJx"
        "CgKgB7uJagAMg5XBAFiIADJ8NMAO4IRIDhcAAkimyXhd9AB9hGPh91P0ABVrvEAPR0"
        "P4giZ1P4WB0APxvLcAAwGtwbveXAsJtwTr4FswJADHj48QwRv6GzKsM56gAUAlwgBp"
        "hwDlZnPIPC0GNEGLR6Cp5MkAC63ippA8SkNrOptvMEAMACsOn0APl1goOjx8OADvIA"
        "PNuPsHvkAOcagQeMwHCAPAB1gNkAADvdvDgKusABp5vvquwEy8EP/SAA8mIagB1AIF"
        "DyGWX73mibbCn8EoKOoDQTAOsYUoYY51KSfJsAC9APnel4PH4AAIny4whAKMgkAEfZ"
        "7gCCgAAIW5oBOqYHhDA4QGye4AAeeoGMKGbPHkBh/AUVhbAmEYAAkeBpg+DLjAoE57"
        "gYIgADQfxvgAAp7H8BB7AAeQdncAB4gquwDFyDIaBOd4DGYdgFR2GghGkBpfloDAox"
        "WeJbvGCB1nkIx8ICCACUggAxBh+gB+u1hAN9gcAD5wgwAB0AhUAOsKO4AMwVsAOiJ8"
        "wgSuQcuZlhAWhlshBkB8AAdtM4ATMrBU2ih2ut9Bpeg19OwAD97NIChZ/g19t8DhcK"
        "r8NtwNA4DAtoiN6lIAP55vgANkMNUCPgAgABgB4AApldDgANPJygB3O1910SgQAPQR"
        "OMAP9qAcKAhXiEHg0AAV8uoAAYKhmZvsIWQBu8AOp90B5wELAAABBAABAAAADQAAAA"
        "EBBAABAAAACwAAAAIBAwAEAAAA/wIAAAMBAwABAAAABQAAAAYBAwABAAAABQAAABEB"
        "BAACAAAABwMAABUBAwABAAAABAAAABYBBAABAAAACAAAABcBBAACAAAADwMAABwBAw"
        "ABAAAAAQAAAD0BAwABAAAAAgAAAAAAAAAIAAgACAAIAAgAAADKAQAAwgEAAKsAAAA=",
        ((11, 13, 3), "748bcd7ae06205f03e30d26e10fa75af"
                      "a69acaf3cd71a20e86c72cd167773c25")),
    "kind:tiflab": (
        "SUkqAPQBAACAHQAt0wCRomMRtE8gZwqR5O5Wvp2J59upHPx0HEGuY3g4CIILBc/h8J"
        "n5/gxEvB4mwCuo2gdwoV3O5SNt/Kxxv1KvR3HICuErhNslYItQ0ApqGUJN0xA5+IgA"
        "OBBP5zJV0PWagNSNkFJxzv1CP5wmsEt4vApvmQCNU6vluGgCNsuhFxnAFN1AxJOOME"
        "JR7AZKvoAIp7O81Atvm8FvI+AZ8n8BvpBgECmUFvAwAZxnt8OxDvABoh9hBDBIFpt+"
        "AZHPl2HAJuU+A98okCvxDgQGIR+hc2YIw6xNOcApZxBNBvwII4DA9PvIIJR7v5HgN8"
        "pZ7vxKOl/pVwg9NNcKJdqAo+PB1KNrBlVM0QpNvBc+PYFHl8AxEO4HpR4ApLPV8EYd"
        "Z7kmcAAFaaYAlqZx/OCdRNGqCRWmYDJMm2CQxH4A4wHmApCm+BA/Hif43ggcQ4gcag"
        "+H+cJMnSeRTm6eRKnMeZEnSe5QG4fxMHcACXgENR5HuPB3HWMYCHcMoKHaP4Im8QAH"
        "nQyYAkoeoAESfB9jifRxkscp6FGeACkIf4AjQf5zDGB5qi0DqegYBBLHsARGn8fhGg"
        "AA5Rn8AhQn0fwvAMdhBHefxOHU4x6gWLMSCwExqC8ER5DeAIBkg4RMHXQp7HuTQBHW"
        "TB/nigIKAAABBAABAAAADQAAAAEBBAABAAAACwAAAAIBAwADAAAAcgIAAAMBAwABAA"
        "AABQAAAAYBAwABAAAACAAAABEBBAABAAAACAAAABUBAwABAAAAAwAAABYBBAABAAAA"
        "CwAAABcBBAABAAAA7AEAABwBAwABAAAAAQAAAAAAAAAIAAgACAA=",
        ((11, 13, 3), "c898073d58a2b783c63bb1ad0f6aeac0"
                      "90bada9f83c33afaf404fbb615af9965")),
    "kind:tiflab16": (
        "TU0AKgAABBmAHNIg4Pu9jht4uE4hxHvQYP5xP5Ystwg07t9KPE2AxkO5bCYcvl4Axs"
        "h0LPR+hU6vYBAQUgYgvRWBU7vU7ARxBdZuoTgp4vwqv0OBNIOx5A4FglBvgCvkFo1+"
        "BcnO4PhBUuc0CNDt87P91vMDtoggpothFv5gP4nv5AhhFvQIBEzhQYPgCAJ8PQtBZC"
        "Px2vtxhYSgRqAMrvwfPsLAASPNGPo0A5yvZoAABAULgcEO8nJJmg9Ju88P8gvoYhA0"
        "u1FvoOvspvZQPxau45A4CvQngRbAo9PhVAo8gACgYPvI1vdrho9O1VPUAhY5AllPYh"
        "O4mB0DP98uldA0zgl+gEkOdlgZ5ggQtwdHdNhEwXkBt56H8AJwJNd1hkAGh9rUEBod"
        "ojAAPYAkWfZYH0SIDFKAY/noSILmidIsAOHQBFsd4mH6Ip9EWBRknsAh9AMEpRgKOY"
        "AkkEp8gSMp/j+eISgMcZ5F+aZAjsJQCnqfJ3HqGYBAiBQ/gsPR5BKAB6gGEAHHmdBC"
        "niEAHgGcyaiOBQenaIYEA6BhBHieYLAudQ1gMSQHiccoBAoGZ9AwAhSAmdx7lmCIwg"
        "2Xx+HyAReAAfoBkudxZnCfBPHadZ+HqDxxDwDoeggLx6lACA6gOWB9kwBJXncDJ7Es"
        "AwYG0agAGgAJ5nGJbUAAMS2AgCR1E+DAnAyMRvCaEBwAcL57miBAEnOLQIDQeI+naN"
        "QLDSe59gocB3k6AxwFmdJwCyfh1HcUAMHMfYUnCHsmH8Ch0iyAZhnoBZ9l0e5gnQUI"
        "EAQAxQHcDQGgYAAsAeRQAhUfwIBMKYKHWeBRgiboNlYcQHnyApzGuAoOnGVh1mcDZR"
        "ncJYNCaehrAyPRPHucwmn+bB8DuChqnQZiRg0CR+CAABwniBoDHIfJ6HoLx8HIdZyL"
        "ocxEAOMZ+CaBYlAEIoCk2DpxAUCgIDWfpFgeKxzFGep1n2LpznIAASnmfYAkCfQagC"
        "ZoAEuA4JD4XgBBEdxvAoNoChKfZDgQHp5EWA5ogOHZ3CQBY3nKdIIFKexfG4coLi2d"
        "I9ACMYBCIfo3AoSYCn4BYigIGQDHkfJwgGe1UAKHoMAebY5AySR/g0fRAgGZx4lAA4"
        "4n0Z40E6EQ8m6GgTDGfZ2gUMQDm8bZsgeVB7j6d54AGdJ3EmB4SngKh2k6BBZgAYwA"
        "ieBx2gcVoNGYBZHn8JoAAAeBQHoKwAFMcIkAkD4KBOeASgefZ/DoBJSHkPQ+xFAKQ0"
        "MYL4UgQjXGwNEDIcwBhgAeKsfY/x4hTASIkfQnB8jeHuDkAwcB6gtH8DgfYAB1jXAs"
        "N4AA+gEgpAeFUCI0wKghHs+gbI+Baj3A+AYFg8AFAQDuAAIw/h5D7A0PYN4DANjjB4"
        "A0DQ/hlAEDCQEACwEAAAQAAAABAAAADQEBAAQAAAABAAAACwECAAMAAAADAAAEowED"
        "AAMAAAABAAUAAAEGAAMAAAABAAgAAAERAAQAAAABAAAACAEVAAMAAAABAAMAAAEWAA"
        "QAAAABAAAACwEXAAQAAAABAAAEEQEcAAMAAAABAAEAAAE9AAMAAAABAAIAAAAAAAAA"
        "EAAQABA=",
        ((11, 13, 3), "9910acb753960a7c27fd2a4c99401c33"
                      "b107d43ac39503ca48e64edf7742e0e2")),
    "kind:tifsigned": (
        "SUkqAP0BAACAJo/JhDp9DmNUnQ9J44KdHm9Moo6m47Gg8m84KBDJ9RItandFJs5JFF"
        "oJJINEJVTIVPI9CpVDI9KHNPo03zZFGMqHw1EwvHYnm85FlDHc5Hw+nY8II2HZFoND"
        "pZKH9UpVEqZJntHoBHnArqAwE6KlMqGIll0wF83IU5nBOms1pk6GBFH8+n1CIRUplD"
        "rpXoRJIFQHciqA3Ek4FgwkkpG0qmVHnpHJZIKpAIe+Gs0JBIEo2pRDHhGKpcqBEqxZ"
        "JA2KVLFxBGM6lUiJIlkdVmI2K5BIpGJo5nVGExHIMnFZHHAqI1GJZQIpcKtRppZLxC"
        "KFIJUxE9XDkdrUdmJYlY5I4/FY3oQupU5H4snU/E49Ho1IBAHlDos6LROoBbIpSjkL"
        "ZXCMMZNiYRhKCmQxGCyMRFjcNhfj6QJDj6PI7DsMY5jUMQqjmNoilUOIxFoNRGkgNB"
        "EkCSA+EWThHkEQJNjyOZMkkJJjE4LxTFkLxIlIJhDkGLY5kAPoyFWRQrmKRgwl2SA7"
        "FETpHEgQJSkYMRRkqOhJlUFxNFWJxMGGNJDmOLhGlUMxOMoUJTFEPZilUNpeFuTBAl"
        "IWQuDiVQqC4SopjUP40CqO47i0RZPjmS5hDYUxWjCTBLD2ThLkMSpQkYQJKlihhZFq"
        "LA9FKH4vEQGQyDaJKAgLAAABBAABAAAADQAAAAEBBAABAAAACwAAAAIBAwADAAAAhw"
        "IAAAMBAwABAAAABQAAAAYBAwABAAAAAgAAABEBBAABAAAACAAAABUBAwABAAAAAwAA"
        "ABYBBAABAAAACwAAABcBBAABAAAA9QEAABwBAwABAAAAAQAAAFMBAwADAAAAjQIAAA"
        "AAAAAIAAgACAACAAIAAgA=",
        ((11, 13, 3), "945f02d23387c6cfc3c3d57967b39b57"
                      "387ea59ffdbddb084da7683e0542ee7f")),
    "kind:tiffill2_lzw": (
        "SUkqAPIBAAABeNKXxJ+mBDHMxQkWwouzGiZcxIrgg1MZexQKmRIQS58GJzxiJBGTol"
        "4mOxE8BIrnJEy4ZJ4ixfHjw0o2A6Y8eLAgIoMRZSUMGKunxUAGBT6i6UhQJVSwAv7C"
        "eXMTIVkkVwVCOEhkwpkzdaqMiZPjQoizFEoitNPgroQJQw5smPBnKkCRDI7sZLIVIp"
        "ClNN4MlfGmrYQuBWF4CInER1YGJXbSafIRzoAVB2aMgoqQopwnN7UMRSgmI04tUUVq"
        "yJrgT18fLTrKaJGRyogCK0aMinBiSZE7HxJ8hcmWy1+7MAUGyagziE21WgJGpLIwwF"
        "W8fGqCZdBlKogvQ66iuHBkIpoJGe68lcgUpFuCPHlMVIoiLk8kWQUSuErkIo43IUKJ"
        "QQYncgjGmlpK8CCNGNIxwk5N6ogjjyaCqcUHS/KxQYMoPDAgEE8cMEAPa1QRwgozxD"
        "HBDWuMSCQDJ6IoIBxnf/EREAEUs+Mvm40sHjSUsWcsnbpgAaSEMCbPjhlZxuwoM2bI"
        "gQM9UYIYihEkUAQ3acIw0RKOjaVIQiJEsZNHX4EcPCrE4hLBEw9dHlRpcecunDEveT"
        "T58uchjJEEtujYCULHUQ4lrjpYSJHJWwVVCbJxSGFKlDM1ejS5ceLHV7hkjqqZ8lRN"
        "TEhACwAAAQQAAQAAAA0AAAABAQQAAQAAAAsAAAACAQMAAwAAAHwCAAADAQMAAQAAAA"
        "UAAAAGAQMAAQAAAAIAAAAKAQMAAQAAAAIAAAARAQQAAgAAAIICAAAVAQMAAQAAAAMA"
        "AAAWAQQAAQAAAAgAAAAXAQQAAgAAAIoCAAAcAQMAAQAAAAEAAAAAAAAACAAIAAgACA"
        "AAAGwBAABkAQAAhgAAAA==",
        ((11, 13, 3), "77fe8b594fcc73fe5220e1a6c80c718e"
                      "26e306efd1134618b64e3c59e33a4ee9")),
    "kind:tiffill2_deflate": (
        "SUkqALkBAAAeOaCD2vJBCgAAB/5r0nwram1l0tYR7QKgjIYeBjgjxTvwFHoA9IWlya"
        "1bVtPje1734q++gV+ROcEc5EaPNF4lmhC2vb9EpuIueEhu3T1160K9jc8cBNlu0zXY"
        "uTmiAWCWB99/6mKQc6ZU5noIjJNf9lndDnWv5pNvstDUOfueATMHcKTpzMF4TA3q4H"
        "kwR714Q7rQtUOnFy2B1BBZq0jSZ0RCsd3cHT625RgesZLp+2nI1WalVo/0vV+cZo45"
        "mRQjjQzbLusUmPy3jRGg4eDQDPqJR0J9nKKl+wl/H3Uj91mDtcBS+XAgiwygN4TwnD"
        "4OBaeVxJ1R/SUtsjsuxIpUXne1oaJ5jR9bCsYFWrPSlRvb9uTG7I0WJi5ZvnU156Dd"
        "Rw0AKCtIlcwoQiP82UwZTB45gK4AUf/WqjGh2pU1vg11hVXBKflazhGq5gHm1jFe7t"
        "5O4RYGQeYu/kbhcdZR5r5RuomVrukdmYnJWUnOUTG23l5O9jGuPpkO5eHmDQ5aKQYW"
        "EcbBCYmZ7gHVXjb93toVgRYpCf6xcS4uCX5WZRn+vaEhtRb6Ac56Vh6lK9zyCwAAAQ"
        "QAAQAAAA0AAAABAQQAAQAAAAsAAAACAQMAAwAAAEMCAAADAQMAAQAAAAgAAAAGAQMA"
        "AQAAAAIAAAAKAQMAAQAAAAIAAAARAQQAAgAAAEkCAAAVAQMAAQAAAAMAAAAWAQQAAQ"
        "AAAAgAAAAXAQQAAgAAAFECAAAcAQMAAQAAAAEAAAAAAAAACAAIAAgACAAAADkBAAAx"
        "AQAAgAAAAA==",
        ((11, 13, 3), "747b0f4e20bc7a17404dd916e8340523"
                      "1fe35cae8e2f8f8b3f93cc2854d7a580")),
    "kind:tifrle": (
        "SUkqACgAAAA1dmA1cEDyNexgNaMdgB/mNSfgNQkANU5unDVOeDXHKwoAAAEEAAEAAA"
        "ANAAAAAQEEAAEAAAALAAAAAgEDAAEAAAABAAAAAwEDAAEAAAACAAAABgEDAAEAAAAA"
        "AAAAEQEEAAIAAACmAAAAFQEDAAEAAAABAAAAFgEEAAEAAAAIAAAAFwEEAAIAAACuAA"
        "AAHAEDAAEAAAABAAAAAAAAAAgAAAAeAAAAFgAAAAoAAAA=",
        ((11, 13, 3), "03f2ba21693806af8a67752f1ff1f78a"
                      "98c18c7d6b4b6b5f533f9689025310bf")),
    "kind:tifg3": (
        "SUkqADUAAAAAF7McAEd5jgAj1AAR/04AJqeY4AI5xDgA3DzgAjp7gAATUvABNTduAC"
        "am7cAKAAABBAABAAAADQAAAAEBBAABAAAACwAAAAIBAwABAAAAAQAAAAMBAwABAAAA"
        "AwAAAAYBAwABAAAAAAAAABEBBAACAAAAswAAABUBAwABAAAAAQAAABYBBAABAAAACA"
        "AAABcBBAACAAAAuwAAABwBAwABAAAAAQAAAAAAAAAIAAAAKAAAACAAAAANAAAA",
        ((11, 13, 3), "75264721926332b8086fe3e7850e34a8"
                      "3ad42190a1f4e2731fc3b587adfa80de")),
    "kind:tifsgilogl": (
        "SUkqADwBAAANPj4+Pj4+Pj4+Pj09PQ1PcYhpc5jF86QV372DDT4+Pj09Pj4+Pj09PT"
        "4NS0Y0+++L5LRYuz2UBw09PT09PT4+PT08PD09DcfW3LaOEWfhJVAyJscNPT4+Pj49"
        "Pj08PDw9PQ3dBExqD+oagrdevWRKDT09Pj4+Pj49PT0+Pj4NyeNwgRM0ef6//RxRAg"
        "09PT0+Pj4+Pj4+Pj4+DaJV9ScCQVcwRkpJeS8NPTw9Pj49PT4+PT09PQ3h+oQ8Htnp"
        "V1K4ovWyDT08PT4+PT0+PT08PT0N27aGgDWU0SnYE8RO5A09PT0+Pj09PTw9PD0+Dc"
        "YByHtE0/J8/wD9bgINPT09Pj4+PT09PT09PQ3dTeeTgBPfQxJcpPTnDT09Pj4+PT09"
        "PT09Pj4NrZ4poVqdOYriwupVIQoAAAEEAAEAAAANAAAAAQEEAAEAAAALAAAAAgEDAA"
        "EAAAAQAAAAAwEDAAEAAAB0hwAABgEDAAEAAABMgAAAEQEEAAIAAAC6AQAAFQEDAAEA"
        "AAABAAAAFgEEAAEAAAAIAAAAFwEEAAIAAADCAQAAHAEDAAEAAAABAAAAAAAAAAgAAA"
        "DoAAAA4AAAAFQAAAA=",
        ((11, 13, 3), "2db58647f9701f8b690aee99bb9d5a1b"
                      "603f80e01fe9eaa7d86a7b0dd57bbb6f")),
    "kind:tifsgiloguv": (
        "SUkqABwDAAAQPT4+Pj4+Pj4+PTw8PAAAABC4dXpKRSxrn0OTvrf5AAAAEG5UWWVhUU"
        "hOTktVamMAAAAQxcLLz8XL0sW2qY2SrgAAABA9PT09PT49Pj09PT0+AAAAEJCPp77p"
        "AvsoyXyJ7g8AAAAQXVJaXldJS1JRVGNuXwAAABDCq7PDxM/Rzs7GuMLOAAAAED09Pj"
        "49PT09PT09Pj4AAAAQ4KwUMuivnNFxVOhhYgAAABBDR09NRT9AQUhfZmFXAAAAEMy3"
        "u8bHzM7Z2tHR09UAAAAQPj4+Pj49PT09PT09PgAAABBTH57VPrK3dg4eWcc0AAAAEE"
        "ZOTEZBP0BMcHljV1cAAAAQ0cfM0MPD0dPIvcbNzQAAABA9PT4+PT09PT09PT0+AAAA"
        "EOymXKPsa3Utcox0x10AAAAQXmxcT1BVVXGHel1SUgAAABDKytXVvbvOvre8wMvPAA"
        "AAEDw9Pj09PT08PT0+Pj4AAAAQ/D8g/jMaCP+g9Q01VgAAABBncmZYXVlWa3NqVkpO"
        "AAAAEMrS0s27tLSjp73Exs0AAAAQPT0+PT09PT09Pj49PQAAABBk8Hj+GVBpRNxLL+"
        "2mAAAAEFRfV0dJSkpcZFhLSFMAAAAQ1NXLw8PBrpqnwMKvqgAAABA9Pj4+PT0+PT4+"
        "PT09AAAAEM4HTxNqpi3/OGvAgYUAAAAQXmlbSUlQUVpcUlRcXAAAABDOz8rGwL+/ub"
        "e/uq+mAAAAED09PT09PT4+Pj49PT0AAAAQk4HMvE2qjnZIWJ296QAAABBqdHJpaWhe"
        "XVpSXnJoAAAAEMXJxristsjLv7q3xMUAAAAQPj09PT09Pj49Pj09PQAAABAe9uO5eL"
        "1NKv1KxrfuAAAAEFRTW1xqcmZmWEhNZGoAAAAQysy8p67Fz87AvbC3zgAAABA+Pj4+"
        "Pj09PT4+Pj09AAAAEG1IITIG4vXtAU4u6rEAAAAQVkpEREtUWVhMQkRPYwAAABDLxL"
        "WzuMLLz8rEtKvHAAAAjgCOAI4AjgCOAI4AjgCOAI4AjgCOAI4AjgCOAI4AjgCOAI4A"
        "jgCOAAsAAAEEAAEAAAANAAAAAQEEAAEAAAALAAAAAgEDAAMAAACmAwAAAwEDAAEAAA"
        "B0hwAABgEDAAEAAABNgAAAFQEDAAEAAAADAAAAHAEDAAEAAAABAAAAQgEEAAEAAAAQ"
        "AAAAQwEEAAEAAAAQAAAARAEEAAEAAAAIAAAARQEEAAEAAAAUAwAAAAAAABAAEAAQAA"
        "==",
        ((11, 13, 3), "0ee30a49d799a51ae30968992ec22374"
                      "31c8a6b64efa3cb210b216ce8f29069b")),
    "kind:tifsgilog24": (
        "SUkqALUBAACbtGGnc4Sntkuktx2kdL2i9eCmuDip9EqkMFiZLMmL5OyLZo6PrgmZM4"
        "uY7TOab5ab8/CetFCgNwqft9WitxCctw+X9LSYsMye85eg9xmeNjya8LmhcYijNK+e"
        "tQ6a9jiZ9wSdOceXOjGVd36et+imOEmmOQ2lN9Kh9RSp9kKtd22j89ybM9ubd86XeD"
        "uQ9SyR8gqVtL6cdq+jdq+e9emadfOl+KuqOKKe8lOWsYyXdxKS8s+XMOWY8guXcyac"
        "dkal9xCP9fCT9/CiN+if9q+TMZKRr/uQr/mP60yaLICfcmWg9FCjdKyldqiWeKWfOK"
        "2nteWf8+CRs+KVMxiWrfiUaH6d7BGksyOi836e7luabTOc9xigdyCk9eihNKyWsxia"
        "crei8rmf8SujsGKmsrmcMYuYLmmYbAuZNF6YNZOc9Mib8TWU7aiasGqo9YSndk2ksr"
        "6lsYqZ8GSb9GOetFyh9eKfdkaeMfWbrAuXrg6b9GSk9x6itrmf8yKksk2cbsObcM2e"
        "9yGm9kmktEiiL+yjL4egcLueM4Wfdeae9xSgNXik9EKi74eerTGbNSMKAAABBAABAA"
        "AADQAAAAEBBAABAAAACwAAAAIBAwADAAAAMwIAAAMBAwABAAAAdYcAAAYBAwABAAAA"
        "TYAAABEBBAACAAAAOQIAABUBAwABAAAAAwAAABYBBAABAAAACAAAABcBBAACAAAAQQ"
        "IAABwBAwABAAAAAQAAAAAAAAAQABAAEAAIAAAAQAEAADgBAAB1AAAA",
        ((11, 13, 3), "dd14742e79356a5d615b36a1c703d3b6"
                      "620afac0201f26e6339cba6fc7c316b2")),
    "kind:tifthundertiles": (
        "SUkqAAgBAADIyMnJycjHx8jJyMjJwMDAyMfIyMjIycjIyMjJysDAwMjHx8fGyMnJx8"
        "bHyMnAwMDHyMnIx8jJyMXFx8jIwMDAxsnKyMfIycjFxsjIyMDAwMbHyMfGx8nHxsfI"
        "yMfAwMDGxsfIx8fHyMfHxsbGwMDAx8fIycnIyMnJyMfGx8DAwMjHx8fIycnIyMnJx8"
        "fAwMDJyMfGx8nKyMfJycfHwMDAycnIyMfHycjHyMnHx8DAwMDAwMDAwMDAwMDAwMDA"
        "wMDAwMDAwMDAwMDAwMDAwMDAwMDAwMDAwMDAwMDAwMDAwMDAwMDAwMDAwMDAwMDAwM"
        "DAwMDAwMDAwMDAwMDAwMDADAAAAQQAAQAAAA0AAAABAQQAAQAAAAsAAAACAQMAAQAA"
        "AAQAAAADAQMAAQAAACmAAAAGAQMAAQAAAAMAAAAVAQMAAQAAAAEAAAAcAQMAAQAAAA"
        "EAAABAAQMAMAAAAJ4BAABCAQQAAQAAABAAAABDAQQAAQAAABAAAABEAQQAAQAAAAgA"
        "AABFAQQAAQAAAAABAAAAAAAAAAARESIiMzNERFVVZmZ3d4iImZmqqru7zMzd3e7u//"
        "///+7u3d3MzLu7qqqZmYiId3dmZlVVREQzMyIiEREAAAAAEREiIjMzRERVVWZmd3eI"
        "iJmZqqq7u8zM3d3u7v//",
        ((11, 13, 3), "b4832714f4a49186a88d3a7b645c0e38"
                      "50fe8a65960fca7717f96d1510460773")),
    "pil:jpeg_RGB": (
        "SUkqAOQAAAD/2P/AABEIAAsADQNSEQBHEQBCEQD/2gAMA1IARwBCAAA/ALggknsrpo"
        "444JxiNJZcBOvP1qu6fabNxLbMlunyrsHc981PBHPYHz/OSe6VMrG3CqnTA7ZpYdFi"
        "kZ/MmLyAgOpYfK2Oatzx3BWJYJ4oYVQbEHXHqfrVSfcQsl1bPmTLrsbaAD2xStGh0a"
        "WQqNwCOD6HPUelU7G/upPD88bzMUUjA/Gq1tdz3k8AuJDIDCSQayLMeY08j5Ls+SSe"
        "ppbGeS4ed5SGYMBkqOmK2dPhjeJtyA4OBnsK/9kACwAAAQMAAQAAAA0AAAABAQMAAQ"
        "AAAAsAAAACAQMAAwAAAG4BAAADAQMAAQAAAAcAAAAGAQMAAQAAAAIAAAARAQQAAQAA"
        "AAgAAAAVAQMAAQAAAAMAAAAWAQMAAQAAAAsAAAAXAQQAAQAAANsAAAAcAQMAAQAAAA"
        "EAAABbAQcAIQEAAHQBAAAAAAAACAAIAAgA/9j/2wBDAAgGBgcGBQgHBwcJCQgKDBQN"
        "DAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/xA"
        "AfAAABBQEBAQEBAQAAAAAAAAAAAQIDBAUGBwgJCgv/xAC1EAACAQMDAgQDBQUEBAAA"
        "AX0BAgMABBEFEiExQQYTUWEHInEUMoGRoQgjQrHBFVLR8CQzYnKCCQoWFxgZGiUmJy"
        "gpKjQ1Njc4OTpDREVGR0hJSlNUVVZXWFlaY2RlZmdoaWpzdHV2d3h5eoOEhYaHiImK"
        "kpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4eLj5O"
        "Xm5+jp6vHy8/T19vf4+fr/2Q==",
        ((11, 13, 3), "e93644855b1ed349aac199d85d1a708d"
                      "40bde6a3096875d2be24b8a15c0d9ff3")),
    "pil:jpeg_YCbCr": (
        "SUkqAKAAAAD/2P/AABEIAAsADQMBEQACEQEDEQH/2gAMAwEAAhEDEQA/AEuXF5am38"
        "77NciTaVfjeB0xVxpr3pr3tL+gUpLl5rbq/wDlcTZJFDGMzzMR8zb654TdbWXuv0Mo"
        "Yj3eapDVlmFVlt0kkUO7Icswya9FzlHlcdNDkwv7uolEr61NJBeKkTlF2DgV4GHr1G"
        "5e89zsnFOpK5//2Q0AAAEDAAEAAAANAAAAAQEDAAEAAAALAAAAAgEDAAMAAABCAQAA"
        "AwEDAAEAAAAHAAAABgEDAAEAAAAGAAAAEQEEAAEAAAAIAAAAFQEDAAEAAAADAAAAFg"
        "EDAAEAAAALAAAAFwEEAAEAAACYAAAAHAEDAAEAAAABAAAAWwEHAD4CAAB4AQAAEgID"
        "AAIAAAABAAEAFAIFAAYAAABIAQAAAAAAAAgACAAIAAAAAAABAAAA/wAAAAEAAACAAA"
        "AAAQAAAP8AAAABAAAAgAAAAAEAAAD/AAAAAQAAAP/Y/9sAQwAIBgYHBgUIBwcHCQkI"
        "CgwUDQwLCwwZEhMPFB0aHx4dGhwcICQuJyAiLCMcHCg3KSwwMTQ0NB8nOT04MjwuMz"
        "Qy/9sAQwEJCQkMCwwYDQ0YMiEcITIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
        "MjIyMjIyMjIyMjIyMjIyMjIyMjIy/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBg"
        "cICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEI"
        "I0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWm"
        "NkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5"
        "usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQ"
        "EBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEE"
        "BSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nz"
        "g5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaX"
        "mJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8v"
        "P09fb3+Pn6/9k=",
        ((11, 13, 3), "3dfa6b1bd24fd10660b136c5a76f6a72"
                      "92c006926959356302c3aa757edbc8a0")),
    "pil:jpeg_CMYK": (
        "SUkqAPYAAAD/2P/AABQIAAsADQRDEQBNEQBZEQBLEQD/2gAOBEMATQBZAEsAAD8AW1"
        "u5odPuLMec8ULbnZuefbvVu0xc2JaO6xAx80RFfnZvfPvVPVtQuY4LddOk853ARVbh"
        "kb37V8/1Ut7bMfmjT2uIH5jlCEs3ruxVG5vftREkls6yAlGRhnGKo6h/piQDyGjuYw"
        "RcFDuV29RRU1tk6ZqIJPy+YQc8jn161sXVvFa3cskCBGckMR3FdBpdvFJIyugYGJ2O"
        "fX1opUvbqK2iSOeRFAwArYH6VgyxI0jyEEuzHJyearXzm2eJIcIvlg4A70V//9kACw"
        "AAAQMAAQAAAA0AAAABAQMAAQAAAAsAAAACAQMABAAAAIABAAADAQMAAQAAAAcAAAAG"
        "AQMAAQAAAAUAAAARAQQAAQAAAAgAAAAVAQMAAQAAAAQAAAAWAQMAAQAAAAsAAAAXAQ"
        "QAAQAAAO0AAAAcAQMAAQAAAAEAAABbAQcAIQEAAIgBAAAAAAAACAAIAAgACAD/2P/b"
        "AEMACAYGBwYFCAcHBwkJCAoMFA0MCwsMGRITDxQdGh8eHRocHCAkLicgIiwjHBwoNy"
        "ksMDE0NDQfJzk9ODI8LjM0Mv/EAB8AAAEFAQEBAQEBAAAAAAAAAAABAgMEBQYHCAkK"
        "C//EALUQAAIBAwMCBAMFBQQEAAABfQECAwAEEQUSITFBBhNRYQcicRQygZGhCCNCsc"
        "EVUtHwJDNicoIJChYXGBkaJSYnKCkqNDU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVm"
        "Z2hpanN0dXZ3eHl6g4SFhoeIiYqSk5SVlpeYmZqio6Slpqeoqaqys7S1tre4ubrCw8"
        "TFxsfIycrS09TV1tfY2drh4uPk5ebn6Onq8fLz9PX29/j5+v/Z",
        ((11, 13, 3), "f9c65392e3440bf507f0f567cd8d5e7b"
                      "9bfb7f47c600c75b4d98d464ca2ea44b")),
    "pil:ccitt_2": (
        "SUkqAFIAAAAdDofHQ6HQNU6HQ6hDgB0Pjp06Hx06H3A1TofHQ6HQHx0Oh0Oh0DVDod"
        "DodDodAB0Oh0Oh0OhwNUOnTodDoB0OnQ6Hxx8dOh0PgAkAAAEDAAEAAAANAAAAAQED"
        "AAEAAAALAAAAAgEDAAEAAAABAAAAAwEDAAEAAAACAAAABgEDAAEAAAABAAAAEQEEAA"
        "EAAAAIAAAAFgEDAAEAAAALAAAAFwEEAAEAAABKAAAAHAEDAAEAAAABAAAAAAAAAA==",
        ((11, 13, 3), "e6acc9f70e3c234235a6058c163e8972"
                      "df7afaa1f56e38dd6551f1d7af7ec801")),
    "pil:ccitt_3": (
        "SUkqAF4AAAAAEdDofHQ6HQAJqnQ6HUIcAEdD46dOgAR8dOh9wATVOh8dDodAAj46HQ"
        "6HQ6ABNUOh0Oh0Oh0ACOh0Oh0Oh0OACaodOnQ6HQAI6HTodD44AI+OnQ6HwAkAAAED"
        "AAEAAAANAAAAAQEDAAEAAAALAAAAAgEDAAEAAAABAAAAAwEDAAEAAAADAAAABgEDAA"
        "EAAAABAAAAEQEEAAEAAAAIAAAAFgEDAAEAAAALAAAAFwEEAAEAAABWAAAAHAEDAAEA"
        "AAABAAAAAAAAAA==",
        ((11, 13, 3), "e6acc9f70e3c234235a6058c163e8972"
                      "df7afaa1f56e38dd6551f1d7af7ec801")),
    "pil:ccitt_3_2d": (
        "SUkqAFYAAAAAGaodDodDodDoAF2l+ADHQ6HQ6dOACSVpIKADHQ+Oh0Oh0ACSpJJWAD"
        "HQ6Hx0Oh0ACSSQSSSUAGaodOh0PjoAE0EkkEFwAZqh0Oh8fcAKAAABAwABAAAADQAA"
        "AAEBAwABAAAACwAAAAIBAwABAAAAAQAAAAMBAwABAAAAAwAAAAYBAwABAAAAAQAAAB"
        "EBBAABAAAACAAAABYBAwABAAAACwAAABcBBAABAAAATgAAABwBAwABAAAAAQAAACQB"
        "BAABAAAAAQAAAAAAAAA=",
        ((11, 13, 3), "89430adee9c64b4b6423491bfa055522"
                      "2f8fb4a54f1c5962cca4d0e852352fd8")),
    "pil:ccitt_4": (
        "SUkqADwAAAAjojoj5HQIJUukmrCtIIJ7CsK2gkgkggVWkEF/QQX/2kkkkkqSW0krQQ"
        "TC72EE0ggmACACCQAAAQMAAQAAAA0AAAABAQMAAQAAAAsAAAACAQMAAQAAAAEAAAAD"
        "AQMAAQAAAAQAAAAGAQMAAQAAAAEAAAARAQQAAQAAAAgAAAAWAQMAAQAAAAsAAAAXAQ"
        "QAAQAAADQAAAAcAQMAAQAAAAEAAAAAAAAA",
        ((11, 13, 3), "e6acc9f70e3c234235a6058c163e8972"
                      "df7afaa1f56e38dd6551f1d7af7ec801")),
    "pil:cmyk_raw": (
        "SUkqAAgAAAAKAAABBAABAAAADQAAAAEBBAABAAAACwAAAAIBAwAEAAAAhgAAAAMBAw"
        "ABAAAAAQAAAAYBAwABAAAABQAAABEBBAABAAAAjgAAABUBAwABAAAABAAAABYBBAAB"
        "AAAACwAAABcBBAABAAAAPAIAABwBAwABAAAAAQAAAAAAAAAIAAgACAAIAHehlQCAmG"
        "UAfXVlAJJxgwCRh4sAbph3AG+nVwCBrVYAdqpxAHuLfwCOYH0AjVl2AJFxkAByhH0A"
        "an5rAGhqjwB8b6UAf4OVAGWNdwBqqUcAgbU+AH6NVwCPYmwAn1qFAI5qhgCNgZwAbH"
        "GUAGZqnQBwca0AbYCfAF6AewBcd2oAhI5aAJ6eVgCQeGIAkll9AKJskgCWjHcAgJp9"
        "AHh+mQB2fKoAdoaeAGuLeQBMj2MAU3V8AKFxiwDAg30Ajm+HAGlpnQB4jo4AeaViAG"
        "WfagB9k4wAh5iLAHigZwBxj1oAU4ddAFd5hACXd6MAqXqaAIRxlwBcgJUAV42JAGCL"
        "gwBfiYcAeY55AJ+cYwCVqk4AhZBoAGV3ZABWg2MAXZmCAF2NnABteJkAbnWDAF1piA"
        "BZZJkAXHKWAGSMZwCJh1sAjZZfAHSKiQBPdYEARoVeAFKXYQBQk4IAToiJAGdhaABw"
        "UWUAVGl4AEtvjQBvkGgAc4FtAGN3aABRXn8ATlGLAGdtcQCLiW0AeYh+AEuEgQBrbW"
        "MAk2xUAHGMZABcfYkAeYpiAIWGXwB1WlwAYTttAGs8hACIUIIAnHuGAHSEkgBYaZQA"
        "imh/AK6FeACWm38Ag4J/AG2eeQB/j2cAimFpAHVXiQBWWZcAZV2GAIuDeAB+loUAeX"
        "OOAJ5mggCpfoIAlIF/AIdzbwCHrrAAbKuWAGedhwBriaAATmqlAFVviwCBj3YAjZp7"
        "AI+UgQCZoIEAmaqEAImRbgB7e2EA",
        ((11, 13, 3), "e4eb7a5e2fc2d4883492ace9c04ddf3b"
                      "b922f9b3edc8e55e3508200f8348ae13")),
    "pil:cmyk_lzw": (
        "SUkqAEQCAACAHdQpUAIBMGUAH06whJHFBgBIodFgA3Jg7gA3qcrgBAq0rAA7Ko4gA9"
        "os/gBHGA+gBGlk7RA4pAAHJCSs1H41gA0GpHgA+G9SgA/oOCGVGxc1Kkjxxaj4AH5G"
        "xtHmI2ABPlpCyg1IaWIFOAA2HFKAAzGpOgA4HFWgA2oBPgAvIA9gAuHc1ABCI4tABP"
        "J6PpA8GIAJIsytRGxJABLIyLoBNSs8H5MyA+KqQIZPAA1os8gAmI8xgApnU+ABQnGJ"
        "sBBytHG9DgA0mmznhHI4AHlS4Iyp+7n1JowAIdMRM8KAzgA4o+9lNDl0AFc8oQAJc7"
        "qMAKk9Jq8HFL3RAQQro1EgAwIuHl9E688o7Op9OaFKqonABCpA0AAyncyAArIPQi6T"
        "JBAALpGq+No8MmNw6oeLo0kQAAsjIyYuDkSwADIRjjvSLaWEsL4ADoRTxieOpAgAIx"
        "Ci8AApEuMIACgScBCcRDxjOML7jgKKECoNI8AAJY3kajD7AAOZAjaAAxju+4oi8k4n"
        "CiiYzjakZFkTJA8kQP0fkJEw1ja0JJjYKjkEY/YuD68Y8kUwRCkND46i0LgADCHckD"
        "WHjpEQKEBE4PauDoQjEiwNKxkUNCTlcQsfEsTaTkGQSTjaTzOj+R7jkUMI0gAOorvG"
        "Kwsu6Mouq480fD8SysjyObbE8M0BFSP0BEoQKTkOOY3uCVxYLAVcLDOTrXjWRJQAAJ"
        "w1KCKo3omQJHpeRpNLmR9aAATJQRMTJVOkRJIjckg9xcgIAAoAAAEDAAEAAAANAAAA"
        "AQEDAAEAAAALAAAAAgEDAAQAAADCAgAAAwEDAAEAAAAFAAAABgEDAAEAAAAFAAAAEQ"
        "EEAAEAAAAIAAAAFQEDAAEAAAAEAAAAFgEDAAEAAAALAAAAFwEEAAEAAAA7AgAAHAED"
        "AAEAAAABAAAAAAAAAAgACAAIAAgA",
        ((11, 13, 3), "e4eb7a5e2fc2d4883492ace9c04ddf3b"
                      "b922f9b3edc8e55e3508200f8348ae13")),
    "pil:lab_raw": (
        "SUkqAAgAAAALAAABBAABAAAADQAAAAEBBAABAAAACwAAAAIBAwADAAAAkgAAAAMBAw"
        "ABAAAAAQAAAAYBAwABAAAACAAAABEBBAABAAAA1AIAABUBAwABAAAAAwAAABYBBAAB"
        "AAAACwAAABcBBAABAAAArQEAABwBAwABAAAAAQAAAHOHBwA8AgAAmAAAAAAAAAAIAA"
        "gACAAAAAI8bGNtcwIQAABhYnN0TGFiIExhYiAH6gAKABIACQAgADthY3NwQVBQTAAA"
        "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA9tYAAQAAAADTLWxjbXMAAAAAAAAAAAAAAA"
        "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAVkZXNjAAAAwAAAAJxj"
        "cHJ0AAABXAAAACF3dHB0AAABgAAAABRjaGFkAAABlAAAACxBMkIwAAABwAAAAHxkZX"
        "NjAAAAAAAAABZMYWIgaWRlbnRpdHkgYnVpbHQtaW4AAAAAAAAAABYATABhAGIAIABp"
        "AGQAZQBuAHQAaQB0AHkAIABiAHUAaQBsAHQALQBpAG4AAAAAAAAAAAAAAAAAAAAAAA"
        "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
        "AAAAAAB0ZXh0AAAAAE5vIGNvcHlyaWdodCwgdXNlIGZyZWVseQAAAABYWVogAAAAAA"
        "AA9tYAAQAAAADTLXNmMzIAAAAAAAEAAAAAAAAAAAAAAAAAAAABAAAAAAAAAAAAAAAA"
        "AAAAAQAAbWZ0MgAAAAADAwIAAAEAAAAAAAAAAAAAAAAAAAABAAAAAAAAAAAAAAAAAA"
        "AAAQAAAAIAAgAA//8AAP//AAD//wAAAAAAAAAAAAD//wAA//8AAAAA////////AAAA"
        "AP//AAD///////8AAP///////wAA//8AAP//AAD//3j/6mQj3mci3n4F7qf0/LH7+6"
        "H8+JL99XYN8nUQDYgYIIUhG4MCFY3x/XAF9XIG7Ynv+qfeCa/mCZj1+3cE7lsS5FoO"
        "32wH4WoQ6WgQBYsA7Yb+85jqAafeDqjdFJ/qCIj97nAI6mIJ6mgB4nn36GwC52EQ7n"
        "QJ6YX7+KDmEpj5EJr8C473+28K63QM/IEIA4QFBYgDD2oL+mQF7X/4+IvzDY3/GYwU"
        "FKD/EJL5+HQT8YEQBI4HB4wGFokBH3L8CWb59Z7rDJrmHIj/GZMJGKT2Gpj6CZQFBZ"
        "r5CJjsCpnmGJ7bHJrYE4Dw9qbcIq3TKpfiH4H5E376FI3xGJn0FJr4BJDtApfjC7DW"
        "DLfRCp3n957aGrDSIp3fG2f+D2b1DYniEYP0CXQQ7nYM4oD+7pzq/6ne/5jo/43rAq"
        "PfCZzxC3MJC2/zAXzu9mgF+GoU94MQ64QP9IgDC5j3C476BnX575rmAKfzEIkCC23/"
        "8WcN4l8d+HcOEZv5DZIAB5IDEacBEKX9CmMG9obxCKDuHIj5FF4Q7Vwl32Ik+3UEDJ"
        "TpC5ztCqD4BJ0C+ZwA/g==",
        ((11, 13, 3), "e9779e8265d1a260e05da1e3fbd64773"
                      "9bb586698b82dcb9b58e49b2eef7d209")),
    "pil:ycbcr_raw": (
        "SUkqAAgAAAAMAAABBAABAAAADQAAAAEBBAABAAAACwAAAAIBAwADAAAAngAAAAMBAw"
        "ABAAAAAQAAAAYBAwABAAAABgAAABEBBAABAAAA1AAAABUBAwABAAAAAwAAABYBBAAB"
        "AAAACwAAABcBBAABAAAArQEAABwBAwABAAAAAQAAABICAwACAAAAAQABABQCBQAGAA"
        "AApAAAAAAAAAAIAAgACAAAAAAAAQAAAP8AAAABAAAAgAAAAAEAAAD/AAAAAQAAAIAA"
        "AAABAAAA/wAAAAEAAAByg42GbHp6bnhLjHM9mnRkjXt+ent1dYJtfpNxkKR9kZ+QhJ"
        "KZioaMg5iYZY15coZWlXxUlnhqiHd7hXB2hohxgqF2hpt2ioyDioKImICQgpCOdJF8"
        "eohyint8h3CEfm6GiW2EloJ5jqBvd5hsbId3gH98n3F1fJR4e4mFfHODjHGDkHCAjH"
        "t4noh+rX97o4ByhI90ZJ5/cJqFlnZze4loc498coKChIh1molpq4hwt46FsnePomSO"
        "jnuIdpuFdp2HkH2UgWp9cZJybKNvfKdnmp5nso13s46InYacgnOoe26Uh3mFjY2XiI"
        "Cke2Cce3yBfZxriZpnnINurH58nYx9fZ2PbZWldHOLj2Z/m3yYhIGSeGmRinWGi5GF"
        "hoR7jnFqpHVymXt2f5J/gaOOiYSBjWR0lF94jGh5hYCOh4STgXqUeWqAgHlik4VjlY"
        "Z4i5R8kJl9jHyIfFyDelR5flxnlJqNiZyQfX2DfWt2iXRniH5qe5SEe6GEhIx+eHOL"
        "a2eOdm2NdnhemJZ2iqNzgpduiYxyi4BpenVsbIWAcpeBeo2DbIOEcYB9iX+KhIE=",
        ((11, 13, 3), "a4211c59b0d759302d41a8cf6cbd3ccd"
                      "c67c5c44251a7b7135e7384f267bef72")),
    "random:2_1": (
        "SUkqAHsAAAAa00OrKE5G1YoQAmlw+cijqrnKgPP9Ieq4YqTEIbh+PD3hYBm7rFeY+W"
        "9V16BkAY9pSPhEFsJwyt188ogLoyt/mKalC9/gvE7y8/hGU+4dQNdVybngwk5cX7AC"
        "fFLRmEPBZowYznmUNDBBPbeemJb+AUHgCwAAAQQAAQAAACUAAAABAQQAAQAAABcAAA"
        "ACAQMAAQAAAAEAAAADAQMAAQAAAAIAAAAGAQMAAQAAAAAAAAAKAQMAAQAAAAEAAAAR"
        "AQQABgAAAAUBAAAVAQMAAQAAAAEAAAAWAQQAAQAAAAQAAAAXAQQABgAAAB0BAAAcAQ"
        "MAAQAAAAEAAAAAAAAACAAAABwAAAAwAAAARAAAAFgAAABsAAAAFAAAABQAAAAUAAAA"
        "FAAAABQAAAAPAAAA",
        ((23, 37, 3), "24750541ef26255117137fb01a73e721"
                      "a26f3ad15e387b1111269b3734f75037")),
    "random:3_1": (
        "SUkqAHsAAAAaQoquKFnP0ulw9uZuB2BlewFPWP9s1xhoTBaCkAh+vNIZ6Gv7ZRqQe2"
        "APlaBZj7wIUFwPockwFQJ2inhn2+6xKO+tcF2IeJ4EyrAiXgnTGHVZPf+AhexvsWBA"
        "65DayJCLOa/oSnwX64jWyP8KEP4AkhVwDAAAAQQAAQAAACUAAAABAQQAAQAAABcAAA"
        "ACAQMAAQAAAAEAAAADAQMAAQAAAAMAAAAGAQMAAQAAAAAAAAAKAQMAAQAAAAEAAAAR"
        "AQQABgAAABEBAAAVAQMAAQAAAAEAAAAWAQQAAQAAAAQAAAAXAQQABgAAACkBAAAcAQ"
        "MAAQAAAAEAAAAkAQQAAQAAAAAAAAAAAAAACAAAABwAAAAwAAAARAAAAFgAAABsAAAA"
        "FAAAABQAAAAUAAAAFAAAABQAAAAPAAAA",
        ((23, 37, 3), "0ca85e1fb30cf783568d7b0ae55d4f5f"
                      "7082ca9dee85e5922ce6389b5e6c35ae")),
    "random:3_2d": (
        "SUkqAHsAAADd5QiteINsaXQoex/KAQiJfyMYEHv5IBGoh1Ns3zCxyvkHuKmDRq9oeL"
        "Z1rRDvIF924Gr04DoQVvYX15jbg0Tk+FpHcS/gKtHRELCHix8CELJuTBUwtuFHOOBB"
        "mgRsoNHkjxFYFK0DGYCMGHYaSM1HtEqADAAAAQQAAQAAACUAAAABAQQAAQAAABcAAA"
        "ACAQMAAQAAAAEAAAADAQMAAQAAAAMAAAAGAQMAAQAAAAAAAAAKAQMAAQAAAAEAAAAR"
        "AQQABgAAABEBAAAVAQMAAQAAAAEAAAAWAQQAAQAAAAQAAAAXAQQABgAAACkBAAAcAQ"
        "MAAQAAAAEAAAAkAQQAAQAAAAEAAAAAAAAACAAAABwAAAAwAAAARAAAAFgAAABsAAAA"
        "FAAAABQAAAAUAAAAFAAAABQAAAAPAAAA",
        ((23, 37, 3), "6e8852aa1c508fe5087c06874f3db6c4"
                      "bed57690a72692169aed0dfc519ac295")),
    "random:4_2": (
        "SUkqAHsAAABD0gcp8K1exjbYfukSSIB0QWcE4OqrFpfobqapEHiqHS7x0CKomuIwxh"
        "wH/hgYkKbqsMJEcxGIAUa5szCCXomamPobeyugzhoMKjjg5pVDQD11PT9ALRoHkjgF"
        "UWrxUCC7xIyIGfrDm1gAFGw90MwOpMfACwAAAQQAAQAAACUAAAABAQQAAQAAABcAAA"
        "ACAQMAAQAAAAEAAAADAQMAAQAAAAQAAAAGAQMAAQAAAAAAAAAKAQMAAQAAAAIAAAAR"
        "AQQABgAAAAUBAAAVAQMAAQAAAAEAAAAWAQQAAQAAAAQAAAAXAQQABgAAAB0BAAAcAQ"
        "MAAQAAAAEAAAAAAAAACAAAABwAAAAwAAAARAAAAFgAAABsAAAAFAAAABQAAAAUAAAA"
        "FAAAABQAAAAPAAAA",
        ((23, 37, 3), "5019b29050d1dc34663e3fb66e3bcb62"
                      "e4d3c9f754483e0ec8fd21a66ea28fbf")),
    "random:32771_1": (
        "SUkqAHsAAAC3Dp8C+Oqr+hpYp6GRtKiKVS4qAPscVyDQfUyTXyhWbdSYMHBKb4qI07"
        "3rgSCJ/P9AuFSxyiEIoJyovVhDKN4NGLMyCZwoeg6VFNiph5lCuBazRUq4ZUhHWzjo"
        "3H8fSGOhqMWI6hohafirABKtINrSpeMACwAAAQQAAQAAACUAAAABAQQAAQAAABcAAA"
        "ACAQMAAQAAAAEAAAADAQMAAQAAAAOAAAAGAQMAAQAAAAAAAAAKAQMAAQAAAAEAAAAR"
        "AQQABgAAAAUBAAAVAQMAAQAAAAEAAAAWAQQAAQAAAAQAAAAXAQQABgAAAB0BAAAcAQ"
        "MAAQAAAAEAAAAAAAAACAAAABwAAAAwAAAARAAAAFgAAABsAAAAFAAAABQAAAAUAAAA"
        "FAAAABQAAAAPAAAA",
        ((23, 37, 3), "428f61f606dea6cd2cd1e874aff82c5e"
                      "14e18dd2c47ef59dc227e26b3d6ee0b7")),
    "zero:jpeg2000_ycbcr": (
        "SUkqAAEKAAAm1KdcFrNZ3FakLowSwxe3wnfMkt2/6BAApbm80GbWgSo6yabc+MdMjn"
        "ZC5PqNM2tvq+4HDycG31MoDQff7R7AzfrxwursQFiawYwqG9Jzu0owzS/eKyHRG6rF"
        "RyGnv6/PsFz+mtgXbrcMtDpdE9/I8csaNmLy/lLad7+U6f905QQkC+TPNHzNmaswJl"
        "8N1e1aAeol+vkRsuaQ6XRfkjR2bhB4OrhQPX8rZD+4Os33xOt1OGQyBVRaOMlcWUxJ"
        "LykpohWAMguNPW4TeSfcQWkTXv1FogceTYZRZaox0mllkQwZ9PQDf8ETf69w8poEKa"
        "4+1n5ynBMPwaFVb01lxf4Bmz/Q6LQochI4F3yF/V+vgwHqQT1+xDiUY6DPB3wM1iYJ"
        "ccBdeUwy3V6RHlbem+jegzG0Znc2JYMDIQFX3/5t68wDNFkX0GLW1lAOqBrDomdqHf"
        "PJFbwZjzLH9/0BOAoB+J8vMHLexMLUeCzIjPFsuQdEv3WYFCqgS1TiI3w8TFAKz00E"
        "eyreQyjUCBxd/I/IOWr8nxiu9slWPi/h+LeeGegDKaTK0dWr785OAIftxF6GaTvJfJ"
        "GpcCsX2+nklesGjoZ/q5R3apulL/r/vn2uDEBAeNnOvLeO5UHcumnRVBxeEg3BcKNz"
        "wKIv+OaHcz/FTTixX9ldX2kD3iWPxcw6oELFJXz0BzeDaR/7BNHYF47BjpGRuHM6P3"
        "B2n4PItaVq0kE2opGyGS7k6v/JdklK3JS39j4jNK/6IN1zFCEnNfLPq8udbQ/XuNqJ"
        "ma7wwtymSKdi7Yi7zHOX2Cm6cJmTXANdKPBFqZGl+Hsqulj5HC2Ghrio8jtmWYcqNx"
        "ywho9lTMkzrYnLtWVl/zigz1NT4aywGO/1TWLrPWRuFlEGAHeJnPtBiiKvMTovqAxJ"
        "Jc4h52eLlE+cdlqiVQ5DktUz07R0oJLtTl6aw+Xw7cyZM0vEyBk7pD46Xt2Le4Z6g1"
        "iRDgOG4f/3ZQBVNrF1ANMiJiGIyHsfwmODk1mRYh29Y2mC6ACi004HfesUodNQ1OZS"
        "glHFWg9tpcNWnY3fxIeMxp7CTDXRIoc+DW6pBuIjB6D0ZBeCVI13e2Ig2O677Qs7dG"
        "/xjqS1j5T9yZi0Ki8mR59+/lWuZL1VafCiRx6R+2TQMQedNRJ+wuBWpq+wFspQZ9Wr"
        "LZ2/Vm2gvwwv6+SnYjgppebkpFlskPbwIXl7JqqFoZ70DCp8shMidz7s3CU75ymHAP"
        "l+BdFMNu0FyUtpMncJfwc1euxkAzPms8bUgZVaE/LkOL/fXUq0QkDRKQ3omN/HU87B"
        "ixaaUwLBqTQMCW2kpd/lpzX/3CfjSC2u4lq7zEFJPNqvQyl8SW7t11CufFjJtoAMxa"
        "nH6Ja9gLkiHHhDuPavHfdCJrinbET0Dr1UzGNiCe0g1dPLE/Qf4SRi4NbgjpQSdy2H"
        "w3ypHwFpZYjlD7nHW5bnqYBo6OOFpg/VX+O+7F9gvPA4WuHrki5JM6t0/E6atQvxCL"
        "Zq8gNR9qxOi77aLQd7ypT78L2wbG9KAZMZu0/9HBnyMIlPLhPtZrI8hhXRFcWCZGqT"
        "KzKujw1R4fA9cMExqbLi3KNAnwaEgZ8XLMHN3UxHb/fPvBtFcFJUJEFBEfXUb1O/jB"
        "tpyC0Wu1CDvFLrn05+HwTyCyqwAdMwq6anXZff28r2lCpYe7Yc5TZ08OSSutvTDzzR"
        "iYl+gkZ55tSmOcwghHutMIFQ6eKuBnorxHfKLN3Lo++ncNtl5EVZkuGe3oXXb+vkgo"
        "q5QC99nHsiAkcrHbtYZdt4a3bkAmA2CKHc0I/URBFadKQCwlNycXAA/b/zRrUXF6vK"
        "IaApEb2js9Wl20KBGewH2Vl9CXP1afv30r959CxuluZuVP/D6saJSgELs9rMZJcNK2"
        "GDITkOOLKB5zW/yUum4DWjeVJNKLXne+GJQn5TyNTtAlqyPKqgddWrEWR22iEdS+/M"
        "tF9JVyD7WKjtugTTh8GCHugA4kzF+VQqQxVcb/SI6w9Zv/46RhJUNQYXlSCagSUVMg"
        "4Kvw8npnmWsdbLAIkOVOB9RX2eRmdr20L4fRo3Igqpc1RsUAFGmVsFKYQlX29G5U0c"
        "ip9LtvrK9kRYLQDGYUjUB1fN/XTb4egiF1AR8NqnfEdY254Su11EtBtXxVhLwNv8L7"
        "JQiMVGMhz4iAJJKDX+qMEcSRqDp9YQMf+ZVkZr5x3LwvnFnXSm19L7RGCopLUBnfSZ"
        "3KtEX2eFKf3C0XITT/HNjEdiWPuPgfcrGU9eCs/dFaIrE/QeA3wpnrXBllzm5YGJzy"
        "x0i2nwRGF/ej/o36PXLkGfAs6Zzbq1MKe9UFUe3MzdSg3AAmGacOpLGek0SMbtU2Qk"
        "QY5mJ0tpR7ynfeC+7OS3kSvyRQ2sC6+sDsQTKiNSjqr3Yt3oqrsLql9S3YvvlE4ylq"
        "aKLgvV8puOQOIIKbD1t0PDkxWZIdjOcWMHq7soxdda0+QLHsmYfvyguR/eRPCNK4tS"
        "c2tIkrcLKKfmlVGMfTOCnnTkurG3uz57nHBALixU+c3SF5oVPxnf634oYAjUwtHzz6"
        "e+asxXIGFRlzRqx+n6OCR9a2g6rK4KJZD4GIw8LbAHgCEDLWasJ3fskBIasd2OVJiW"
        "boUqMd4gURVXTqkT5WvTTf5yFncNOw9CGKHGo4d95ihbrif6cwTkwxiAR3Q/zafDNC"
        "K4gllkLFb3C3fzrhZ0LBCaUK+C3RRViE10QzmyijMHfim6yFA8vt/aLZ717CnqUB8Q"
        "YHizOjHbPVSik40ElDi0dG5ZLq4wud7z+RPNGNys72MfKE80w92GP2oNZBmTpNGeaD"
        "1F4X0h5FysTuH+aBHQ0GotJtbL2PuGoG2lOMgn6lvP6hp6sFQrx6VTNvGUpOZN7pih"
        "LnwwL2KqR+efvMsoHg7npemFE2vx39s2RNUO4HT/3OAyiQ+BDr9+PzAIZeonftjnlU"
        "hmHC4iSlDk7+MtxQZWlQunvihbuHMsLlKs31rlBGAddOYGo9e3TkloCHqqLrNE+BG0"
        "ZOYLRYJUE0OazxmuVw2oZTxWkkculMSdxsmbYwAhiI+xcFjJLyej71CX8TWuY7qxC7"
        "2IT7AYsmeE+hbZZ94Srd/7WxMKEZunEPXSUIEGR4ECXRfD3BlnzVBJLzJ+AgTV3hzH"
        "1jgRrqx30NIC8TDcIc1P+Fk9s6UBQsnKEzY6/dUsDUBIfkcO9EWQmwI/ydAnGGAX1r"
        "NtcOsCMLHZ4rYJzfzi50/GqsIwlwi59q4sEAgapBZWLpjkBlqPOMsupr2xbhTCGEfU"
        "YvVt2XJ+IIOip2id8C/qMI0qp8a/jPOuB0BMYtbX9BJ7J6X/uYuaqSyVxGFs7McSAd"
        "ikn/BflVzXpW3HgXElDYesRiqNYKibTFJtsS4bHuuL4IRP/nQKAAABBAABAAAAJQAA"
        "AAEBBAABAAAAFwAAAAIBAwADAAAAfwoAAAMBAwABAAAAmIcAAAYBAwABAAAABgAAAB"
        "EBBAABAAAACAAAABUBAwABAAAAAwAAABYBBAABAAAAFwAAABcBBAABAAAA+QkAABwB"
        "AwABAAAAAQAAAAAAAAAIAAgACAA=",
        ((23, 37, 3), "fa1973742e3f2c6a30c819bdd358ee6f"
                      "14c06335ed0d2aa1d4e42082784cdc05")),
    "zero:c65000_palette": (
        "SUkqAL0BAAAtpRtdWigcG8fJ2+EKu9bYI8rQ/Eh074NmrgAg1SAN4cz/zuRZwIIde0"
        "PC0i0axCq6y1+dFrCzUdDPwTb/XXue9+Ag7DfJoyUN5Q4g/xvp51k3YXO1NyY7PPzn"
        "NjBVMMVUQiKhgwg2Fy1GFfSgFIVqPWBpAf8HwXp/kCo9d5EMpWRs8JPQ6ycTF49agO"
        "Q3w5asBw0gfFdD0FkV2e2DtnMoAgXfbsA1HW3VChDKZh/BsYPP8DAPkjfczXLI9rBA"
        "t5EqReJzRQxActQtAV+MNvka8MUy77keAqzdrsQI7Fhjx5pyHeDp4Ih6l2mi/7egRH"
        "3LuOTbbVFQEMenyi/oc8Q7XVVg0ozDpMJ/ADhh8N0YyJm3M3eYy6bUOpsS7vDHRNm/"
        "Mjry1xIj/KyWDb2Jr82gSm6Lx50reZUFL0qa9ytfEoi68DZYIxuIZMOoy2bzrFXqse"
        "9G42BhUAeJ9IKjMqBCwuaJSXWlBJ0w23qeRZzv7JNMwTozXYeHhZAI4P9gU7cNIijH"
        "HGiVlhtmjgrUB+Aa1d5YXFBqxZjciMnEPSgwag4gCvYYWHdi3r4DdvirifybIiSX8A"
        "sAAAEEAAEAAAAlAAAAAQEEAAEAAAAXAAAAAgEDAAEAAAAEAAAAAwEDAAEAAADo/QAA"
        "BgEDAAEAAAADAAAAEQEEAAEAAAAIAAAAFQEDAAEAAAABAAAAFgEEAAEAAAAXAAAAFw"
        "EEAAEAAAC1AQAAHAEDAAEAAAABAAAAQAEDADAAAABHAgAAAAAAAE1Vha6qZP+9SVVj"
        "afDwhKILR28e05Eb+6FkJ9CHMacHHZ22NeESf37qwtHg1FazpnWvI7BcFhPKQ1CSZ+"
        "/VRas3LSqdp794Vi1t3KAtv0YMjC+b67/kgKcbYtI4xiknpQ==",
        ((23, 37, 3), "96ebbfbb2c80db519e644bb070cf2246"
                      "49223f686f8811a81aefcb9b48b4cfa4")),
}


if __name__ == "__main__":
    sys.exit(_print_fixtures())

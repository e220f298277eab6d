"""The port's readers of the lossless formats (PNG, BMP, TIFF:
`efficientteacher_torch/data/image_io.py`, `data/tiff_io.py`, `csrc/
raster_decode.h`) and its `.bmp` / `.tif` writers, against cv2.imread and
cv2.imwrite (cv2 5.0.0), and its datasets and LoadImages on a mixed-format
split against the JAX package's (which read through cv2).

Tolerance: exact everywhere. Every kind (`KINDS`: one case each) is
written by this module's own writers (PNG of every depth, colour type,
filter and Adam7; BMP of every header, depth, bit field and RLE escape;
TIFF of every compression, predictor, layout, photometric, depth and byte
order; Pillow and cv2 write some more), read by the port and by
`cv2.imread(p)[..., ::-1]`, and the two are equal, as are `image_size` and
cv2's shape. A file cv2 cannot read either raises OSError in the port,
which the datasets drop as JAX's do: a non-square TIFF of Orientation 5-8
among them (ROADMAP F9, closed), pinned by its own test.

`FIXTURES` are small files of these kinds (base64) with the SHA-256 of
cv2.imread's RGB output: the oracle on the card's machine, where the port
uses neither cv2 nor Pillow, though both import there (PERF.md, PR 14's
`[data]` line; `check_fixtures`, called by chip_smoke.py and
tests/test_torch_cuda.py). Regenerate them with `python
tests/test_torch_image_formats.py` (it prints the dict). This module
imports no JAX, cv2 or Pillow at import time: the tests that compare
against them import them.
"""

import base64
import hashlib
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from efficientteacher_torch.data import image_io, tiff_io
from efficientteacher_torch.data import datasets as port_ds
from efficientteacher_torch.utils import native_loader as nl

SIZES = [(23, 37), (41, 64)]   # (h, w): odd sizes, partial tiles and bytes


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread for the module, as tests/torch_port_
    helpers.one_torch_thread sets it (that module imports JAX, which the
    card's machine, where check_fixtures runs, does not have)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rgb_digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _cv2():
    return pytest.importorskip("cv2")


def _cv2_read(path):
    img = _cv2().imread(str(path))
    return None if img is None else np.ascontiguousarray(img[..., ::-1])


# -- PNG ------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack(values: np.ndarray, bits: int) -> np.ndarray:
    """(h, n) sample values -> (h, bytes) rows, MSB first; 16 bits
    big-endian."""
    v = np.asarray(values, np.uint32)
    if bits == 16:
        return v.astype(">u2").view(np.uint8).reshape(v.shape[0], -1)
    if bits == 8:
        return v.astype(np.uint8)
    per = 8 // bits
    n = -(-v.shape[1] // per) * per
    padded = np.zeros((v.shape[0], n), np.uint32)
    padded[:, :v.shape[1]] = v
    shifts = (8 - bits * (np.arange(per) + 1)).astype(np.uint32)
    return (padded.reshape(v.shape[0], -1, per) << shifts).sum(2).astype(
        np.uint8)


def _filter_rows(raw: np.ndarray, bpp: int) -> bytes:
    """PNG-filter each row of `raw` (h, row bytes), cycling through the
    five filter types."""
    out = []
    prev = np.zeros(raw.shape[1], np.int32)
    for y, row in enumerate(raw.astype(np.int32)):
        t = y % 5
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        if t == 0:
            f = row
        elif t == 1:
            f = row - a
        elif t == 2:
            f = row - b
        elif t == 3:
            f = row - (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            f = row - np.where((pa <= pb) & (pa <= pc), a,
                               np.where(pb <= pc, b, c))
        out.append(bytes([t]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


def png_bytes(samples: np.ndarray, depth: int, ctype: int,
              interlace: bool = False, plte=None, before=(), after=()):
    """A PNG of `samples` (h, w, spp) values: colour type `ctype`, bit
    depth `depth`, Adam7 when `interlace` (each pass filtered on its own);
    `before` / `after` are (kind, body) chunks before / after the IDAT."""
    h, w, spp = samples.shape
    bpp = max(1, depth * spp // 8)
    passes = ADAM7 if interlace else [(0, 0, 1, 1)]
    stream = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub.reshape(sub.shape[0], -1), depth)
        stream += _filter_rows(rows, bpp)
    body = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                        int(interlace)))]
    if plte is not None:
        body.append(_chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes()))
    body += [_chunk(k, v) for k, v in before]
    body.append(_chunk(b"IDAT", zlib.compress(stream, 6)))
    body += [_chunk(k, v) for k, v in after]
    body.append(_chunk(b"IEND", b""))
    return b"\x89PNG\r\n\x1a\n" + b"".join(body)


def exif_block(orientation: int, little_endian: bool = True) -> bytes:
    bo = "<" if little_endian else ">"
    return ((b"II" if little_endian else b"MM")
            + struct.pack(bo + "HIH", 42, 8, 1)
            + struct.pack(bo + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(bo + "I", 0))


def _png_kind(rng, h, w, name):
    """name: png_<what>; returns the file's bytes."""
    spec = name.split("_")[1:]
    what, depth = spec[0], int(spec[1]) if len(spec) > 1 and \
        spec[1].isdigit() else 8
    interlace = "adam7" in spec
    top = (1 << depth) - 1
    before, after, plte = [], [], None
    ctype = {"grey": 0, "rgb": 2, "pal": 3, "greyalpha": 4, "rgba": 6}.get(
        what, 2)
    if what == "trns":   # tRNS on palette, grey and RGB: alpha is dropped
        ctype = {"pal": 3, "grey": 0, "rgb": 2}[spec[1]]
        depth, top = 8, 255
    spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    if ctype == 3:
        n = 1 << depth
        samples = rng.integers(0, n, (h, w, 1))
        plte = rng.integers(0, 256, (n, 3))
        if "short" in spec:   # indices past the PLTE's entries
            plte = plte[:max(1, n // 2)]
    else:
        samples = rng.integers(0, top + 1, (h, w, spp))
    if what == "trns":
        if ctype == 3:
            trns = bytes(rng.integers(0, 256, 16).astype(np.uint8))
        else:   # the colour of the first pixel is the transparent one
            trns = struct.pack(f">{spp}H", *map(int, samples[0, 0]))
        before.append((b"tRNS", trns))
    if what == "ancillary":
        before += [(b"gAMA", struct.pack(">I", 45455)),
                   (b"sBIT", bytes([5, 6, 5])),
                   (b"bKGD", struct.pack(">HHH", 10, 20, 30)),
                   (b"iCCP", b"x\0\0" + zlib.compress(b"\0" * 128)),
                   (b"tEXt", b"Comment\0ancillary chunks")]
    if what == "exif":
        block = exif_block(int(spec[1]), little_endian=spec[-1] != "mm")
        (after if "after" in spec else before).append((b"eXIf", block))
        depth = 8
    return png_bytes(samples, depth, ctype, interlace, plte, before, after)


PNG_KINDS = [
    "png_grey_1", "png_grey_2", "png_grey_4", "png_grey_8", "png_grey_16",
    "png_pal_1", "png_pal_2", "png_pal_4", "png_pal_8", "png_pal_4_short",
    "png_greyalpha_8", "png_greyalpha_16", "png_rgb_8", "png_rgb_16",
    "png_rgba_8", "png_rgba_16",
    "png_grey_1_adam7", "png_grey_16_adam7", "png_pal_4_adam7",
    "png_rgb_8_adam7", "png_rgba_16_adam7", "png_greyalpha_8_adam7",
    "png_trns_pal", "png_trns_grey", "png_trns_rgb", "png_ancillary",
    "png_exif_6", "png_exif_3_mm", "png_exif_8", "png_exif_5_after",
]


# -- BMP ------------------------------------------------------------------

def rle_stream(idx: np.ndarray, bits: int, variant: str) -> bytes:
    """BI_RLE8 (bits 8) / BI_RLE4 (bits 4) of the index rows `idx` (file
    order): runs where a row repeats, absolute runs elsewhere, with
    end-of-line after each row; `variant` adds escapes: "delta" skips
    pixels with a delta, "eob" ends the bitmap after half the rows,
    "no_eol" leaves out the end-of-line after a row a run completes."""
    out = bytearray()
    h, w = idx.shape
    for y in range(h):
        row = [int(v) for v in idx[y]]
        x = 0
        ended = False
        while x < w:
            if variant == "delta" and y % 3 == 1 and x == 2 and w > 8:
                out += bytes([0, 2, 3, 1 if y + 1 < h - 1 else 0])
                if y + 1 < h - 1:
                    ended = True  # the delta moved to the next row
                    break
                x += 3
                continue
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or w - x < 3:
                n = min(run, w - x)
                code = row[x] if bits == 8 else (row[x] << 4) | row[x]
                out += bytes([n, code])
                x += n
                continue
            n = 3
            while x + n < w and n < 255 and not (
                    x + n + 2 < w and row[x + n] == row[x + n + 1]
                    == row[x + n + 2]):
                n += 1
            vals = row[x:x + n]
            if bits == 8:
                body = bytes(vals)
            else:
                vals = vals + [0] * (len(vals) & 1)
                body = bytes((vals[i] << 4) | vals[i + 1]
                             for i in range(0, len(vals), 2))
            out += bytes([0, n]) + body + b"\0" * (len(body) & 1)
            x += n
        if variant == "eob" and y == h // 2:
            out += b"\0\1"
            return bytes(out)
        if ended:
            continue
        if not (variant == "no_eol" and bits == 8 and y % 2 == 0):
            out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp_bytes(pixels: bytes, w: int, h: int, bpp: int, header: int = 40,
              compression: int = 0, palette=None, masks=None,
              clrused: int = 0, masks_after: bool = False) -> bytes:
    """A BMP: `pixels` as stored; h < 0 is top-down; `palette` (n, 3) RGB,
    written BGR0 (BGR for the 12-byte OS/2 header); `masks` (r, g, b)
    inside a v2+ header, and after the header with `masks_after` (where a
    40-byte BI_BITFIELDS header keeps them)."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, h, 1, bpp, compression,
                           len(pixels), 2835, 2835, clrused, 0)
        if header >= 52:
            r, g, b = masks or (0, 0, 0)
            info += struct.pack("<III", r, g, b)
        if header >= 56:
            info += struct.pack("<I", 0xFF000000 if bpp == 32 else 0)
        info = info.ljust(header, b"\0")
        if header >= 108:   # LCS_sRGB
            info = info[:56] + b"BGRs" + info[60:]
    table = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            pal = np.concatenate([pal, np.zeros((len(pal), 1), np.uint8)], 1)
        table = pal.tobytes()
    if masks_after:
        table += struct.pack("<III", *masks)
    offset = 14 + len(info) + len(table)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + info + table + pixels)


def _rows(data: np.ndarray, pitch_bits: int) -> bytes:
    """Rows of bytes padded to 4 bytes."""
    pitch = ((pitch_bits + 7) // 8 + 3) & ~3
    out = np.zeros((data.shape[0], pitch), np.uint8)
    out[:, :data.shape[1]] = data
    return out.tobytes()


def _bmp_kind(rng, h, w, name):
    spec = name.split("_")[1:]
    header = int(spec[0])
    what = spec[1]
    topdown = "topdown" in spec
    order = (lambda a: a) if topdown else (lambda a: a[::-1])
    hh = -h if topdown else h
    if what in ("1", "4", "8", "grey"):
        bits = 8 if what == "grey" else int(what)
        n = 1 << bits
        pal = rng.integers(0, 256, (n, 3))
        if what == "grey":
            pal = np.repeat(np.arange(256)[:, None], 3, 1)
        clrused = 0
        if "short" in spec:   # fewer entries than indices: the rest black
            clrused = n // 2
            pal = pal[:clrused]
        idx = rng.integers(0, n, (h, w))
        rows = _rows(_pack(order(idx), bits), w * bits)
        return bmp_bytes(rows, w, hh, bits, header, 0, pal, clrused=clrused)
    if what.startswith("rle"):
        bits = int(what[3:])
        n = 1 << bits
        pal = rng.integers(0, 256, (n, 3))
        # rows of runs and noise, so both modes occur
        idx = np.repeat(rng.integers(0, n, (h, (w + 4) // 5)), 5, 1)[:, :w]
        idx[::2, w // 3:w // 3 + 4] = rng.integers(0, n, (len(idx[::2]), 4))[
            :, :len(idx[0, w // 3:w // 3 + 4])]
        stream = rle_stream(idx[::-1], bits, spec[2] if len(spec) > 2 else "")
        return bmp_bytes(stream, w, h, bits, header, 1 if bits == 8 else 2,
                         pal)
    if what in ("555", "565"):
        masks = ((0x7C00, 0x3E0, 0x1F) if what == "555"
                 else (0xF800, 0x7E0, 0x1F))
        words = rng.integers(0, 1 << 16, (h, w)).astype("<u2")
        rows = _rows(order(words).view(np.uint8).reshape(h, -1), w * 16)
        bf = "bf" in spec
        return bmp_bytes(rows, w, hh, 16, header, 3 if bf else 0,
                         masks=masks, masks_after=bf)
    bpp = int(what)   # 24, 32
    px = rng.integers(0, 256, (h, w, bpp // 8), np.uint8)
    rows = _rows(order(px).reshape(h, -1), w * bpp)
    if "bf" in spec:
        masks = (0xFF0000, 0xFF00, 0xFF)
        return bmp_bytes(rows, w, hh, 32, header, 3, masks=masks,
                         masks_after=header == 40)
    return bmp_bytes(rows, w, hh, bpp, header)


BMP_KINDS = [
    "bmp_12_1", "bmp_12_4", "bmp_12_8", "bmp_12_24",
    "bmp_40_1", "bmp_40_4", "bmp_40_8", "bmp_40_grey", "bmp_40_8_short",
    "bmp_40_555", "bmp_40_555_bf", "bmp_40_565_bf", "bmp_40_24",
    "bmp_40_32", "bmp_40_32_bf", "bmp_52_24", "bmp_56_32_bf", "bmp_108_8",
    "bmp_108_32_bf", "bmp_124_24", "bmp_124_4", "bmp_124_565_bf",
    "bmp_40_24_topdown", "bmp_40_8_topdown", "bmp_124_32_topdown",
    "bmp_40_rle8", "bmp_40_rle8_delta", "bmp_40_rle8_eob",
    "bmp_40_rle8_no_eol", "bmp_40_rle4", "bmp_40_rle4_delta",
]


# -- TIFF -----------------------------------------------------------------

def _packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 128 and \
                data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out += bytes([(257 - run) & 0xFF, data[i]])
            i += run
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and not (
                j + 1 < len(data) and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_bytes(samples: np.ndarray, bits: int = 8, photometric: int = 2,
               compression: int = 1, predictor: int = 1, planar: int = 1,
               rows_per_strip: int = 0, tile=None, big_endian: bool = False,
               extras=None, colormap=None, orientation: int = 0,
               bigtiff: bool = False, tags=()) -> bytes:
    """A TIFF of `samples` (h, w, spp) values of `bits` bits. Strips of
    `rows_per_strip` rows (0: one strip) or tiles (tw, th); planes with
    `planar` 2; `extras` the ExtraSamples values; `colormap` (3 * 2^bits)
    16-bit entries; `tags` more (tag, type, values)."""
    bo = ">" if big_endian else "<"
    h, w, spp = samples.shape
    planes = [samples] if planar == 1 else [samples[..., k:k + 1]
                                             for k in range(spp)]
    if tile:
        cw, ch = tile
    else:
        cw, ch = w, rows_per_strip or h
    chunks = []
    for plane in planes:
        for y in range(0, h, ch):
            for x in range(0, w, cw):
                part = plane[y:y + ch, x:x + cw]
                if tile:   # tiles are whole: pad past the image
                    full = np.zeros((ch, cw, plane.shape[2]), part.dtype)
                    full[:part.shape[0], :part.shape[1]] = part
                    part = full
                v = part.reshape(part.shape[0], -1).astype(np.int64)
                if predictor == 2:
                    n = plane.shape[2]
                    v[:, n:] = v[:, n:] - v[:, :-n]
                    v &= (1 << bits) - 1
                if bits == 16:
                    raw = v.astype(bo + "u2").tobytes()
                else:
                    raw = _pack(v, bits).tobytes()
                if compression == 5:
                    raw = nl.lzw_encode(raw)
                elif compression in (8, 32946):
                    raw = zlib.compress(raw)
                elif compression == 32773:
                    raw = _packbits(raw)
                chunks.append(raw)
    extra_tags = []
    if predictor != 1:
        extra_tags.append((317, 3, [predictor]))
    if extras is not None:
        extra_tags.append((338, 3, list(extras)))
    if colormap is not None:
        extra_tags.append((320, 3, list(colormap)))
    if orientation:
        extra_tags.append((274, 3, [orientation]))
    return tiff_file(samples.shape, chunks, bits, photometric, compression,
                     planar, 0 if tile else ch, tile, big_endian, bigtiff,
                     extra_tags + list(tags))


def tiff_file(shape, chunks, bits: int = 8, photometric: int = 2,
              compression: int = 1, planar: int = 1, rows_per_strip: int = 0,
              tile=None, big_endian: bool = False, bigtiff: bool = False,
              tags=()) -> bytes:
    """A TIFF of `shape` (h, w, spp) whose strips (of `rows_per_strip`
    rows, 0: one strip) or tiles (tw, th) are the byte strings `chunks`;
    `tags` more (tag, type, values; a RATIONAL's values in pairs)."""
    bo = ">" if big_endian else "<"
    h, w, spp = shape
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
               (259, 3, [compression]), (262, 3, [photometric]),
               (277, 3, [spp]), (284, 3, [planar])]
    if tile:
        entries += [(322, 4, [tile[0]]), (323, 4, [tile[1]]), (324, 4, None),
                    (325, 4, [len(c) for c in chunks])]
    else:
        entries += [(278, 4, [rows_per_strip or h]), (273, 4, None),
                    (279, 4, [len(c) for c in chunks])]
    entries += list(tags)
    head = 16 if bigtiff else 8
    data = b"".join(chunks)
    offsets, at = [], head
    for c in chunks:
        offsets.append(at)
        at += len(c)
    entries = sorted((t, ty, offsets if v is None else v)
                     for t, ty, v in entries)
    ifd_at = head + len(data)
    esize, inline = (20, 8) if bigtiff else (12, 4)
    extra_at = ifd_at + (8 if bigtiff else 2) + esize * len(entries) + \
        (8 if bigtiff else 4)
    fmt = {1: "B", 3: "H", 4: "I", 5: "I", 7: "B", 11: "f", 12: "d",
           16: "Q"}
    ifd, extra = b"", b""
    for tag, typ, vals in entries:
        body = struct.pack(f"{bo}{len(vals)}{fmt[typ]}", *vals)
        cnt = struct.pack(bo + ("Q" if bigtiff else "I"),
                          len(vals) // 2 if typ == 5 else len(vals))
        if len(body) <= inline:
            ifd += struct.pack(bo + "HH", tag, typ) + cnt + body.ljust(
                inline, b"\0")
        else:
            ifd += struct.pack(bo + "HH", tag, typ) + cnt + struct.pack(
                bo + ("Q" if bigtiff else "I"), extra_at + len(extra))
            extra += body
    if bigtiff:
        start = (b"MM" if big_endian else b"II") + struct.pack(
            bo + "HHHQ", 43, 8, 0, ifd_at)
        count, end = struct.pack(bo + "Q", len(entries)), b"\0" * 8
    else:
        start = (b"MM" if big_endian else b"II") + struct.pack(
            bo + "HI", 42, ifd_at)
        count, end = struct.pack(bo + "H", len(entries)), b"\0" * 4
    return start + data + count + ifd + end + extra


def _tiff_kind(rng, h, w, name):
    spec = name.split("_")[1:]
    kw = {}
    comp = {"none": 1, "lzw": 5, "deflate": 8, "adobe": 32946,
            "packbits": 32773}
    for s in spec:
        if s in comp:
            kw["compression"] = comp[s]
        elif s == "pred":
            kw["predictor"] = 2
        elif s == "planar":
            kw["planar"] = 2
        elif s == "strips":
            kw["rows_per_strip"] = 5
        elif s == "tiles":
            kw["tile"] = (16, 32)
        elif s == "mm":
            kw["big_endian"] = True
        elif s == "big":
            kw["bigtiff"] = True
        elif s.startswith("orient"):
            kw["orientation"] = int(s[6:])
    what, bits = spec[0], int(spec[1])
    top = (1 << bits) - 1
    dtype = np.uint16 if bits == 16 else np.uint8
    if what in ("black", "white"):
        kw["photometric"] = 1 if what == "black" else 0
        spp = 2 if "alpha" in spec else 1
        if spp == 2:
            kw["extras"] = [{"assoc": 1, "unassoc": 2}.get(spec[-1], 0)]
    elif what == "pal":
        kw["photometric"] = 3
        spp = 1
        n = 1 << bits
        cmap = rng.integers(0, 65536, 3 * n)
        if "byte" in spec:   # every entry below 256: taken as it is
            cmap = rng.integers(0, 256, 3 * n)
        kw["colormap"] = cmap
    else:   # rgb, rgba
        kw["photometric"] = 2
        spp = 4 if what == "rgba" else 3
        alpha = spec[-1] if spp == 4 else None
        if alpha in ("assoc", "unassoc", "unspec"):
            kw["extras"] = [{"assoc": 1, "unassoc": 2, "unspec": 0}[alpha]]
    samples = rng.integers(0, top + 1, (h, w, spp)).astype(dtype)
    return tiff_bytes(samples, bits, **kw)


TIFF_KINDS = [
    "tif_rgb_8_none", "tif_rgb_8_lzw", "tif_rgb_8_deflate",
    "tif_rgb_8_adobe", "tif_rgb_8_packbits", "tif_rgb_8_lzw_pred",
    "tif_rgb_8_deflate_pred_strips", "tif_rgb_16_lzw_pred",
    "tif_rgb_16_none_mm", "tif_rgb_16_deflate_pred_mm",
    "tif_rgb_8_lzw_tiles", "tif_rgb_16_packbits_tiles_pred",
    "tif_rgb_8_none_planar", "tif_rgb_16_lzw_planar_pred",
    "tif_rgb_8_lzw_planar_tiles", "tif_rgb_8_none_big",
    "tif_rgb_8_lzw_mm_big",
    "tif_rgb_8_none_pred", "tif_rgb_16_packbits_pred",
    "tif_black_1_none", "tif_black_1_packbits_strips",
    "tif_black_8_lzw_pred", "tif_black_16_deflate_pred",
    "tif_black_16_none_mm", "tif_white_1_none", "tif_white_1_lzw_tiles",
    "tif_white_8_none", "tif_white_16_lzw",
    "tif_black_8_none_alpha_unassoc", "tif_black_16_none_alpha_unassoc",
    "tif_black_8_none_planar_alpha_assoc",
    "tif_black_8_none_planar_alpha_unassoc",
    "tif_black_16_lzw_planar_alpha_unassoc",
    "tif_white_8_none_planar_alpha_assoc",
    "tif_pal_1_none", "tif_pal_4_lzw", "tif_pal_8_packbits",
    "tif_pal_8_none_byte", "tif_pal_4_none_tiles",
    "tif_rgba_8_none_assoc", "tif_rgba_8_lzw_unassoc",
    "tif_rgba_8_none_unspec", "tif_rgba_8_none_noextra",
    "tif_rgba_16_none_unassoc", "tif_rgba_16_deflate_pred_assoc",
    "tif_rgba_8_none_planar_unassoc",
    "tif_rgb_8_none_orient2", "tif_rgb_8_lzw_orient3",
    "tif_rgb_8_none_tiles_orient4", "tif_black_8_none_strips_orient3",
]
# square images of each Orientation (cv2 5.0.0 turns a square one only)
TIFF_ORIENT_KINDS = [f"tifsq_rgb_8_none_strips_orient{o}"
                     for o in range(1, 9)]

KINDS = PNG_KINDS + BMP_KINDS + TIFF_KINDS + TIFF_ORIENT_KINDS


def make_kind(name: str, h: int, w: int, seed: int = 0) -> tuple:
    """(file suffix, bytes) of kind `name` at (h, w)."""
    rng = np.random.default_rng([seed, h, w, len(name)])
    if name.startswith("png"):
        return "png", _png_kind(rng, h, w, name)
    if name.startswith("bmp"):
        return "bmp", _bmp_kind(rng, h, w, name)
    if name.startswith("tifsq"):
        return "tif", _tiff_kind(rng, w, w, "tif" + name[5:])
    return "tif", _tiff_kind(rng, h, w, name)


def _write_kind(root: Path, name: str, h: int, w: int) -> Path:
    ext, data = make_kind(name, h, w)
    path = Path(root) / f"{name}_{h}x{w}.{ext}"
    path.write_bytes(data)
    return path


@pytest.mark.parametrize("name", KINDS)
def test_kind_reads_as_cv2_imread(name, tmp_path):
    for h, w in SIZES:
        path = _write_kind(tmp_path, name, h, w)
        want = _cv2_read(path)
        assert want is not None, f"cv2 does not read {path.name}"
        got = image_io.imread(str(path))
        np.testing.assert_array_equal(got, want, err_msg=path.name)
        assert image_io.image_size(str(path)) == (want.shape[1],
                                                  want.shape[0])


# BMP files cv2's decoder refuses (it returns nothing): each raises
# OSError in the port, which the datasets drop, as JAX's drop what cv2
# cannot read; "header" where the header names a kind cv2 does not take
# (ROADMAP F10: these raised NotImplementedError before)
_PAL = np.zeros((256, 3))
CV2_FAILS = {
    "bmp_40_555_badmasks": ("header", lambda rng, h, w: bmp_bytes(
        b"\0" * 4 * w * h, w, h, 16, 40, 3, masks=(0xF00, 0xF0, 0xF),
        masks_after=True)),
    # a v5 header keeps its masks inside it, but cv2 reads them after it
    "bmp_124_565_masks_inside": ("header", lambda rng, h, w:
                                 bmp_bytes(rng.integers(
                                     1, 256, 4 * w * h, np.uint8).tobytes(),
                                     w, h, 16, 124, 3,
                                     masks=(0xF800, 0x7E0, 0x1F))),
    "bmp_40_16_rle8": ("header", lambda rng, h, w: bmp_bytes(
        b"\0" * 64, w, h, 16, 40, 1)),
    "bmp_12_16": ("header", lambda rng, h, w: bmp_bytes(
        b"\0" * 4 * w * h, w, h, 16, 12)),
    "bmp_40_24_truncated": ("data", lambda rng, h, w: bmp_bytes(
        b"\7" * (3 * w * h // 2), w, h, 24)),
    "bmp_40_rle8_run_past_row": ("data", lambda rng, h, w: bmp_bytes(
        bytes([w + 1, 3, 0, 1]), w, h, 8, 40, 1, _PAL)),
    "bmp_40_rle8_no_eob": ("data", lambda rng, h, w: bmp_bytes(
        bytes([2, 3, 0, 0]), w, h, 8, 40, 1, _PAL)),
    # RLE4's end of bitmap ends only its row (cv2 then reads past the data)
    "bmp_40_rle4_eob": ("data", lambda rng, h, w: _bmp_kind(
        rng, h, w, "bmp_40_rle4_eob")),
    "bmp_40_rle4_no_eol": ("data", lambda rng, h, w: bmp_bytes(
        bytes([w, 0x11, w, 0x22, 0, 1]), w, h, 4, 40, 2, _PAL[:16])),
}


@pytest.mark.parametrize("name", sorted(CV2_FAILS))
def test_files_cv2_cannot_read_raise(name, tmp_path):
    rng = np.random.default_rng(1)
    path = tmp_path / f"{name}.bmp"
    error, make = CV2_FAILS[name]
    path.write_bytes(make(rng, 23, 37))
    assert _cv2_read(path) is None
    with pytest.raises(OSError):
        image_io.imread(str(path))
    if error == "header":
        with pytest.raises(OSError, match="BMP .* is not read"):
            image_io.image_size(str(path))
        assert port_ds.verify_image_label(str(path), None, 8) is None


@pytest.mark.parametrize("kind", ["opencv", "pillow"])
def test_files_of_cv2_and_pillow_read_as_cv2(kind, tmp_path):
    """What cv2's and Pillow's writers write, with every TIFF option
    cv2.imwrite takes, and Pillow's BMP, PNG and TIFF modes."""
    cv2 = _cv2()
    rng = np.random.default_rng(5)
    img = cv2.GaussianBlur(rng.integers(0, 256, (41, 64, 3), np.uint8),
                           (5, 5), 2)
    paths = []
    if kind == "opencv":
        deep = rng.integers(0, 65536, (41, 64, 3), np.uint16)
        for arr, tag in ((img, "rgb"), (img[..., 0], "grey"), (deep, "rgb16"),
                         (deep[..., 0], "grey16"),
                         (np.dstack([img, img[..., :1]]), "rgba")):
            for comp in (1, 5, 8, 32773, 32946):
                for pred in (1, 2):
                    p = tmp_path / f"cv_{tag}_{comp}_{pred}.tif"
                    if cv2.imwrite(str(p), arr, [
                            cv2.IMWRITE_TIFF_COMPRESSION, comp,
                            cv2.IMWRITE_TIFF_PREDICTOR, pred,
                            cv2.IMWRITE_TIFF_ROWSPERSTRIP, 7]):
                        paths.append(p)
            for ext in ("png", "bmp"):
                p = tmp_path / f"cv_{tag}.{ext}"
                if cv2.imwrite(str(p), arr):
                    paths.append(p)
        p = tmp_path / "cv_bitfields.bmp"
        if cv2.imwrite(str(p), np.dstack([img, img[..., :1]]),
                       [cv2.IMWRITE_BMP_COMPRESSION,
                        cv2.IMWRITE_BMP_COMPRESSION_BITFIELDS]):
            paths.append(p)
        assert len(paths) >= 50
    else:
        Image = pytest.importorskip("PIL.Image")
        im = Image.fromarray(img)
        for mode in ("1", "L", "P", "RGB", "RGBA", "LA", "I;16"):
            src = im.convert(mode) if mode != "I;16" else Image.fromarray(
                rng.integers(0, 65536, (41, 64), np.uint16))
            for ext, opts in (("png", {}), ("bmp", {}),
                              ("tif", {"compression": "tiff_lzw"}),
                              ("tif", {"compression": "packbits"}),
                              ("tif", {"compression": "tiff_deflate"}),
                              ("png", {"optimize": True})):
                p = tmp_path / f"pil_{mode.replace(';', '')}_{len(paths)}.{ext}"
                try:
                    src.save(p, **opts)
                except (OSError, ValueError, KeyError):
                    continue
                paths.append(p)
        assert len(paths) >= 30
    read = 0
    for p in paths:
        want = _cv2_read(p)
        if want is None:
            with pytest.raises((OSError, NotImplementedError)):
                image_io.imread(str(p))
            continue
        np.testing.assert_array_equal(image_io.imread(str(p)), want,
                                      err_msg=p.name)
        assert image_io.image_size(str(p)) == (want.shape[1], want.shape[0])
        read += 1
    assert read >= len(paths) - 2


def test_tiny_adam7_images_with_empty_passes(tmp_path):
    """1x1 to 9x9: passes with no columns or no rows have no bytes."""
    rng = np.random.default_rng(2)
    for h in range(1, 10):
        for w in (1, 2, 3, 5, 9):
            for ctype, depth, spp in ((0, 1, 1), (2, 8, 3), (6, 16, 4)):
                s = rng.integers(0, 1 << depth, (h, w, spp))
                p = tmp_path / f"a{h}x{w}_{ctype}.png"
                p.write_bytes(png_bytes(s, depth, ctype, interlace=True))
                np.testing.assert_array_equal(image_io.imread(str(p)),
                                              _cv2_read(p), err_msg=p.name)


def test_16_bit_samples_reduce_as_cv2_reduces_them(tmp_path):
    """PNG takes the high byte (png_set_strip_16), as does a TIFF's grey;
    a TIFF's RGB rounds, (v + 128) / 257: 255 -> 0 / 1, 65280 -> 255 /
    254 tell them apart."""
    v = np.array([0, 255, 383, 384, 32767, 32768, 65280, 65535], np.uint16)
    rgb = np.repeat(v[None, :, None], 3, 2)
    png, tif, grey = (tmp_path / n for n in ("v.png", "v.tif", "g.tif"))
    png.write_bytes(png_bytes(rgb, 16, 2))
    tif.write_bytes(tiff_bytes(rgb, 16))
    grey.write_bytes(tiff_bytes(rgb[..., :1], 16, photometric=1))
    high = (v >> 8).astype(np.uint8)
    rounded = ((v.astype(int) + 128) // 257).astype(np.uint8)
    for path, want in ((png, high), (tif, rounded), (grey, high)):
        got = image_io.imread(str(path))
        np.testing.assert_array_equal(got[0, :, 0], want, err_msg=path.name)
        np.testing.assert_array_equal(got, _cv2_read(path))


# -- orientation: F9 ----------------------------------------------------------

@pytest.mark.parametrize("orientation", [5, 6, 7, 8])
def test_f9_non_square_tiff_orientation(orientation, tmp_path):
    """cv2 5.0.0 fails on a non-square TIFF of Orientation 5-8 (imread
    asserts), so the JAX package drops it from a dataset; so does the port
    now (OSError from imread and image_size, None from verify_image_label;
    ROADMAP F9, closed). A square one is turned as cv2 turns it."""
    jax_ds = pytest.importorskip("efficientteacher_tpu.data.datasets")
    rng = np.random.default_rng(orientation)
    stored = rng.integers(0, 256, (23, 37, 3), np.uint8)
    path = tmp_path / "images" / "f9.tif"
    path.parent.mkdir()
    path.write_bytes(tiff_bytes(stored, orientation=orientation))
    assert _cv2_read(path) is None
    assert jax_ds.verify_image_label(str(path), None, 8) is None
    assert port_ds.verify_image_label(str(path), None, 8) is None
    with pytest.raises(OSError, match="non-square"):
        image_io.imread(str(path))
    with pytest.raises(OSError, match="non-square"):
        image_io.image_size(str(path))
    square = tmp_path / "square.tif"
    square.write_bytes(tiff_bytes(stored[:23, :23], orientation=orientation))
    np.testing.assert_array_equal(
        _cv2_read(square), tiff_io.orient(stored[:23, :23], orientation))
    np.testing.assert_array_equal(image_io.imread(str(square)),
                                  _cv2_read(square))


# -- refusals -------------------------------------------------------------

def _refused_tiff(kind: str) -> bytes:
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (23, 37, 3))
    if kind == "jpeg":
        return tiff_bytes(rgb, compression=7)
    if kind == "old_jpeg":
        return tiff_bytes(rgb, compression=6)
    if kind == "ccitt_g4":
        return tiff_bytes(rgb[..., :1] & 1, 1, photometric=0, compression=4)
    if kind == "ccitt_rle":
        return tiff_bytes(rgb[..., :1] & 1, 1, photometric=0, compression=2)
    if kind == "lzma":
        return tiff_bytes(rgb, compression=34925)
    if kind == "ycbcr":
        return tiff_bytes(rgb, photometric=6)
    if kind == "cmyk":
        return tiff_bytes(np.dstack([rgb, rgb[..., :1]]), photometric=5)
    if kind == "cielab":
        return tiff_bytes(rgb, photometric=8)
    if kind == "float":
        return tiff_bytes(rgb.astype(np.uint16), 16,
                          tags=[(339, 3, [3, 3, 3])])
    if kind == "signed":
        return tiff_bytes(rgb, tags=[(339, 3, [2, 2, 2])])
    if kind == "bits_12":
        return tiff_bytes(rgb[..., :1] & 0xFF, 8, photometric=1,
                          tags=[]).replace(
            struct.pack("<HHIHH", 258, 3, 1, 8, 0),
            struct.pack("<HHIHH", 258, 3, 1, 12, 0))
    if kind == "float_predictor":
        return tiff_bytes(rgb, compression=5, predictor=3)
    if kind == "fill_order_2":
        return tiff_bytes(rgb, tags=[(266, 3, [2])])
    if kind == "grey_alpha_4_bit":
        return tiff_bytes(rgb[..., :2] & 15, 4, photometric=1, extras=[2])
    if kind == "grey_2_bit":
        return tiff_bytes(rgb[..., :1] & 3, 2, photometric=1)
    if kind == "palette_2_bit":
        return tiff_bytes(rgb[..., :1] & 3, 2, photometric=3,
                          colormap=np.arange(12) * 5000)
    if kind == "grey_4_bit":
        return tiff_bytes(rgb[..., :1] & 15, 4, photometric=0)
    if kind == "palette_16_bit":
        return tiff_bytes(rgb[..., :1], 16, photometric=3,
                          colormap=np.arange(3 << 16) % 65536)
    raise KeyError(kind)


# what the port's error names, for each kind it refused before ROADMAP
# Q1.9c's TIFF half
REFUSED_TIFF = {"jpeg": "corrupt", "old_jpeg": "old-style JPEG",
                "ccitt_g4": "", "ccitt_rle": "", "lzma": "LZMA",
                "ycbcr": "", "cmyk": "", "cielab": "", "float": "float",
                "signed": "", "bits_12": "12-bit",
                "float_predictor": "predictor 3", "fill_order_2": "",
                "grey_alpha_4_bit": "4-bit", "grey_2_bit": "2-bit",
                "palette_2_bit": "2-bit", "grey_4_bit": "4-bit",
                "palette_16_bit": "16-bit"}
# of these cv2 5.0.0 reads all but these, which it returns None for (the
# "jpeg" file's strip is no JPEG stream; the JAX package drops them all)
CV2_REFUSES_TOO = ("jpeg", "old_jpeg", "lzma", "float", "bits_12",
                   "float_predictor", "grey_alpha_4_bit", "grey_2_bit",
                   "palette_2_bit", "grey_4_bit", "palette_16_bit")


@pytest.mark.parametrize("kind", sorted(REFUSED_TIFF) + ["webp"])
def test_refused_kinds_raise_at_dataset_build(kind, tmp_path):
    """Each kind the port refused before (TIFF kinds until ROADMAP
    Q1.9c's TIFF half, WebP until Q1.9b) now takes the JAX package's
    course: one cv2 reads builds and reads as cv2.imread reads it; one cv2
    reads nothing of leaves the dataset, as it leaves JAX's (F10, closed),
    through an OSError that names its kind."""
    good = tmp_path / "images" / "good.png"
    good.parent.mkdir()
    image_io.write_png(str(good), np.full((24, 40, 3), 90, np.uint8))
    lst = tmp_path / "list.txt"
    if kind == "webp":
        ok = tmp_path / "images" / "x.webp"
        image_io.imwrite(str(ok), np.full((24, 40, 3), 60, np.uint8))
        lst.write_text(f"{good}\n{ok}\n")
        ds = port_ds.LoadImagesAndLabels(str(lst), img_size=32, nc=8)
        assert len(ds) == 2 and tuple(ds.shapes[1]) == (40, 24)
        np.testing.assert_array_equal(image_io.imread(str(ok)),
                                      _cv2_read(ok))
        return
    bad = tmp_path / "images" / f"{kind}.tif"
    bad.write_bytes(_refused_tiff(kind))
    lst.write_text(f"{good}\n{bad}\n")
    ds = port_ds.LoadImagesAndLabels(str(lst), img_size=32, nc=8)
    want = _cv2_read(bad)
    if kind not in CV2_REFUSES_TOO:
        assert want is not None
        assert len(ds) == 2 and tuple(ds.shapes[1]) == (37, 23)
        np.testing.assert_array_equal(image_io.imread(str(bad)), want)
        return
    jax_ds = pytest.importorskip("efficientteacher_tpu.data.datasets")
    assert want is None
    assert jax_ds.verify_image_label(str(bad), None, 8) is None
    assert ds.img_files == [str(good)]
    with pytest.raises(OSError, match=REFUSED_TIFF[kind]) as err:
        image_io.image_size(str(bad))
    assert str(bad) in str(err.value)
    with pytest.raises(OSError):
        image_io.imread(str(bad))


# -- writers --------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 2, 3, 4, 37, 64])
def test_bmp_writer_is_byte_equal_to_cv2(w, tmp_path):
    cv2 = _cv2()
    img = np.random.default_rng(w).integers(0, 256, (23, w, 3), np.uint8)
    ours, theirs = tmp_path / "a.bmp", tmp_path / "b.bmp"
    image_io.imwrite(str(ours), img)
    assert cv2.imwrite(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(image_io.imread(str(ours)), img[..., ::-1])


@pytest.mark.parametrize("h,w", [(1, 1), (23, 37), (480, 640)])
def test_tiff_writer_reads_back_exactly(h, w, tmp_path):
    """LZW + predictor 2 in strips of 8 KiB, as cv2 writes it (its layout
    checked against cv2's file): cv2.imread and the port read the canvas
    back; at 640x480 (120 strips of 4 rows) the LZW table fills and clears
    within a strip."""
    cv2 = _cv2()
    rng = np.random.default_rng(h)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    if h > 100:   # half noise, half smooth: long and short strings
        img[h // 2:] = cv2.GaussianBlur(img[h // 2:], (9, 9), 4)
    for ext in ("tif", "tiff"):
        path = tmp_path / f"a.{ext}"
        image_io.imwrite(str(path), img)
        np.testing.assert_array_equal(cv2.imread(str(path)), img)
        np.testing.assert_array_equal(image_io.imread(str(path)),
                                      img[..., ::-1])
        theirs = tmp_path / f"b.{ext}"
        cv2.imwrite(str(theirs), img)
        lay = tiff_io._layout(str(theirs), theirs.read_bytes())
        mine = tiff_io._layout(str(path), path.read_bytes())
        assert (lay.compression, lay.predictor, lay.bits, lay.spp,
                lay.planar, lay.ch, len(lay.chunks)) == (
            mine.compression, mine.predictor, mine.bits, mine.spp,
            mine.planar, mine.ch, len(mine.chunks))
        assert (mine.compression, mine.predictor, mine.planar) == (5, 2, 1)
    webp = tmp_path / "a.webp"   # written since ROADMAP Q1.9b
    image_io.imwrite(str(webp), img)
    np.testing.assert_array_equal(cv2.imread(str(webp)), img)


# -- a mixed-format split through the entry points ------------------------

REPO = Path(__file__).resolve().parents[1]
SUP_YAML = REPO / "configs/sup/public/yolov5l_coco.yaml"
SMALL = ["Model.width_multiple", "0.125", "Model.depth_multiple", "0.33",
         "Dataset.img_size", "96", "device", "cpu"]
# (h, w, kind): around the 96-px target, an upscale and a downscale
MIXED = [(72, 96, "bmp"), (96, 72, "tif"), (48, 64, "png16"),
         (150, 200, "adam7"), (80, 96, "rle8"), (96, 90, "tiles"),
         (70, 96, "orient3"), (96, 96, "os2"), (90, 96, "jpg411"),
         (64, 96, "cmyk")]


def _photo(rng, h, w):
    """A colour gradient with noise and a few flat boxes (RGB uint8)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([(xx * (2 + c) + yy * (3 - c)) % 256 for c in range(3)],
                   -1) + rng.normal(0, 10, (h, w, 3))
    for _ in range(3):
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
        img[y:y + 8, x:x + 8] = rng.uniform(0, 255, 3)
    return img.clip(0, 255).astype(np.uint8)


def _write_mixed_image(path: Path, kind: str, rgb: np.ndarray, rng):
    h, w = rgb.shape[:2]
    if kind in ("bmp", "tif"):
        image_io.imwrite(str(path), rgb[..., ::-1])
    elif kind == "png16":
        deep = rgb.astype(np.uint16) * 257 + rng.integers(0, 257, rgb.shape)
        path.write_bytes(png_bytes(deep, 16, 2))
    elif kind == "adam7":
        path.write_bytes(png_bytes(rgb, 8, 2, interlace=True))
    elif kind == "rle8":
        pal = rng.integers(0, 256, (256, 3))
        idx = (rgb.astype(int).sum(2) // 12).clip(0, 63)
        path.write_bytes(bmp_bytes(rle_stream(idx[::-1], 8, "delta"), w, h,
                                   8, 40, 1, pal))
    elif kind == "tiles":
        path.write_bytes(tiff_bytes(rgb, compression=5, predictor=2,
                                    tile=(32, 32)))
    elif kind == "orient3":
        path.write_bytes(tiff_bytes(rgb[::-1, ::-1], compression=8,
                                    orientation=3))
    elif kind == "os2":
        path.write_bytes(bmp_bytes(_rows(rgb[::-1, :, ::-1].reshape(h, -1),
                                         w * 24), w, h, 24, 12))
    elif kind == "jpg411":
        cv2 = _cv2()
        assert cv2.imwrite(str(path), rgb[..., ::-1], [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    else:   # cmyk
        Image = pytest.importorskip("PIL.Image")
        Image.fromarray(rgb).convert("CMYK").save(str(path), quality=90)


def write_mixed(root: Path, seed: int = 0, nc: int = 8):
    """A split of MIXED's kinds (images/, labels/, mixed.txt) and its PNG
    copy (png/images holds each image's decoded pixels, same stems and
    labels); returns the two list files."""
    rng = np.random.default_rng(seed)
    ext = {"bmp": "bmp", "rle8": "bmp", "os2": "bmp", "tif": "tif",
           "tiles": "tiff", "orient3": "tif", "png16": "png", "adam7": "png",
           "jpg411": "jpg", "cmyk": "jpeg"}
    lists = {}
    for sub in ("mixed", "png"):
        for d in ("images", "labels"):
            (root / sub / d).mkdir(parents=True, exist_ok=True)
    paths, copies = [], []
    for i, (h, w, kind) in enumerate(MIXED):
        path = root / "mixed" / "images" / f"{i}.{ext[kind]}"
        _write_mixed_image(path, kind, _photo(rng, h, w), rng)
        copy = root / "png" / "images" / f"{i}.png"
        image_io.write_png(str(copy), image_io.imread(str(path)))
        n = int(rng.integers(1, 6))
        rows = "".join(f"{rng.integers(0, nc)} {cx:.6f} {cy:.6f} {bw:.6f} "
                       f"{bh:.6f}\n"
                       for cx, cy, bw, bh in rng.uniform(0.2, 0.45, (n, 4)))
        for sub in ("mixed", "png"):
            (root / sub / "labels" / f"{i}.txt").write_text(rows)
        paths.append(str(path))
        copies.append(str(copy))
    for sub, files in (("mixed", paths), ("png", copies)):
        lists[sub] = root / sub / f"{sub}.txt"
        lists[sub].write_text("\n".join(files) + "\n")
    return lists["mixed"], lists["png"]


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    _cv2()
    return write_mixed(tmp_path_factory.mktemp("mixed"))


def test_mixed_split_equals_jax(mixed):
    """verify_image_label, the val dataset's items and load_image, and
    LoadImages: the port's against the JAX package's (cv2) on the mixed
    split, bit for bit."""
    jax_ds = pytest.importorskip("efficientteacher_tpu.data.datasets")
    from efficientteacher_tpu.data.loaders import LoadImages as JaxLoadImages
    from efficientteacher_torch.data.loaders import LoadImages
    from test_torch_datasets import cfgs

    lst, _ = mixed
    files = Path(lst).read_text().split()
    for f in files:
        label = f.replace("/images/", "/labels/").rsplit(".", 1)[0] + ".txt"
        got = port_ds.verify_image_label(f, label, 8)
        want = jax_ds.verify_image_label(f, label, 8)
        np.testing.assert_array_equal(got[0], want[0])
        assert tuple(got[1]) == tuple(want[1]), f
    pc, jc = cfgs(str(lst))
    port = port_ds.create_dataloader(pc, "val", augment=False).ds
    ref = jax_ds.create_dataloader(jc, "val", augment=False).ds
    assert len(port) == len(ref) == len(MIXED)
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
    folder = str(Path(files[0]).parent)
    for (p, rgb, img0, rp), (jp, jrgb, jimg0, jrp) in zip(
            LoadImages(folder, 96), JaxLoadImages(folder, 96)):
        assert p == jp and rp == jrp
        np.testing.assert_array_equal(rgb, jrgb)
        np.testing.assert_array_equal(img0, jimg0)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A seeded YOLOv5 (the supervised YAML at width 0.125) whose
    objectness and first classes are raised so that boxes pass conf 0.25,
    as a port checkpoint."""
    import torch

    from efficientteacher_torch.configs import get_cfg
    from efficientteacher_torch.models import build_model, spec_from_cfg
    from efficientteacher_torch.utils.checkpoint import (module_variables,
                                                         save_checkpoint)

    cfg = get_cfg()
    cfg.merge_from_file(str(SUP_YAML))
    cfg.merge_from_list(SMALL)
    model = build_model(spec_from_cfg(cfg), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for conv in model.head.m:
            conv.bias.view(model.head.na, model.head.no)[:, 4] += 5.0
            conv.bias.view(model.head.na, model.head.no)[:, 5:9] += 5.0
    v = module_variables(model)
    path = tmp_path_factory.mktemp("weights") / "w.ckpt"
    save_checkpoint(path, params=v["params"], batch_stats=v["batch_stats"])
    return str(path), cfg


def test_cli_val_and_detect_on_mixed_formats(mixed, weights, tmp_path):
    """cli.val gives the same results on the mixed split as on its PNG
    copy; cli.detect over the mixed folder writes each annotated canvas
    under its source's suffix (read back equal to the canvas by cv2 and by
    the port, JPEG aside), and label files equal to the PNG copy's;
    AutoShape and DetectBackend take the mixed files as the copies."""
    from efficientteacher_torch.cli import detect as cli_detect
    from efficientteacher_torch.cli import val as cli_val
    from efficientteacher_torch.data.loaders import LoadImages
    from efficientteacher_torch.eval.multi_backend import DetectBackend
    from efficientteacher_torch.models import autoshape

    lst, png_lst = mixed
    ckpt, cfg = weights
    res = [cli_val.main(["--cfg", str(SUP_YAML), "--weights", ckpt,
                         "--batch-size", "4", *SMALL, "Dataset.val", str(l)])
           for l in (lst, png_lst)]
    assert res[0] == res[1]
    canvases, real = [], image_io.imwrite

    def record(path, img):
        canvases.append((Path(path), np.array(img)))
        real(path, img)

    image_io.imwrite = record
    try:
        out = [cli_detect.main([
            "--cfg", str(SUP_YAML), "--weights", ckpt, "--source",
            str(Path(l).parent / "images"), "--save-dir",
            str(tmp_path / name), "--save-txt", "--img-size", "96", *SMALL])
            for name, l in (("mixed", lst), ("png", png_lst))]
    finally:
        image_io.imwrite = real
    (mixed_dir, dets, _), (png_dir, png_dets, _) = out
    assert sum(len(d) for d in dets.values()) >= 10
    for p, d in dets.items():
        np.testing.assert_array_equal(
            d, png_dets[str(png_lst.parent / "images" / (Path(p).stem
                                                          + ".png"))])
    txt = sorted(mixed_dir.glob("*.txt"))
    assert [t.read_text() for t in txt] == [
        t.read_text() for t in sorted(png_dir.glob("*.txt"))]
    assert len(txt) == len(MIXED)
    written = {p.name: img for p, img in canvases if p.parent == mixed_dir}
    assert sorted(written) == sorted(Path(p).name for p in dets)
    for name, canvas in written.items():
        if image_io.suffix(name) in image_io.JPEG_SUFFIXES:
            continue
        np.testing.assert_array_equal(_cv2().imread(str(mixed_dir / name)),
                                      canvas, err_msg=name)
        np.testing.assert_array_equal(image_io.imread(str(mixed_dir / name)),
                                      canvas[..., ::-1], err_msg=name)
    files = [str(p) for p in sorted(Path(lst).parent.glob("images/*"))]
    copies = [str(Path(png_lst).parent / "images" / (Path(p).stem + ".png"))
              for p in files]
    import torch

    from efficientteacher_torch.models import build_model, spec_from_cfg
    from efficientteacher_torch.utils.torch_import import load_weights_into

    model = build_model(spec_from_cfg(cfg), device="cpu")
    load_weights_into(model, ckpt, strict=True)
    shaper = autoshape.AutoShape(model.eval(), list(cfg.Dataset.names), 96)
    a, b = shaper(files), shaper(copies)
    for x, y in zip(a.xyxy, b.xyxy):
        np.testing.assert_array_equal(x, y)
    backend = DetectBackend(ckpt, cfg)
    batch = np.stack([rgb for _, rgb, _, _ in LoadImages(files[0], 96)]
                     + [rgb for _, rgb, _, _ in LoadImages(files[1], 96)])
    copy = np.stack([rgb for _, rgb, _, _ in LoadImages(copies[0], 96)]
                    + [rgb for _, rgb, _, _ in LoadImages(copies[1], 96)])
    with torch.no_grad():
        np.testing.assert_array_equal(backend(batch), backend(copy))


def test_cli_train_on_mixed_formats(mixed, tmp_path):
    """cli.train (the supervised YAML as written: host augmentation,
    mosaic) trains an epoch on the mixed split; its first batch equals the
    PNG copy's, image for image."""
    from efficientteacher_torch.cli import train as cli_train
    from efficientteacher_torch.configs import get_cfg

    lst, png_lst = mixed
    common = [*SMALL, "Dataset.batch_size", "4", "Dataset.workers", "2",
              "epochs", "1", "project", str(tmp_path), "Dataset.val",
              str(lst)]
    batches = []
    for l in (lst, png_lst):
        cfg = get_cfg()
        cfg.merge_from_file(str(SUP_YAML))
        cfg.merge_from_list([*common, "Dataset.train", str(l)])
        loader = port_ds.create_dataloader(cfg, "train", seed=0)
        batches.append(next(iter(loader)))
    np.testing.assert_array_equal(np.asarray(batches[0]["images"]),
                                  np.asarray(batches[1]["images"]))
    np.testing.assert_array_equal(np.asarray(batches[0]["labels"]),
                                  np.asarray(batches[1]["labels"]))
    best = cli_train.main(["--cfg", str(SUP_YAML), *common, "name", "mixed",
                           "Dataset.train", str(lst)])
    assert best >= 0.0
    assert (tmp_path / "mixed" / "weights" / "best.ckpt").is_file()


# -- fixtures -------------------------------------------------------------

FIXTURE_KINDS = [
    "png_grey_1", "png_grey_2", "png_grey_4", "png_pal_2", "png_grey_16",
    "png_rgba_16", "png_rgb_8_adam7", "png_pal_4_adam7", "png_trns_pal",
    "png_exif_6", "bmp_12_8", "bmp_40_1", "bmp_40_4", "bmp_40_grey",
    "bmp_40_555", "bmp_40_565_bf", "bmp_40_24", "bmp_40_32_bf",
    "bmp_124_24", "bmp_40_24_topdown", "bmp_40_rle8_delta",
    "bmp_40_rle4_delta", "tif_rgb_8_lzw_pred", "tif_rgb_8_deflate_pred_strips",
    "tif_rgb_8_packbits", "tif_rgb_16_lzw_planar_pred", "tif_rgb_8_lzw_tiles",
    "tif_rgb_16_none_mm", "tif_white_1_none", "tif_black_1_packbits_strips",
    "tif_pal_4_lzw", "tif_rgba_8_lzw_unassoc", "tif_rgb_8_none_big",
    "tifsq_rgb_8_none_strips_orient6",
]
FIXTURE_SIZE = (11, 13)

# name: (base64 file, ((h, w, 3), sha256 of cv2.imread's RGB bytes))
FIXTURES = {
    "png_grey_1": (
        "iVBORw0KGgoAAAANSUhEUgAAAA0AAAALAQAAAACMyTrMAAAAKklEQVR4nGPoiWDcKc"
        "4kfILZQJPFgIkh8wTjvC6m6AfMfyRYEtMZpp4AAJQBCfyQ4szbAAAAAElFTkSuQmCC",
        ((11, 13, 3), "f5a7f5f7bcac458b84730b81462cf62e"
                      "6a5b307e97d2de3cc69c7b6295ba6e03")),
    "png_grey_2": (
        "iVBORw0KGgoAAAANSUhEUgAAAA0AAAALAgAAAADLaUAcAAAAQklEQVR4nAE3AMj/AJ"
        "HwZoABjvghmQIXb99AA3VLTm4E6kD8wAA9l6SAAdLmVbMC3R/0wAPjTQdHBHiu7oAA"
        "g3a0gJZ3GGrsW89gAAAAAElFTkSuQmCC",
        ((11, 13, 3), "9181a34a25f666bea7b7000fade2707b"
                      "52ca409c58b197e0162df4140526c75e")),
    "png_grey_4": (
        "iVBORw0KGgoAAAANSUhEUgAAAA0AAAALBAAAAABEKbW8AAAAY0lEQVR4nAFYAKf/AL"
        "Qk3QFoWbABkzbIuEDEEwImrF4M+QwgA5erglcN3JYEy9gvERTgwAAfxKVNqHGwAfY1"
        "cRZ/pOsCxNFLm+Iy0AOwNQbVQemDBKJidtnz95AAsC59ebxAgGwmJ3WgjIqqAAAAAE"
        "lFTkSuQmCC",
        ((11, 13, 3), "a6e91028901507e4662488df7c9000a9"
                      "c850d8a59e567f388a092252a900c0ae")),
    "png_pal_2": (
        "iVBORw0KGgoAAAANSUhEUgAAAA0AAAALAgMAAADZ3O/yAAAADFBMVEWq6DiGZavet2"
        "8qKpoq74AFAAAAQklEQVR4nAE3AMj/AKoWQ4ABM8hFgALJT/uAA0zOYEwEpdaHIQDl"
        "IDkAAZwLR1ICjLvPwAPy60ukBN0eTEAAzmC2wEM7Fh+p2HpoAAAAAElFTkSuQmCC",
        ((11, 13, 3), "28d4453ff75153ecc9a378cd78f6c920"
                      "779fff737eab2b855f7e73e73d417c72")),
    "png_grey_16": (
        "iVBORw0KGgoAAAANSUhEUgAAAA0AAAALEAAAAADRSYT+AAABNElEQVR4nAEpAdb+AH"
        "sl4n98KxRhTyFZjJSLvxcJd5c6LNaAYicRAeUdBKokYlUua9UTdT+tIPgUzmGz3rTy"
        "q1RCAorKNyXaFM2YkhahKAG5BndLTfueX6LyuoMlAwAXHqkSjvGYihz7MMVADutEbl"
        "Wq3ZxSpH7CBAwvPWJ7zPfw2Aea3Bq8XXkAMBxWcqw2Q23EACBFoOgV1rzHkYzWitlE"
        "AvQIlYVn7Ovud10hAXKNXkMShW1IQIqPtZhTD0VcxF5u3cZI5LGCAkyXDi85JMiumL"
        "DqgYnj1JV1lv3TPxz/zec5Ay9pDMhxRBFqMCRVxCa0fezhUUSqUbRSa2v9BJq+ECqn"
        "jTRUP3KQPHRU33b52MrSXWeeLUAJAI23bnSiy4CmE7Bp8a5riepIFGkg17oqUcd7ax"
        "+ITfEuyvoAAAAASUVORK5CYII=",
        ((11, 13, 3), "d43ae835b0a1cd1b0b7bb77e5c0ec19a"
                      "ed2a7c1fbcff8ae0695bcde51478c9eb")),
    "png_rgba_16": (
        "iVBORw0KGgoAAAANSUhEUgAAAA0AAAALEAYAAAD0ItsiAAAEjklEQVR4nAGDBHz7AH"
        "sl4n98KxRhTyFZjJSLvxcJd5c6LNaAYicR5R3pxw0pYlfNLOChH04/RlMUtMeSe4Qm"
        "2Ghv5yDs5z0v719CgckgB0W9nmGvZfEdduBbjTeKSWSq3l1+6Hyv0iysRp+27gdTWd"
        "S5fghHAUO5huwluBxufbzDwiGwh3P2qdrGhRhe4Lgk/dHVaBQVToVxRzaixG5GLXcJ"
        "r90Tp+yDVYztJuTl9N7yfB2aTgzU2nbXkhFhyqY939w0mj9+gpN3KcJ5abMqXiSZgr"
        "5v93QcXHYKFKY9AkvCPJm6C3CDyZNUSE7QcCt/oHnRIZoYxScDCPT+e1Q84Z9L7pao"
        "B0JxumQB4bANk8k8mm4bKp6kwHYxCYSJSxX4PMR2J9zqentOhgFyqffym/9ZLP2vdu"
        "Brgh/szeDdtCKHNA0h/ctCA92OyFAei4LP9ibIeGX4ALsGiHMGw/XchP1780PeNcea"
        "2HHsgS/fTXjnoGSEV6pPxazb1PmR0+HhhQSS2eAjKvDjvBiLeyPGNFtH++xtCC4NC0"
        "4YMMZmCKix1d3iQnu+Bft0ScxYONTiBKJv42wvT+Lm4BoGZRiL0lHFcNzyMkwnDkB5"
        "QVBbyd+ya7Gd5IoHqN1XY3jpoTNHrU87A6B4aFYY+V3jY0ekN5/hLfKP7TZo39e9yK"
        "2l3Ty74Mq1JDdWW0H2fZGqOApu6LBbhiWBgjV1AN0IsPxreMa+GSPEhzXTnsUzvEaW"
        "VpfBhcPkJpnBuJUMl1tcQxe81f5ytdGJZKQWShjJeNGcwR3cntC8uPHFOV4njO11AN"
        "mzbROJzYSUKPYl1t/8/I3JC+nkkivj5eRVUHPVX8Ln1SYMAcqIPpaMvw6y6D72+PRJ"
        "ychduUp22DirrC2tXuwMS433l1xvDK+m+EKUMDWT6q7Cu+kNFy/oDguBtZwkFTsJYH"
        "ECrwvV7UxqqqaTiJePQdvck4OpA1XUVWUWAX4hkt434Hqhz4WP2YhhAiFH35WDblzU"
        "bMvSgOQQpbtUo+agpGUDgRRe9mwFj0hMK2Zikmbls7AYxeRsfPyxB+y6qP+UQWAOGq"
        "Q02BvAcZY9lG9arE2hNA78fZtSe/TcKInAJTfHBVCiMcV5QPBOWcxW2IsyC8McA7V4"
        "QKbKljmqfQtkDg1IGJWkRXwLCn360fxbv9wfPujfmF4rMNKIQKFpwXQH4U1E3oMSyh"
        "8a+iFF0okcm1mka4utOyx43zxD3XFhPUsa4a/hsc2F9m9JQz6oaxe2BUn1gcX+ETWo"
        "K4FKBD8BcANOiti/Nhs/ZzXXxSbJ7HWoc94WU+1BnJkRa2SnMNJBZmXQ8xQq+U49Sx"
        "RkoBk0MFgYcFHkr9dLWuc1U+eD67g4y8JleN7lwb/eKxzLyp1OfzHXkRo9hooq1SZ7"
        "l55gyPeBwHl0AOr9ObiNBjPTU8YNweoRoKrHws2iOA9d/VeHinKMl64abg8em5qCU9"
        "GwRtdCvn8SyNP6EOqODuyqzsB0LrkDyq8TRYMcC1H8MxEXEEEA6c8LzmYn3Zqmolhd"
        "TipHyXB4muouoqyTAw14N8A+a8tKPJoAAAAASUVORK5CYII=",
        ((11, 13, 3), "866ab77f47336a0c8cd9c0eafd5103ac"
                      "8a30d8478d50f1d3445e4ab705e80cf2")),
    "png_rgb_8_adam7": (
        "iVBORw0KGgoAAAANSUhEUgAAAA0AAAALCAIAAAFc16CgAAABzklEQVR4nAHDATz+AN"
        "XYqZmFbwHF/0bzY6YAKd9gscVFAY7nukLKWABC+ZdpgPvTt6JicEQAd5jMqWQPu/vx"
        "AfPeBP17Jamp9AK6DyCMLGGpFDwAivqpm+GNoLYbFrvVPwq8bgu/ry+5ARfrkWwzAF"
        "KdsRmtbg+E6iynQyFqAQKeVYEegDOsUjxPQ5AopF+dapXFKpcAnAuCEvHHaZBoQ6Gm"
        "7e0js/GPAY2KK+kqYCIUSzEhvKVGp3XlNQLqr6XOre2hGGiKFd4s/gdS8BYDArVWSL"
        "hBkIeC3uOREbW97WXCBA9VPI6BZCVWJp0JoPMSqsRGYgB9IQryvQJIlRxkqQSirw22"
        "Q2UAeNGfNTaMgWTaj7ED1+IAo1IEVBFvttmi1fBZEw8ocFgjco6lFrySAfh6h/TKoO"
        "tYjz4f+nnypC550DPcQnPVq2cN3YhEIPzQhnU5sxtG0QI+h81B+O/+z33/59Q6Nu2B"
        "WzEovB6LpPIgvkU9V/bIdaMdwXSx7XADajuJwST9xfUkADqdkRdi2zVJNvgMuOFQht"
        "UMwGPHCY6Ai6v6aHx6BCUkYRHz6L6ZjKqpH78L1SWUG3je7Y1LLrMm47R0+XSd2zhe"
        "zjoeYlR11+Q4pOfLAAAAAElFTkSuQmCC",
        ((11, 13, 3), "adf0037bf327a3ab616e1871ec93158b"
                      "440ed64d12712e0c466fd2de7f7d52cf")),
    "png_pal_4_adam7": (
        "iVBORw0KGgoAAAANSUhEUgAAAA0AAAALBAMAAAEhmyrEAAAAMFBMVEXuUSgOTfiUwj"
        "FH3XcYQvmXdznQ894ERGF4aYD7OeA+8FkpU/5w07eimi1AmQIdNQQ2fYDeAAAAbklE"
        "QVR4nAFjAJz/ANwBsQACAWsA4L8Ap/ABof8CigAAbr/7QAGK/wIVAiGX1kAA2YkcAe"
        "IZkQIjW1ED9ofzBGvg6gBS5twA1mlqYEqpgAF9FqVOUtggAtRvPaGya8ADiUNJQSsf"
        "bwRGl3GX2CiAklonnZ0nbaAAAAAASUVORK5CYII=",
        ((11, 13, 3), "4cd3df3e9a1e26e8c67afb7b4dfee349"
                      "599085e053164190005ea23bb65ab6e3")),
    "png_trns_pal": (
        "iVBORw0KGgoAAAANSUhEUgAAAA0AAAALCAMAAACTbPdTAAADAFBMVEW8VUkQOCA4ki"
        "nG3Dm6rf/CcLKbNizr98ba1Hr6f7bXXuPAkzZBIzIN1XinXYSqh8RW7afilxgGciAT"
        "HiEoyLDAyyviif9DDZpBkI7KQH/oUQQBLOFwADSzrv2noLJYRdlWdPr264LBQChICc"
        "4QBw6E498UTK34OqKyIu1OCm5nB5FsI/5LYsJttR+VILZ0YZWOfszXHqmljRbxLKsg"
        "rAG/WBR5xq5WgxHK5HYfZGNU+xTwpwv+63JvQEltdI3lHMRUP65ZJv+ZhIc3/hRGbM"
        "gZb+pPcHKyixtelMnLMuGx1MZ+lTyKmlMYpZStBnADg+GZ1IjGRemugv6afAn0NY72"
        "rgtsLrJsYaS8Krz4e8C/Xcgt4Bu+q2lPbvmWhsZdybh2FO1rVw+vBsOvYUF30Uzpcr"
        "mSHIKxXoil25mZJ8Ge4QpqZxe0wRCpkqIcQZDfl1uJ6yhn97IhEHvcyyUCNB3q6rC5"
        "cyNXdN3OqJw106x23OSnT/l3GGjl1nKwSqACOhorw3QGTinFswzTcHzJMkqkoZa2gd"
        "W6+tm0HqfnKaZVmeH/EVI+jDImm8lmQv56IQEpam75HzAREZxvcgvT9QnbWL2sWNQq"
        "tEwKEo6zZyBZgGr7MwcYnEIsBar8gw3Xjkmacx+1usKbIWub+vhaMQChd4dBykdmRg"
        "ra2HATrn45PJ8ZVQxGDPW9UBskiuy0UTf0SfRrl/1xi8khMap2E+qQhV0Uv7t4TAdE"
        "lJiuymNQEPJcVxuyam29uK8QhwMvQY3rTx1lW1Igg1Ojbxin6NeuxS3vqNxMA0SbHg"
        "NgGXEe0UP/lTokx4K6VrJJ8XqUPpOBU6t2UsoGVJALQ+s8g7oK0GNDae6Pf7Og2XSF"
        "zSaIviS21KUfD/qTE6EEH4jlRDFrdPZVtcD/pi+LZ+Mt+NVBVS/XyXeGf5mqJqV1KG"
        "XXmkDHuydMXa4sreHyvLEtga90rYMEJAYnp2f7XTVSDsYVow4RGYfBdybqDS2hcEzz"
        "WweFGey8ms8XiVDTYRIHUcMzAabOAAAAEHRSTlNvBzeBcRPz97q0wmlQFcpeN1sYUw"
        "AAAKVJREFUeJwBmgBl/wDCG/pOjUHG/ut25TFnASTqqRTBQWRHOin0TQgC8j2HTTgz"
        "evPSd8fv+gPXGGnNiM5q9RduZOfGBNXREVus20gdwBOOxToAZ+KrGx+q1gnDpLM88w"
        "GaQWTlVAbQ7/zdRujiAizsn2qkPqC5G5ZP4UADInanSWGa7WBAxk+N0QS2izrgpbUz"
        "JQ0d+9ZRAMEMEF/cpLOJNguyS6jhlErN/MQrPwAAAABJRU5ErkJggg==",
        ((11, 13, 3), "3a6ae7fefb2fadc6420ccdefa892ae09"
                      "4579c5a71a2892139785592b63732a19")),
    "png_exif_6": (
        "iVBORw0KGgoAAAANSUhEUgAAAA0AAAALCAIAAAAr0JA2AAAAGmVYSWZJSSoACAAAAA"
        "EAEgEDAAEAAAAGAAAAAAAAALdIESkAAAGdSURBVHicBcFrb5pQAADQy0O95a1XBAdo"
        "bbFOrYrRFoyJ/flbsywx/WCzVKfpVh8xTEEMWPGyc0ArC6W+TaW0SuGubQpWrZpC1V"
        "tTsrV21Sg4IyVfYfK1G2IkKEQsLgUCJPu3QkXYzWUxwxDeJhN9xez2g+Bz0mp6RWLG"
        "czWW8ZcL42IlXkcxP9fF10UA/TjCiEvBPyFymyLFWYAM3d813ng5HvPrGcTX4VnS8S"
        "xCO8U/rUMoroLtgV7NBzL8hqbMnI+lSQfx399ag+LzBya5WD/uIA99EUQBqAyeujRS"
        "i7ptdpot89p8HMm33bok6JmHq+zd6N6xnaquEKjc2+OJUcp4HhURgE431dMMg8rB9S"
        "/wX7DJNgtnN5mSMkmDE5ee7BuIxbGe855n51VAxbAc3aiUU5KIcFPOW9RehY01Wzin"
        "fr6XclVqtVx23MbpwOziUEgWLpBf6a0I/tItpJ/hj/k4Qfcv7PhLkjg+vuxyvyzBmL"
        "limh2n3qlPbIBHWx7q+lDgWO2pzg3thir0xV4v85Dl5Ha/biGtW5Kyzf+CZ6iDCSuS"
        "jQAAAABJRU5ErkJggg==",
        ((13, 11, 3), "80399c697a5cdfdd4a0cad1a23b3adb9"
                      "bf79c25a2f9e2cce0ba4524ce0b821a8")),
    "bmp_12_8": (
        "Qk3KAwAAAAAAABoDAAAMAAAADQALAAEACACpTe9WOCW97lrPOIKu1WeRPAXinwOlJS"
        "2DuBPrdddrW4bSb5nQRKBUY46s3n9SgnvMWx2JanBMA7ZBaOowLw5tr6o+LgN0a8dM"
        "snyg04/kYVExnBPSmpWv999p0soL0x3N6xUYP06wgMKYy8NmsjO3X8gXbSIv7Y25zF"
        "hjxb3KIKAz87KyW1pqHptwwNAWRAowla9RUqy58ng/w3am9Pk5tTbodERefGsuz+UX"
        "hfNlByTyLDN9fXU3f+3vqh2oJTw+w/EibrFjZalorEW5uddKWK1sMDnMSt1jqtahbY"
        "aoWvgNa65nAIRDIwDkS8ToOqdeiV3yi4AH1AT3GCqFbvOM9LWyhjyE9w7322iT2Y++"
        "DaLs8nFF7CNw2yGz5KMYFsU0MPo4nwjIdJuPClq9Yq85RIPvVy45nUrxyplrOOav6a"
        "t321QySCkSMKnKDpaXqmFv79sVYXrGfIOBbnkPG1LithEmQ8iyD+4bBNpZvh3bfIFR"
        "FiqzUFyfMOzXGS8J5VL/jxA4g/w0lj/+EpV1FQZmCA3XMuEkH/wchXH0xQ0MBl3imL"
        "d76GLEXe1ONera1/RqVRyvE9xQiw3NH4R9COzyYbdbMgW7kmybAz4BLorwTJyB4npr"
        "oxN+KJl05UQ7rGKiDVMgSu5LoGHqFmyUf0TIeBZECR79l3wO6jO9D3bQR8WdyitXeC"
        "j6fmlnqtSxfXYwhu/j7U7Pa+1RoPHb1rPMBAJJsAhnNVCmmf4jZg368zfchmUwhiMW"
        "KkoWeNsgPuUcyY7fhiNIo53JUmKBVvWYeBcck3cxt0xQB06cWRupeybT96E8wGJoUQ"
        "eCMYAHXgsLvCSiwo0vvpVGoPytJMeIiEb3V39VH+x99Y22+B4blndu3O66+VEcs+Et"
        "jOxJoYUWnyu3kjQo8GH9x0pPxL01yiz3o77Bm+PgVoYaeEXzcl4vG+YTIMhyrvoz+/"
        "YoWeeMApZMIRhdZdAqdrcyQBXGBlFm1rL/QAaCC7lQ5uRMA5gk0ITQvmOQu6ea/Xp/"
        "S3kOUgxJCo4huMrx144BAAAACHkgKOxz9yGy7iR5PQAAANbQ9yqySolnhHVtusQAAA"
        "CA76Zj/HQ75q6VL//CAAAAAOlcGZIf70sf6rr2BAAAABRgrd+wZCNLn12RM8IAAAD/"
        "dPYozSwa5zJyVwfgAAAAs4Tx/8Xf06eBU3bBMQAAACncNZaSv/zpTZMnaNYAAACN3e"
        "xHZTvIuc0CDiIfAAAAtJFJFCtJ2JJIU/jagAAAAA==",
        ((11, 13, 3), "4c699d3114fc9aab46a7f1e02143fa73"
                      "10aeabb17712d98f17d761c793106764")),
    "bmp_40_1": (
        "Qk1qAAAAAAAAAD4AAAAoAAAADQAAAAsAAAABAAEAAAAAACwAAAATCwAAEwsAAAAAAA"
        "AAAAAAqU3vAFY4JQAw0AAA1xgAAFGYAADH6AAA/yAAAC5QAAAGEAAARMgAAFsYAADL"
        "sAAAdZAAAA==",
        ((11, 13, 3), "9d3feac70118650c0927f18e8ed5ea8f"
                      "554f73db379d65839e5b58a6b6634bdd")),
    "bmp_40_4": (
        "Qk3OAAAAAAAAAHYAAAAoAAAADQAAAAsAAAABAAQAAAAAAFgAAAATCwAAEwsAAAAAAA"
        "AAAAAAqU3vAFY4JQC97loAzziCAK7VZwCRPAUA4p8DAKUlLQCDuBMA63XXAGtbhgDS"
        "b5kA0ESgAFRjjgCs3n8AUoJ7AC93fnMa4yAAZ17C+BIGMAC3w/+js0fgAMcEGpOlV/"
        "AAosvzVbkW0ACyYY4ly7xgADHIvMk7bFAA36zWHQHsQABI2lbhk5nQACOqYCPGd7AA"
        "FcdosE5kAAA=",
        ((11, 13, 3), "61a1d3841ac18dd4de089b9850f958f8"
                      "cf2dd323c5f5708ea95d83304d6e58b3")),
    "bmp_40_grey": (
        "Qk3mBAAAAAAAADYEAAAoAAAADQAAAAsAAAABAAgAAAAAALAAAAATCwAAEwsAAAAAAA"
        "AAAAAAAAAAAAEBAQACAgIAAwMDAAQEBAAFBQUABgYGAAcHBwAICAgACQkJAAoKCgAL"
        "CwsADAwMAA0NDQAODg4ADw8PABAQEAAREREAEhISABMTEwAUFBQAFRUVABYWFgAXFx"
        "cAGBgYABkZGQAaGhoAGxsbABwcHAAdHR0AHh4eAB8fHwAgICAAISEhACIiIgAjIyMA"
        "JCQkACUlJQAmJiYAJycnACgoKAApKSkAKioqACsrKwAsLCwALS0tAC4uLgAvLy8AMD"
        "AwADExMQAyMjIAMzMzADQ0NAA1NTUANjY2ADc3NwA4ODgAOTk5ADo6OgA7OzsAPDw8"
        "AD09PQA+Pj4APz8/AEBAQABBQUEAQkJCAENDQwBEREQARUVFAEZGRgBHR0cASEhIAE"
        "lJSQBKSkoAS0tLAExMTABNTU0ATk5OAE9PTwBQUFAAUVFRAFJSUgBTU1MAVFRUAFVV"
        "VQBWVlYAV1dXAFhYWABZWVkAWlpaAFtbWwBcXFwAXV1dAF5eXgBfX18AYGBgAGFhYQ"
        "BiYmIAY2NjAGRkZABlZWUAZmZmAGdnZwBoaGgAaWlpAGpqagBra2sAbGxsAG1tbQBu"
        "bm4Ab29vAHBwcABxcXEAcnJyAHNzcwB0dHQAdXV1AHZ2dgB3d3cAeHh4AHl5eQB6en"
        "oAe3t7AHx8fAB9fX0Afn5+AH9/fwCAgIAAgYGBAIKCggCDg4MAhISEAIWFhQCGhoYA"
        "h4eHAIiIiACJiYkAioqKAIuLiwCMjIwAjY2NAI6OjgCPj48AkJCQAJGRkQCSkpIAk5"
        "OTAJSUlACVlZUAlpaWAJeXlwCYmJgAmZmZAJqamgCbm5sAnJycAJ2dnQCenp4An5+f"
        "AKCgoAChoaEAoqKiAKOjowCkpKQApaWlAKampgCnp6cAqKioAKmpqQCqqqoAq6urAK"
        "ysrACtra0Arq6uAK+vrwCwsLAAsbGxALKysgCzs7MAtLS0ALW1tQC2trYAt7e3ALi4"
        "uAC5ubkAurq6ALu7uwC8vLwAvb29AL6+vgC/v78AwMDAAMHBwQDCwsIAw8PDAMTExA"
        "DFxcUAxsbGAMfHxwDIyMgAycnJAMrKygDLy8sAzMzMAM3NzQDOzs4Az8/PANDQ0ADR"
        "0dEA0tLSANPT0wDU1NQA1dXVANbW1gDX19cA2NjYANnZ2QDa2toA29vbANzc3ADd3d"
        "0A3t7eAN/f3wDg4OAA4eHhAOLi4gDj4+MA5OTkAOXl5QDm5uYA5+fnAOjo6ADp6ekA"
        "6urqAOvr6wDs7OwA7e3tAO7u7gDv7+8A8PDwAPHx8QDy8vIA8/PzAPT09AD19fUA9v"
        "b2APf39wD4+PgA+fn5APr6+gD7+/sA/Pz8AP39/QD+/v4A////AOZMAOOdsfZux4bV"
        "/bQAAAAqkkqa6U/+lT0uV+rvAAAAAzuCoZ0ftsLzwJTevAAAAOmZW4wagASFaTjPTo"
        "EAAAD6nOIaD3aXMHwk7BGPAAAA9g9OfUKuznL4uSqoYgAAAOHLU6UDtythLUM7vZgA"
        "AAAV5gLDCKFDe2BfNFp3AAAAb5DLoBQIJTDfWk370AAAABAroqRp96chtKaWNEUAAA"
        "DF1wsoFpXwKAxOUe+IAAAA",
        ((11, 13, 3), "979d2c4e31d4e74e5456d630253f38f8"
                      "63910f1c14d3fff4f5dfe532fdefbc44")),
    "bmp_40_555": (
        "Qk1qAQAAAAAAADYAAAAoAAAADQAAAAsAAAABABAAAAAAADQBAAATCwAAEwsAAAAAAA"
        "AAAAAAZr4XB9MtouT+cDbR2HTkk16y/cPIRxIKB4sAALqqo/BGEa20ZJ94H2sy3f67"
        "XpqXmiyNKfd+AABuDbjarb6olEDVj22YbT9mpn1521srer/o7AAAkbGQpNT1t80M73"
        "N0EUyP3ewRITKeDTd79pcAAEHxS2O0IHGwOZUjxwK9EiqlN94WEtNSU9vAAAB3HVH5"
        "QsaKSmKk8VusTXTZpKHqjBd3WBAwswAAnrcF42Y53XFsXLaMbKzXeTm2ZLLcPK9bdc"
        "8AAEf5VTtfXIH9YykimvqXEmNjnr6V9lw6XGcBAACcuV+UDnefWBjjkfkfXH9Rsoa4"
        "K29TXZyGiwAASZOzO8nBSJwklGAWGEzVl5KN7pClQnbfnW0AACG2vEfeII1BE9C13e"
        "UOnheqbU6GLVgEmZi6AAA=",
        ((11, 13, 3), "4d1e3171caf6d525a9a0e7a0b4648606"
                      "d46164c798d3c5d5f4a7a9985a6afd9a")),
    "bmp_40_565_bf": (
        "Qk12AQAAAAAAAEIAAAAoAAAADQAAAAsAAAABABAAAwAAADQBAAATCwAAEwsAAAAAAA"
        "AAAAAAAPgAAOAHAAAfAAAAN9KLBBP1LSjShWK2ekZyf/KJUVipllro6GEAAGJXE6VB"
        "Tk7bCiNY2cR3gBpHhm+K+UopGMb2AACNJWAkwLp4hLwGykRSV9Kra0oEBBuqMgbvOg"
        "AAwRxUS+2PR2fgvlAHra9avxD8zGjzMFYwa3oAAPwwSyr/UzVZZxZdDRhv0x63lYPB"
        "IIcqrHfBAAAFrYG2zNKZngNzft1EW3PR+WgLJsGnI5b6YAAAE3xLEmkXMcY0WaiL1m"
        "rsLxhZoWm2NAUMGgwAAGzByxdauuMTDfdgemKwUa/EQhArYz0l1uByAAB/ytHk4meO"
        "deGV0MdyBu07xYc4XA7Mm6DTDwAA1RFyyxv9RHPN9XBj/TfpaRqJl5ImFx13QF0AAH"
        "fnWYpsohO+w37I1qQVKyd1u7OtKNppGLpdAAA=",
        ((11, 13, 3), "555481778ac8af74288989f5c8641b5f"
                      "5499465a51257ab3ba6e06b888c91c14")),
    "bmp_40_24": (
        "Qk3uAQAAAAAAADYAAAAoAAAADQAAAAsAAAABABgAAAAAALgBAAATCwAAEwsAAAAAAA"
        "AAAAAAJxe/uXyoyWUOrZdMN89dOX/zEvaldJwM6htf8kAg8vn+Ma0UdXyXAJLaGf7b"
        "AhtFhSRZKWb/MDozZbL1pQuRVqVeY+I8YnwXfXVDYYfkiABUv9ONR5vsWmttdspsj3"
        "sLM4RigZV5xa2ayWR6LN0w6oJNKvpDcpUAiA5ephn9LwtjnazgV+cfxXz8AQMKkT0P"
        "xS3oJpieuHjgQmuP3IcVADjP86aWuNy6nuAtupVbRz1tybblwPcj5HQsu1ZMx937dY"
        "oIa4RY0wC126BnhkhInHDJNi/MtbvdefXfB4R4wBD0mtWA8Z4QJjZhDiehgI4Ae6Ar"
        "27xw+Co3fLapCgBXqrtUIlm/DxxU3nC5lMnkDD6XzSC8N/HPAG3NAUf69XIqJEgNVo"
        "5Lr3WV05sLnZIf41ym1rQ3sbdvivjEZ//aRwBWmFxX5M6NfrBv4vqpFAQdagSm9rgs"
        "Aihq52UaIdE0qu3lvXgcwpcAHgfK0Q2y0x7rRbHRpof2KzpwT/zcdAwNEF9zx8uDpW"
        "Dg8R56xL/rAIDhd4o8YbK26CrVpjqFMJLcPzgDYMqsQ+xph1AV6KmW20b2XIGt2gA=",
        ((11, 13, 3), "5954a56b0531c14f1c77c07ddc9c60b0"
                      "043fdf11ad995783672662c2e387744d")),
    "bmp_40_32_bf": (
        "Qk1+AgAAAAAAAEIAAAAoAAAADQAAAAsAAAABACAAAwAAADwCAAATCwAAEwsAAAAAAA"
        "AAAAAAAAD/AAD/AAD/AAAAPSsfwb+VoAxDbhUQADKBX8TowNzgKZqke3r7s1wDBokM"
        "YgI2kn5WC0oGnLJU+x1LQYpvqPVGsTtTCbmnWXKD4Xup/sEVODxmWqD4Dd9KPouX2d"
        "RIci4DiE25tnZI+jrMJQtA3oj0ri/zFr2FUD8rHApFaiQWssmizQtqwN4X1VgN0reQ"
        "PJBFI4Ve7HtGhg9Z8auU0RHq0QiwnbwIlqftxsM/kMfdQPneACpQjhK7zhxJ3Ly8QL"
        "tn7uHHffYMsH5UapM3rFiXUqv8OdYl8bVPZjzdC5phdE7bLWCoP2j19iSLlUJ43rtt"
        "fmqim05IVCQ92IA9OTNtsBZ6jlRcDovrRCabCCaHsEtnW77g4iChkavn9zwb8PevHz"
        "ouPapZg0HWz3XgCS7enMP5w22k/2seszqexzyZWA/znIG9tyVafX8ch06/QeP1o8RV"
        "CfTrKdLPGvrAcvDrS49osFZPaFcA5oqwj6YPnui9hWdTi0Xu0+I6/+WujpAr31JYE0"
        "iSEL8OVmXq1Zl+virgeKc/8lEOeNtDEtMxfQMYWIx6+NZg+1ECSO8WM88IS4E8ED6D"
        "af8YBpagxLl8twDUKeyrAD3Ia1JQpoRKlfpSrxUqll44GQvs2+Yei2xkJM5fCA7lDc"
        "y35mTRy4bcl4zGBfbNlQCoMUmtEXiKtc6y3p1T22zmPc8836Mc687+JFpnbsKDrPIb"
        "CZfn+kEQFU7eLOyNs9yeQXllssarLUP+Xgkb6w8wHXY3InPlA1vGMd9tQ2c=",
        ((11, 13, 3), "34ff7e25f4c4ba1dc58f7a1147a98e1d"
                      "c861af657051abcfc9d31c2cd2f95159")),
    "bmp_124_24": (
        "Qk1CAgAAAAAAAIoAAAB8AAAADQAAAAsAAAABABgAAAAAALgBAAATCwAAEwsAAAAAAA"
        "AAAAAAAAAAAAAAAAAAAAAAAAAAAEJHUnMAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
        "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAEUwc54/dOn3sES"
        "MfITLVHp4N+9A3ewGf9pcycG4NDMW42sLbrb5RABbVHRLTmiVSU4ZT28DEQZGxvpWQ"
        "pGNC1PXRJrfNl+YM7zGUc3SqrACA6EHx8cxLY11jtCAhL3GwdIw5lTkEI8f+FQK9HD"
        "MSKq2IpTdKg94AXYpKmzxipLsS8VvGdaxNY1F02T1epKF/AOqMjUgXd35ZWBDUjDCz"
        "AGysm7LXebKCObZjNmSybErcPDTgr1tuAHXPEHJ3HTOTUflZDULGAQCV4fb2XLwoOl"
        "wWQ2cBAIeet3EDBeMn5WY5MmTdcR1dbFwbB7aM11gAZs1H+eaqVTuqIF9cjBiB/TSn"
        "YylRZiKaqzz6l/9JEmPYSGOexmC+ANWfWPnqGOP8NpH5a5QfXOGbf1GwuLKGAJu4K5"
        "kyb1MtrV2c3RaGiwAYTB0i1ZcWdZKNThbukAWgpUKFtXbfKnedba/1nLmBGV+U7HQO"
        "d0sAhpXILVi2vQSZA5+YuhNlSZNJsrM7qKDJwcldSJx24SSUiFlgFntEABtNIbZ5or"
        "xHAn7eIMmOjUHQjhPQlKy13SgZ5Q7pTZ4Xe2OqbaNgTgA=",
        ((11, 13, 3), "3bb4a530e7f93ac5d9f9ea7e9f87045a"
                      "57fa1367bd6a601cc50fae04cd14edec")),
    "bmp_40_24_topdown": (
        "Qk3uAQAAAAAAADYAAAAoAAAADQAAAPX///8BABgAAAAAALgBAAATCwAAEwsAAAAAAA"
        "AAAAAAqn9TUfv7T26vxHL0p1qhzJl3rHj03OnOAgF20XkIhj86JmZNr+/EAPq7tLKb"
        "Qr/CiphmCUNSwzEewqWwVRWTjl+oyAxrRy6AZbPADGyfUQBwZ5cgxgwHPtVyNzV8uz"
        "IQcnoxoR+VJIZ3+e3UalHqejt/tZXEeEAA+BE4EYDt99UHCLLOpM7Ajmq/6xhb2YuB"
        "txlyRGD/akOEYQPzJb5aAKPA+mjZ70XeUfyvRvGtZbH/80Ssv3d3OnPfiHyYe13YT7"
        "7oU+4ycwCt4BOZyj+EiEbyL+QWJZxXk6gdgdEF/CC5bFtMPtkVBzT+C6hBmesA/gLC"
        "9GrsIgR65McmVZdXPKg7lZqghP2SHI13fwc8bUU713CIenSuAK4dlpdm9PDkGA1iPD"
        "BoxojM5f+B64taTtXwLadpn/8oaG+RLhLjkgB9Ra3ARnqBgXZCO+eIk6AYXrDN0w+t"
        "ajO7dB7eTTHm/Za5TSC7snoAvHX3NkknnmUcfN7I06FKQVWn4slqfZWuC5mH/blRjs"
        "LAEum8m2onAKJqiYFBEq3wuxAcEbqidpcMh41MbSj5B1aWR5YugQKYnP1ZstSG1wA=",
        ((11, 13, 3), "d6fb794d69dc6633de2df4b1c9a67d9d"
                      "958610a8919b84ff6b97848011477848")),
    "bmp_40_rle8_delta": (
        "Qk20BAAAAAAAADYEAAAoAAAADQAAAAsAAAABAAgAAQAAAH4AAAATCwAAEwsAAAAAAA"
        "AAAAAA9G5RAM54zABNP9EAipv6AFUeQwBla18ADGdsAHq7cgBR+ZUAOHh/AMCy9wBy"
        "i+sAWgNqAEbeaAA6rLEAU9h8AEbKrQDRkxYAND65AOwCQQA7l+QAPI2EAJZ01wDGYv"
        "AALVr/AJKR/wDngcAAM9MYACD93gAcSbwAalXTAMC5CwASapsAh6IQAIGWKADzhv0A"
        "+VynADlHpwAbpaEAqusJABqzoAB2cL4Ax2etABMVCwD3X54Al4jYADOe6wAJwbsA8C"
        "d4APGNCwAROwMALnZnAHhhCwCOIEQAavJRAJgpdADVUKsAZk9QAPJ1MwC31jwAIIi7"
        "ALB4EADhSo4AYR5PABr6AADKvXQAGmfVAIUbdQD2V0EAZEP2AOWFdwBPoHIAy7tLAE"
        "1fDQBwluMAbTfhALvjPQD24ggAjtKzABcfjQCQKmgAS6miAKoQvgCDbDcA9fe8ALAc"
        "cgAENQwABlfKAO7y/wDJHsMAev02AMFh2wAcf0sAdka2AN859QCu3joAvj19ABdDFA"
        "Ci20IAR5+dABzohABg9OoALwm+AD43GQA34PUASGyxAL29zADQtQUAcEb4AGbHQwBF"
        "EycA3aadABJCqQDExeQA9OzEAExrzQD2JIQAbEBwADu/SgDB6C0Ai3L+AC8VaAAKvI"
        "4AIxRBAIHpLgDhGOMAijl6AG04vgDsyrcA182oAGAJMgBwsN4AWlX0AEs04wDeCmYA"
        "AzFJAD/o+gBsKrMAn7DfAGepggBmZ3UA+x/TAGLQJwCybuoAMSAlAADlwgAMep0A19"
        "daACmeMgDbSUMAcMrfADuOqwAso9gA1jScAIi2PgDPbyAAgZhbADdhggCXR6YA5zhC"
        "AIukfABiYj0A7F78AL9NKgB78lUAfBVoANh43AD4MKEAoVmEAC05OwBdF/AAs80lAP"
        "EylQAtxZQAuMFdAE/mfgC0tLcAhwaZALKjDwD4wiIA/fVIAAxSzAAfaz4AP4cAANFL"
        "PAAidR4AO5FPAIj++ADLGuMAEDJkAD1rUQDcFw4A3Zq/APN2/gAxT2MA6jo4AGWhCg"
        "BCDokAC8WcAK2wfgBDkQcA4WTMABCteABz90oAeSK8AH9IAAAzuV4ArX0SAFaX/ABN"
        "bJMAj4AXAL6MxgCWyqAA/gIyAIR5NQDIIGcABqV0ALIJoAAf/xcAjsf2AGWKqQBn0C"
        "YArr0WAEEaIgDUz4cASEA5AKloMQDSvtAAP/SRACBhYwAYx7wAYx0MANBwcwAksDUA"
        "vCESACzrlgD4QNoAo81yAM2+tgANmnAArZ+NADDtuQAoL2gAZILDAP772gAO+o0AOI"
        "rkAFMiBAAPYzAAXwmLAKAU/gBLmGAAS31tAOrimAB6mX8AJclGAAQnAAaVZDLy09MD"
        "KwAABTEF1gNUAAAEHgAGX3jc+Y+PAz0AAAXoBSUDqQAABMAABn8AJC4kJAPkAAAFUQ"
        "XQA2YAAATZAAZx9lVk7+8DPgAABSUF4gO7AAAEMgAG7Rif1wsLA1YAAAXMBaMDDgAA"
        "BO0ABjiW85ghIQP1AAAAAQ==",
        ((11, 13, 3), "6edc81c4bf05aad16a6af33d7e3e8167"
                      "0a68175d6ef5beb0eccbed7bc27484c9")),
    "bmp_40_rle4_delta": (
        "Qk3iAAAAAAAAAHYAAAAoAAAADQAAAAsAAAABAAQAAgAAAGwAAAATCwAAEwsAAAAAAA"
        "AAAAAA9G5RAM54zABNP9EAipv6AFUeQwBla18ADGdsAHq7cgBR+ZUAOHh/AMCy9wBy"
        "i+sAWgNqAEbeaAA6rLEAU9h8AATMAAOCkAOIA+4AAAX/CJkAAAT/AAZhGlUAAyIAAA"
        "X/BWYDzAAABN0ABgvJdwADmQAACogDMwAABO4ABh1WmQADMwAABUQFAAPuAAAEuwAE"
        "8rQFMwAABREFmQPdAAAEqgAGHT3MAANEAAAAAQ==",
        ((11, 13, 3), "bd34f1b98dc2a925648d7e57952faead"
                      "cab9f366d8c14f6b7851951be72bbebc")),
    "tif_rgb_8_lzw_pred": (
        "SUkqAAICAACAAMrCMQgMmHc2iRQMBfBhFGh0kJpvUgqQpAk5klqhRerw/EJvqhRDo+"
        "C00htuJcksELK43gJrHIYDxeiBlLZng03jQ5tkWEJXi0XCg4mYrptrEprKoVPgPkZj"
        "kRjttTK0pDhgmI5H5ck4yoRGIAjJxIkoziUXl5EjZEExqKFGnUwPkTMh1At2PxUjpS"
        "pQlPMnFNxGdsjsKtNQlZALAJmhznZBENtlcYkpnspNHdSnI5sZkA97ENEgtOJoAMAk"
        "D9fkQPIt4jkCgsJjleHxzNNOH5OOtCnZdp8zHddEp3A8CCVCIcAIMGn8zmE+qAhgt+"
        "FwFBB8I0Uu0YnNtrFui1TrJ6ioqNATus4u0+JAKqN9hx9JtjCpTIxcvMluQ5jZ6GKM"
        "YJDoDxVkCPZfmudwTliT5TliDoyBkHp1mkPAQFGLA5BiJp4FcRpOkIA45nsHBCGQGQ"
        "UgUVpACONQLn6CIEiCBoLmyIgogCVhuhoSY9EMY4dE6XhKAeXxyBAepQhGHY8hAIJC"
        "wyCRrgwfpUDoXZLAQKZ9BINgRnKD4nA6SheGiSwoDQYw6EWT4oC0LJhhoOhyhMXwzC"
        "kEwJgCaI9AQfA5hOU4XHgPpdAQLoOBoWQjA0OZQkueJok4FxNhORJAkqXYABOUwFgk"
        "EhOHOKIkiMNAlmWcJEBSHYsoCAsAAAEEAAEAAAANAAAAAQEEAAEAAAALAAAAAgEDAA"
        "MAAACMAgAAAwEDAAEAAAAFAAAABgEDAAEAAAACAAAAEQEEAAEAAAAIAAAAFQEDAAEA"
        "AAADAAAAFgEEAAEAAAALAAAAFwEEAAEAAAD6AQAAHAEDAAEAAAABAAAAPQEDAAEAAA"
        "ACAAAAAAAAAAgACAAIAA==",
        ((11, 13, 3), "3e7835db59ebc0e03b60fb222ab22618"
                      "428ffae1e3be2d60e502b16504c2ebe7")),
    "tif_rgb_8_deflate_pred_strips": (
        "SUkqANYBAAB4nAHDADz/FYENDPyYgiK56kChv0QV0CyiyqGYNYozX8XHsDtdZESwjx"
        "V/IkcETMEKD0JZFzP5+3S4nh+EeHvXNBrrwJf06rndIYO/UOlq9i9HxVJiR2MWhzFS"
        "11qS03uSQvM7ORfQqrJQtZyO4eNpcEYNYKDBhNWtZMF4/8e1ZxxTqu93jFZ16mTAq5"
        "HVQgt6bBTgCQyE+NqyWveuoIXwqM9KpR6s5wl8xCwv2148XHSuz9y7YSGw4tjDd3GN"
        "4uEPurrdYDJ61kkctMZkBHicAcMAPP/mMrfl+R4ndHP4YXMiBuqXG2eC+XL+CABmxi"
        "LDVwQUoOqGVqIzlaE/QOUb+erLYrjCsEweVWeDbCGZi1N3GlRH+tlT5eAcDXnh5R+Q"
        "v1LpKMYZmxPEfBtpq100y5BneLCvPM3+Udegrh/x8tLZZVMRv9ZtulUJcHKqlyPjbm"
        "xZ+UEaMzS7EhVGU/teDjxKxXrT51UCuEhAunNpnJOsZ7ed7RsZ1VHwYJkljQgzfBfA"
        "9IgzUhdcEGm3NO2B3ReT9bsVWvDE3V8leJwBJwDY/2tAPofCe11kdF2iN9iCFCynD+"
        "Zfb3l9iaG6XuhAOCSurNH898LDX2ZRE9sLAAABBAABAAAADQAAAAEBBAABAAAACwAA"
        "AAIBAwADAAAAYAIAAAMBAwABAAAACAAAAAYBAwABAAAAAgAAABEBBAADAAAAZgIAAB"
        "UBAwABAAAAAwAAABYBBAABAAAABQAAABcBBAADAAAAcgIAABwBAwABAAAAAQAAAD0B"
        "AwABAAAAAgAAAAAAAAAIAAgACAAIAAAA1gAAAKQBAADOAAAAzgAAADIAAAA=",
        ((11, 13, 3), "1246775c1f198c268b33e0328d52f9b2"
                      "db475bd567b9190b13c723b18afb0e30")),
    "tif_rgb_8_packbits": (
        "SUkqALkBAABEA1YjJFlvm8aTO4ZRUxC5PFKMMZMwg5yjzHG3iS01ywzdbUZZmq903J"
        "dJna33DK/Nft8JO//T8c7gYAJTOS6V6FvDEMwp/2d//7E9qds1yEbHRA2i6rr0IntW"
        "lPkP4l6Tbt7ZCm8jcZRSzx2IV2lc+PbRWO/3IOoL7Oa0JotIcH6Ww2D9nJsSbzxo7+"
        "x7V9Px2RbMMEcW/xGwdrYi6cbID7wLmMenMsdnegYmviSxr122unDvduzVSYhT5XPY"
        "Wy53waUxC+4PBBN/k4sTFpiSffkPHTwaGZgkKZCxUn3ixViTooU6VHpkqEqLk7vtfJ"
        "ACH4seGSbkQ8xw/L+74DLx1PdU5mtykeztUMPbd3R6HiWXglc969K1C3UNfaZabVTn"
        "Ctjufc4mAZZYKqAFqudvweSAyiWN4f7RMv+s3TQ/V7oGkVfCJWaACYZldaqpsCPJ8a"
        "ghY7r4e7eg73I298UwGzFT5R9OArMK00laOw/Oxq4eIAfhVHvGejkszF8/zTC51Sgs"
        "/M9a7EwUCF0cPA9iVoID7XPUiaFvsCrwReXwbIv7fq+XZQDgq2grdkmzn4QMCgAAAQ"
        "QAAQAAAA0AAAABAQQAAQAAAAsAAAACAQMAAwAAADcCAAADAQMAAQAAAAWAAAAGAQMA"
        "AQAAAAIAAAARAQQAAQAAAAgAAAAVAQMAAQAAAAMAAAAWAQQAAQAAAAsAAAAXAQQAAQ"
        "AAALEBAAAcAQMAAQAAAAEAAAAAAAAACAAIAAgA",
        ((11, 13, 3), "3e7835db59ebc0e03b60fb222ab22618"
                      "428ffae1e3be2d60e502b16504c2ebe7")),
    "tif_rgb_16_lzw_planar_pred": (
        "SUkqAOMDAACAAESoANK0GI55Ls8HFQklALBFs1VAVzLN3CULGgMjZNIgbEMfh4BFkb"
        "gobDkblwymE0NRbM5OKITu0pGAGL0vEBSNpBicxF0NKIqJpHnBtHh1KIGj1Ys5bNBX"
        "nkarEZnonvB1pcjp4Hpx8pY4AwWpRoLc9PQLANNJ52sI3CkwjJWBh9nAbHkUIIHsgm"
        "v0vtlaIdEggPu4HthOBRUEtRtxHpU5uQukJDm8kvIAqRssFxhgli8IvVdH5fiYUkRt"
        "kIwI0sPJ0JMOh8ygMEAQbBomhkTlpTn5CPstk8pBsTDd7sAvFJHrhHrsbAtIGBEJEl"
        "mlpB46tcju1BgA8B8KlBmvNkgBwPpEKJQBAvqMvmtep1bhUAtUTDtvlx2MoDqV6CGB"
        "ggkwGxLgoZg2CgZRxioVJnGgI5RkGIZFgIRYsiObpZkwOxFDsQCAgIA3XKyXcOAyiE"
        "efigdk6lH29QANXa4EIREYIyqzEmZzWKD4ZnwXGIpEkdAsZ3al3CthqnE240aGRAil"
        "4ThQYjs+huDmmoACJwASXAbR+dicDmA0QQ30ufmI+gQ2hKOHwywopVaPjKum8UlyAB"
        "ATwoLUSN0CZF4hg+LQqnQ67gC/3ajw0MV8dAGpn8ewwlGqkWokHaTwQ3VmYWSLR+Nh"
        "u80Qew8uC0o1SzFS7WE8QOCnyb1WCGsC3g6gghzws0GmQs8j6lFy/iOLBGyh2Mw8vF"
        "g1hqFV+MhU7Us8HA41c/CAPhCaH0GUW034FgiqWcOnWZiAjkW2RQqQ2DhSpy4qzkCS"
        "GywYShWxEqfg+/m+1WO8w6Tnq2AyCEaEFmZBely4CQqggXYFE4WxCnUKYlCILohAYd"
        "QZFMOQQH4QQQDyCplFkKwtjiNYtICAgAMczBTCAZafXKUf4XD6/Z4zKZlF4PVyVNRU"
        "HxEc73ZJnASAKoNNoeNTNdKwML2BipAywJAYC5oCaneBbWLKCoAHART4QQTLYxuU5d"
        "V6jBIgeiFTAqEbsV6MW5mC7XXaeHzFaqWOQUOINFQTPIIKAJNrZQ6LZrvfT5eAlaoR"
        "QxFSKgNgwdb9MxHAyWewQbi+WJRSwhYAgXZTC7eR6fKQSXqkVJdHbCBpyLTaTqZR4L"
        "f4cIwTBZgFYDDAjSRXapyOI+eqaEhRaQvECARBsbLQSZGGzCHKHM6RbiVJbtLYpcoI"
        "fbxJpSTC7DRbd59bx6TJbJ78bptcweMChAzSAQ2FgTRgEfAmCikChrY4iWomZxmKZG"
        "OYxcJtXpYMxCb58DhShGEo4EWO5tBwKxuG2XAtjgd4YDqaovmkSAtEuM4hBUGYgDeK"
        "poBKgIALAAABBAABAAAADQAAAAEBBAABAAAACwAAAAIBAwADAAAAbQQAAAMBAwABAA"
        "AABQAAAAYBAwABAAAAAgAAABEBBAADAAAAcwQAABUBAwABAAAAAwAAABYBBAABAAAA"
        "CwAAABcBBAADAAAAfwQAABwBAwABAAAAAgAAAD0BAwABAAAAAgAAAAAAAAAQABAAEA"
        "AIAAAAUQEAAJoCAABJAQAASQEAAEkBAAA=",
        ((11, 13, 3), "791500f6df51ed3633618bbb4799f524"
                      "9320bb3908260b542bee74939282d5e9")),
    "tif_rgb_8_lzw_tiles": (
        "SUkqAEkCAACAIsvDdChFSsh5tVxDF3DFhKwyCwVuJ9pEPKF0r0FHV1hsCFNEo15BwQ"
        "MkiuQASmVSoKsZ/CdvNMBPtoMlzmxMD0+ClPhhfmMxD54N50p47pAHANXhVUrc4IFG"
        "CNKyuqJkcPgLE4fiYZBomj1TrgUC4+ko4IJHJIbqNjNoKCVcnV+PAZpx3Lk8FsnkKq"
        "SsCCNgNkinsbml3pxDN8SAdRHwcjlhJ1bs1Qn9Lq8lOZPOUXq9vCdSh5xhl132VH4n"
        "i55OIEDoTGFODMsBJxLBUFgNFAxJYin9bj1QPc1jFsNIAItpO9kMAYjjTSlgoAKhNI"
        "gB0sc+BFHgUDNw4KxuEcjhUVuBQm1RnE1mAMEYTGZulhfGY2uwL88AG84OY4Jp1GAC"
        "ooGiEQMHSIx3DgQ4ZEMYJoDcEZ7GEfh7B0PRSGoKw0iwAZ8kceQfvwFpZCYCxZDKaB"
        "QkcVhZD8AB3gqcYVGsDBbAgNAfnqLBTBuGoZBGOJdBEIJWF8cIVkc/A7BydxqmWOIU"
        "CqJYZBmSxLmcP4/H6AZZCOIAFgAHQMG8Rxbk2CY7h+KRDBKRg0A0ab8HYKAaCoVwiA"
        "QfQgjKBgAC2bogCkBxWmCURoHWDwZiGdJqFeI5lm8UpokYMYRmcH5kPwAxCnONp8EC"
        "Ixon8SpOE2LpSmyNgmBEFB6jQfIGGYEJMm8LQnAeZJ4joahxgOeRWhe/Fg2FYdiWLY"
        "1j2RZNlWXZlm2dZ9oWjaVp2patrWvbFs21bduW7b1v3BcNxXHclkoCCwAAAQQAAQAA"
        "AA0AAAABAQQAAQAAAAsAAAACAQMAAwAAANMCAAADAQMAAQAAAAUAAAAGAQMAAQAAAA"
        "IAAAAVAQMAAQAAAAMAAAAcAQMAAQAAAAEAAABCAQQAAQAAABAAAABDAQQAAQAAACAA"
        "AABEAQQAAQAAAAgAAABFAQQAAQAAAEECAAAAAAAACAAIAAgA",
        ((11, 13, 3), "ec0d817402ec762c8e070701e9b63bd2"
                      "7a3f58843b5081efd47ebe1e878f11b5")),
    "tif_rgb_16_none_mm": (
        "TU0AKgAAA2IDX1b/I1ckIVn5b0ybvsYhk787SYbtUQxTlhCQuXQ8pFI9jGIx1pN7MN"
        "eD2Jy0oxrM7nEMtxKJrC02NY7Lawy43S5trkaNWWmam6+odM/crpe8ScqdOK0h98oM"
        "9a9CzeF+T99+CQw7df/p09Pxh8544M9gJQIVUwQ5kS5Klbzoils0w04Q88wKKQhnaG"
        "eD/76x+T2TqTjbyDX1yDlGqcfhRO8NQaKl6kq67PS/Il575VYrlKX58A/K4vteDZMM"
        "biXendkUCqZvJCNWcW+Ug1KlzxYdmIgWV6FpCVzW+Kn2CdEUWOjvafcTII7qLQs97E"
        "Tmr7TeJouLNUgmcOp+8pa7wzFgkf3cnJCbdRLSb/48amgJ79rsSnvIV6DTsfFL2RwW"
        "mcxhMDhHgxY2/10RlLBTdku2tiLr6azGusj8DyW8ygujmLXHfqd1MrPHt2dQeqUGWS"
        "aQvgUkmLEoryJdW7b7ur5wfe8UdjzsdtVPSVqIQ1Oi5eVz0dhCWz8usnfOwXKlMzHv"
        "C43uGw+5BCUTNJPtizATIBbJmHOSs308+V0PxR0BPAoaJxnSmLEkiynqkAexe1KefZ"
        "jifcXYWNyTXaKGhVE6V1QdeiVkOKj2SkuLJZMAux3tinyrkNsC5B8Liyoe7BkJJgvk"
        "0kO0zI1wSvw7v7i7IeAaMj7x7tT893VUK+aza/pyzpHu7OvtGFAgw3TbAndcdE564x"
        "6BJXWXPYIwV2I9ausx0pS1JwvAdUUN+X3ZpoxaSm0UVJjnqwpe2BDu/n3+ztcmswET"
        "lgFYmyosoOgFCKpc5+VvjsGT5AeAlsrhJQ2NQuGb/qnR1DKA/2SsKN2cNEA/AldTuj"
        "AGzpEKVwXCRCVLZmmAswl+hpR1zaoCqeCwTCP3yZTxhqjhIVBjLbrM+M57p7eUoI3v"
        "HHLmNrr3HsX4MAgbrDFRU3zlrR+mTk0CYrMTChHT/0lMWmA74A85zqbGh66XHm0gTA"
        "d34QVUL3uixvp6HTmcLNfM+l83PyvN6zAauWDVMignLAL8Wc9PWrzsnUy9FCUID11Q"
        "HGY8pA/vYiVW44JiA27tWnM21FyJXaEDb36wACoU8PpF/OVV8IFs5otF+2p+Za9Zl/"
        "llOwBi4Gqr12gEK0R2DUnCs9afqoTaDNMACgEAAAQAAAABAAAADQEBAAQAAAABAAAA"
        "CwECAAMAAAADAAAD4AEDAAMAAAABAAEAAAEGAAMAAAABAAIAAAERAAQAAAABAAAACA"
        "EVAAMAAAABAAMAAAEWAAQAAAABAAAACwEXAAQAAAABAAADWgEcAAMAAAABAAEAAAAA"
        "AAAAEAAQABA=",
        ((11, 13, 3), "b418dd63117e607e185bfc1d0bc44771"
                      "e0ae64c2b0efc758636ebaf1e779d724")),
    "tif_white_1_none": (
        "SUkqAB4AAADQ4IsIWWBa8C7ok4jU8MngksDYcDMwCgAAAQQAAQAAAA0AAAABAQQAAQ"
        "AAAAsAAAACAQMAAQAAAAEAAAADAQMAAQAAAAEAAAAGAQMAAQAAAAAAAAARAQQAAQAA"
        "AAgAAAAVAQMAAQAAAAEAAAAWAQQAAQAAAAsAAAAXAQQAAQAAABYAAAAcAQMAAQAAAA"
        "EAAAAAAAAA",
        ((11, 13, 3), "61b9692829577107bb405eb0d7181d23"
                      "44f4179d379c7f04db99703a6b74987b")),
    "tif_black_1_packbits_strips": (
        "SUkqACEAAAAJg3D8eHfIkPgQqAnA2Plgc3jO4L34AbWACgAAAQQAAQAAAA0AAAABAQ"
        "QAAQAAAAsAAAACAQMAAQAAAAEAAAADAQMAAQAAAAWAAAAGAQMAAQAAAAEAAAARAQQA"
        "AwAAAJ8AAAAVAQMAAQAAAAEAAAAWAQQAAQAAAAUAAAAXAQQAAwAAAKsAAAAcAQMAAQ"
        "AAAAEAAAAAAAAACAAAABMAAAAeAAAACwAAAAsAAAADAAAA",
        ((11, 13, 3), "5f7fd4741b2fc47b3a876349217dce3d"
                      "947c153af77c3984c0b33c25cf96914d")),
    "tif_pal_4_lzw": (
        "SUkqAGEAAACACNrnEOFgxFAxgBVtk+l0wCpLDIqhAwpBkKwKIZYKt4GMbiJcAQtEAF"
        "AMtE0WnFAIQPtB5IsjoAsuZyGU4H0oOs9CQmm0lvB1M0OCM4n9oCFSLlRBA/oCAgsA"
        "AAEEAAEAAAANAAAAAQEEAAEAAAALAAAAAgEDAAEAAAAEAAAAAwEDAAEAAAAFAAAABg"
        "EDAAEAAAADAAAAEQEEAAEAAAAIAAAAFQEDAAEAAAABAAAAFgEEAAEAAAALAAAAFwEE"
        "AAEAAABZAAAAHAEDAAEAAAABAAAAQAEDADAAAADrAAAAAAAAAHfnWYpsohO+w37I1q"
        "QVKyd1u7OtKNppGLpd1RFyyxv9RHPN9XBj/TfpaRqJl5ImFx13QF1/ytHk4meOdeGV"
        "0MdyBu07xYc4XA7Mm6DTD2zByxdauuMTDfdgemKwUa/EQg==",
        ((11, 13, 3), "bc3eadc34f0ddc98d56af35f2e2fbe85"
                      "7c2d2bcc80c8d98da297a88caa29756b")),
    "tif_rgba_8_lzw_unassoc": (
        "SUkqALQCAACAJhgIERKJUA1dkkrqErsxZiJXpczAsKERVvNLMUqEA+C8BEtPNY3E0w"
        "E1qIVLAMMFcDro3hYNH0xGp5g1PNE2r15k1AEQ5tMdgIjAtprIsEtCFYIuMEM9zDYD"
        "IoBEBAGYukw3n9wJZOvJnFNioQ5qJtJhwu1SGA3KEVB4emZUEF+tx3oMBKwIN4fkYk"
        "h5JHtrjxjFBdBEvoVftQno5zBZTgpbkpOIwDJhrvpYgxBs4lGtmHNrnVyB5lKQ3MB1"
        "qBtMx3jsbjlotAehxmoAIBYHjRDtJLLURsMQvx9iYIM0TuF+BsbGgQn5KnprgRJp8f"
        "lwkvVALo9lkGvk+BdsrZKCchDNeGs2BJwBoOk9aIVFJhVl15s1xBNhCUVtxLJhblsd"
        "AEmQSIyG+XZcB2VwsiiQAEliOA7keYI7HeQprkYOZ6CUGwyE6ZIzmUSx2HuQ4TNqaw"
        "HF4Lh2gCIBOHSeYiB8NhqEoUQGEiPRMDAHJ4iyXQvmMKRoGMMJJD+CpsHQOYqDeJ4i"
        "CYOIjFSNQZlIZBsF8HoLkeU4vgcAxnkqVpSG0fB9mUa4RA8LxvHqQI+i+cp0l0TRij"
        "eLx3HOFgED2Bozk4aJOl8NJemCUodEEQRql2BZhDKIwpgqCx6hiWQLCEVofCCEwxmw"
        "axtG6XhEAyZ5cCWWJfCKdRaDwQYolYco5i4W40D2ZQjFgd4wlwJg9i0KBKA8KAHH2X"
        "BpkiPAIgYegkn2UReEEPBFESFxWlEFoHgSeQ6DKb5rBoA4OFUSw1F6DIfk4U4sOOYx"
        "KGkVYnCgDBUEAaJUhOJYiHiUBlHaEhwlkWQEkUYoXj0fRoCMGRlF+Y5NhMQABEWb5R"
        "AESYaCOYQCFmQAtHMao1CULghHyZAHiiIQ9g8D4BgWGpBE4ChJlQGBbhedptDMgIAL"
        "AAABBAABAAAADQAAAAEBBAABAAAACwAAAAIBAwAEAAAAPgMAAAMBAwABAAAABQAAAA"
        "YBAwABAAAAAgAAABEBBAABAAAACAAAABUBAwABAAAABAAAABYBBAABAAAACwAAABcB"
        "BAABAAAArAIAABwBAwABAAAAAQAAAFIBAwABAAAAAgAAAAAAAAAIAAgACAAIAA==",
        ((11, 13, 3), "32920542838c39d7bea6358da1a832ce"
                      "4134fea681570b6ecb9278a129f41154")),
    "tif_rgb_8_none_big": (
        "SUkrAAgAAAC9AQAAAAAAAANWIyRZb5vGkzuGUVMQuTxSjDGTMIOco8xxt4ktNcsM3W"
        "1GWZqvdNyXSZ2t9wyvzX7fCTv/0/HO4GACUzkulehbwxDMKWdn/7E9qds1yEbHRA2i"
        "6rr0IntWlPkP4l6Tbt7ZCm8jcZRSzx2IV2lc+PbRWO/3IOoL7Oa0JotIcH6Ww2D9nJ"
        "sSbzxo7+x7V9Px2RbMMEcW/xGwdrYi6cbID7wLmMenMsdnegYmviSxr122unDvduzV"
        "SYhT5XPYWy53waUxC+4PBBOTixMWmJJ9+Q8dPBoZmCQpkLFSfeLFWJOihTpUemSoSo"
        "uTu+18kAIfix4ZJuRDzHD8v7vgMvHU91Tma3KR7O1Qw9t3dHoeJZeCVz3r0rULdQ19"
        "plptVOcK2O59ziYBllgqoAWq52/B5IDKJY3h/tEy/6zdND9XugaRV8IlZoAJhnWqqb"
        "AjyfGoIWO6+Hu3oO9yNvfFMBsxU+UfTgKzCtNJWjsPzsauHiAH4VR7xno5LMxfP80w"
        "udUoLPzPWuxMFAhdHDwPYlaCA+1z1Imhb7Aq8EXl8GyL+36vl2UA4KtoK3ZJs5+EDA"
        "oAAAAAAAAAAAEEAAEAAAAAAAAADQAAAAAAAAABAQQAAQAAAAAAAAALAAAAAAAAAAIB"
        "AwADAAAAAAAAAAgACAAIAAAAAwEDAAEAAAAAAAAAAQAAAAAAAAAGAQMAAQAAAAAAAA"
        "ACAAAAAAAAABEBBAABAAAAAAAAABAAAAAAAAAAFQEDAAEAAAAAAAAAAwAAAAAAAAAW"
        "AQQAAQAAAAAAAAALAAAAAAAAABcBBAABAAAAAAAAAK0BAAAAAAAAHAEDAAEAAAAAAA"
        "AAAQAAAAAAAAAAAAAAAAAAAA==",
        ((11, 13, 3), "3e7835db59ebc0e03b60fb222ab22618"
                      "428ffae1e3be2d60e502b16504c2ebe7")),
    "tifsq_rgb_8_none_strips_orient6": (
        "SUkqAAMCAADyjJP+iPU5KNR/tRGrF9kqM3RafhLUCcj2Jo0YqtEvze2FtEJ1oShsMr"
        "xvJ4kNNB5RTTRYZn1bWP0d3ZursCjsgV+i+HnHFiDtnGQd4ZUo1cefqyqatpy51ocB"
        "9/qIwPouMdC7OGVu0b7aagaB8dJ0gw6HlpvuVlr2tjzvqE/PKbldltf6H7SImul3vT"
        "Eh4+NKhGg7h+9ItnTMxAbITWgBHV4oNX4hsFsI2P1viE4rZzHmRrsPKVs8EFP7U159"
        "N20lesciaypzdVtaxNnqyTkaW05O6sQJP1ycbGAZMcxgjcBGt1W0kYGpYICZ5vcqdp"
        "LAGtnYTFMgobyd29/GuiO8UOTcYU0xxs4wB2MAL2sk8IapCb24YSE/eaRwlia7FJQx"
        "TiOjfgc0ApHFJJXgEnVdCRflH+GJxbfpMn5gul+ryM0uru+La2bXV7lUu0QDYJG9at"
        "QvZJ2qslhdcfMdqqSpDsOYixsLvTZwQI5Y+O7bkFp3H47wzKEtAF3QDp/UKt5fvyj1"
        "1J4OX5oOhTG247bpIjEVMYSu+ZrJlHjfg40krO1i7CaaCr7XQbXk9yXAj0NVenPXfa"
        "YWoWPFNlHwu38QfuQBKmvKPOckbyKV255R5kAuR1BgwFCK8wq5ZM4RaChAZWc5LBWb"
        "j7fvp58TzJIIx3gbLMC7ar/IEHELAAABBAABAAAADQAAAAEBBAABAAAADQAAAAIBAw"
        "ADAAAAjQIAAAMBAwABAAAAAQAAAAYBAwABAAAAAgAAABEBBAADAAAAkwIAABIBAwAB"
        "AAAABgAAABUBAwABAAAAAwAAABYBBAABAAAABQAAABcBBAADAAAAnwIAABwBAwABAA"
        "AAAQAAAAAAAAAIAAgACAAIAAAAywAAAI4BAADDAAAAwwAAAHUAAAA=",
        ((13, 13, 3), "8d055d2780d8082ec2992134faef75d8"
                      "6edf6fa1e37a9fa1a84b1d0282d99356")),
}


def fixture_format(name: str) -> str:
    return name.split("_")[0].replace("tifsq", "tif")


def write_fixtures(root) -> dict:
    """FIXTURES as files under `root`: {name: path}."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (b64, _) in FIXTURES.items():
        ext = "tif" if name.startswith("tif") else name.split("_")[0]
        path = root / f"{name}.{ext}"
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


def test_fixtures_cover_every_format():
    assert sorted(FIXTURES) == sorted(FIXTURE_KINDS)
    assert {fixture_format(n) for n in FIXTURES} == {"png", "bmp", "tif"}


@pytest.mark.parametrize("name", FIXTURE_KINDS)
def test_fixtures_decode_to_cv2s_digests(name, tmp_path):
    path = write_fixtures(tmp_path)[name]
    shape, digest = FIXTURES[name][1]
    got = image_io.imread(path)
    assert (got.shape, rgb_digest(got)) == (shape, digest)


@pytest.mark.parametrize("name", FIXTURE_KINDS)
def test_fixture_digests_are_cv2_imread(name, tmp_path):
    path = write_fixtures(tmp_path)[name]
    shape, digest = FIXTURES[name][1]
    want = _cv2_read(path)
    assert (want.shape, rgb_digest(want)) == (shape, digest)


def test_damaged_files_raise_and_never_crash(tmp_path):
    """Seeded damage to the fixtures (bytes overwritten, truncation,
    garbage inserted): every read returns an image of the size
    `image_size` gives or raises OSError / NotImplementedError; none takes
    the process down."""
    rng = np.random.default_rng(0)
    sources = list(write_fixtures(tmp_path / "fx").values())
    outcomes = set()
    for i in range(600):
        src = sources[i % len(sources)]
        data = bytearray(Path(src).read_bytes())
        at = int(rng.integers(8, len(data)))
        kind = i % 3
        if kind == 0:
            for _ in range(int(rng.integers(1, 6))):
                data[int(rng.integers(8, len(data)))] = int(
                    rng.integers(0, 256))
        elif kind == 1:
            data = data[:at]
        else:
            data[at:at] = rng.integers(0, 256, int(rng.integers(1, 40)),
                                       np.uint8).tobytes()
        path = tmp_path / f"damaged{Path(src).suffix}"
        path.write_bytes(bytes(data))
        try:
            img = image_io.imread(str(path))
            assert img.shape[2] == 3 and img.shape[:2] == \
                image_io.image_size(str(path))[::-1]
            outcomes.add("read")
        except NotImplementedError:
            outcomes.add("refused")
        except OSError:
            outcomes.add("corrupt")
    assert {"read", "corrupt"} <= outcomes


def _print_fixtures():
    """The FIXTURES dict of FIXTURE_KINDS at FIXTURE_SIZE, with cv2's
    digests (needs cv2)."""
    import tempfile
    import textwrap

    import cv2

    with tempfile.TemporaryDirectory() as tmp:
        print("FIXTURES = {")
        for name in FIXTURE_KINDS:
            path = _write_kind(Path(tmp), name, *FIXTURE_SIZE)
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


if __name__ == "__main__":
    sys.exit(_print_fixtures())

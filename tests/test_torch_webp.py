"""The port's WebP reader and writer (`efficientteacher_torch/data/
webp_io.py`, `csrc/webp_decode.h`, `csrc/webp_encode.h`) against
cv2.imread and cv2.imwrite (cv2 5.0.0, its libwebp built in), and its
datasets and LoadImages on a split of PNG, JPEG and WebP against the JAX
package's (which read through cv2).

Tolerance: exact everywhere. Every kind (`KINDS`: one case each) is
written by cv2, by Pillow, by hand (the container: VP8X, ALPH, ANIM /
ANMF, EXIF) or by this module's own VP8 writer (`Vp8Writer`: a boolean
encoder with chosen modes and coefficients, for the header kinds
libwebp's encoder never writes: the simple filter, level 0, sharpness
1-7, 2-8 token partitions, segment maps with and without updates, no
loop-filter deltas, no skip probability, probability updates, every 4x4
mode), then read by the port and by `cv2.imread(p)[..., ::-1]`: the two
are equal, as are `image_size` and cv2's shape. A file cv2 reads nothing
of raises OSError in the port (`test_damaged_files_fail_as_cv2_fails`:
seeded truncations and byte flips, each against cv2).

`FIXTURES` are small files of these kinds (base64) with the SHA-256 of
cv2.imread's RGB output: the oracle on the card's machine
(`check_fixtures`, called by chip_smoke.py and tests/test_torch_cuda.py).
Regenerate them with `PYTHONPATH=. python tests/test_torch_webp.py` (it
prints the dict; needs cv2 and Pillow); `--sizes` prints the port's
writers' file sizes beside cv2.imwrite's (PERF.md). This module imports no JAX, cv2 or Pillow at
import time: the tests that compare against them import them.
"""

import base64
import hashlib
import io
import re
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

from efficientteacher_torch.data import datasets as port_ds
from efficientteacher_torch.data import image_io

from test_torch_image_formats import (  # noqa: F401
    SMALL, SUP_YAML, one_torch_thread, weights)

REPO = Path(__file__).resolve().parents[1]
DECODER = REPO / "efficientteacher_torch/csrc/webp_decode.h"


def rgb_digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _cv2():
    return pytest.importorskip("cv2")


def _pil():
    return pytest.importorskip("PIL.Image")


def _cv2_read(path):
    """cv2.imread's RGB, or None (cv2 raises on a size over its limits,
    which the JAX package's verify_image_label catches as a failure)."""
    cv2 = _cv2()
    try:
        img = cv2.imread(str(path))
    except cv2.error:
        return None
    return None if img is None else np.ascontiguousarray(img[..., ::-1])


# -- the container ----------------------------------------------------------

def chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def vp8x(w: int, h: int, flags: int) -> bytes:
    return chunk(b"VP8X", struct.pack("<I", flags) + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little"))


def anim() -> bytes:
    return chunk(b"ANIM", struct.pack("<IH", 0xFF204080, 0))


def anmf(x: int, y: int, w: int, h: int, payload: bytes, flags=0) -> bytes:
    le3 = lambda v: v.to_bytes(3, "little")   # noqa: E731
    return chunk(b"ANMF", le3(x // 2) + le3(y // 2) + le3(w - 1) + le3(h - 1)
                 + le3(100) + bytes([flags]) + payload)


def exif(orientation: int, order: str = "<") -> bytes:
    """An EXIF chunk: a bare TIFF header with IFD0's Orientation."""
    body = (b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42, 8) \
        + struct.pack(order + "H", 1) \
        + struct.pack(order + "HHIHH", 0x112, 3, 1, orientation, 0) + b"\0" * 4
    return chunk(b"EXIF", body)


def chunks_of(data: bytes) -> list:
    """[(tag, payload)] of a RIFF WebP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        n = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def _photo(rng, h, w):
    """A colour gradient with noise and a few flat boxes (RGB uint8)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([(xx * (2 + c) + yy * (3 - c)) % 256 for c in range(3)],
                   -1) + rng.normal(0, 10, (h, w, 3))
    for _ in range(3):
        y, x = rng.integers(0, max(h - 8, 1)), rng.integers(0, max(w - 8, 1))
        img[y:y + 8, x:x + 8] = rng.uniform(0, 255, 3)
    return img.clip(0, 255).astype(np.uint8)


def cv2_webp(rgb, quality=None) -> bytes:
    """cv2.imencode's .webp: lossless by default, VP8 at `quality`."""
    cv2 = _cv2()
    params = [] if quality is None else [cv2.IMWRITE_WEBP_QUALITY, quality]
    ok, enc = cv2.imencode(".webp", np.ascontiguousarray(rgb[..., ::-1]),
                           params)
    assert ok
    return enc.tobytes()


def pil_webp(arr, **kw) -> bytes:
    Image = _pil()
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "WEBP", **kw)
    return buf.getvalue()


def pil_anim(frames, **kw) -> bytes:
    Image = _pil()
    buf = io.BytesIO()
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(buf, "WEBP", save_all=True, append_images=ims[1:], **kw)
    return buf.getvalue()


def _alpha_image(rng, h, w):
    """RGBA: a photo under a smooth alpha ramp with a transparent box."""
    a = np.tile(np.linspace(0, 255, w).astype(np.uint8), (h, 1))
    a[h // 4:h // 2, w // 4:w // 2] = 0
    return np.dstack([_photo(rng, h, w), a])


# -- a VP8 writer with chosen header fields, modes and coefficients ---------

def _c_table(name: str, dtype=np.uint8) -> np.ndarray:
    """A constant table of the port's decoder, read from its source."""
    src = DECODER.read_text()
    m = re.search(rf"{name}\[[^=]*=\s*\{{(.*?)\}};", src, re.S)
    return np.array([int(v, 0) for v in re.findall(r"0x[0-9a-f]+|\d+",
                                                   m.group(1))], dtype)


class BoolEncoder:
    """RFC 6386 7.3's boolean entropy encoder."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v, n):
        for i in range(n - 1, -1, -1):
            self.put((v >> i) & 1, 0x80)

    def signed(self, v, n):
        self.value(abs(v), n)
        self.put(int(v < 0), 0x80)

    def flag_value(self, v, n, signed=True):   # "flag, then value"
        self.put(int(v != 0), 0x80)
        if v:
            self.signed(v, n) if signed else self.value(v, n)

    def finish(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


_BANDS = [0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0]
_CATS = [[173, 148, 140], [176, 155, 140, 135], [180, 157, 141, 134, 130],
         [254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129]]
B_MODES = 10   # DC TM VE HE RD VR LD VL HD HU (libwebp's numbers)


class Vp8Writer:
    """A VP8 key frame: the header fields given, random modes and sparse
    random coefficients from `seed`. The decoder's own tables (default and
    update probabilities, 4x4 mode probabilities) are read from the port's
    source: cv2 decodes the file with libwebp's, so a wrong table shows."""

    def __init__(self, w, h, seed=0, simple=0, level=20, sharpness=0,
                 parts=1, segments=None, lf_delta=(2, 0, 0, 0, 3, -1, 0, 0),
                 skip_prob=200, base_q=40, q_deltas=(0, 0, 0, 0, 0),
                 proba_updates=0, i4x4_share=0.5, big=0.05):
        self.w, self.h = w, h
        self.rng = np.random.default_rng(seed)
        self.simple, self.level, self.sharpness = simple, level, sharpness
        self.parts, self.segments, self.lf_delta = parts, segments, lf_delta
        self.skip_prob, self.base_q, self.q_deltas = skip_prob, base_q, q_deltas
        self.proba_updates, self.i4x4_share, self.big = (proba_updates,
                                                         i4x4_share, big)
        self.p0 = _c_table("kCoeffsProba0").reshape(4, 8, 3, 11)
        self.pu = _c_table("kCoeffsUpdateProba").reshape(4, 8, 3, 11)
        self.pb = _c_table("kBModesProba").reshape(10, 10, 9)

    def _large(self, e, v, p):
        if v <= 4:
            e.put(0, p[3])
            e.put(int(v != 2), p[4])
            if v != 2:
                e.put(v - 3, p[5])
        elif v <= 10:
            e.put(1, p[3])
            e.put(0, p[6])
            e.put(int(v > 6), p[7])
            if v <= 6:
                e.put(v - 5, 159)
            else:
                e.put((v - 7) >> 1, 165)
                e.put((v - 7) & 1, 145)
        else:
            e.put(1, p[3])
            e.put(1, p[6])
            cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
            e.put(cat >> 1, p[8])
            e.put(cat & 1, p[9 + (cat >> 1)])
            extra, tab = v - (3 + (8 << cat)), _CATS[cat]
            for i, prob in enumerate(tab):
                e.put((extra >> (len(tab) - 1 - i)) & 1, prob)

    def _block(self, e, t, ctx, first, lv):
        """One block's tokens (levels in zigzag order); returns the
        decoder's nz (the position after the last non-zero)."""
        nzs = [i for i in range(first, 16) if lv[i]]
        last = nzs[-1] if nzs else first - 1
        n, p = first, self.proba[t][_BANDS[first]][ctx]
        while n < 16:
            if n > last:
                e.put(0, p[0])
                break
            e.put(1, p[0])
            while not lv[n]:
                e.put(0, p[1])
                n += 1
                p = self.proba[t][_BANDS[n]][0]
            e.put(1, p[1])
            v = abs(int(lv[n]))
            if v == 1:
                e.put(0, p[2])
                nctx = 1
            else:
                e.put(1, p[2])
                self._large(e, v, p)
                nctx = 2
            e.put(int(lv[n] < 0), 0x80)
            n += 1
            p = self.proba[t][_BANDS[n]][nctx]
        return max(first, last + 1)

    def _levels(self, first):
        lv = np.zeros(16, int)
        rng = self.rng
        for i in range(first, 16):
            if rng.random() < (0.5 if i < 4 else 0.12):
                v = int(rng.integers(1, 4))
                if rng.random() < self.big:
                    v = int(rng.choice([5, 8, 15, 30, 60, 200]))
                lv[i] = v if rng.random() < 0.5 else -v
        return lv

    def encode(self) -> bytes:
        rng = self.rng
        mb_w, mb_h = (self.w + 15) // 16, (self.h + 15) // 16
        e0 = BoolEncoder()
        e0.value(0, 1)   # colour space
        e0.value(0, 1)   # clamping type
        seg = self.segments
        e0.put(int(seg is not None), 0x80)
        if seg is not None:
            e0.put(int(seg["update_map"]), 0x80)
            e0.put(int("quant" in seg), 0x80)
            if "quant" in seg:
                e0.put(int(seg["absolute"]), 0x80)
                for q in seg["quant"]:
                    e0.flag_value(q, 7)
                for f in seg["filter"]:
                    e0.flag_value(f, 6)
            if seg["update_map"]:
                for p in seg["probs"]:
                    e0.flag_value(p, 8, signed=False)
        e0.value(self.simple, 1)
        e0.value(self.level, 6)
        e0.value(self.sharpness, 3)
        e0.put(int(self.lf_delta is not None), 0x80)
        if self.lf_delta is not None:
            e0.put(1, 0x80)
            for d in self.lf_delta:
                e0.flag_value(d, 6)
        e0.value(self.parts.bit_length() - 1, 2)
        e0.value(self.base_q, 7)
        for d in self.q_deltas:
            e0.flag_value(d, 4)
        e0.value(0, 1)   # refresh_entropy_probs
        self.proba = self.p0.astype(int).copy()
        for t, b, c, k in np.ndindex(4, 8, 3, 11):
            upd = self.proba_updates and rng.random() < self.proba_updates
            e0.put(int(upd), int(self.pu[t, b, c, k]))
            if upd:
                v = int(rng.integers(1, 256))
                e0.value(v, 8)
                self.proba[t, b, c, k] = v
        e0.put(int(self.skip_prob is not None), 0x80)
        if self.skip_prob is not None:
            e0.value(self.skip_prob, 8)
        tokens = [BoolEncoder() for _ in range(self.parts)]
        intra_t = np.zeros(4 * mb_w, int)
        top = [dict(y=[0] * 4, u=[0] * 2, v=[0] * 2, dc=0) for _ in range(mb_w)]
        for mb_y in range(mb_h):
            intra_l = [0] * 4
            left = dict(y=[0] * 4, u=[0] * 2, v=[0] * 2, dc=0)
            e = tokens[mb_y % self.parts]
            for mb_x in range(mb_w):
                if seg is not None and seg["update_map"]:
                    s = int(rng.integers(0, 4))
                    probs = [p or 255 for p in seg["probs"]]
                    e0.put(s >> 1, probs[0])
                    e0.put(s & 1, probs[1 + (s >> 1)])
                skip = self.skip_prob is not None and rng.random() < 0.25
                if self.skip_prob is not None:
                    e0.put(int(skip), self.skip_prob)
                i4x4 = rng.random() < self.i4x4_share
                e0.put(int(not i4x4), 145)
                tc = intra_t[4 * mb_x:4 * mb_x + 4]
                if not i4x4:
                    ymode = int(rng.integers(0, 4))   # DC TM V H
                    bits = {0: (0, 0), 2: (0, 1), 3: (1, 0), 1: (1, 1)}[ymode]
                    e0.put(bits[0], 156)
                    e0.put(bits[1], 128 if bits[0] else 163)
                    tc[:] = ymode
                    intra_l = [ymode] * 4
                else:
                    for y in range(4):
                        for x in range(4):
                            m = int(rng.integers(0, B_MODES))
                            self._bmode(e0, m, self.pb[tc[x], intra_l[y]])
                            tc[x] = m
                            intra_l[y] = m
                uv = int(rng.integers(0, 4))
                e0.put(int(uv != 0), 142)
                if uv:
                    e0.put(int(uv != 2), 114)
                    if uv != 2:
                        e0.put(int(uv == 1), 183)
                t = top[mb_x]
                if skip:
                    for k in ("y", "u", "v"):
                        t[k] = [0] * len(t[k])
                        left[k] = [0] * len(left[k])
                    if not i4x4:
                        t["dc"] = left["dc"] = 0
                    continue
                first = 0 if i4x4 else 1
                if not i4x4:
                    nz = self._block(e, 1, t["dc"] + left["dc"], 0,
                                     self._levels(0))
                    t["dc"] = left["dc"] = int(nz > 0)
                for y in range(4):
                    for x in range(4):
                        nz = self._block(e, 3 if i4x4 else 0,
                                         t["y"][x] + left["y"][y], first,
                                         self._levels(first))
                        t["y"][x] = left["y"][y] = int(nz > first)
                for k in ("u", "v"):
                    for y in range(2):
                        for x in range(2):
                            nz = self._block(e, 2, t[k][x] + left[k][y], 0,
                                             self._levels(0))
                            t[k][x] = left[k][y] = int(nz > 0)
        part0 = e0.finish()
        parts = [p.finish() for p in tokens]
        tag = (0 | (0 << 1) | (1 << 4) | (len(part0) << 5)).to_bytes(3,
                                                                       "little")
        head = tag + b"\x9d\x01\x2a" + struct.pack("<HH", self.w, self.h)
        sizes = b"".join(len(p).to_bytes(3, "little") for p in parts[:-1])
        return riff(chunk(b"VP8 ", head + part0 + sizes + b"".join(parts)))

    @staticmethod
    def _bmode(e, m, p):
        # libwebp's tree: DC | TM | VE | (HE | RD | VR) | (LD | VL | HD | HU)
        path = {0: [(0, 0)], 1: [(1, 0), (0, 1)],
                2: [(1, 0), (1, 1), (0, 2)],
                3: [(1, 0), (1, 1), (1, 2), (0, 3), (0, 4)],
                4: [(1, 0), (1, 1), (1, 2), (0, 3), (1, 4), (0, 5)],
                5: [(1, 0), (1, 1), (1, 2), (0, 3), (1, 4), (1, 5)],
                6: [(1, 0), (1, 1), (1, 2), (1, 3), (0, 6)],
                7: [(1, 0), (1, 1), (1, 2), (1, 3), (1, 6), (0, 7)],
                8: [(1, 0), (1, 1), (1, 2), (1, 3), (1, 6), (1, 7), (0, 8)],
                9: [(1, 0), (1, 1), (1, 2), (1, 3), (1, 6), (1, 7), (1, 8)]}
        for bit, k in path[m]:
            e.put(bit, int(p[k]))


SEG = dict(update_map=True, quant=[-10, 0, 12, 30], filter=[0, -8, 6, 20],
           absolute=False, probs=[100, 0, 200])
VP8_KINDS = {
    "vp8w_normal": {},
    "vp8w_simple": dict(simple=1, level=30),
    "vp8w_simple_sharp5": dict(simple=1, level=40, sharpness=5),
    "vp8w_level0": dict(level=0),
    "vp8w_level63": dict(level=63, base_q=100),
    **{f"vp8w_sharpness{s}": dict(sharpness=s, level=35) for s in range(1, 8)},
    "vp8w_parts2": dict(parts=2),
    "vp8w_parts4": dict(parts=4),
    "vp8w_parts8": dict(parts=8),
    "vp8w_segments": dict(segments=SEG),
    "vp8w_segments_absolute": dict(segments={**SEG, "absolute": True,
                                             "quant": [5, 40, 80, 127],
                                             "filter": [0, 10, 30, 63]}),
    "vp8w_segments_no_map": dict(segments=dict(update_map=False,
                                               quant=[20, 0, 0, 0],
                                               filter=[10, 0, 0, 0],
                                               absolute=False)),
    "vp8w_segments_map_only": dict(segments=dict(update_map=True,
                                                 probs=[128, 60, 0])),
    "vp8w_no_lf_delta": dict(lf_delta=None),
    "vp8w_no_skip_prob": dict(skip_prob=None),
    "vp8w_proba_updates": dict(proba_updates=0.3),
    "vp8w_q_deltas": dict(q_deltas=(-5, 7, -3, 4, -8), base_q=10),
    "vp8w_i4x4_all": dict(i4x4_share=1.0, big=0.2),
    "vp8w_i16_all": dict(i4x4_share=0.0, big=0.2),
    "vp8w_q0": dict(base_q=0, big=0.0),
}


# -- the kinds --------------------------------------------------------------

def _palette_image(rng, h, w, n):
    pal = rng.integers(0, 256, (n, 3), np.uint8)
    idx = (np.add.outer(np.arange(h) // 3, np.arange(w) // 2)
           + rng.integers(0, 2, (h, w))) % n
    return pal[idx]


def _rewrite_alph(data: bytes, header: int) -> bytes:
    cs = chunks_of(data)
    body = b"".join(chunk(t, bytes([header]) + p[1:] if t == b"ALPH" else p)
                    for t, p in cs)
    return riff(body)


def _raw_alph(rgba, filt: int) -> bytes:
    """VP8X + a raw ALPH of filter `filt` + Pillow's VP8 of the colours."""
    h, w = rgba.shape[:2]
    vp8 = dict(chunks_of(pil_webp(rgba[..., :3], quality=80)))[b"VP8 "]
    return riff(vp8x(w, h, 0x10) + chunk(b"ALPH", bytes([filt << 2])
                                         + rgba[..., 3].tobytes())
                + chunk(b"VP8 ", vp8))


def _compressed_alph(rng, filt: int, pre: int = 0) -> bytes:
    data = pil_webp(_alpha_image(rng, 21, 30), quality=70)
    header = dict(chunks_of(data))[b"ALPH"][0]
    assert header & 3 == 1, "Pillow wrote a raw ALPH"
    return _rewrite_alph(data, 1 | filt << 2 | pre << 4)


def _offset_frame(rng, lossy: bool) -> bytes:
    """An animation whose first frame is smaller than the canvas and
    offset; a second, full frame follows."""
    small = _photo(rng, 8, 10)
    if lossy:
        cs = dict(chunks_of(pil_webp(_alpha_image(rng, 8, 10), quality=70)))
        first = chunk(b"ALPH", cs[b"ALPH"]) + chunk(b"VP8 ", cs[b"VP8 "])
        flags = 0x12
    else:
        first = chunk(b"VP8L", dict(chunks_of(cv2_webp(small)))[b"VP8L"])
        flags = 0x02
    full = chunk(b"VP8L", dict(chunks_of(cv2_webp(_photo(rng, 20, 30))))
                 [b"VP8L"])
    return riff(vp8x(30, 20, flags) + anim() + anmf(4, 6, 10, 8, first)
                + anmf(0, 0, 30, 20, full))


def _exif_kind(rng, orientation: int, square: bool, lossy: bool) -> bytes:
    h, w = (24, 24) if square else (20, 30)
    img = _photo(rng, h, w)
    tag, body = chunks_of(cv2_webp(img, 80 if lossy else None))[0]
    return riff(vp8x(w, h, 0x08) + chunk(tag, body) + exif(orientation))


def make_kind(name: str) -> bytes:
    """The bytes of kind `name` (one file each)."""
    rng = np.random.default_rng(list(name.encode()))
    parts = name.split("_")
    if name.startswith("cv2_lossy"):                 # cv2_lossy_q75_37x50
        h, w = map(int, parts[3].split("x"))
        img = _photo(rng, h, w)
        return cv2_webp(img, int(parts[2][1:]))
    if name.startswith("cv2_lossless"):
        h, w = map(int, parts[2].split("x"))
        return cv2_webp(_photo(rng, h, w))
    if name == "pil_lossy_alpha":
        return pil_webp(_alpha_image(rng, 33, 47), quality=60)
    if name.startswith("pil_lossy"):                 # pil_lossy_m4_37x50
        h, w = map(int, parts[3].split("x"))
        return pil_webp(_photo(rng, h, w), quality=75, method=int(parts[2][1:]))
    if name.startswith("pil_lossless_m"):            # pil_lossless_m3_q50
        return pil_webp(_photo(rng, 29, 41), lossless=True,
                        method=int(parts[2][1:]), quality=int(parts[3][1:]))
    if name.startswith("pil_palette"):               # pil_palette_16_29x41
        h, w = map(int, parts[3].split("x"))
        return pil_webp(_palette_image(rng, h, w, int(parts[2])),
                        lossless=True)
    if name == "pil_lossless_exact_alpha":
        return pil_webp(_alpha_image(rng, 23, 31), lossless=True, exact=True)
    if name == "pil_lossless_alpha":
        return pil_webp(_alpha_image(rng, 23, 31), lossless=True)
    if name.startswith("alph_raw_f"):
        return _raw_alph(_alpha_image(rng, 21, 30), int(parts[2][1:]))
    if name.startswith("alph_vp8l_f"):
        return _compressed_alph(rng, int(parts[2][1:]))
    if name == "alph_vp8l_levels":
        return _compressed_alph(rng, 1, pre=1)
    if name == "anim_pil_lossy":
        return pil_anim([_photo(rng, 20, 30) for _ in range(3)], quality=70)
    if name == "anim_pil_lossless":
        return pil_anim([_photo(rng, 20, 30) for _ in range(3)],
                        lossless=True)
    if name == "anim_offset_vp8l":
        return _offset_frame(rng, False)
    if name == "anim_offset_lossy_alpha":
        return _offset_frame(rng, True)
    if name.startswith("exif"):                      # exif6_square_lossy
        return _exif_kind(rng, int(parts[0][4:]), parts[1] == "square",
                          parts[2] == "lossy")
    if name.startswith("vp8w"):
        return Vp8Writer(45, 37, seed=len(name), **VP8_KINDS[name]).encode()
    raise KeyError(name)


KINDS = (
    [f"cv2_lossy_q{q}_{s}" for q in (1, 50, 75, 90, 100)
     for s in ("13x17", "37x50")]
    + ["cv2_lossy_q75_1x1", "cv2_lossy_q75_16x16", "cv2_lossy_q90_40x1",
       "cv2_lossy_q75_480x640"]
    + [f"pil_lossy_m{m}_{s}" for m in (0, 4, 6) for s in ("17x13", "33x50")]
    + ["cv2_lossless_1x1", "cv2_lossless_40x1", "cv2_lossless_1x40",
       "cv2_lossless_37x50"]
    + [f"pil_lossless_m{m}_q50" for m in range(7)]
    + ["pil_lossless_m4_q0", "pil_lossless_m4_q100"]
    + [f"pil_palette_{n}_29x41" for n in (1, 2, 4, 16, 256)]
    + [f"pil_palette_{n}_23x1" for n in (2, 16)]
    + ["pil_lossless_exact_alpha", "pil_lossless_alpha", "pil_lossy_alpha"]
    + [f"alph_raw_f{f}" for f in range(4)]
    + [f"alph_vp8l_f{f}" for f in range(4)] + ["alph_vp8l_levels"]
    + ["anim_pil_lossy", "anim_pil_lossless", "anim_offset_vp8l",
       "anim_offset_lossy_alpha"]
    + [f"exif{o}_{shape}_{kind}" for o in range(1, 9)
       for shape, kind in (("square", "lossless"), ("wide", "lossy"))]
    + sorted(VP8_KINDS))


@pytest.mark.parametrize("name", KINDS)
def test_kind_reads_as_cv2_imread(name, tmp_path):
    _pil()
    path = tmp_path / f"{name}.webp"
    path.write_bytes(make_kind(name))
    want = _cv2_read(path)
    assert want is not None, f"cv2 does not read {name}"
    got = image_io.imread(str(path))
    np.testing.assert_array_equal(got, want, err_msg=name)
    assert image_io.image_size(str(path)) == (want.shape[1], want.shape[0])


# -- what cv2 reads nothing of ----------------------------------------------

def lsb_bits(fields) -> bytes:
    """(value, bits) fields packed LSB first, as VP8L reads them."""
    acc = n = 0
    for v, bits in fields:
        acc |= v << n
        n += bits
    return acc.to_bytes((n + 7) // 8, "little")


# a 1x1 VP8L: no transform, no colour cache, no meta codes, five simple
# codes of the one symbol 0
_ONE_PIXEL = [(0x2F, 8), (0, 14), (0, 14), (0, 1), (0, 3), (0, 1), (0, 1),
              (0, 1)] + [(1, 1), (0, 1), (0, 1), (0, 1)] * 5

def _bad_files(rng) -> dict:
    """name: bytes of files cv2.imread returns None on."""
    lossless = cv2_webp(_photo(rng, 20, 30))
    vl = dict(chunks_of(lossless))[b"VP8L"]
    lossy = pil_webp(_alpha_image(rng, 21, 30), quality=70)
    cs = dict(chunks_of(lossy))
    small = dict(chunks_of(cv2_webp(_photo(rng, 8, 10))))[b"VP8L"]
    tiny = riff(chunk(b"VP8L", lsb_bits(_ONE_PIXEL)))   # 28 bytes
    return {
        "short_file": tiny,
        "riff_size_short": lossless[:4] + struct.pack("<I", len(lossless) - 10)
        + lossless[8:],
        "riff_size_long": lossless[:4] + struct.pack("<I", len(lossless))
        + lossless[8:],
        "vp8x_size_12": riff(chunk(b"VP8X", b"\0" * 12) + chunk(b"VP8L", vl)),
        "vp8x_wrong_canvas": riff(vp8x(31, 20, 0) + chunk(b"VP8L", vl)),
        "unknown_chunk_first": riff(chunk(b"ABCD", b"xyz")
                                    + chunk(b"VP8L", vl)),
        "alph_reserved_bits": riff(vp8x(30, 21, 0x10) + chunk(
            b"ALPH", bytes([0x41]) + cs[b"ALPH"][1:])
            + chunk(b"VP8 ", cs[b"VP8 "])),
        "alph_zeroed": riff(vp8x(30, 21, 0x10) + chunk(
            b"ALPH", cs[b"ALPH"][:1] + bytes(len(cs[b"ALPH"]) - 1))
            + chunk(b"VP8 ", cs[b"VP8 "])),
        "alph_halved_no_flag": riff(vp8x(30, 21, 0) + chunk(
            b"ALPH", cs[b"ALPH"][:len(cs[b"ALPH"]) // 2])
            + chunk(b"VP8 ", cs[b"VP8 "])),
        "alph_raw_short": riff(vp8x(30, 21, 0x10) + chunk(b"ALPH", b"\0" * 10)
                               + chunk(b"VP8 ", cs[b"VP8 "])),
        "anim_frame_past_canvas": riff(vp8x(30, 20, 0x02) + anim()
                                       + anmf(24, 6, 10, 8,
                                              chunk(b"VP8L", small))),
        "anim_without_anim_chunk": riff(vp8x(30, 20, 0x02)
                                        + anmf(0, 0, 10, 8,
                                               chunk(b"VP8L", small))),
        "anim_flag_plain_image": riff(vp8x(30, 20, 0x02) + anim()
                                      + chunk(b"VP8L", vl)),
        "anmf_without_anim_flag": riff(vp8x(30, 20, 0) + anim()
                                       + anmf(0, 0, 30, 20,
                                              chunk(b"VP8L", vl))),
        "anim_odd_riff": (lambda f: f[:4] + struct.pack("<I", len(f) - 7)
                          + f[8:] + b"\0")(
            riff(vp8x(30, 20, 0x02) + anim()
                 + anmf(4, 6, 10, 8, chunk(b"VP8L", small)))),
        "anim_damaged_first": riff(vp8x(30, 20, 0x02) + anim() + anmf(
            0, 0, 30, 20, chunk(b"VP8L", vl[:30] + bytes(30) + vl[60:]))),
        "vp8l_transform_twice": riff(chunk(b"VP8L", lsb_bits(
            _ONE_PIXEL[:5] + [(1, 1), (2, 2), (1, 1), (2, 2)]
            + _ONE_PIXEL[5:]) + bytes(20))),
    }


def test_files_cv2_cannot_read_raise_oserror(tmp_path):
    _pil()
    for name, data in _bad_files(np.random.default_rng(3)).items():
        path = tmp_path / f"{name}.webp"
        path.write_bytes(data)
        assert _cv2_read(path) is None, name
        with pytest.raises(OSError):
            image_io.imread(str(path))


def test_container_rules_cv2_reads(tmp_path):
    """Trailing bytes, a RIFF size past the data's end but inside the file,
    unknown chunks inside VP8X, and the EXIF rules: the demuxer's first
    EXIF chunk with the EXIF flag, none with a reserved flag, a RIFF size
    the chunks do not end at, a simple file or an "Exif" prefix."""
    _pil()
    rng = np.random.default_rng(4)
    img = _photo(rng, 20, 30)
    vl = dict(chunks_of(cv2_webp(img)))[b"VP8L"]
    plain = riff(chunk(b"VP8L", vl))
    with_exif = riff(vp8x(30, 20, 0x08) + chunk(b"VP8L", vl) + exif(3))
    cases = {
        "trailing": plain + b"junk",
        "riff_plus_2": plain[:4] + struct.pack("<I", len(plain) - 6)
        + plain[8:] + b"\0\0",
        "unknown_chunks": riff(vp8x(30, 20, 0) + chunk(b"ABCD", b"xyz")
                               + chunk(b"VP8L", vl) + chunk(b"ZZZZ", b"12")),
        "exif_before": riff(vp8x(30, 20, 0x08) + exif(6) + chunk(b"VP8L", vl)),
        "exif_no_flag": riff(vp8x(30, 20, 0) + chunk(b"VP8L", vl) + exif(6)),
        "exif_flag_no_chunk": riff(vp8x(30, 20, 0x08) + chunk(b"VP8L", vl)),
        "exif_riff_plus_1": with_exif[:4] + struct.pack(
            "<I", len(with_exif) - 7) + with_exif[8:] + b"\0",
        "exif_trailing": with_exif + b"junkjunk",
        "exif_two": riff(vp8x(30, 20, 0x08) + chunk(b"VP8L", vl) + exif(3)
                         + exif(6)),
        "exif_big_endian": riff(vp8x(30, 20, 0x08) + chunk(b"VP8L", vl)
                                + exif(8, ">")),
        "exif_reserved_flag": riff(vp8x(30, 20, 0x09) + chunk(b"VP8L", vl)
                                   + exif(6)),
        "exif_prefixed": riff(vp8x(30, 20, 0x08) + chunk(b"VP8L", vl)
                              + chunk(b"EXIF", b"Exif\0\0"
                                      + exif(6)[8:])),
        "exif_simple_file": riff(chunk(b"VP8L", vl) + exif(6)),
        "anim_exif": riff(vp8x(30, 20, 0x0A) + anim()
                          + anmf(0, 0, 30, 20, chunk(b"VP8L", vl))
                          + anmf(0, 0, 30, 20, chunk(b"VP8L", vl)) + exif(6)),
        "anmf_size_not_bitstream": riff(vp8x(30, 20, 0x02) + anim()
                                        + anmf(2, 2, 5, 5, chunk(
                                            b"VP8L", dict(chunks_of(cv2_webp(
                                                _photo(rng, 8, 10))))
                                            [b"VP8L"]))),
        "anmf_extra_subchunk": riff(vp8x(30, 20, 0x02) + anim() + anmf(
            0, 0, 30, 20, chunk(b"VP8L", vl) + chunk(b"UNKN", b"abc"))),
        "bare_vp8l": vl,
        "one_pixel_padded": riff(chunk(b"VP8L", lsb_bits(_ONE_PIXEL))
                                 + chunk(b"ABCD", b"\0" * 8)),
        "subtract_green_once": riff(chunk(b"VP8L", lsb_bits(
            _ONE_PIXEL[:5] + [(1, 1), (2, 2)] + _ONE_PIXEL[5:]))
            + chunk(b"ABCD", b"\0" * 8)),
    }
    for name, data in cases.items():
        path = tmp_path / f"{name}.webp"
        path.write_bytes(data)
        want = _cv2_read(path)
        assert want is not None, name
        np.testing.assert_array_equal(image_io.imread(str(path)), want,
                                      err_msg=name)
        assert image_io.image_size(str(path)) == want.shape[1::-1], name


@pytest.mark.parametrize("source", ["cv2_lossless_37x50", "cv2_lossy_q75_37x50",
                                    "alph_vp8l_f2", "anim_offset_lossy_alpha",
                                    "vp8w_parts4", "pil_palette_4_29x41"])
def test_damaged_files_fail_as_cv2_fails(source, tmp_path):
    """Seeded truncations and byte flips of a file of each kind: the port
    raises OSError exactly where cv2.imread returns None, never crashes,
    and where both read, the images are equal."""
    _pil()
    rng = np.random.default_rng(list(source.encode()))
    data = make_kind(source)
    outcomes = set()
    for i in range(40):
        bad = bytearray(data)
        if i % 4 == 0:
            bad = bad[:int(rng.integers(1, len(bad)))]
        else:
            lo = 12 if i % 4 == 1 else min(40, len(bad) - 1)
            for _ in range(int(rng.integers(1, 4))):
                bad[int(rng.integers(lo, len(bad)))] = int(rng.integers(0,
                                                                        256))
        path = tmp_path / f"d{i}.webp"
        path.write_bytes(bytes(bad))
        want = _cv2_read(path)
        if want is None:
            with pytest.raises(OSError):
                image_io.imread(str(path))
            outcomes.add("fails")
        else:
            np.testing.assert_array_equal(image_io.imread(str(path)), want,
                                          err_msg=f"{source} damage {i}")
            outcomes.add("reads")
    assert "fails" in outcomes


# -- the writer -------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(1, 1), (1, 40), (40, 1), (23, 37),
                                 (480, 640)])
def test_writer_reads_back_equal(h, w, tmp_path):
    """image_io.imwrite(.webp) writes one VP8L chunk that cv2.imread and
    the port read back equal to the canvas. Sizes beside cv2.imwrite's:
    the port's files are larger (no LZ77, no colour cache; PERF.md)."""
    cv2 = _cv2()
    rng = np.random.default_rng(h * w)
    img = _photo(rng, h, w)[..., ::-1].copy()
    if h > 100:
        img[: h // 2] = rng.integers(0, 256, (h // 2, w, 3), np.uint8)
    ours, theirs = tmp_path / "a.webp", tmp_path / "b.webp"
    image_io.imwrite(str(ours), img)
    assert [t for t, _ in chunks_of(ours.read_bytes())] == [b"VP8L"]
    np.testing.assert_array_equal(cv2.imread(str(ours)), img)
    np.testing.assert_array_equal(image_io.imread(str(ours)), img[..., ::-1])
    assert cv2.imwrite(str(theirs), img)
    assert ours.stat().st_size < 2 * theirs.stat().st_size + 64


# -- a split of PNG, JPEG and WebP through the entry points -----------------

# (h, w, kind) around the 96-px target: an upscale and a downscale
MIXED = [(72, 96, "png"), (96, 70, "jpg"), (80, 96, "webp_port"),
         (96, 90, "webp_cv2"), (70, 96, "webp_q75"), (150, 200, "webp_q90"),
         (90, 96, "webp_alpha"), (64, 96, "webp_exif6"),
         (96, 96, "webp_anim")]


def _write_mixed_image(path: Path, kind: str, rgb: np.ndarray, rng):
    h, w = rgb.shape[:2]
    if kind in ("png", "jpg", "webp_port"):
        image_io.imwrite(str(path), rgb[..., ::-1])
    elif kind == "webp_cv2":
        path.write_bytes(cv2_webp(rgb))
    elif kind in ("webp_q75", "webp_q90"):
        path.write_bytes(cv2_webp(rgb, int(kind[-2:])))
    elif kind == "webp_alpha":
        a = rng.integers(0, 256, (h, w, 1), np.uint8)
        path.write_bytes(pil_webp(np.dstack([rgb, a]), quality=80))
    elif kind == "webp_exif6":
        tag, body = chunks_of(cv2_webp(np.rot90(rgb, 1), 85))[0]
        path.write_bytes(riff(vp8x(h, w, 0x08) + chunk(tag, body) + exif(6)))
    else:   # the first of two frames
        path.write_bytes(pil_anim([rgb, rgb[::-1]], quality=85))


def write_mixed(root: Path, seed: int = 0, nc: int = 8):
    """A split of MIXED's kinds (mixed/images, labels, mixed.txt) and its
    PNG copy (png/: each image's decoded pixels, same stems and labels);
    returns the two list files."""
    rng = np.random.default_rng(seed)
    lists, files = {}, {"mixed": [], "png": []}
    for sub in ("mixed", "png"):
        for d in ("images", "labels"):
            (root / sub / d).mkdir(parents=True, exist_ok=True)
    for i, (h, w, kind) in enumerate(MIXED):
        path = root / "mixed" / "images" / f"{i}.{kind[:4]}"
        _write_mixed_image(path, kind, _photo(rng, h, w), rng)
        copy = root / "png" / "images" / f"{i}.png"
        image_io.write_png(str(copy), image_io.imread(str(path)))
        n = int(rng.integers(1, 6))
        rows = "".join(f"{rng.integers(0, nc)} {cx:.6f} {cy:.6f} {bw:.6f} "
                       f"{bh:.6f}\n"
                       for cx, cy, bw, bh in rng.uniform(0.2, 0.45, (n, 4)))
        for sub in ("mixed", "png"):
            (root / sub / "labels" / f"{i}.txt").write_text(rows)
        files["mixed"].append(str(path))
        files["png"].append(str(copy))
    for sub in ("mixed", "png"):
        lists[sub] = root / sub / f"{sub}.txt"
        lists[sub].write_text("\n".join(files[sub]) + "\n")
    return lists["mixed"], lists["png"]


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    _cv2()
    _pil()
    return write_mixed(tmp_path_factory.mktemp("mixed"))


def test_mixed_split_equals_jax(mixed):
    """verify_image_label, the val dataset's items and load_image, and
    LoadImages: the port's against the JAX package's (cv2) on a split of
    PNG, JPEG and WebP kinds, bit for bit; each WebP equals cv2.imread."""
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
        np.testing.assert_array_equal(image_io.imread(f), _cv2_read(f))
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
    got = list(LoadImages(folder, 96))
    want = list(JaxLoadImages(folder, 96))
    assert len(got) == len(want) == len(MIXED)
    for (p, rgb, img0, rp), (jp, jrgb, jimg0, jrp) in zip(got, want):
        assert p == jp and rp == jrp
        np.testing.assert_array_equal(rgb, jrgb)
        np.testing.assert_array_equal(img0, jimg0)


def test_unreadable_webp_is_dropped_and_skipped_as_in_jax(mixed, tmp_path):
    """A .webp cv2 reads nothing of: verify_image_label drops it and
    LoadImages skips it, in both packages."""
    jax_ds = pytest.importorskip("efficientteacher_tpu.data.datasets")
    from efficientteacher_tpu.data.loaders import LoadImages as JaxLoadImages
    from efficientteacher_torch.data.loaders import LoadImages

    lst, _ = mixed
    good = Path(Path(lst).read_text().split()[2])
    bad = tmp_path / "bad.webp"
    bad.write_bytes(good.read_bytes()[:-9])   # truncated
    (tmp_path / "good.webp").write_bytes(good.read_bytes())
    assert port_ds.verify_image_label(str(bad), None, 8) is None
    assert jax_ds.verify_image_label(str(bad), None, 8) is None
    got = [p for p, *_ in LoadImages(str(tmp_path), 96)]
    want = [p for p, *_ in JaxLoadImages(str(tmp_path), 96)]
    assert got == want == [str(tmp_path / "good.webp")]


def test_cli_val_and_detect_on_webp(mixed, weights, tmp_path):
    """cli.val gives the same results on the split as on its PNG copy;
    cli.detect writes each .webp source's canvas as .webp, read back equal
    to the canvas by cv2 and by the port, with label files equal to the
    PNG copy's."""
    from efficientteacher_torch.cli import detect as cli_detect
    from efficientteacher_torch.cli import val as cli_val

    lst, png_lst = mixed
    ckpt, _ = weights
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
    assert [t.read_text() for t in sorted(mixed_dir.glob("*.txt"))] == [
        t.read_text() for t in sorted(png_dir.glob("*.txt"))]
    written = [(p, img) for p, img in canvases
               if p.parent == mixed_dir and p.suffix == ".webp"]
    assert len(written) == sum(k.startswith("webp") for _, _, k in MIXED)
    for path, canvas in written:
        np.testing.assert_array_equal(_cv2().imread(str(path)), canvas)
        np.testing.assert_array_equal(image_io.imread(str(path)),
                                      canvas[..., ::-1])


@pytest.mark.parametrize("quality", [0, 50, 75, 90, 100])
def test_lossy_writer_decodes_as_cv2(quality, tmp_path):
    """webp_io.write_webp at a quality writes one VP8 chunk that cv2 and the
    port decode equal, for odd and whole-macroblock sizes; on a smooth
    image its PSNR is within 2 dB of cv2.imwrite's at the same number
    (the scales differ: tests/test_torch_webp.py --sizes)."""
    from efficientteacher_torch.data import webp_io

    cv2 = _cv2()
    rng = np.random.default_rng(quality)
    for h, w in ((1, 1), (13, 17), (48, 64), (37, 50)):
        img = cv2.GaussianBlur(_photo(rng, h, w), (0, 0), 1.5)
        path = tmp_path / f"{h}x{w}.webp"
        webp_io.write_webp(str(path), img, quality)
        assert [t for t, _ in chunks_of(path.read_bytes())] == [b"VP8 "]
        got = image_io.imread(str(path))
        np.testing.assert_array_equal(got, _cv2_read(path))
        if h * w > 1000:
            theirs = _cv2_read_bytes(cv2_webp(img, quality), tmp_path)

            def psnr(a):
                mse = np.mean((a.astype(np.float64) - img) ** 2)
                return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))

            assert psnr(got) > min(psnr(theirs) - 2.0, 40.0)


def _cv2_read_bytes(data: bytes, tmp_path) -> np.ndarray:
    path = tmp_path / "cv2.webp"
    path.write_bytes(data)
    return _cv2_read(path)


# -- fixtures ---------------------------------------------------------------

FIXTURE_KINDS = ["cv2_lossless_1x40", "cv2_lossy_q75_13x17",
                 "pil_lossy_m6_17x13", "pil_palette_2_23x1",
                 "pil_palette_16_29x41", "alph_raw_f3", "alph_vp8l_f1",
                 "anim_offset_lossy_alpha", "exif6_wide_lossy",
                 "vp8w_simple", "vp8w_parts8", "vp8w_segments",
                 "vp8w_sharpness3"]

# name: (base64 file, ((h, w, 3), sha256 of cv2.imread's RGB bytes))
FIXTURES = {
    "cv2_lossless_1x40": (
        "UklGRqIAAABXRUJQVlA4TJUAAAAvJwAAAOegIJKt5ONOA4b+eYjiTg3WkSSlwv3bCZ"
        "agCIggnCfFOJLkNGKmDFQKSflngGb2Y/5DAJADIjMFPkEZzsMFXMx8ysUaig9ST7F1"
        "omR4BFoAlwiLYGYiQhZGR/Az4n1hK7yZ1PMb7yn81O+LlF9Q0EaScs/MDP6Nft5DRP"
        "8TIyCUcSGVfuaz2fkUYmm3rjP7HgA=",
        ((1, 40, 3), "4e52db05860197203241b05ee8f7a2d5"
                      "d54c110785b746ae8aa6270496e95316")),
    "cv2_lossy_q75_13x17": (
        "UklGRqoAAABXRUJQVlA4IJ4AAACwBACdASoRAA0APpE4l0eloyIhMAgAsBIJbACdMo"
        "MpLIBoYAEtafXnj7wmYXAQAP74cHqTog8q1Uaf5M35TzPuEgmCK7Red+sVab9BLH+p"
        "kkt8opVr0ROs+PX6+eTz/L7Bn9z5DuN38ciJfYS/CNP9P6HvH213n1Q9h7zaltInyA"
        "8E9n4tb/Che+ZT9QLzpRQ5A8ookAWUARIZ6b0AAA==",
        ((13, 17, 3), "ffe868a3715b8b7493d7a8d3bf6852db"
                      "691c59ede5d68ec776064cc42a5aba70")),
    "pil_lossy_m6_17x13": (
        "UklGRpwAAABXRUJQVlA4IJAAAABQBQCdASoNABEAPpE6l0eloyIhMAgAsBIJbACdMo"
        "HCAb3/6EG7K9KABrhsKw+gvhQU00gA/vvhJSn4/1bYAp/DjnW0fjyXugzGGm54ZEGK"
        "OhZkYuGeSa1kI//3/rreg80BxUn/lW2575Fi4vtW6Fsm6TUiSR0RzT65L/px1fge86"
        "Lt8H9msC7aGPEbKWrLAAA=",
        ((17, 13, 3), "0eccbe6d63da0de548ce19688df62f91"
                      "eeb91ca0b4917afebb13971a9b416c6a")),
    "pil_palette_2_23x1": (
        "UklGRioAAABXRUJQVlA4TB4AAAAvAIAFAA9wpKxneClI24DFAtud+Y8fYAIi+h9RRn"
        "Y=",
        ((23, 1, 3), "1d6f3e5566c233a5b50a386914c25d21"
                      "1a9b93b2099eac2ba7ac9cbbfa392916")),
    "pil_palette_16_29x41": (
        "UklGRmQCAABXRUJQVlA4TFcCAAAvKAAHAH+gqLaViGHFkhYk4JCDFKQw19hFA5jBHE"
        "oDAGkqVDoJ18teZTLutOLKaiLZaqr/Pxn6XIIXDGTVaEDH/MdnWAdI0Gww+K9LJMTR"
        "1nj3Mj5tfy8NByOGYvuquw5yHQBs4srpBZ2Qb2KF+bZUdguJD/AIE/LAmuLlNTZPaa"
        "T5B1IuBXYr7bU01puQRyQmiznN0nEfEdF/hW3bNkrSPd1eYcOtSgqjeeujfb7y7Tdk"
        "quo4sMbBjdFkJx5aWHssHIuFHchYi6njyHdXHnvQ2sJTjIVtvBGE3GG9y1gVdBIWDm"
        "6E+dZHPF351oPJFg4MyCp8kzeaRPsppYXDWDjoqFDe5Fr3CXcpdWBSV0EJtjAuhfl2"
        "gtDCwmNhJ1tqIAymAjkkRvvpwrff0KpxIA0lhaHfYuTzYd6FqgpKYSp5I7TuI7SwVj"
        "g2ZApLACpc5loT4nP6zbGtrVCWOcA3AmQnEXLXHgvbYjgoDdPEN0a7qp+ufStsqCpZ"
        "isaUpdBvxOMpffxtsyFSgPkyB1ns7bu0FUdheWOY2fRNbmYnnu8u0N8Oq9WglXVagO"
        "ZtCKePjpPUKhDC7E/nICMEpWv0dzfZCoMbod9OJgXI4mh/Ye3xtwO38KA0zLf+NNBv"
        "sYf4wrffNmO41VqTSZ31o31OiwJaCgdlDjRBc81bHPlpS1KHgRAgI2gS9GPPd9ceRx"
        "OZt99pTsfId1eo48C2LkC/H+1P9E8IchdoYUPWvrXZPyH+nO57nI/2jK5KyP4cQXxU"
        "nDoMZKsqQnwmjni6Rntdq1b4RjRZjFA6AwA=",
        ((29, 41, 3), "4481365c66c464bfe88d4a126801cf6e"
                      "1fb7e407aaecf095a296d93006ff1325")),
    "alph_raw_f3": (
        "UklGRrYDAABXRUJQVlA4WAoAAAAQAAAAHQAAFAAAQUxQSHcCAAAMAAgRGiMrND1GT1"
        "dgaXJ7g4yVnqevuMHK09vk7fb/AAgRGiMrND1GT1dgaXJ7g4yVnqevuMHK09vk7fb/"
        "AAgRGiMrND1GT1dgaXJ7g4yVnqevuMHK09vk7fb/AAgRGiMrND1GT1dgaXJ7g4yVnq"
        "evuMHK09vk7fb/AAgRGiMrND1GT1dgaXJ7g4yVnqevuMHK09vk7fb/AAgRGiMrNAAA"
        "AAAAAAAAg4yVnqevuMHK09vk7fb/AAgRGiMrNAAAAAAAAAAAg4yVnqevuMHK09vk7f"
        "b/AAgRGiMrNAAAAAAAAAAAg4yVnqevuMHK09vk7fb/AAgRGiMrNAAAAAAAAAAAg4yV"
        "nqevuMHK09vk7fb/AAgRGiMrNAAAAAAAAAAAg4yVnqevuMHK09vk7fb/AAgRGiMrND"
        "1GT1dgaXJ7g4yVnqevuMHK09vk7fb/AAgRGiMrND1GT1dgaXJ7g4yVnqevuMHK09vk"
        "7fb/AAgRGiMrND1GT1dgaXJ7g4yVnqevuMHK09vk7fb/AAgRGiMrND1GT1dgaXJ7g4"
        "yVnqevuMHK09vk7fb/AAgRGiMrND1GT1dgaXJ7g4yVnqevuMHK09vk7fb/AAgRGiMr"
        "ND1GT1dgaXJ7g4yVnqevuMHK09vk7fb/AAgRGiMrND1GT1dgaXJ7g4yVnqevuMHK09"
        "vk7fb/AAgRGiMrND1GT1dgaXJ7g4yVnqevuMHK09vk7fb/AAgRGiMrND1GT1dgaXJ7"
        "g4yVnqevuMHK09vk7fb/AAgRGiMrND1GT1dgaXJ7g4yVnqevuMHK09vk7fb/AAgRGi"
        "MrND1GT1dgaXJ7g4yVnqevuMHK09vk7fb/AFZQOCAYAQAA0AYAnQEqHgAVAD5tKJNF"
        "pCIhmAwGAEAGxLYAWI9COulrDZGOygsC4cjt/8gd4FiDcLkWi53v+maC66OAXWKAAP"
        "7+Gw5mg/kvBiUtzfMACrbOAMUIKDbcOnx41J1xqk7Z6ovqzdc4eq80HlIOHZzfrf4m"
        "Z5/fG53BX/joETMiwtiX5Qc3y87Q1EBcJaHHVbuq2hK+lIyrsMEcPNTsoXFUIqwmrU"
        "gibblKQdHx57mOH5W3gOZSdEJeAMfIJkAGQ+50mIRBExHnkmnOyNvaHfNQs98dloq6"
        "5kb3k3MJ3bFyBx48idD27gN9VbaOJHKLWhXEQU2IQduIrCk5jHXkD1Xcb6IH+NN4iQ"
        "FceFxPldJU26J2MG1Gf0kAAA==",
        ((21, 30, 3), "18c834c44a825a030826886c72ec6a47"
                      "384e22ffc91496acefe747c1b1539cb9")),
    "alph_vp8l_f1": (
        "UklGRjYBAABXRUJQVlA4WAoAAAAQAAAAHQAAFAAAQUxQSC4AAAAFJ0CYbRzbflM7pY"
        "uIID8ohiRJGoSJNpgkWIb1N7veEf2PFkYY4fiuqnULI58DVlA4IOIAAAAQBgCdASoe"
        "ABUAPp08mEiloyIhMBgMALATiWwArDLjdwM7rMsSIMRuWvuWbXYe841l3XQbRSGzyz"
        "AA/v1X0mRCc85PSMyqg5U53bUI/XYgCVVAwA3aUz8b7iUB+EaMpNrJHP36MMsZcEG4"
        "quxyeuGFw/uP9/H+qJBOB6BmnlPL+KXeOejdu9M+ovBTqkGGK0hnUR4B2nQk/CmaLR"
        "Jsc54CrSjfa6+vPoBo2puwfuU8oi0s1PrJ0gMoVZA48gb8k6k02ICStwFRkGZya+ef"
        "sb4S9azh/PYp7woagWGAxfIITQAA",
        ((21, 30, 3), "bbd04cdc8e320b08a9f8e796882ce74c"
                      "60184150334ba02794aa82c9e19093c1")),
    "anim_offset_lossy_alpha": (
        "UklGRigFAABXRUJQVlA4WAoAAAASAAAAHQAAEwAAQU5JTQYAAACAQCD/AABBTk1Geg"
        "AAAAIAAAMAAAkAAAcAAGQAAABBTFBIJAAAAAFPIBBI4SAdEREzQyFkK1AIsXySLpZY"
        "Aj4RIvofjMjqJBPxAFZQOCA2AAAA0AEAnQEqCgAIAAJAOCWoAnQBDv3vPgAA/vKkPb"
        "bMK6yRCnHk/DRZPgTP2Hlb4u/nLjOOwAAAQU5NRnoEAAAAAAAAAAAdAAATAABkAAAA"
        "VlA4TGIEAAAvHcAEAAkyAYtzQ//ESkT0P7Ky7S4UtG3DGMr4A/sDpKhtG8gqgPGHej"
        "6UNJLEfBNw/tUd+oYePux/YD6BfBRgN7sl916wCCTZ1p42ksAWWWYnKYZ11ZLq9LiX"
        "QwvoKc2Yw7YsWZHV9O9Bjrb/bdv8ARAAIeqvwiLSvXv0492HyCmyZcs1POUS7QB9zt"
        "wP0Ju6BHYCkCzbttNGeqLnF1nmYuYJcMNXD7QH1HPoPwqTUS5LDrVpGzDKXu5ABFHS"
        "oyksPd1bR/dtqPKAqOaXxdmq191SRUi0aXodKZk/3SriYxDKmUh7fbpVs+gSmVqiEn"
        "2EsZEZ4e9wSt2NzFMkVKADuaORDmMyPbZLfHhfIID/8+osxFU8IjpUOEg9Ky0cqjy0"
        "ken2us4OjmF1wGk9mZaj16MaDYwZtu7HKJxw8+WFQwAAdZk/qISmavVfLJCEZqAxQZ"
        "+WVaREvNEKwsEs1Nf3xDHwp6rr3T4WdamJ0vrjsxlEEEaROWBpzNOp25+UF+vGatuy"
        "QeYC9ycnRhRMklM8bvxBHVgv/M9hwKPyhqfvnpaQryrqW1Y2k844ni+2/YXGkMUqNB"
        "t7KBXvySexahjXuKjx5oyFcYDk8r9MSlmkw/v7DYQU0jhneemvaKqGqedpfGwDqAqr"
        "DAzEVmdai2aZmy1KDdOWlMa3Q39upvPA4PXrKTQA5Jz4pkOhQAueFajWsd0AyUxSUE"
        "tcEIPdRHNkte0wvyDRHnmNGBVkohGHzcsSOvf8qlWh10Xo45jExF4zu0VXVds5cF7z"
        "RBZr3SN6WI2DPP61c/eSM1QPRT7be4WFDHj5pPryaPX/wP27H1ZRJAZlRA2Rliuh55"
        "h92j0pwvF2cVb79X6UfRutg2ePDZWoWHvqX5Buu/+N19e7Hw8RrPC8QlZhIdlcm0Hb"
        "KGUx1g46AhT+P/nwDp48xZ80Meen5MQZrC7vztbf/s4VBcUW/cw2xE9M3p2m3bRyE/"
        "hkBHfo7EIQ4T2U1qvz9ABJZjhSXxdl0bBgo/736tDXLdSc1ObPFQlLU19BX5aiHYHG"
        "rFJ31k5Zkzi7ivV5VOPmlqD9wpDj2uxUyRnEoQxUjY2XkOkqIBMVMCxMVE9nrAdQmV"
        "xRudJoTcGgkp3p/YJhzqup49dlx0ISYJOu3Gy9/QqR5A/9Lacwp9lvyIZQ7Qd0SxxO"
        "jZwejaIkay2tWXe62UObeZX4uTS2ZGer++9l2EaVRmoLExxSsQDYL6C4YBMkLmP9UJ"
        "eySJSqJRu82u4aMk+hO0+5+jJDOdPzPNwkQ0rpzMkCXaqF8z14GgvbQcHYjlVqebRx"
        "WCagzDoTPhPH3IrHB9ib4xXoI+wbH/oBSnZdzdXHi46t4YIA3pQVMyiY1EbW/nSons"
        "Vw0RjaNgWON861i/y4HoRLu6pa61P6gYFIQbQoN1nUSyu2LLoQokpYzPpue+ivybVZ"
        "L725HmW74ZxBpNFn7nExWW3VqgxO1l+ZFuYQ9gysD6wJc+7p2OSlDQA=",
        ((20, 30, 3), "439a3eef2bcc71d87de86dcde27fb015"
                      "f48a26e54bca215442da1c6150ccd785")),
    "exif6_wide_lossy": (
        "UklGRmABAABXRUJQVlA4WAoAAAAIAAAAHQAAEwAAVlA4ICABAADQBgCdASoeABQAPm"
        "0skkWkIqGYBABABsS0AE6ZQjwfpIRJ9AA/AXR20B9pLPeMKuf694BCO6aJOLcnESyi"
        "RAAA/q35uv5vzfH/SHE6zy6exB208UBgQc8IuDwaq+laqVr/pI1lCKDU+/qK4UgS+/"
        "rbe/3CmWkYFT7rHA+f/zvbrgKOsxXvzqy5MHer/8dUS+co+LfrtOJXqG/lzE/L1Ygg"
        "ihAxAVLhJQzzI1oUN5Q/3RKGN324mUS724AsiTSIP0OAMT3Uwi5rTWlt1q/OwEltb9"
        "Jyihefuv8ow4ccYHTXavKpqB6NdLYQ06+CTBo2Jjo2SCwv/WHMJN3EWjWBelLBfSlM"
        "SvLeF6e6FZYg+RBz7ichz6350hF4vgiZ5HAmQABFWElGGgAAAElJKgAIAAAAAQASAQ"
        "MAAQAAAAYAAAAAAAAA",
        ((30, 20, 3), "f8c8b018a19748aa009366e35dad37bf"
                      "708c4e7745e50b1ba60a128762cab38a")),
    "vp8w_simple": (
        "UklGRt4CAABXRUJQVlA4INECAADwBgCdASotACUAF4cIIaDBQAAArFaKDKWDhSF0PQ"
        "uXLxBXC2nsmemr6SsSgh9nR7xmzMiMQvzu4eUzAvW+N8xgAPS/+oPlwUNfBVNi9xhf"
        "qXt4oX+0/w08FVJ9hrf7y9RwsbPT/7ud5n8lCwuScxTk/+6Mqcrn0f/9zwg/2LtF0H"
        "A5oDRIw3+JN+Tmb3rTK/g9f/u428gNodsdFxA/ogEAAEj/l2tsdra9o80Dad/Pb4Q3"
        "RWt6T8avO/xh8Kjfj/ih/Q18penWwmete2ECq8gjzEf22OFC4v+kzPCi6pvwz+wXnB"
        "X6bb76wZb//5fR/x/1kiyd+wVIf+TihX2b/4f7H/wuFUVh2hILlCv5MLSdH/wcAnff"
        "nM1/raKkExQhNcM/HkHN7PK3tLBa//t36ak/3/q/yu9RJMdj/Jfg/dz8XXbmein/We"
        "90I333et/OUL/O5ZOy7/7r3l05+C107a56hKUbJf4/4Xf8G7BMj+h1v+Sc8JdDP/P/"
        "EoCM3v6Pwm7XQFdhS5A4fqok/BawJ9dRPd5M8f5AbwxqVLNu717kfpMrnpRactKz/+"
        "6+EaLMdXwb8d5a+u37ixUtuB9PSf/dHP7roe83hqNtHHVq52CPOL07QiWXqcrC1aPc"
        "blDt6CnNOAj+hmg8H/3Om/0LtohFD+F2jbq7AHv9RAUxDs6Pc/MsVlXhcvc/z5n/7t"
        "js4C3+NG9hveTHtpW/+8DUXx72OPBvoxtns7/y9jn4L9aHz8/I5tLvBT2Z7IfsDXvL"
        "50Oz3uvg+/XscV/U9dLO9rn5TMngY9Dh+prvqiX+rAbmoBYr7Fb5v/h+UP3VPbpxh/"
        "/shn/+x5cDz/7APo/A95TehnaAi27FMEn19/7WmenGx2LK3Dq6miv1n4yIOxuDhqgM"
        "V9DbJAf6IBrvdzX0j/5gP/spcsqdusMVNov6SgGVhScXJ/yTJH/yeHV/yd1JpEgAAA"
        "==",
        ((37, 45, 3), "14fc7c0e0a9aa57fb4583a158e5bf514"
                      "85ef62c4ed5abed41c0d16a3b34772db")),
    "vp8w_parts8": (
        "UklGRgoDAABXRUJQVlA4IP0CAADwBgCdASotACUABQcIIaDNQAAArFaKDKWDhSF0PQ"
        "uXLxBXC2nsmemr6SsSgh9nR7xmzMiMQvzu4eUzAvW+N8xgANkAAOQAANYAAAQAAAQA"
        "AAQAAAQAAPS/+oPlwUNfBVNi9xhfqXt4oX+0/w08FVJ9hrf7y9RwsbPT/7ud5n8lCw"
        "uScxTk/+6Mqcrn0f/9zwg/2LtF0HA5oDRIw3+JN+Tmb3rTK/g9f/u428gNodsdFxA/"
        "ogEAAEj/l2tsdra9o80Dad/Pb4Q3RWt6T8avO/xh8Kjfj/ih/Q18penWwmete2ECq8"
        "gjzEf22OFC4v+kzPCi6pvwz+wXnBX6bb76wZb//5fR/x/1kiyd+wVIf+TihX2b/4f7"
        "H/wuFUVh2hILlCv5MLSdH/wcAnffnM1/rAj4UKTsuPkrf13Ylnf218w/px/9u/TUn+"
        "/9X+V3qJJjsf5L8H7ufi67cz0U/6z3uhG++71v5yhf53LJ2Xf/de8unPwWunbXPUJS"
        "jZL/H/C7/g3YJkf0Ot/yTnhLoZ/5/4lARm9/R+E3a6ArsKXIHD9VEn4LWBPrqJ7vJn"
        "j/IDeGNSpZt3evcj9Jlc9KLTlpWf/3XwjRZjq+DfjvLX12/cWKltwPp6T/7o5/ddD3"
        "m8NRto46tXOwR5xenaESy9TlYWrR7jcodvQU5pwEf0M0Hg/+503+hdtEIofwu0bdXY"
        "A9/qICbACCFZ/Z7e3S0M/MdCqZj29/3bHZwFv8aN7De8mPbSt/94Govj3sceDfRjbP"
        "Z3/l7HPwX60Pn5+RzaXeCnsz2Q/YGveXzodnvdfB9+vY4r+p66Wd7XPymZPAx6HD9T"
        "XfVEv9WA3NQCxX2K3zf/D8ofuqe3TjD//ZDP/9jy4Hn/2AfR+B7ym9DO0BFt2KYJPr"
        "7/2tM9ONjsWVuHV1NFfrPxkQdjcHDVAYr6G2SA/0QDXe7mvpH/zAf/ZS5ZU7dYYqbR"
        "f0lAMrCk4uT/kmSP/k8Or/k7qTSJAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA",
        ((37, 45, 3), "0643e12b8db06d3d54fb1cdd008b1248"
                      "4e19ddf4139fbe6f4c6f3e63129dc41d")),
    "vp8w_segments": (
        "UklGRhoEAABXRUJQVlA4IA4EAADQCACdASotACUAOiqMTxIxlRZHIKDhBDQYKAAAFY"
        "uGNt/Tn6ewxOmufjuWjXznEhnSxtzpL7aH5U6ztGdB81u9mo5xEzOCl36bukg3g5OA"
        "QPs4A+V+7d+r/3sVy3ZF+/4+V5iL+QnpeUj+Pr0elMfSf6X9zkpHP/dMf6qu3yy/gU"
        "vQUylj+6ykeGFfJPwwIdvTIxaZD2HrrjfjoQd//dtNZ+fIv8wH8wCoxJv+2koaUIvH"
        "YlAOaAUP5PX/l/+smHesrNn352+3zxdHBQOpX8f/BsjBLJgLcpJvFSve6ylLjNnRIv"
        "ly3X58xI53oT+TAn6pOYqDLU4/L/8w/LJqn7fsg40WKpMXvKjFbjV9pVE3dUUFnib/"
        "eiI1SMSnyZ/3WdvJOUObv/LO7bSwWK1X3OQO4QOQA+rq4thgAGYgWOYKH//siXx+Dc"
        "yrew8x5GZa//dJA8v9pG5Iq4bG5evKZnZtkPAMRvwwf//dEUKoeYXjAycShcoo7cwc"
        "+FQ0TMTvmts5amPBf3wcwLi6Eb1CX/EBd0YBwVJYr/qpq//IiBa4RP+XfyI3VGtond"
        "hKl61HeU0bYsRvYn+vQn+lC5e4fSab3+5R/qLcposolLf/iz1h71Lcv1v/+TVs6re0"
        "Xgv1U2fxt//2TmmcHkq1g0wAhsEO/8HjPzgP6FXQ/+ZQQJcfya77lYv/xAWOPf/9kM"
        "/ocC4nAAAd/mb7oa2HmNOV/LVfueG9DdftRpNC4c/PJyJgcH8bOpbgQ4mcs/3dgQi/"
        "qDFHdc5bjOGmfkGAn0OsB46HS3yzhr0PURQC7/4MPX/0OAwYxov/Ccaj/gSvfMu+Ds"
        "maz/qYev/wQlmUy3moaESNLu/pKlOY+jRrp9IZ/HNijWcdtvNefCcUNuCcNMoqo3b/"
        "d6/++2Efmf53Ir//LP/+XQaHZZ//sa2pzP6yAAs9b5tK8Bvj+p8Y+TAG53HgAD2D8A"
        "qfx/wUf1//2RXEvuqe6C9P3Y+sYqzXMZtuM/6cwfDIsKzxg/7uFNXv+esX/sfHfh6d"
        "7wgkKFMqCLRuDv+p/a1l+ZQ6v2f+f+hvFDqhA4QPQ/mJR/9ScpgXP4ErzcoGD+H9lM"
        "O4ff+6VLYsHcSGrOJ17kXhNa04jLiZ05D/+5uccV2IE1BHjrVr8YdvQ7Ar//7ouCf9"
        "5KTn/c3MWw9DYDK3VXfhWiUJWGDn//ZERwXwiN6AHD9RK4/lGM969nAQ//c89FvowB"
        "DdZ+OnVI7+BD+WBy/Rmp4Sg2cvjou9kN3nxGoNhD8c6LFQVzWNjuHF60///ZFMygS6"
        "hCyEXVtQcht+uAPNCaknNSWi40SFk+Bcpd1U/oVtFf5/58it7RytiCqv/KE/4Eos/5"
        "PGfldqTJn0XgMT8LtSx5InB/A=",
        ((37, 45, 3), "8babfb522ee71944c7390ac3d23ae24d"
                      "212c3458ece798ed587822e9596198fd")),
    "vp8w_sharpness3": (
        "UklGRnQDAABXRUJQVlA4IGgDAABwBACdASotACUACN8IIaDBQAAArDap++eWZu+Pub"
        "K+grui1uY/4to60kGn4SD9nFnP2l3Vm76UDYg7wTqHYZxJMPJpjH9J9aCXu+EvsYTY"
        "96aIkX+qEHG8ZxP+53e0/4MtzJC+3Fr0LIT7t00KU+k1+woj3qv/NRuPrn9TT4uX/i"
        "UHsbIAAaP0S/+VfQb+Tz/EB//Y2vU3lXBf8nrtPhaBb7ft5QZPjA3hPBsIuUb/YOD/"
        "v6V+/f3PY/9d+f+0VucF8nRrs+TZ/S+La38C/1r1DK/lTL739ZN8jIebv+Wl+RDfe1"
        "wewcLy6RhwIJTgABc/hds1En8SgBHkHQ/wTTvDUa/1cQS7PDYn1FuV+PeSv5+2SeuF"
        "b0DCjNh1b+pv4QHTOt8l2ZyzUc0ZbWuwN/Ud9E/P/vLuB4yfI4JcJwkaB/593fhCXz"
        "6e/5OatkAxPwIgKG3DvfyGxdriu/22+6Vj+RK5H/+59lRf/gzf16+ZXKX//Y1RwCh0"
        "VVWk5Hhax6oi3b2mpumiEFaFpgbwj3/+6ntDYItuh7EIkIfR/7AnQ9ZPIXbCOoX/y9"
        "BbBgBbReAAh/4N16efme4rzgApWp3zfTjouEc8AA5VkH2t/fI4LZ2/Qy/O/Bp+ulX+"
        "snOsdR931CTvP5Ti/qv+tKzdtJ947zIX6q/Ju6g//cqSSR33PtxEbzzR+tWwsBIFUp"
        "3/g8Yw73/yadNr7nwT/3QQGfvAs1LVJ9EnrQ/oJXyBn9f+pVkaSE/QflBp5d8P+Hmu"
        "XTlp///dX48iC8jGD/6lhbNbPrf+yFW///sisgvhq9mw/eJXRpoiYbYn//9kMa7qXz"
        "ck6v81b4CSZCbxF/kRAtfTWqKDncQxZ1R/yeSYAEYT/JbK/OH8k0pg+/oJXI/+ThQ/"
        "+jJbX09aG3/3St3QhkL3rqg7kC4vDLSb+qeP3PAJ9bjmZD3RW6zY/xWRJJq7dYh1n/"
        "3bRb/RXCaHONY0If8CV1HCV7N8MKQc/+i7zKNnKd+0lH/0LpbLKH8f9DvPQBCr2//d"
        "oHhg6WGPU6Zz/N1C6jkAnddYHJ7aS3Nh8xj7GzNm5rVoT9sjxuhPqKkUtB6jFI3BmN"
        "O1UrVfoZwnzsEZm78FP/+yOX+UvMjZ/ADfGV/LkEU/60Of//2SaVLtGY/5vh+fQv6A"
        "AA==",
        ((37, 45, 3), "662685f401aeeac9a2d8eaa349346b54"
                      "8f2549c34831bf9b964755cc42f69487")),
}


def write_fixtures(root) -> dict:
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (b64, _) in FIXTURES.items():
        path = root / f"{name}.webp"
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
    assert sorted(FIXTURES) == sorted(FIXTURE_KINDS)


@pytest.mark.parametrize("name", FIXTURE_KINDS)
def test_fixtures_decode_to_cv2s_digests(name, tmp_path):
    path = write_fixtures(tmp_path)[name]
    shape, digest = FIXTURES[name][1]
    got = image_io.imread(path)
    assert (got.shape, rgb_digest(got)) == (shape, digest)
    want = _cv2_read(path)
    assert (want.shape, rgb_digest(want)) == (shape, digest)


def _print_fixtures():
    """The FIXTURES dict of FIXTURE_KINDS, with cv2's digests (needs cv2
    and Pillow)."""
    import tempfile
    import textwrap

    import cv2

    with tempfile.TemporaryDirectory() as tmp:
        print("FIXTURES = {")
        for name in FIXTURE_KINDS:
            path = Path(tmp) / f"{name}.webp"
            path.write_bytes(make_kind(name))
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


def _print_sizes():
    """The port's WebP writers beside cv2.imwrite's on chip_smoke.py's val
    images (its `write_split`, 5 images at its native sizes): bytes, and
    for the lossy kinds the PSNR of the decode against the image (needs
    cv2)."""
    import tempfile

    import cv2

    sys.path.insert(0, str(REPO))
    import chip_smoke
    from efficientteacher_torch.data import webp_io

    def psnr(a, b):
        mse = np.mean((a.astype(np.float64) - b) ** 2)
        return "exact" if mse == 0 else f"{10 * np.log10(255.0 ** 2 / mse):.2f}"

    with tempfile.TemporaryDirectory() as tmp:
        lst, _ = chip_smoke.write_split(Path(tmp) / "val", "val", 5, 2, 0)
        print("image, kind: port bytes (PSNR dB) / cv2 bytes (PSNR dB)")
        for src in Path(lst).read_text().split():
            rgb = image_io.imread(src)
            for q in (None, 75, 90):
                ours, theirs = Path(tmp) / "a.webp", Path(tmp) / "b.webp"
                webp_io.write_webp(str(ours), rgb, q)
                cv2.imwrite(str(theirs), rgb[..., ::-1], [] if q is None
                            else [cv2.IMWRITE_WEBP_QUALITY, q])
                a, b = image_io.imread(str(ours)), _cv2_read(theirs)
                print(f"{Path(src).name} {rgb.shape[1]}x{rgb.shape[0]}, "
                      f"{'lossless' if q is None else f'q{q}'}: "
                      f"{ours.stat().st_size} ({psnr(a, rgb)}) / "
                      f"{theirs.stat().st_size} ({psnr(b, rgb)})")


if __name__ == "__main__":
    sys.exit(_print_sizes() if "--sizes" in sys.argv else _print_fixtures())

"""JPEG writers for the tests and chip_smoke.py: the kinds no encoder on the
test machines writes (numpy and the standard library only).

- `encode(planes, factors, script, ...)`: a DCT file from full-size planes
  (YCbCr, RGB, CMYK as the markers say) sampled with `factors`, coded by
  `script`: "baseline" (one interleaved Huffman scan), "progressive"
  (libjpeg's jpeg_simple_progression script: DC and AC first and
  refinement scans, EOB runs, correction bits), or a list of
  (components, Ss, Se, Ah, Al) scans; Huffman tables are built from each
  scan's symbol counts (libjpeg's jpeg_gen_optimal_table), or the data are
  arithmetic-coded (`arith`: the QM coder of ITU T.81 Annex D as
  libjpeg's jcarith.c codes it, with DAC conditioning). `precision` 12
  writes an extended (SOF1) 12-bit file.
- `encode_lossless(planes, psv, pt, ...)`: a lossless (SOF3) file, Huffman
  coded differences of predictor `psv` (1-7) with point transform `pt`.
- `encode_hierarchical(plane)`: a hierarchical file (DHP, a baseline frame
  of the half-size image, EXP, a differential SOF5 frame).
- `cut(data, fraction)` and `first_scans(data, n)`: a file cut short as an
  interrupted download leaves it, and a progressive file ended by EOI after
  its first n scans.
"""

import struct

import numpy as np

ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
                   28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
                   37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
                   54, 47, 55, 62, 63])
# jcparam.c std_luminance_quant_tbl / std_chrominance_quant_tbl (natural)
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.full(64, 99)
CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]


def quant_table(base, quality, limit=255):
    """jcparam.c jpeg_quality_scaling + jpeg_add_quant_table."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, limit).astype(np.int64)


def _seg(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def ycc(rgb):
    """JFIF's YCbCr planes of an RGB image (h, w, 3), rounded."""
    x = rgb.astype(np.float64)
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    return [np.rint(c).clip(0, 255).astype(np.uint8)
            for c in (y, 128 + (x[..., 2] - y) * 0.564,
                      128 + (x[..., 0] - y) * 0.713)]


# ---------------------------------------------------------------- DCT model

def coefficients(planes, factors, qtables, tq, precision=8):
    """Quantised DCT blocks of each plane: [(bh, bw, 64) int64, natural
    order], sampled by point decimation to (h, v) of the largest factors,
    padded by edge replication to whole MCUs."""
    h, w = planes[0].shape
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    k = np.arange(8)
    dct = np.sqrt(2 / 8) * np.cos((2 * k[None] + 1) * k[:, None] * np.pi / 16)
    dct[0] /= np.sqrt(2)
    out = []
    for plane, (ch, cv), t in zip(planes, factors, tq):
        big = np.pad(plane.astype(np.float64),
                     ((0, mcuy * 8 * vmax - h), (0, mcux * 8 * hmax - w)),
                     mode="edge")
        rows = np.arange(mcuy * 8 * cv) * vmax // cv
        cols = np.arange(mcux * 8 * ch) * hmax // ch
        small = big[rows][:, cols] - (1 << (precision - 1))
        blocks = small.reshape(mcuy * cv, 8, mcux * ch, 8).transpose(0, 2, 1,
                                                                      3)
        coef = dct @ blocks @ dct.T
        q = qtables[t].reshape(8, 8)
        out.append(np.rint(coef / q).astype(np.int64).reshape(
            mcuy * cv, mcux * ch, 64))
    return out, (mcux, mcuy, hmax, vmax)


# ---------------------------------------------------------------- Huffman

def optimal_table(freq):
    """jchuff.c jpeg_gen_optimal_table: (bits[16], symbols) of a code no
    longer than 16 bits with no all-ones code, from symbol counts."""
    freq = list(freq) + [1]
    codesize, others = [0] * 257, [-1] * 257
    while True:
        live = [i for i in range(257) if freq[i]]
        c1 = max(live, key=lambda i: (-freq[i], i))
        rest = [i for i in live if i != c1]
        if not rest:
            break
        c2 = max(rest, key=lambda i: (-freq[i], i))
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    vals = [s for n in range(1, 33) for s in range(256) if codesize[s] == n]
    return bits[1:17], vals


def huffman_codes(bits, vals):
    """{symbol: (code, length)} of a DHT table (ITU T.81 C.2)."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _magnitude(v):
    size = int(abs(v)).bit_length()
    return size, (v if v >= 0 else v + (1 << size) - 1)


def _pack_codes(values, lengths):
    """Bits of (value, length) items, MSB first, padded with 1s and 0xFF
    stuffed (numpy: the lossless writer's millions of items)."""
    lengths = np.asarray(lengths, np.int64)
    values = np.asarray(values, np.int64)
    out = []
    for lo in range(0, len(values), 1 << 18):
        v, n = values[lo:lo + (1 << 18)], lengths[lo:lo + (1 << 18)]
        shift = n[:, None] - 1 - np.arange(32)[None, :]
        bits = ((v[:, None] >> np.maximum(shift, 0)) & 1).astype(np.uint8)
        out.append(bits[shift >= 0])
    stream = np.concatenate(out) if out else np.zeros(0, np.uint8)
    stream = np.concatenate([stream, np.ones(-len(stream) % 8, np.uint8)])
    packed = np.packbits(stream)
    return np.insert(packed, np.nonzero(packed == 0xFF)[0] + 1, 0).tobytes()


def _huffman_scan(tokens, tables) -> bytes:
    """A scan's entropy-coded bytes from its tokens: ("dc"|"ac",
    component, symbol), ("bits", v, n), ("rst", k); each segment padded
    with 1s (`_pack_codes`), RSTk between them."""
    out, values, lengths = [], [], []
    for t in tokens:
        if t[0] == "rst":
            out += [_pack_codes(values, lengths), bytes([0xFF, 0xD0 + t[1]])]
            values, lengths = [], []
            continue
        v, n = t[1:] if t[0] == "bits" else tables[(t[0], t[1])][t[2]]
        values.append(v & ((1 << n) - 1))
        lengths.append(n)
    return b"".join(out) + _pack_codes(values, lengths)


# ---------------------------------------------------------------- scans

def _cdiv(a, b):
    return -(-a // b)


def _blocks_of_scan(geom, comps, factors):
    """The (component, block row, block col) of each block of each MCU of
    a scan: one block per MCU in a scan of one component (its blocks that
    the image covers), else whole interleaved MCUs."""
    mcux, mcuy, hmax, vmax, h, w = geom
    if len(comps) == 1:
        c = comps[0]
        ch, cv = factors[c]
        hib = _cdiv(_cdiv(h * cv, vmax), 8)
        wib = _cdiv(_cdiv(w * ch, hmax), 8)
        return [[(c, by, bx)] for by in range(hib) for bx in range(wib)]
    mcus = []
    for my in range(mcuy):
        for mx in range(mcux):
            mcu = []
            for c in comps:
                ch, cv = factors[c]
                mcu += [(c, my * cv + v, mx * ch + hh) for v in range(cv)
                        for hh in range(ch)]
            mcus.append(mcu)
    return mcus


SIMPLE_PROGRESSION = [  # jcparam.c jpeg_simple_progression, YCbCr
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
    ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
    ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
    ((0,), 1, 63, 1, 0)]
SIMPLE_PROGRESSION_GREY = [
    ((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
    ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


def _ac_value(c, al):
    """A coefficient after the point transform (jcphuff.c: the absolute
    value shifted, the sign kept)."""
    return (abs(c) >> al) * (1 if c >= 0 else -1)


def _scan_tokens(coefs, mcus, scan, restart, progressive):
    """Huffman tokens of one scan (jchuff.c encode_one_block; jcphuff.c
    encode_mcu_DC_first / AC_first / DC_refine / AC_refine)."""
    comps, ss, se, ah, al = scan
    tokens = []
    preds = {c: 0 for c in comps}
    eobrun, be = 0, []

    def emit_eobrun(c):
        nonlocal eobrun, be
        if eobrun:
            r = eobrun.bit_length() - 1
            tokens.append(("ac", c, r << 4))
            if r:
                tokens.append(("bits", eobrun, r))
            eobrun = 0
            tokens.extend(("bits", b, 1) for b in be)
            be = []

    for m, mcu in enumerate(mcus):
        if restart and m and m % restart == 0:
            emit_eobrun(mcu[0][0])
            tokens.append(("rst", (m // restart - 1) & 7))
            preds = {c: 0 for c in comps}
        for c, by, bx in mcu:
            blk = coefs[c][by, bx]
            if not progressive or (ss == 0 and ah == 0):
                dc = blk[0] >> al if progressive else blk[0]
                size, bits = _magnitude(dc - preds[c])
                preds[c] = dc
                tokens += [("dc", c, size), ("bits", bits, size)]
                if progressive:
                    continue
            if progressive and ss == 0:  # DC refinement: one raw bit
                tokens.append(("bits", (blk[0] >> al) & 1, 1))
                continue
            zz = blk[ZIGZAG]
            lo, hi = (1, 63) if not progressive else (ss, se)
            if not progressive or ah == 0:
                vals = [_ac_value(int(zz[k]), al) for k in range(lo, hi + 1)]
                last = max([i for i, v in enumerate(vals) if v] or [-1])
                if progressive and last < 0:
                    eobrun += 1
                    if eobrun == 0x7FFF:
                        emit_eobrun(c)
                    continue
                if progressive:
                    emit_eobrun(c)
                run = 0
                for v in vals[:last + 1]:
                    if not v:
                        run += 1
                        continue
                    while run > 15:
                        tokens.append(("ac", c, 0xF0))
                        run -= 16
                    size, bits = _magnitude(v)
                    tokens += [("ac", c, (run << 4) | size), ("bits", bits,
                                                              size)]
                    run = 0
                if last < len(vals) - 1:
                    if progressive:
                        eobrun += 1
                        if eobrun == 0x7FFF:
                            emit_eobrun(c)
                    else:
                        tokens.append(("ac", c, 0x00))
                continue
            # AC refinement (jcphuff.c encode_mcu_AC_refine)
            absv = [abs(int(zz[k])) >> al for k in range(ss, se + 1)]
            eob = max([i for i, v in enumerate(absv) if v == 1] or [-1])
            run, br = 0, []
            for i, v in enumerate(absv):
                if v == 0:
                    run += 1
                    continue
                while run > 15 and i <= eob:
                    emit_eobrun(c)
                    tokens.append(("ac", c, 0xF0))
                    run -= 16
                    tokens += [("bits", b, 1) for b in br]
                    br = []
                if v > 1:
                    br.append(v & 1)
                    continue
                emit_eobrun(c)
                tokens += [("ac", c, (run << 4) | 1),
                           ("bits", 0 if zz[ss + i] < 0 else 1, 1)]
                tokens += [("bits", b, 1) for b in br]
                br, run = [], 0
            if run > 0 or br:
                eobrun += 1
                be += br
                if eobrun == 0x7FFF or len(be) > 1000 - 63:
                    emit_eobrun(c)
    emit_eobrun(comps[0])
    return tokens


# ---------------------------------------------------------------- QM coder

def _aritab():
    """jaricom.c's Qe table: (Qe, Next_Index_LPS, Next_Index_MPS,
    Switch_MPS) per state (ITU T.81 Table D.3, then T.851's fixed 0.5)."""
    rows = """5a1d 1 1 1;2586 14 2 0;1114 16 3 0;080b 18 4 0;03d8 20 5 0;
    01da 23 6 0;00e5 25 7 0;006f 28 8 0;0036 30 9 0;001a 33 10 0;
    000d 35 11 0;0006 9 12 0;0003 10 13 0;0001 12 13 0;5a7f 15 15 1;
    3f25 36 16 0;2cf2 38 17 0;207c 39 18 0;17b9 40 19 0;1182 42 20 0;
    0cef 43 21 0;09a1 45 22 0;072f 46 23 0;055c 48 24 0;0406 49 25 0;
    0303 51 26 0;0240 52 27 0;01b1 54 28 0;0144 56 29 0;00f5 57 30 0;
    00b7 59 31 0;008a 60 32 0;0068 62 33 0;004e 63 34 0;003b 32 35 0;
    002c 33 9 0;5ae1 37 37 1;484c 64 38 0;3a0d 65 39 0;2ef1 67 40 0;
    261f 68 41 0;1f33 69 42 0;19a8 70 43 0;1518 72 44 0;1177 73 45 0;
    0e74 74 46 0;0bfb 75 47 0;09f8 77 48 0;0861 78 49 0;0706 79 50 0;
    05cd 48 51 0;04de 50 52 0;040f 50 53 0;0363 51 54 0;02d4 52 55 0;
    025c 53 56 0;01f8 54 57 0;01a4 55 58 0;0160 56 59 0;0125 57 60 0;
    00f6 58 61 0;00cb 59 62 0;00ab 61 63 0;008f 61 32 0;5b12 65 65 1;
    4d04 80 66 0;412c 81 67 0;37d8 82 68 0;2fe8 83 69 0;293c 84 70 0;
    2379 86 71 0;1edf 87 72 0;1aa9 87 73 0;174e 72 74 0;1424 72 75 0;
    119c 74 76 0;0f6b 74 77 0;0d51 75 78 0;0bb6 77 79 0;0a40 77 48 0;
    5832 80 81 1;4d1c 88 82 0;438e 89 83 0;3bdd 90 84 0;34ee 91 85 0;
    2eae 92 86 0;299a 93 87 0;2516 86 71 0;5570 88 89 1;4ca9 95 90 0;
    44d9 96 91 0;3e22 97 92 0;3824 99 93 0;32b4 99 94 0;2e17 93 86 0;
    56a8 95 96 1;4f46 101 97 0;47e5 102 98 0;41cf 103 99 0;3c3d 104 100 0;
    375e 99 93 0;5231 105 102 0;4c0f 106 103 0;4639 107 104 0;
    415e 103 99 0;5627 105 106 1;50e7 108 107 0;4b85 109 103 0;
    5597 110 109 0;504f 111 107 0;5a10 110 111 1;5522 112 109 0;
    59eb 112 111 1;5a1d 113 113 0"""
    return [(int(q, 16), int(lps), int(mps), int(sw)) for q, lps, mps, sw in
            (r.split() for r in rows.split(";"))]


_ARITAB = _aritab()


class QMEncoder:
    """jcarith.c arith_encode and finish_pass: the QM coder's registers and
    its byte output (carries over stacked 0xFF bytes, 0xFF stuffing)."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _emit(self, b):
        self.out.append(b)

    def encode(self, st, i, val):
        """Code `val` (0/1) with the statistics bin st[i]."""
        sv = st[i]
        qe, nlps, nmps, switch = _ARITAB[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (nlps | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self.out += b"\0" * self.zc
                        self.zc = 0
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self.out += b"\0" * self.zc
                        self.zc = 0
                        self._emit(self.buffer)
                    if self.sc:
                        self.out += b"\0" * self.zc
                        self.zc = 0
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self.out += b"\0" * self.zc
                self.zc = 0
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self.out += b"\0" * self.zc
                self.zc = 0
                self._emit(self.buffer)
            if self.sc:
                self.out += b"\0" * self.zc
                self.zc = 0
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self.out += b"\0" * self.zc
            self.zc = 0
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)
        self.reset()


def _arith_value(enc, st, i, v, x1, ac=False):
    """Figures F.8 and F.9 for a nonzero |v|: its magnitude category from
    bin i (an AC value takes its second decision there too), then from bin
    x1 on, its bits from 14 bins further. Returns m, the top bit of
    v - 1 (0 when v is 1), on which DC conditioning decides."""
    m, v = 0, v - 1
    if v:
        enc.encode(st, i, 1)
        m, v2 = 1, v >> 1
        if ac and v2:
            enc.encode(st, i, 1)
            m, v2 = 2, v2 >> 1
        if m == 2 or not ac:
            i = x1
        while v2:
            enc.encode(st, i, 1)
            m <<= 1
            i += 1
            v2 >>= 1
    enc.encode(st, i, 0)
    top, i = m, i + 14
    while m > 1:
        m >>= 1
        enc.encode(st, i, 1 if m & v else 0)
    return top


def _arith_scan(enc, coefs, mcus, scan, restart, progressive, dac):
    """One arithmetic-coded scan (jcarith.c encode_mcu, encode_mcu_DC_first,
    _AC_first, _DC_refine, _AC_refine) -> bytes, RSTn included. The
    statistics areas are per table, as jcarith.c keeps them."""
    comps, ss, se, ah, al = scan
    dc_l, dc_u, ac_k = dac
    out = bytearray()
    tables = sorted({min(c, 1) for c in comps})

    def fresh():
        return ({t: bytearray(64) for t in tables},
                {t: bytearray(256) for t in tables},
                {c: 0 for c in comps}, {c: 0 for c in comps})

    dcs, acs, last, ctx = fresh()
    fixed = bytearray([113, 0, 0, 0])
    for n, mcu in enumerate(mcus):
        if restart and n and n % restart == 0:
            enc.finish()
            out += enc.out + bytes([0xFF, 0xD0 + ((n // restart - 1) & 7)])
            enc.out = bytearray()
            dcs, acs, last, ctx = fresh()
        for c, by, bx in mcu:
            blk = coefs[c][by, bx]
            tbl = min(c, 1)
            if not progressive or (ss == 0 and ah == 0):
                dcv = int(blk[0]) >> al if progressive else int(blk[0])
                st, s0 = dcs[tbl], ctx[c]
                v = dcv - last[c]
                if v == 0:
                    enc.encode(st, s0, 0)
                    ctx[c] = 0
                else:
                    last[c] = dcv
                    enc.encode(st, s0, 1)
                    enc.encode(st, s0 + 1, 0 if v > 0 else 1)
                    ctx[c] = 4 if v > 0 else 8
                    m = _arith_value(enc, st, s0 + (2 if v > 0 else 3),
                                     abs(v), 20)
                    if m < ((1 << dc_l[tbl]) >> 1):
                        ctx[c] = 0
                    elif m > ((1 << dc_u[tbl]) >> 1):
                        ctx[c] += 8
                if progressive:
                    continue
            if progressive and ss == 0:  # DC refinement: a fixed bin
                enc.encode(fixed, 0, (int(blk[0]) >> al) & 1)
                continue
            zz = [int(x) for x in blk[ZIGZAG]]
            lo, hi = (ss, se) if progressive else (1, 63)
            st = acs[tbl]
            if progressive and ah:  # G.1.3.3 Encode_AC_Coefficients_SA
                ke = max([k for k in range(lo, hi + 1)
                          if abs(zz[k]) >> al] or [0])
                kex = max([k for k in range(lo, ke + 1)
                           if abs(zz[k]) >> ah] or [0])
                k = lo
                while k <= ke:
                    i = 3 * (k - 1)
                    if k > kex:
                        enc.encode(st, i, 0)
                    while True:
                        v = abs(zz[k]) >> al
                        if v:
                            if v >> 1:
                                enc.encode(st, i + 2, v & 1)
                            else:
                                enc.encode(st, i + 1, 1)
                                enc.encode(fixed, 0, 1 if zz[k] < 0 else 0)
                            break
                        enc.encode(st, i + 1, 0)
                        i += 3
                        k += 1
                    k += 1
                if k <= hi:
                    enc.encode(st, 3 * (k - 1), 1)
                continue
            vals = {k: _ac_value(zz[k], al if progressive else 0)
                    for k in range(lo, hi + 1)}
            ke = max([k for k in vals if vals[k]] or [0])
            k = lo
            while k <= ke:  # F.5 Encode_AC_Coefficients
                i = 3 * (k - 1)
                enc.encode(st, i, 0)
                while vals[k] == 0:
                    enc.encode(st, i + 1, 0)
                    i += 3
                    k += 1
                enc.encode(st, i + 1, 1)
                v = vals[k]
                enc.encode(fixed, 0, 0 if v > 0 else 1)
                _arith_value(enc, st, i + 2, abs(v),
                             189 if k <= ac_k[tbl] else 217, ac=True)
                k += 1
            if k <= hi:
                enc.encode(st, 3 * (k - 1), 1)
    enc.finish()
    out += enc.out
    enc.out = bytearray()
    return bytes(out)


# ---------------------------------------------------------------- files

def encode(planes, factors, script="baseline", quality=75, precision=8,
           arith=False, restart=0, ids=None, adobe=None, dac=None,
           jfif=True):
    """A DCT-coded JPEG of the full-size `planes` (uint8, or 0-4095 for
    precision 12), sampled with `factors`. See the module docstring."""
    n = len(planes)
    ids = ids or list(range(1, n + 1))
    limit = 255 if precision == 8 else 32767
    qtables = [quant_table(LUMA_Q, quality, limit),
               quant_table(CHROMA_Q, quality, limit)]
    if precision == 12:
        qtables = [np.clip(t * 4, 1, limit) for t in qtables]
    tq = [min(c, 1) for c in range(n)]
    coefs, geom = coefficients(planes, factors, qtables, tq, precision)
    h, w = planes[0].shape
    geom = geom + (h, w)
    if script == "baseline":
        scans, progressive = [(tuple(range(n)), 0, 63, 0, 0)], False
    elif script == "progressive":
        scans = SIMPLE_PROGRESSION if n == 3 else SIMPLE_PROGRESSION_GREY
        progressive = True
    else:
        scans, progressive = list(script), True
    dac = dac or ([0, 0], [1, 1], [5, 5])
    sof = (0xCA if progressive else 0xC9) if arith else (
        0xC2 if progressive else (0xC1 if precision != 8 else 0xC0))
    head = b"\xff\xd8"
    if jfif and adobe is None:
        head += _seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if adobe is not None:
        head += _seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    pq = 0 if max(int(t.max()) for t in qtables) < 256 else 1
    head += _seg(0xDB, b"".join(
        bytes([(pq << 4) | t]) + (qtables[t][ZIGZAG].astype(">u2").tobytes()
                                  if pq else
                                  bytes(qtables[t][ZIGZAG].tolist()))
        for t in range(2)))
    head += _seg(sof, struct.pack(">BHHB", precision, h, w, n) + b"".join(
        bytes([ids[c], (f[0] << 4) | f[1], tq[c]])
        for c, f in enumerate(factors)))
    if arith:
        head += _seg(0xCC, b"".join(
            bytes([t, (dac[1][t] << 4) | dac[0][t]]) for t in range(2))
            + b"".join(bytes([16 + t, dac[2][t]]) for t in range(2)))
    if restart:
        head += _seg(0xDD, struct.pack(">H", restart))
    body = b""
    enc = QMEncoder()
    for scan in scans:
        comps, ss, se, ah, al = scan
        mcus = _blocks_of_scan(geom, list(comps), factors)
        sos = _seg(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[c], (min(c, 1) << 4) | min(c, 1)]) for c in comps)
            + bytes([ss, se, (ah << 4) | al]))
        if arith:
            body += sos + _arith_scan(enc, coefs, mcus, scan, restart,
                                      progressive, dac)
            continue
        tokens = _scan_tokens(coefs, mcus, scan, restart, progressive)
        tables, dht = {}, b""
        for kind in ("dc", "ac"):
            for t in sorted({min(tok[1], 1) for tok in tokens
                             if tok[0] == kind}):
                freq = [0] * 256
                for tok in tokens:
                    if tok[0] == kind and min(tok[1], 1) == t:
                        freq[tok[2]] += 1
                bits, vals = optimal_table(freq)
                codes = huffman_codes(bits, vals)
                for c in range(n):
                    if min(c, 1) == t:
                        tables[(kind, c)] = codes
                dht += _seg(0xC4, bytes([(kind == "ac") << 4 | t])
                            + bytes(bits) + bytes(vals))
        body += dht + sos + _huffman_scan(tokens, tables)
    return head + body + b"\xff\xd9"


def _lossless_diffs(x, psv, first_rows, initial):
    """jclossls.c's differences of the samples x (rows in `first_rows`
    predicted from the left and `initial`, the first column from above),
    modulo 2**16 in -32768..32767."""
    x = x.astype(np.int64)
    ra, rb, rc = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    ra[:, 1:], rb[1:], rc[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    p = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
         6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv].copy()
    p[:, 0] = rb[:, 0]
    for y in first_rows:
        p[y, 0] = initial
        p[y, 1:] = x[y, :-1]
    return ((x - p + 32768) & 0xFFFF) - 32768


def encode_lossless(planes, psv=1, pt=0, precision=8, factors=None,
                    restart_rows=0, ids=None, adobe=None, jfif=False,
                    interleave=True):
    """A lossless (SOF3) JPEG of `planes` (values < 2**precision): each
    sample >> pt, predicted as jclossls.c predicts (predictor `psv`; the
    first row from its left neighbour and 1 << (P - Pt - 1), the first
    column from above; again after each restart), the differences
    Huffman-coded (jclhuff.c: categories 0-16, 32768 with no extra bits).
    `restart_rows` sets the restart interval to that many MCU rows."""
    n = len(planes)
    factors = factors or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    h, w = planes[0].shape
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    comps = []
    for plane, (ch, cv) in zip(planes, factors):
        big = np.pad(plane.astype(np.int64),
                     ((0, mcuy * vmax - h), (0, mcux * hmax - w)),
                     mode="edge")
        rows = np.arange(mcuy * cv) * vmax // cv
        cols = np.arange(mcux * ch) * hmax // ch
        comps.append(big[rows][:, cols] >> pt)
    wib = [-(-w * f[0] // hmax) for f in factors]
    hib = [-(-h * f[1] // vmax) for f in factors]
    initial = 1 << (precision - pt - 1)
    head = b"\xff\xd8"
    if jfif:
        head += _seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if adobe is not None:
        head += _seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    head += _seg(0xC3, struct.pack(">BHHB", precision, h, w, n) + b"".join(
        bytes([ids[c], (f[0] << 4) | f[1], 0]) for c, f in enumerate(factors)))
    body = b""
    for comps_in in ([tuple(range(n))] if interleave else
                     [(c,) for c in range(n)]):
        single = len(comps_in) == 1
        # each MCU row's differences in stream order: [row][sample]
        rows = []
        for c in comps_in:
            ch, cv = (1, 1) if single else factors[c]
            x = comps[c][:hib[c], :wib[c]] if single else comps[c]
            step = restart_rows * cv
            first = range(0, x.shape[0], step) if step else [0]
            d = _lossless_diffs(x, psv, first, initial)
            k = d.shape[0] // cv
            rows.append(d.reshape(k, cv, -1, ch).transpose(0, 2, 1, 3)
                        .reshape(k, -1, cv * ch))
        d = np.concatenate(rows, axis=2).reshape(len(rows[0]), -1)
        size = np.zeros(d.shape, np.int64)
        for bit in range(16):
            size[np.abs(d) >= (1 << bit)] = bit + 1
        size[d == -32768] = 16
        freq = np.bincount(size.ravel(), minlength=256).tolist()
        bits, vals = optimal_table(freq)
        codes = huffman_codes(bits, vals)
        code = np.zeros(17, np.int64)
        clen = np.zeros(17, np.int64)
        for sym, (c, ln) in codes.items():
            code[sym], clen[sym] = c, ln
        extra = np.where(d >= 0, d, d + (1 << size) - 1)
        extra[size == 16] = 0
        nbits = np.where(size == 16, 0, size)
        value = (code[size] << nbits) | extra
        length = clen[size] + nbits
        step = restart_rows or len(d)
        segments = [_pack_codes(value[r:r + step].ravel(),
                                length[r:r + step].ravel())
                    for r in range(0, len(d), step)]
        data = b"".join(seg + (bytes([0xFF, 0xD0 + (i & 7)])
                               if i < len(segments) - 1 else b"")
                        for i, seg in enumerate(segments))
        interval = restart_rows * (wib[comps_in[0]] if single else mcux)
        dri = _seg(0xDD, struct.pack(">H", interval)) if interval else b""
        body += _seg(0xC4, bytes([0]) + bytes(bits) + bytes(vals)) + dri \
            + _seg(0xDA, bytes([len(comps_in)]) + b"".join(
                bytes([ids[c], 0]) for c in comps_in) + bytes([psv, 0, pt])) \
            + data
    return head + body + b"\xff\xd9"


def encode_hierarchical(plane):
    """A hierarchical JPEG of the grey `plane`: DHP, a baseline frame of
    the image at half size, EXP (2x in both directions), a differential
    sequential frame (SOF5) of the difference to the upsampled first frame
    (all zero here: coded as such)."""
    h, w = plane.shape
    half = plane[::2, ::2]
    first = encode([half], [(1, 1)])
    start = first.index(b"\xff\xdb")
    frame1 = first[start:-2]
    dhp = _seg(0xDE, struct.pack(">BHHB", 8, h, w, 1) + bytes([1, 0x11, 0]))
    exp = _seg(0xDF, bytes([0x11]))
    zero = np.zeros((-(-h // 8), -(-w // 8), 64), np.int64)
    tokens = _scan_tokens([zero], [[(0, by, bx)] for by in range(zero.shape[0])
                                   for bx in range(zero.shape[1])],
                          ((0,), 0, 63, 0, 0), 0, False)
    tables, dht = {}, b""
    for kind in ("dc", "ac"):
        freq = [0] * 256
        for tok in tokens:
            if tok[0] == kind:
                freq[tok[2]] += 1
        bits, vals = optimal_table(freq)
        tables[(kind, 0)] = huffman_codes(bits, vals)
        dht += _seg(0xC4, bytes([(kind == "ac") << 4]) + bytes(bits)
                    + bytes(vals))
    data = _huffman_scan(tokens, tables)
    sof5 = _seg(0xC5, struct.pack(">BHHB", 8, h, w, 1) + bytes([1, 0x11, 0]))
    sos = _seg(0xDA, bytes([1, 1, 0, 0, 63, 0]))
    return (b"\xff\xd8" + dhp + frame1 + exp + sof5 + dht + sos
            + data + b"\xff\xd9")


def cut(data: bytes, fraction: float, in_data: bool = False) -> bytes:
    """The first `fraction` of the file, as a download cut short leaves
    it; with `in_data`, the headers and that fraction of what follows the
    first scan's header."""
    start = 0
    if in_data:
        sos = scan_offsets(data)[0]
        start = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    return data[:max(2, start + int((len(data) - start) * fraction))]


def scan_offsets(data: bytes):
    """Offsets of the SOS markers: where each scan's headers end, after
    the tables before it (the DHT / DAC segments of a scan precede its
    SOS)."""
    out, pos = [], 2
    while pos < len(data) - 1:
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0xDA:
            out.append(pos)
        if m in (0xD8, 0xD9, 0x01, 0x00, 0xFF) or 0xD0 <= m <= 0xD7:
            pos += 2 if m != 0xFF else 1
            continue
        if m == 0xDA:
            pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
            while pos < len(data) - 1 and not (
                    data[pos] == 0xFF and data[pos + 1] not in
                    (0, 0xFF) and not 0xD0 <= data[pos + 1] <= 0xD7):
                pos += 1
            continue
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    return out


def first_scans(data: bytes, n: int) -> bytes:
    """A progressive file ended by EOI after its first `n` scans (the
    tables of scan n + 1 dropped with it)."""
    sos = scan_offsets(data)
    if n >= len(sos):
        return data
    end = sos[n]
    # step back over the tables that belong to the next scan
    pos, start = 2, end
    while pos < end:
        m = data[pos + 1]
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if m == 0xDA:
            nxt = pos + 2 + length
            while not (data[nxt] == 0xFF and data[nxt + 1] not in (0, 0xFF)
                       and not 0xD0 <= data[nxt + 1] <= 0xD7):
                nxt += 1
            start = nxt
            pos = nxt
            continue
        pos += 2 + length
    return data[:start] + b"\xff\xd9"


# the kinds of chip_smoke.py's [formats] split and of its decode rates
SPLIT_KINDS = ("cut", "progressive_cut", "partial", "arith",
               "arith_progressive", "lossless")


def kind_file(kind: str, rgb: np.ndarray, quality: int = 90) -> bytes:
    """A file of `kind` of the RGB image: "baseline" (4:2:0 Huffman), "cut"
    (that file cut three quarters into its data), "progressive_cut" (a
    progressive file cut in the data of its sixth scan of ten), "partial"
    (a progressive file ended by EOI after four scans), "arith" (SOF9),
    "arith_progressive" (SOF10, a restart every 40 MCUs), "lossless"
    (SOF3 RGB, predictor 1). A module-level function, so that a process
    pool can write them."""
    sub = [(2, 2), (1, 1), (1, 1)]
    if kind == "lossless":
        return encode_lossless([rgb[..., c] for c in range(3)], 1)
    if kind in ("baseline", "cut"):
        data = encode(ycc(rgb), sub, quality=quality)
        return cut(data, 0.75, in_data=True) if kind == "cut" else data
    if kind in ("progressive_cut", "partial"):
        data = encode(ycc(rgb), sub, "progressive", quality=quality)
        if kind == "partial":
            return first_scans(data, 4)
        sos = scan_offsets(data)
        return data[:(sos[5] + sos[6]) // 2]
    if kind == "arith":
        return encode(ycc(rgb), sub, quality=quality, arith=True)
    if kind == "arith_progressive":
        return encode(ycc(rgb), sub, "progressive", quality=quality,
                      arith=True, restart=40)
    raise KeyError(kind)

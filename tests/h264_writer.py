"""A seeded H.264 syntax writer: streams the port's H.264 decoder is held
against cv2.VideoCapture with (tests/test_torch_h264.py,
scripts/make_video_fixtures.py).

It is not an encoder: it makes random but legal choices over every tool
the port decodes (I and P slices, CAVLC and CABAC, I_PCM / I4x4 / I8x8 /
I16x16, every P partition and sub-partition, P_8x8ref0 and P_Skip, intra
modes the available neighbours allow, motion vectors inside the level's
range and past the picture's edges, sparse coefficients, QP deltas that
wrap, several slices, deblocking idc 0 / 1 / 2 with offsets, constrained
intra prediction, reference list modification, long-term references and
MMCO 1-6, explicit weights, SPS / PPS scaling lists with their fall-back
rules, both chroma QP offsets, cropping and the VUI colour fields), and
writes them as Annex B, or as length-prefixed NAL units with an avcC
record, in MP4 (avc1 / avc3) or AVI (H264). It tracks what the syntax
needs of the decoder's state (neighbour modes, counts of coefficients,
CABAC contexts, motion vectors for their prediction, the reference lists)
and nothing of the pictures: cv2 is the oracle. It can also write what
the port refuses: a B slice of skipped macroblocks, a field pair.

    stream = H264Writer(Config(...), seed).write()   # -> Stream
    write_mp4(path, stream) / write_avi(path, stream)

The constant tables come from the port's csrc/h264_tables.h: an entry
wrong there shows up as a mismatch with cv2 all the same.
"""

from __future__ import annotations

import random
import re
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[1]
TABLES_H = ROOT / "efficientteacher_torch" / "csrc" / "h264_tables.h"


def _tables() -> dict:
    text = TABLES_H.read_text()
    out = {}
    pattern = r"static constexpr \w+ (k\w+)((?:\[\d+\])+) = \{(.*?)\};"
    for m in re.finditer(pattern, text, re.S):
        body = re.sub(r"//[^\n]*", "", m.group(3))
        out[m.group(1)] = [int(v) for v in re.findall(r"-?\d+", body)]
    return out


T = _tables()
ZZ4 = T["kZigzag4x4"]
ZZ8 = T["kZigzag8x8"]
CHROMA_QP = T["kChromaQp"]
NORM4 = [T["kNorm4x4"][3 * m:3 * m + 3] for m in range(6)]
NORM8 = [T["kNorm8x8"][6 * m:6 * m + 6] for m in range(6)]
DEFAULT4 = [T["kDefault4x4"][:16], T["kDefault4x4"][16:]]
DEFAULT8 = [T["kDefault8x8"][:64], T["kDefault8x8"][64:]]
INTRA_CBP = T["kIntraCbp"]
INTER_CBP = T["kInterCbp"]
CBP_CODE_INTRA = {v: i for i, v in enumerate(INTRA_CBP)}
CBP_CODE_INTER = {v: i for i, v in enumerate(INTER_CBP)}
RANGE_LPS = [T["kRangeLps"][4 * i:4 * i + 4] for i in range(64)]
TRANS_LPS = T["kTransLps"]
SIG8 = T["kSig8x8"]
LAST8 = T["kLast8x8"]
CABAC_INIT = [[(T["kCabacInit"][k * 920 + 2 * i],
                T["kCabacInit"][k * 920 + 2 * i + 1]) for i in range(460)]
              for k in range(4)]

I4x4, I8x8, I16x16, IPCM, PINTER, PSKIP = range(6)


# ------------------------------------------------------------------ bits

class Bits:
    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.n = 0

    def u(self, n: int, v: int):
        if n == 0:
            return
        assert 0 <= v < (1 << n), (n, v)
        self.cur = (self.cur << n) | v
        self.n += n
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.cur >> self.n) & 0xFF)
        self.cur &= (1 << self.n) - 1

    def bit(self, b):
        self.u(1, 1 if b else 0)

    def ue(self, v: int):
        v += 1
        n = v.bit_length()
        self.u(n - 1, 0)
        self.u(n, v)

    def se(self, v: int):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def aligned(self):
        return self.n == 0

    def align_zero(self):
        if self.n:
            self.u(8 - self.n, 0)

    def trailing(self):
        self.bit(1)
        self.align_zero()

    def data(self) -> bytes:
        assert self.n == 0
        return bytes(self.out)


def nal_unit(nal_type: int, ref_idc: int, rbsp: bytes) -> bytes:
    """The NAL unit (header + emulation prevention) of an RBSP."""
    out = bytearray([(ref_idc << 5) | nal_type])
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


# ------------------------------------------------------------------ CABAC

class CabacEnc:
    """9.3.4.2's arithmetic encoder, writing into a Bits."""

    def __init__(self, bits: Bits):
        self.b = bits
        self.state = [0] * 460
        self.start()

    def start(self):
        self.low, self.range = 0, 510
        self.first = True
        self.outstanding = 0

    def init_contexts(self, table: int, qp: int):
        q = max(0, min(51, qp))
        for i, (m, n) in enumerate(CABAC_INIT[table]):
            pre = max(1, min(126, ((m * q) >> 4) + n))
            self.state[i] = ((63 - pre) << 1) if pre <= 63 else \
                (((pre - 64) << 1) | 1)

    def _put(self, b):
        if self.first:
            self.first = False
        else:
            self.b.bit(b)
        while self.outstanding:
            self.b.bit(1 - b)
            self.outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: int, b: int):
        s = self.state[ctx]
        st, mps = s >> 1, s & 1
        lps = RANGE_LPS[st][(self.range >> 6) & 3]
        self.range -= lps
        if b != mps:
            self.low += self.range
            self.range = lps
            if st == 0:
                mps = 1 - mps
            st = TRANS_LPS[st]
        elif st < 62:
            st += 1
        self.state[ctx] = (st << 1) | mps
        self._renorm()

    def bypass(self, b: int):
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, b: int):
        self.range -= 2
        if b:
            self.low += self.range
            self.flush()
        else:
            self._renorm()

    def flush(self):
        self.range = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        self.b.u(2, ((self.low >> 7) & 3) | 1)

    def exp_golomb(self, v: int, k: int):
        while True:
            if v >= (1 << k):
                self.bypass(1)
                v -= 1 << k
                k += 1
            else:
                self.bypass(0)
                while k:
                    k -= 1
                    self.bypass((v >> k) & 1)
                return


# ------------------------------------------------------------------ config

@dataclass
class Config:
    """What a stream is made of; the writer draws the rest."""
    mb_w: int = 3
    mb_h: int = 2
    frames: int = 4
    cabac: bool = False
    profile: int = 100
    poc_type: int = 0
    log2_max_frame_num: int = 4
    log2_max_poc_lsb: int = 6
    num_ref_frames: int = 2
    max_slices: int = 1
    constrained_intra: bool = False
    transform_8x8: bool = False
    sps_scaling: bool = False
    pps_scaling: bool = False
    chroma_qp_offset: int = 0
    second_chroma_qp_offset: Optional[int] = None
    deblocking_control: bool = False
    deblock_idcs: tuple = (0, 0, 1, 2, 2)
    weighted_pred: bool = False
    crop: tuple = (0, 0, 0, 0)          # left, right, top, bottom (units of 2)
    full_range: Optional[bool] = None   # VUI video_signal_type when set
    matrix: int = 2
    bitstream_restriction: bool = False
    qp: tuple = (18, 38)
    skip_prob: float = 0.3
    intra_in_p: float = 0.1
    pcm_prob: float = 0.02
    coef_density: float = 0.3
    i_picture_prob: float = 0.1
    i_slice_prob: float = 0.1           # an I slice in a P picture
    idr_prob: float = 0.0
    nonref_prob: float = 0.15
    long_term: bool = False
    reorder: bool = False
    mmco: bool = False
    pps_count: int = 1
    big_levels: bool = True
    mv_range: int = 48                  # quarter samples around the predictor
    far_mv_prob: float = 0.05
    b_slice_at: Optional[int] = None    # refused: a B picture at this index
    poc_back_at: Optional[int] = None   # refused: POC type 0 steps back here
    field_at: Optional[int] = None      # refused: an IDR field pair here
    inband: bool = False                # parameter sets in band (avc3)
    sps_id: int = 0
    pps_base: int = 0                   # the PPS ids: pps_base + 0, 1, ...
    # a picture to paint instead of random syntax: target means (Y per
    # 8x8, U and V per chroma 4x4: each (2 mb_h, 2 mb_w)); each I picture
    # paints them with DC-predicted I_8x8 macroblocks (the 8x8 transform
    # on, no scaling lists), each P picture pans the last by `pan` (quarter
    # samples) with P_Skip where the skip vector is the pan, but for the
    # macroblocks `skip_prob` leaves to random syntax
    paint: Optional[tuple] = None
    pan: tuple = (0, 0)


@dataclass
class Stream:
    width: int
    height: int
    sps: List[bytes]
    pps: List[bytes]
    access_units: List[List[bytes]]     # NAL units (no start codes)


class _Mb:
    __slots__ = ("slice", "kind", "intra", "t8x8", "cbp", "chroma_mode",
                 "dc_cbf", "ipred", "nnz", "nnzc", "ref", "mv", "mvd")

    def __init__(self, slice_):
        self.slice = slice_
        self.kind = PSKIP
        self.intra = False
        self.t8x8 = False
        self.cbp = 0
        self.chroma_mode = 0
        self.dc_cbf = 0
        self.ipred = [-1] * 16
        self.nnz = [0] * 16
        self.nnzc = [[0] * 4, [0] * 4]
        self.ref = [0] * 4
        self.mv = [[0, 0] for _ in range(16)]
        self.mvd = [[0, 0] for _ in range(16)]


class _Ref:
    """A decoded picture as the reference marking sees it."""

    def __init__(self, frame_num, uid):
        self.frame_num = frame_num
        self.uid = uid
        self.short = False
        self.long = False
        self.long_idx = -1


def _b8(idx):
    return ((idx >> 3) << 1) | ((idx & 3) >> 1)


# ------------------------------------------------------------------ writer

class H264Writer:
    def __init__(self, cfg: Config, seed: int):
        self.cfg = cfg
        self.rng = random.Random(seed)
        r = self.rng
        c = cfg
        self.level_idc = 40
        # scaling lists (zigzag order), as the SPS / PPS say them
        flat4, flat8 = [[16] * 16] * 6, [[16] * 64] * 2
        self.sps_lists = None
        if c.sps_scaling:
            self.sps_lists = self._draw_lists(8)
        self.seq4, self.seq8 = (self._resolve(self.sps_lists, DEFAULT4,
                                              DEFAULT8)
                                if self.sps_lists else (flat4, flat8))
        self.pps_lists = []
        self.pps_eff = []
        for _ in range(c.pps_count):
            if c.pps_scaling:
                lists = self._draw_lists(8 if c.transform_8x8 else 6)
                if c.sps_scaling:
                    fb4 = [self.seq4[0], self.seq4[3]]
                    fb8 = self.seq8
                else:
                    fb4, fb8 = DEFAULT4, DEFAULT8
                self.pps_lists.append(lists)
                self.pps_eff.append(self._resolve(lists, fb4, fb8))
            else:
                self.pps_lists.append(None)
                self.pps_eff.append((self.seq4, self.seq8))
        self.pps_cabac_init = [r.randrange(1, 4) for _ in range(c.pps_count)]
        self.pps_init_qp = [r.randrange(20, 34) for _ in range(c.pps_count)]
        self.pps_num_ref = [r.randrange(1, max(2, c.num_ref_frames) + 1)
                            for _ in range(c.pps_count)]
        self.second = c.chroma_qp_offset if c.second_chroma_qp_offset is None \
            else c.second_chroma_qp_offset
        self.uid = 0

    # ---------------------------------------------------------- lists

    def _draw_lists(self, n):
        """Per list: None (not present), 'default', or explicit values."""
        r = self.rng
        out = []
        for i in range(n):
            k = r.random()
            if k < 0.3:
                out.append(None)
            elif k < 0.45:
                out.append("default")
            else:
                size = 16 if i < 6 else 64
                vals = []
                v = r.randrange(6, 40)
                for _ in range(size):
                    v = max(4, min(64, v + r.randrange(-3, 5)))
                    vals.append(v)
                if r.random() < 0.3:            # ends early: repeats its last
                    cut = r.randrange(1, size)
                    vals = vals[:cut] + [vals[cut - 1]] * (size - cut)
                    vals = ("cut", cut, vals)
                out.append(vals)
        return out

    @staticmethod
    def _values(entry):
        return entry[2] if isinstance(entry, tuple) else entry

    def _resolve(self, lists, fb4, fb8):
        s4 = [None] * 6
        s8 = [None] * 2
        for i in range(6):
            e = lists[i]
            if e is None:
                s4[i] = (fb4[0] if i == 0 else fb4[1]) if i in (0, 3) \
                    else s4[i - 1]
            elif e == "default":
                s4[i] = DEFAULT4[0 if i < 3 else 1]
            else:
                s4[i] = self._values(e)
        for i in range(2):
            e = lists[6 + i] if len(lists) > 6 else None
            if e is None:
                s8[i] = fb8[i]
            elif e == "default":
                s8[i] = DEFAULT8[i]
            else:
                s8[i] = self._values(e)
        return s4, s8

    def _write_lists(self, b: Bits, lists):
        for i, e in enumerate(lists):
            b.bit(e is not None)
            if e is None:
                continue
            size = 16 if i < 6 else 64
            if e == "default":
                b.se(-8)                # nextScale 0 at j == 0
                continue
            cut = e[1] if isinstance(e, tuple) else size
            vals = self._values(e)
            last = 8
            for j in range(size):
                if j == cut:
                    d = (0 - last) % 256
                    b.se(d - 256 if d > 127 else d)
                    break
                d = (vals[j] - last) % 256
                b.se(d - 256 if d > 127 else d)
                last = vals[j]

    # ---------------------------------------------------------- headers

    def sps_rbsp(self, sps_id=None, interlaced=False) -> bytes:
        c = self.cfg
        b = Bits()
        b.u(8, c.profile)
        b.u(8, 0)
        b.u(8, self.level_idc)
        b.ue(c.sps_id if sps_id is None else sps_id)
        if c.profile >= 100:
            b.ue(1)                     # 4:2:0
            b.ue(0)
            b.ue(0)
            b.bit(0)                    # no transform bypass
            b.bit(self.sps_lists is not None)
            if self.sps_lists is not None:
                self._write_lists(b, self.sps_lists)
        b.ue(c.log2_max_frame_num - 4)
        b.ue(c.poc_type)
        if c.poc_type == 0:
            b.ue(c.log2_max_poc_lsb - 4)
        elif c.poc_type == 1:
            b.bit(0)                    # delta_pic_order_always_zero_flag
            b.se(1)                     # offset_for_non_ref_pic
            b.se(0)
            b.ue(2)
            b.se(2)
            b.se(2)
        b.ue(c.num_ref_frames)
        b.bit(0)
        b.ue(c.mb_w - 1)
        b.ue((c.mb_h // 2 if interlaced else c.mb_h) - 1)
        b.bit(not interlaced)           # frame_mbs_only_flag
        if interlaced:
            b.bit(0)                    # mb_adaptive_frame_field_flag
        b.bit(1 if interlaced else self.rng.random() < 0.5)
        crop = c.crop if not interlaced else (0, 0, 0, 0)
        b.bit(any(crop))
        if any(crop):
            for v in crop:
                b.ue(v)
        vui = c.full_range is not None or c.bitstream_restriction
        b.bit(vui)
        if vui:
            b.bit(0)                    # aspect_ratio_info
            b.bit(0)                    # overscan
            b.bit(c.full_range is not None)
            if c.full_range is not None:
                b.u(3, 5)
                b.bit(c.full_range)
                b.bit(1)
                b.u(8, 1 if c.matrix == 1 else 2)
                b.u(8, 1 if c.matrix == 1 else 2)
                b.u(8, c.matrix)
            b.bit(0)                    # chroma_loc
            b.bit(1)                    # timing
            b.u(32, 1)
            b.u(32, 50)
            b.bit(1)
            b.bit(0)
            b.bit(0)
            b.bit(0)                    # pic_struct_present
            b.bit(c.bitstream_restriction)
            if c.bitstream_restriction:
                b.bit(1)
                b.ue(0)
                b.ue(0)
                b.ue(16)
                b.ue(16)
                b.ue(0)                 # max_num_reorder_frames
                b.ue(max(1, c.num_ref_frames))
        b.trailing()
        return b.data()

    def pps_rbsp(self, pps_id, sps_id=None, cabac=None) -> bytes:
        """The PPS of index pps_id (its id pps_base + pps_id)."""
        c = self.cfg
        b = Bits()
        b.ue(c.pps_base + pps_id)
        b.ue(c.sps_id if sps_id is None else sps_id)
        b.bit(c.cabac if cabac is None else cabac)
        b.bit(0)                        # bottom_field_pic_order_in_frame
        b.ue(0)                         # one slice group
        b.ue(self.pps_num_ref[pps_id % c.pps_count] - 1)
        b.ue(0)
        b.bit(c.weighted_pred)
        b.u(2, 0)
        b.se(self.pps_init_qp[pps_id % c.pps_count] - 26)
        b.se(0)
        b.se(c.chroma_qp_offset)
        b.bit(c.deblocking_control)
        b.bit(c.constrained_intra)
        b.bit(0)                        # redundant_pic_cnt_present
        lists = self.pps_lists[pps_id % c.pps_count]
        if c.transform_8x8 or lists is not None or \
                self.second != c.chroma_qp_offset:
            b.bit(c.transform_8x8)
            b.bit(lists is not None)
            if lists is not None:
                self._write_lists(b, lists)
            b.se(self.second)
        b.trailing()
        return b.data()

    # ---------------------------------------------------------- stream

    def write(self) -> Stream:
        c, r = self.cfg, self.rng
        sps = [nal_unit(7, 3, self.sps_rbsp())]
        pps = [nal_unit(8, 3, self.pps_rbsp(i)) for i in range(c.pps_count)]
        stream = Stream(c.mb_w * 16 - 2 * (c.crop[0] + c.crop[1]),
                        c.mb_h * 16 - 2 * (c.crop[2] + c.crop[3]), sps, pps,
                        [])
        self.dpb: List[_Ref] = []
        self.prev_ref_frame_num = 0
        self.max_long_idx = -1
        self.poc = 0
        self.prev_was_nonref = False
        for k in range(c.frames):
            au = []
            if c.inband and (k == 0 or r.random() < 0.2):
                au += sps + pps
            if c.b_slice_at == k:
                au += self._b_picture()
                stream.access_units.append(au)
                continue
            if c.field_at == k:
                other = (c.sps_id + 1) % 32
                au += [nal_unit(7, 3, self.sps_rbsp(other, interlaced=True)),
                       nal_unit(8, 3, self.pps_rbsp(c.pps_count, other,
                                                    cabac=False))]
                au += self._field_pair()
                stream.access_units.append(au)
                continue
            idr = k == 0 or r.random() < c.idr_prob
            au += self._picture(idr, k)
            stream.access_units.append(au)
        return stream

    # ---------------------------------------------------------- pictures

    def _picture(self, idr: bool, index: int) -> List[bytes]:
        c, r = self.cfg, self.rng
        if idr:
            for f in self.dpb:
                f.short = f.long = False
            self.dpb = []
            frame_num = 0
            ref_idc = r.randrange(1, 4)
        else:
            ref_idc = 0 if (r.random() < c.nonref_prob and
                            not self.prev_was_nonref) else r.randrange(1, 4)
            frame_num = (self.prev_ref_frame_num + 1) % \
                (1 << c.log2_max_frame_num)
        refs = [f for f in self.dpb if f.short or f.long]
        kind_i = idr or not refs or r.random() < c.i_picture_prob
        # POC type 0: 2 more per picture (types 1 and 2 follow frame_num
        # and the reference flag, increasing as well)
        self.poc = 0 if idr else self.poc + 2
        if c.poc_back_at == index:
            self.poc -= 6               # displayed before the last picture
        poc_lsb = self.poc % (1 << c.log2_max_poc_lsb)
        self.cur_frame_num = frame_num
        self.uid += 1
        cur = _Ref(frame_num, self.uid)
        # the slices
        total = c.mb_w * c.mb_h
        n_slices = r.randrange(1, c.max_slices + 1)
        cuts = sorted(r.sample(range(1, total), min(n_slices - 1, total - 1)))
        bounds = list(zip([0] + cuts, cuts + [total]))
        self.mbs = [None] * total
        self.pw, self.ph = c.mb_w, c.mb_h
        nals = []
        marking = self._marking(idr, ref_idc, frame_num) if ref_idc else None
        pps_id = r.randrange(c.pps_count)
        for si, (first, end) in enumerate(bounds):
            stype = 2 if kind_i or r.random() < c.i_slice_prob else 0
            nals.append(self._slice(si, first, end, stype, idr, ref_idc,
                                    frame_num, poc_lsb, pps_id, marking))
        # the marking, as the decoder applies it after the picture
        self._apply_marking(cur, idr, ref_idc, marking)
        self.prev_was_nonref = ref_idc == 0
        return nals

    def _pic_num(self, f):
        mx = 1 << self.cfg.log2_max_frame_num
        return f.frame_num - mx if f.frame_num > self.cur_frame_num else \
            f.frame_num

    def _marking(self, idr, ref_idc, frame_num):
        """dec_ref_pic_marking's choices: (long_term_reference_flag) for an
        IDR, else None (sliding window) or a list of MMCOs."""
        c, r = self.cfg, self.rng
        if idr:
            return ("idr", c.long_term and r.random() < 0.5)
        shorts = [f for f in self.dpb if f.short]
        longs = [f for f in self.dpb if f.long]
        if not shorts and len(longs) >= max(c.num_ref_frames, 1):
            # the sliding window cannot free a long-term frame
            return [(2, longs[0].long_idx, 0)]
        if not c.mmco or r.random() < 0.5:
            return None
        ops = []
        used_short = set()
        cur_pic_num = frame_num
        if shorts and r.random() < 0.5:
            f = r.choice(shorts)
            used_short.add(f.uid)
            ops.append((1, cur_pic_num - self._pic_num(f) - 1, 0))
        if longs and r.random() < 0.3:
            f = r.choice(longs)
            ops.append((2, f.long_idx, 0))
        if c.long_term and r.random() < 0.5:
            if self.max_long_idx < 1 or r.random() < 0.2:
                ops.append((4, 3, 0))             # MaxLongTermFrameIdx 2
                max_idx = 2
            else:
                max_idx = self.max_long_idx
            cand = [f for f in shorts if f.uid not in used_short]
            if cand and r.random() < 0.6:
                f = r.choice(cand)
                ops.append((3, cur_pic_num - self._pic_num(f) - 1,
                            r.randrange(0, max_idx + 1)))
            elif r.random() < 0.5:
                ops.append((6, 0, r.randrange(0, max_idx + 1)))
        if r.random() < 0.08:
            ops = [(5, 0, 0)]
        if not ops:
            return None
        # no more reference frames than max_num_ref_frames after the
        # picture: unmark the oldest short-term ones first
        while self._count_after(ops) > max(c.num_ref_frames, 1):
            gone = {self.cur_frame_num - a - 1 for op, a, _ in ops
                    if op in (1, 3)}
            left = [f for f in shorts if self._pic_num(f) not in gone]
            if left:
                f = min(left, key=self._pic_num)
                ops.insert(0, (1, cur_pic_num - self._pic_num(f) - 1, 0))
            else:
                gone_l = {a for op, a, _ in ops if op == 2}
                f = next((f for f in longs if f.long_idx not in gone_l), None)
                if f is not None:
                    ops.insert(0, (2, f.long_idx, 0))
                    continue
                ops = [o for o in ops if o[0] in (1, 2)]
                if not ops:
                    return None
        return ops

    def _count_after(self, ops):
        """Reference frames after the MMCOs, the current one included."""
        state = {f.uid: [f.short, f.long, f.long_idx] for f in self.dpb}
        max_idx = self.max_long_idx
        for op, a, bb in ops:
            if op in (1, 3):
                pn = self.cur_frame_num - (a + 1)
                f = next((g for g in self.dpb if state[g.uid][0] and
                          self._pic_num(g) == pn), None)
                if f is None:
                    continue
                if op == 1:
                    state[f.uid][0] = False
                else:
                    for u, st in state.items():
                        if st[1] and st[2] == bb and u != f.uid:
                            st[1] = False
                    state[f.uid] = [False, True, bb]
            elif op == 2:
                for st in state.values():
                    if st[1] and st[2] == a:
                        st[1] = False
            elif op == 4:
                max_idx = a - 1
                for st in state.values():
                    if st[1] and st[2] > max_idx:
                        st[1] = False
            elif op == 5:
                for st in state.values():
                    st[0] = st[1] = False
            elif op == 6:
                for st in state.values():
                    if st[1] and st[2] == bb:
                        st[1] = False
        return 1 + sum(1 for st in state.values() if st[0] or st[1])

    def _apply_marking(self, cur, idr, ref_idc, marking):
        c = self.cfg
        mx = 1 << c.log2_max_frame_num
        if not ref_idc:
            return
        self.dpb = [f for f in self.dpb if f.short or f.long]
        if idr:
            for f in self.dpb:
                f.short = f.long = False
            if marking[1]:
                cur.long, cur.long_idx = True, 0
                self.max_long_idx = 0
            else:
                cur.short = True
                self.max_long_idx = -1
        elif marking is None:
            shorts = [f for f in self.dpb if f.short]
            longs = [f for f in self.dpb if f.long]
            if len(shorts) + len(longs) >= max(c.num_ref_frames, 1) and shorts:
                old = min(shorts, key=self._pic_num)
                old.short = False
            cur.short = True
        else:
            cur_long = False
            reset = False
            for op, a, bb in marking:
                if op in (1, 3):
                    pn = self.cur_frame_num - (a + 1)
                    f = next((g for g in self.dpb if g.short and
                              self._pic_num(g) == pn), None)
                    if f is None:
                        continue
                    if op == 1:
                        f.short = False
                    else:
                        for g in self.dpb:
                            if g.long and g.long_idx == bb and g is not f:
                                g.long = False
                        f.short, f.long, f.long_idx = False, True, bb
                elif op == 2:
                    for g in self.dpb:
                        if g.long and g.long_idx == a:
                            g.long = False
                elif op == 4:
                    self.max_long_idx = a - 1
                    for g in self.dpb:
                        if g.long and g.long_idx > self.max_long_idx:
                            g.long = False
                elif op == 5:
                    for g in self.dpb:
                        g.short = g.long = False
                    self.max_long_idx = -1
                    reset = True
                elif op == 6:
                    for g in self.dpb:
                        if g.long and g.long_idx == bb:
                            g.long = False
                    cur.long, cur.long_idx = True, bb
                    cur_long = True
            if not cur_long:
                cur.short = True
            if reset:
                cur.frame_num = 0
                self.poc = -2           # the next picture's POC restarts
            assert len([f for f in self.dpb + [cur] if f.short or f.long]) \
                <= max(c.num_ref_frames, 1)
            if reset:
                self.prev_ref_frame_num = 0
                self.dpb.append(cur)
                return
        self.prev_ref_frame_num = cur.frame_num
        self.dpb.append(cur)

    def _ref_list(self, num_ref, mods):
        """RefPicList0 after the modification commands."""
        mx = 1 << self.cfg.log2_max_frame_num
        shorts = sorted((f for f in self.dpb if f.short),
                        key=lambda f: -self._pic_num(f))
        longs = sorted((f for f in self.dpb if f.long),
                       key=lambda f: f.long_idx)
        lst = (shorts + longs)[:num_ref]
        lst += [None] * (num_ref + 1 - len(lst))
        pred = self.cur_frame_num
        idx = 0
        for idc, v in mods:
            if idc < 2:
                diff = v + 1
                if idc == 0:
                    nw = pred - diff
                    if nw < 0:
                        nw += mx
                else:
                    nw = pred + diff
                    if nw >= mx:
                        nw -= mx
                pred = nw
                num = nw - mx if nw > self.cur_frame_num else nw
                pic = next(f for f in self.dpb if f.short and
                           self._pic_num(f) == num)
                same = lambda f: f is not None and f is pic and f.short  # noqa
            else:
                pic = next(f for f in self.dpb if f.long and f.long_idx == v)
                same = lambda f: f is not None and f.long and \
                    f.long_idx == v  # noqa
            lst = lst[:idx] + [pic] + lst[idx:num_ref]
            idx += 1
            keep = lst[:idx] + [f for f in lst[idx:] if not same(f)]
            lst = (keep + [None] * (num_ref + 1))[:num_ref + 1]
        return lst[:num_ref]

    def _draw_mods(self, num_ref):
        c, r = self.cfg, self.rng
        if not c.reorder or r.random() < 0.4:
            return []
        mx = 1 << c.log2_max_frame_num
        mods = []
        pred = self.cur_frame_num
        shorts = [f for f in self.dpb if f.short]
        longs = [f for f in self.dpb if f.long]
        for _ in range(r.randrange(1, num_ref + 1)):
            if longs and r.random() < 0.3:
                mods.append((2, r.choice(longs).long_idx))
                continue
            if not shorts:
                break
            f = r.choice(shorts)
            target = f.frame_num            # picNumNoWrap of f
            if target > self.cur_frame_num:
                target -= mx
            nw = target % mx
            # abs_diff_pic_num from pred to nw, either direction
            down = (pred - nw) % mx
            up = (nw - pred) % mx
            if down and (not up or r.random() < 0.5):
                mods.append((0, down - 1))
            elif up:
                mods.append((1, up - 1))
            else:
                mods.append((0, mx - 1))
            pred = nw
        return mods

    # ---------------------------------------------------------- slices

    def _slice(self, si, first, end, stype, idr, ref_idc, frame_num, poc_lsb,
               pps_id, marking) -> bytes:
        c, r = self.cfg, self.rng
        b = Bits()
        b.ue(first)
        b.ue(stype)
        b.ue(c.pps_base + pps_id)
        b.u(c.log2_max_frame_num, frame_num)
        if idr:
            b.ue(0)
        if c.poc_type == 0:
            b.u(c.log2_max_poc_lsb, poc_lsb)
        elif c.poc_type == 1:
            # expected POC from the cycle (2 per frame), corrected to ours
            b.se(0)
        self.num_ref = 0
        self.refs = []
        if stype == 0:
            default = self.pps_num_ref[pps_id]
            n = default
            override = r.random() < 0.3
            if override:
                n = r.randrange(1, 5)
            b.bit(override)
            if override:
                b.ue(n - 1)
            self.num_ref = n
            mods = self._draw_mods(n)
            b.bit(bool(mods))
            for idc, v in mods:
                b.ue(idc)
                b.ue(v)
            if mods:
                b.ue(3)
            self.refs = self._ref_list(n, mods)
            if not any(self.refs):
                raise _Redo()
        self.weights = None
        if stype == 0 and c.weighted_pred:
            ll, cl = r.randrange(0, 8), r.randrange(0, 8)
            b.ue(ll)
            b.ue(cl)
            for _ in range(self.num_ref):
                fl = r.random() < 0.6
                b.bit(fl)
                if fl:
                    b.se(r.randrange(-20, 40) + (1 << ll) // 2)
                    b.se(r.randrange(-30, 30))
                fc = r.random() < 0.5
                b.bit(fc)
                if fc:
                    for _ in range(2):
                        b.se(r.randrange(-20, 40) + (1 << cl) // 2)
                        b.se(r.randrange(-30, 30))
        if ref_idc:
            if idr:
                b.bit(0)
                b.bit(marking[1])
            else:
                b.bit(marking is not None)
                if marking is not None:
                    for op, a, bb in marking:
                        b.ue(op)
                        if op in (1, 3):
                            b.ue(a)
                        if op == 2:
                            b.ue(a)
                        if op in (3, 6):
                            b.ue(bb)
                        if op == 4:
                            b.ue(a)
                    b.ue(0)
        if c.cabac and stype == 0:
            self.cabac_init = r.randrange(3)
            b.ue(self.cabac_init)
        lo, hi = c.qp
        qp = r.randrange(lo, hi + 1)
        if c.paint is not None:
            qp = 22                     # a luma DC level moves 1 sample
        b.se(qp - self.pps_init_qp[pps_id])
        self.deblock_idc = 0
        if c.deblocking_control:
            idc = r.choice(c.deblock_idcs)
            b.ue(idc)
            self.deblock_idc = idc
            if idc != 1:
                b.se(r.randrange(-6, 7))
                b.se(r.randrange(-6, 7))
        self.pps_id = pps_id
        self.scale4, self.scale8 = self.pps_eff[pps_id]
        self.slice_data(b, si, first, end, stype, qp)
        return nal_unit(5 if idr else 1, ref_idc, b.data())

    # ---------------------------------------------------------- slice data

    def slice_data(self, b: Bits, si, first, end, stype, qp):
        c, r = self.cfg, self.rng
        self.b = b
        self.stype = stype
        self.qp = qp
        self.last_dqp = 0
        self.cab = None
        if c.cabac:
            while not b.aligned():
                b.bit(1)
            self.cab = CabacEnc(b)
            self.cab.init_contexts(0 if stype == 2 else self.cabac_init + 1,
                                   qp)
        run = 0
        if c.paint is not None and first == 0:
            self.flat = {}
        for addr in range(first, end):
            self._begin(addr, si)
            skip = stype == 0 and r.random() < c.skip_prob
            # painting, a P macroblock drawn as skipped pans (skipped where
            # the skip vector is the pan); one drawn coded is random syntax
            self.random_mb = c.paint is None or (stype == 0 and not skip)
            if c.paint is not None and skip:
                skip = self._skip_mv() == tuple(c.pan)
            if c.cabac:
                if stype == 0:
                    self.cab.decision(11 + self._skip_ctx(), int(skip))
                if skip:
                    self._skip_mb()
                else:
                    self._coded_mb()
                self.cab.terminate(int(addr == end - 1))
            else:
                if skip:
                    run += 1
                    self._skip_mb()
                    if addr == end - 1:
                        b.ue(run)
                    continue
                if stype == 0:
                    b.ue(run)
                    run = 0
                self._coded_mb()
        if c.cabac:
            b.align_zero()
        else:
            b.trailing()

    # neighbours (as the decoder derives them)

    def _begin(self, addr, si):
        w = self.pw
        self.mba, self.mbx, self.mby = addr, addr % w, addr // w
        m = _Mb(si)
        self.mbs[addr] = m
        self.cur = m

        def av(x, y):
            if x < 0 or y < 0 or x >= w:
                return -1
            a = y * w + x
            n = self.mbs[a]
            return a if n is not None and n.slice == si else -1
        self.na = av(self.mbx - 1, self.mby)
        self.nb = av(self.mbx, self.mby - 1)
        self.nc = av(self.mbx + 1, self.mby - 1)
        self.nd = av(self.mbx - 1, self.mby - 1)
        ci = self.cfg.constrained_intra
        iav = lambda a: a >= 0 and (not ci or self.mbs[a].intra)  # noqa
        self.ia, self.ib = iav(self.na), iav(self.nb)
        self.ic, self.id = iav(self.nc), iav(self.nd)
        self.mask = 0

    def _blk_nb(self, bx, by):
        if bx < 0:
            m = self.nd if by < 0 else (self.na if by < 4 else -1)
        elif bx < 4:
            m = self.nb if by < 0 else (self.mba if by < 4 else -1)
        else:
            m = self.nc if by < 0 else -1
        return m, ((by + 4) & 3) * 4 + ((bx + 4) & 3)

    def _cblk_nb(self, cx, cy):
        if cx < 0:
            m = -1 if cy < 0 else self.na
        elif cy < 0:
            m = self.nb
        else:
            m = self.mba
        return m, ((cy + 2) & 1) * 2 + ((cx + 2) & 1)

    def _skip_ctx(self):
        return (self.na >= 0 and self.mbs[self.na].kind != PSKIP) + \
            (self.nb >= 0 and self.mbs[self.nb].kind != PSKIP)

    # motion

    def _nb_part(self, x, y):
        m, idx = self._blk_nb(x >> 2, y >> 2)
        if m < 0 or (m == self.mba and not (self.mask >> idx) & 1):
            return (False, -1, (0, 0))
        n = self.mbs[m]
        if n.intra:
            return (True, -1, (0, 0))
        return (True, n.ref[_b8(idx)], tuple(n.mv[idx]))

    def _mvp(self, x, y, w, ref, shape):
        a, bb, cc = self._nb_part(x - 1, y), self._nb_part(x, y - 1), \
            self._nb_part(x + w, y - 1)
        if not cc[0]:
            cc = self._nb_part(x - 1, y - 1)
        if shape == 1 and bb[1] == ref:
            return bb[2]
        if shape == 2 and a[1] == ref:
            return a[2]
        if shape == 3 and a[1] == ref:
            return a[2]
        if shape == 4 and cc[1] == ref:
            return cc[2]
        if not bb[0] and not cc[0] and a[0]:
            bb = cc = a
        match = [n for n in (a, bb, cc) if n[1] == ref]
        if len(match) == 1:
            return match[0][2]
        return tuple(sorted((a[2][k], bb[2][k], cc[2][k]))[1]
                     for k in range(2))

    def _set_motion(self, x, y, w, h, mv, mvd):
        m = self.cur
        for j in range(y >> 2, (y + h) >> 2):
            for i in range(x >> 2, (x + w) >> 2):
                idx = j * 4 + i
                m.mv[idx] = [mv[0], mv[1]]
                m.mvd[idx] = [min(abs(mvd[0]), 70), min(abs(mvd[1]), 70)]
                self.mask |= 1 << idx

    def _skip_mv(self):
        a, bb = self._nb_part(-1, 0), self._nb_part(0, -1)
        if a[0] and bb[0] and not (a[1] == 0 and a[2] == (0, 0)) and \
                not (bb[1] == 0 and bb[2] == (0, 0)):
            return self._mvp(0, 0, 16, 0, 0)
        return (0, 0)

    def _skip_mb(self):
        self.cur.kind = PSKIP
        self.last_dqp = 0
        self._set_motion(0, 0, 16, 16, self._skip_mv(), (0, 0))

    def _valid_refs(self):
        return [i for i, f in enumerate(self.refs) if f is not None]

    def _draw_mv(self, pred):
        r = self.rng
        c = self.cfg
        if r.random() < c.far_mv_prob:
            # well past the picture's edges, inside the level's range
            return (r.randrange(-600, 600), r.randrange(-400, 400))
        mv = []
        for k in range(2):
            v = pred[k] + r.randrange(-c.mv_range, c.mv_range + 1)
            if r.random() < 0.3:
                v = pred[k] + r.randrange(-2, 3)
            lim = 2000 if k == 0 else 480
            mv.append(max(-lim, min(lim, v)))
        return tuple(mv)

    # ---------------------------------------------------------- macroblock

    def _coded_mb(self):
        if self.random_mb:
            self._mb()
        elif self.stype == 2:
            self._paint_mb()
        else:
            self._pan_mb()

    def _pan_mb(self):
        """P_L0_16x16 on reference 0 moved by the pan, no residual."""
        m = self.cur
        m.kind, m.intra = PINTER, False
        self._mb_type(0)
        if self.num_ref > 1:
            self._ref_idx(0, 0, 0)
        m.ref = [0] * 4
        pred = self._mvp(0, 0, 16, 0, 0)
        mv = tuple(self.cfg.pan)
        d = (mv[0] - pred[0], mv[1] - pred[1])
        self._mvd(d[0], 0, 0, 0)
        self._mvd(d[1], 0, 0, 1)
        self._set_motion(0, 0, 16, 16, mv, d)
        self._cbp(0, False)
        self.last_dqp = 0

    def _paint_mb(self):
        """An I_8x8 macroblock, DC prediction in its four 8x8 blocks and in
        chroma, whose residual is each block's DC alone: flat 8x8 blocks
        (flat chroma 4x4s) at the painted values, as near as one DC level
        reaches. The flat values are tracked as decoded, before the loop
        filter, since the next blocks predict from them (8.3.2.2's filtered
        references included)."""
        c = self.cfg
        m = self.cur
        m.intra, m.kind, m.t8x8 = True, I8x8, True
        ty, tu, tv = c.paint
        x, y = self.mbx, self.mby
        qp = self.qp
        ls8 = 16 * NORM8[qp % 6][0]

        def luma(level):
            d = (level * ls8 * (1 << (qp // 6 - 6)) if qp >= 36 else
                 (level * ls8 + (1 << (5 - qp // 6))) >> (6 - qp // 6))
            return (d + 32) >> 6
        cur = [None] * 4                  # this MB's flat 8x8 values

        def blk(addr, k):
            return cur[k] if addr == self.mba else self.flat[addr][0][k]
        levels = []
        for b8 in range(4):
            x8, y8 = b8 & 1, b8 >> 1
            hl, ht = x8 > 0 or self.ia, y8 > 0 or self.ib
            htl = (x8 and y8) or (self.id if not x8 and not y8 else
                                  (self.ia if not x8 else self.ib))
            htr = self.ib if b8 == 0 else (self.ic if b8 == 1 else b8 == 2)
            above = (self.mba, x8) if y8 else (self.nb, 2 + x8)
            right = {0: (self.nb, 3), 1: (self.nc, 2), 2: (self.mba, 1)}
            corner = {0: (self.nd, 3), 1: (self.nb, 2), 2: (self.na, 1),
                      3: (self.mba, 0)}[b8]
            left = (self.mba, 2 * y8) if x8 else (self.na, 2 * y8 + 1)
            pt = [0] * 17                 # p[-1..15, -1]
            pl = [0] * 9                  # p[-1, -1..7]
            if ht:
                pt[1:9] = [blk(*above)] * 8
                pt[9:17] = [blk(*right[b8]) if htr else pt[8]] * 8
            if hl:
                pl[1:9] = [blk(*left)] * 8
            if htl:
                pt[0] = pl[0] = blk(*corner)
            t, lf = [0] * 17, [0] * 9
            if ht:
                t[1] = ((pt[0] + 2 * pt[1] + pt[2] + 2) >> 2 if htl else
                        (3 * pt[1] + pt[2] + 2) >> 2)
                for i in range(2, 16):
                    t[i] = (pt[i - 1] + 2 * pt[i] + pt[i + 1] + 2) >> 2
                t[16] = (pt[15] + 3 * pt[16] + 2) >> 2
            if hl:
                lf[1] = ((pl[0] + 2 * pl[1] + pl[2] + 2) >> 2 if htl else
                         (3 * pl[1] + pl[2] + 2) >> 2)
                for i in range(2, 8):
                    lf[i] = (pl[i - 1] + 2 * pl[i] + pl[i + 1] + 2) >> 2
                lf[8] = (pl[7] + 3 * pl[8] + 2) >> 2
            st, sl = sum(t[1:9]), sum(lf[1:9])
            pred = ((st + sl + 8) >> 4 if ht and hl else
                    (st + 4) >> 3 if ht else (sl + 4) >> 3 if hl else 128)
            want = int(ty[2 * y + y8][2 * x + x8]) - pred
            level = max(-200, min(200, round(want * 64 / max(1, luma(64)))))
            cur[b8] = max(0, min(255, pred + luma(level)))
            levels.append(level)
        planes = []
        dc_levels = []
        a = self.flat.get(self.na) if self.ia else None
        t_ = self.flat.get(self.nb) if self.ib else None
        for ci, (tgt, off) in enumerate(((tu, c.chroma_qp_offset),
                                         (tv, self.second))):
            qc = CHROMA_QP[max(0, min(51, qp + off))]
            lsc = 16 * NORM4[qc % 6][0]

            def res(g):
                return ((g * lsc * (1 << (qc // 6))) >> 5) + 32 >> 6
            top = [t_[1 + ci][2 + k] for k in range(2)] if t_ else None
            left = [a[1 + ci][2 * k + 1] for k in range(2)] if a else None
            preds = []
            for k in range(4):
                cx, cy = k & 1, k >> 1
                tp = top[cx] if top else None
                lf = left[cy] if left else None
                if k in (0, 3):
                    pv = ((4 * tp + 4 * lf + 4) >> 3 if tp is not None and
                          lf is not None else lf if lf is not None else
                          tp if tp is not None else 128)
                elif k == 1:
                    pv = tp if tp is not None else lf if lf is not None \
                        else 128
                else:
                    pv = lf if lf is not None else tp if tp is not None \
                        else 128
                preds.append(pv)
            unit = max(1, res(8)) / 8
            f = [round((int(tgt[2 * y + (k >> 1)][2 * x + (k & 1)]) -
                        preds[k]) / unit) for k in range(4)]
            cl = [round((f[0] + f[1] + f[2] + f[3]) / 4),
                  round((f[0] - f[1] + f[2] - f[3]) / 4),
                  round((f[0] + f[1] - f[2] - f[3]) / 4),
                  round((f[0] - f[1] - f[2] + f[3]) / 4)]
            cl = [max(-60, min(60, v)) for v in cl]
            g = [cl[0] + cl[1] + cl[2] + cl[3], cl[0] - cl[1] + cl[2] - cl[3],
                 cl[0] + cl[1] - cl[2] - cl[3], cl[0] - cl[1] - cl[2] + cl[3]]
            planes.append([max(0, min(255, preds[k] + res(g[k])))
                           for k in range(4)])
            dc_levels.append(cl)
        self.flat[self.mba] = (cur, planes[0], planes[1])
        m.cbp = sum(1 << k for k in range(4) if levels[k]) | 0x10
        m.chroma_mode = 0
        self._mb_type_intra(0)
        self._t8x8(True)
        for b8 in range(4):
            bx, by = (b8 & 1) * 2, (b8 >> 1) * 2
            self._intra_mode(2, self._pred_intra_mode(bx, by))
            for q in range(4):
                m.ipred[(by + (q >> 1)) * 4 + bx + (q & 1)] = 2
        self._chroma_mode(0)
        self._cbp(m.cbp, True)
        self._dqp(0)
        self.last_dqp = 0
        for b8 in range(4):
            if not levels[b8]:
                continue
            bx0, by0 = (b8 & 1) * 2, (b8 >> 1) * 2
            lv = [levels[b8]] + [0] * 63
            if self.cab:
                n = self._block_cabac(5, 0, lv)
                for q in range(4):
                    m.nnz[(by0 + (q >> 1)) * 4 + bx0 + (q & 1)] = n
            else:
                for q in range(4):
                    bx, by = bx0 + (q & 1), by0 + (q >> 1)
                    part = [lv[4 * i + q] for i in range(16)]
                    m.nnz[by * 4 + bx] = self._block_cavlc(
                        part, self._nc_luma(bx, by), 16)
        for ci in range(2):
            v = dc_levels[ci]
            n = self._block_cabac(3, self._cbf_dc(1 + ci), v) if self.cab \
                else self._block_cavlc(v, -1, 4)
            if n:
                m.dc_cbf |= 2 << ci

    def _mb(self):
        c, r = self.cfg, self.rng
        m = self.cur
        intra = self.stype == 2 or r.random() < c.intra_in_p
        if intra:
            self._intra_mb()
            return
        m.kind, m.intra = PINTER, False
        valid = self._valid_refs()
        k = r.random()
        if k < 0.35:
            t = 0
        elif k < 0.5:
            t = 1
        elif k < 0.65:
            t = 2
        elif k < 0.72 and not c.cabac and 0 in valid:
            t = 4
        else:
            t = 3
        self._mb_type(t)
        n = self.num_ref
        parts = []
        small = False
        if t < 3:
            cnt = 1 if t == 0 else 2
            refs = [r.choice(valid) for _ in range(cnt)]
            for i in range(cnt):
                x, y = (8 * i if t == 2 else 0), (8 * i if t == 1 else 0)
                if n > 1:
                    self._ref_idx(refs[i], x, y)
                w, h = (8 if t == 2 else 16), (8 if t == 1 else 16)
                for q in range(4):
                    qx, qy = (q & 1) * 8, (q >> 1) * 8
                    if x <= qx < x + w and y <= qy < y + h:
                        m.ref[q] = refs[i]
            for i in range(cnt):
                x, y = (8 * i if t == 2 else 0), (8 * i if t == 1 else 0)
                w, h = (8 if t == 2 else 16), (8 if t == 1 else 16)
                shape = 1 + i if t == 1 else (3 + i if t == 2 else 0)
                pred = self._mvp(x, y, w, refs[i], shape)
                mv = self._draw_mv(pred)
                d = (mv[0] - pred[0], mv[1] - pred[1])
                self._mvd(d[0], x, y, 0)
                self._mvd(d[1], x, y, 1)
                self._set_motion(x, y, w, h, mv, d)
        else:
            sub = [r.randrange(4) if r.random() < 0.6 else 0 for _ in range(4)]
            small = any(sub)
            for s in sub:
                self._sub_mb_type(s)
            for q in range(4):
                m.ref[q] = r.choice(valid) if t == 3 else 0
                if n > 1 and t == 3:
                    self._ref_idx(m.ref[q], (q & 1) * 8, (q >> 1) * 8)
            for q in range(4):
                x0, y0 = (q & 1) * 8, (q >> 1) * 8
                s = sub[q]
                cnt = 1 if s == 0 else (4 if s == 3 else 2)
                w = 8 if s in (0, 1) else 4
                h = 8 if s in (0, 2) else 4
                for j in range(cnt):
                    x = x0 + ((j & 1) * 4 if s in (2, 3) else 0)
                    y = y0 + (j * 4 if s == 1 else
                              ((j >> 1) * 4 if s == 3 else 0))
                    pred = self._mvp(x, y, w, m.ref[q], 0)
                    mv = self._draw_mv(pred)
                    d = (mv[0] - pred[0], mv[1] - pred[1])
                    self._mvd(d[0], x, y, 0)
                    self._mvd(d[1], x, y, 1)
                    self._set_motion(x, y, w, h, mv, d)
        cbp = self._draw_cbp()
        m.cbp = cbp
        self._cbp(cbp, False)
        if (cbp & 15) and c.transform_8x8 and not small:
            m.t8x8 = r.random() < 0.5
            self._t8x8(m.t8x8)
        self._residual(False)

    def _draw_cbp(self):
        r = self.rng
        d = self.cfg.coef_density
        luma = sum((r.random() < d) << k for k in range(4))
        chroma = 0 if r.random() > d else r.choice((1, 2))
        return luma | (chroma << 4)

    def _intra_mb(self):
        c, r = self.cfg, self.rng
        m = self.cur
        m.intra = True
        k = r.random()
        if k < c.pcm_prob:
            self._pcm()
            return
        if k < 0.55:
            m.t8x8 = c.transform_8x8 and r.random() < 0.5
            self._mb_type_intra(0)
            if c.transform_8x8:
                self._t8x8(m.t8x8)
            m.kind = I8x8 if m.t8x8 else I4x4
            if m.t8x8:
                for b8 in range(4):
                    bx, by = (b8 & 1) * 2, (b8 >> 1) * 2
                    mode = self._choose_nxn(8, b8, bx, by)
                    self._intra_mode(mode, self._pred_intra_mode(bx, by))
                    for q in range(4):
                        m.ipred[(by + (q >> 1)) * 4 + bx + (q & 1)] = mode
            else:
                for i in range(16):
                    bx = ((i >> 2) & 1) * 2 + (i & 1)
                    by = (i >> 3) * 2 + ((i >> 1) & 1)
                    mode = self._choose_nxn(4, i, bx, by)
                    self._intra_mode(mode, self._pred_intra_mode(bx, by))
                    m.ipred[by * 4 + bx] = mode
            m.chroma_mode = self._choose_chroma()
            self._chroma_mode(m.chroma_mode)
            cbp = self._draw_cbp()
            m.cbp = cbp
            self._cbp(cbp, True)
        else:
            m.kind = I16x16
            modes = [2]
            if self.ib:
                modes.append(0)
            if self.ia:
                modes.append(1)
            if self.ia and self.ib and self.id:
                modes.append(3)
            mode = r.choice(modes)
            chroma = 0 if r.random() > c.coef_density else r.choice((1, 2))
            luma = r.random() < c.coef_density
            m.cbp = (15 if luma else 0) | (chroma << 4)
            self._mb_type_intra(1 + mode + 4 * chroma + (12 if luma else 0))
            m.chroma_mode = self._choose_chroma()
            self._chroma_mode(m.chroma_mode)
        self._residual(True)

    def _choose_nxn(self, n, blk, bx, by):
        if n == 4:
            hl = bx > 0 or self.ia
            ht = by > 0 or self.ib
            htl = (bx > 0 and by > 0) or (
                self.id if bx == 0 and by == 0 else (self.ia if bx == 0
                                                     else self.ib))
        else:
            x8, y8 = blk & 1, blk >> 1
            hl = x8 > 0 or self.ia
            ht = y8 > 0 or self.ib
            htl = (x8 and y8) or (self.id if not x8 and not y8 else
                                  (self.ia if not x8 else self.ib))
        modes = [2]
        if ht:
            modes += [0, 3, 7]
        if hl:
            modes += [1, 8]
        if ht and hl and htl:
            modes += [4, 5, 6]
        return self.rng.choice(modes)

    def _choose_chroma(self):
        modes = [0]
        if self.ia:
            modes.append(1)
        if self.ib:
            modes.append(2)
        if self.ia and self.ib and self.id:
            modes.append(3)
        return self.rng.choice(modes)

    def _pred_intra_mode(self, bx, by):
        ma, ia = self._blk_nb(bx - 1, by)
        mb, ib = self._blk_nb(bx, by - 1)
        if ma < 0 or mb < 0:
            return 2
        if self.cfg.constrained_intra and (not self.mbs[ma].intra or
                                           not self.mbs[mb].intra):
            return 2
        a = self.mbs[ma].ipred[ia]
        b = self.mbs[mb].ipred[ib]
        return min(2 if a < 0 else a, 2 if b < 0 else b)

    def _pcm(self):
        m, r = self.cur, self.rng
        m.kind = IPCM
        self._mb_type_intra(25)
        b = self.b
        b.align_zero()
        for _ in range(384):
            b.u(8, r.randrange(1, 256))
        m.cbp = 0x2F
        m.dc_cbf = 7
        m.nnz = [16] * 16
        m.nnzc = [[16] * 4, [16] * 4]
        self.last_dqp = 0
        if self.cab:
            self.cab.start()

    # ---------------------------------------------------------- syntax

    def _mb_type(self, t):
        if not self.cab:
            self.b.ue(t)
            return
        c = self.cab
        c.decision(14, 0)
        if t in (0, 3):
            c.decision(15, 0)
            c.decision(16, int(t == 3))
        else:
            c.decision(15, 1)
            c.decision(17, int(t == 1))

    def _mb_type_intra(self, it):
        if not self.cab:
            self.b.ue(it + (5 if self.stype == 0 else 0))
            return
        c = self.cab
        islice = self.stype == 2
        if islice:
            base = 3
            def nn(a):
                return a >= 0 and self.mbs[a].kind in (I16x16, IPCM)
            inc = nn(self.na) + nn(self.nb)
        else:
            c.decision(14, 1)
            base, inc = 17, 0
        c.decision(base + inc, int(it != 0))
        if it == 0:
            return
        c.terminate(int(it == 25))
        if it == 25:
            return
        s = base + 3 if islice else base + 1
        v = it - 1
        mode, chroma, luma = v % 4, (v // 4) % 3, v >= 12
        c.decision(s, int(luma))
        c.decision(s + 1, int(chroma != 0))
        if chroma:
            c.decision(s + (2 if islice else 1), int(chroma == 2))
        c.decision(base + 6 if islice else base + 3, mode >> 1)
        c.decision(base + 7 if islice else base + 3, mode & 1)

    def _sub_mb_type(self, s):
        if not self.cab:
            self.b.ue(s)
            return
        c = self.cab
        c.decision(21, int(s == 0))
        if s == 0:
            return
        c.decision(22, int(s != 1))
        if s == 1:
            return
        c.decision(23, int(s == 2))

    def _nb_ref(self, x, y):
        m, idx = self._blk_nb(x >> 2, y >> 2)
        if m < 0:
            return -1
        n = self.mbs[m]
        if n.intra or n.kind == PSKIP:
            return -1
        return n.ref[_b8(idx)]

    def _ref_idx(self, v, x, y):
        n = self.num_ref
        if not self.cab:
            if n == 2:
                self.b.bit(1 - v)
            else:
                self.b.ue(v)
            return
        ctx = (self._nb_ref(x - 1, y) > 0) + 2 * (self._nb_ref(x, y - 1) > 0)
        j = 0
        while True:
            self.cab.decision(54 + ctx, int(v > j))
            if v <= j:
                return
            j += 1
            ctx = 4 if j == 1 else 5

    def _mvd(self, v, x, y, comp):
        if not self.cab:
            self.b.se(v)
            return
        s = 0
        for k in range(2):
            m, idx = (self._blk_nb((x - 1) >> 2, y >> 2) if k == 0 else
                      self._blk_nb(x >> 2, (y - 1) >> 2))
            if m >= 0:
                s += self.mbs[m].mvd[idx][comp]
        c = self.cab
        base = 47 if comp else 40
        a = abs(v)
        c.decision(base + (0 if s < 3 else (2 if s > 32 else 1)), int(a > 0))
        if not a:
            return
        k = 1
        while k < 9:
            c.decision(base + (k + 2 if k < 4 else 6), int(a > k))
            if a <= k:
                break
            k += 1
        if a >= 9:
            c.exp_golomb(a - 9, 3)
        c.bypass(int(v < 0))

    def _cbp(self, v, intra_nxn):
        if not self.cab:
            self.b.ue((CBP_CODE_INTRA if intra_nxn else CBP_CODE_INTER)[v])
            return
        c = self.cab
        ca = self.mbs[self.na].cbp if self.na >= 0 else 0x0F
        cb = self.mbs[self.nb].cbp if self.nb >= 0 else 0x0F
        for b8 in range(4):
            a = (v >> (b8 - 1)) & 1 if b8 & 1 else (ca >> (b8 + 1)) & 1
            t = (v >> (b8 - 2)) & 1 if b8 & 2 else (cb >> (b8 + 2)) & 1
            c.decision(73 + (not a) + 2 * (not t), (v >> b8) & 1)
        cha = self.mbs[self.na].cbp >> 4 if self.na >= 0 else 0
        chb = self.mbs[self.nb].cbp >> 4 if self.nb >= 0 else 0
        ch = v >> 4
        c.decision(77 + (cha > 0) + 2 * (chb > 0), int(ch > 0))
        if ch:
            c.decision(77 + 4 + (cha == 2) + 2 * (chb == 2), int(ch == 2))

    def _dqp(self, d):
        if not self.cab:
            self.b.se(d)
            return
        c = self.cab
        k = 2 * d - 1 if d > 0 else -2 * d
        c.decision(60 + (self.last_dqp != 0), int(k > 0))
        if not k:
            return
        j = 1
        while True:
            c.decision(62 if j == 1 else 63, int(k > j))
            if k <= j:
                return
            j += 1

    def _t8x8(self, f):
        if not self.cab:
            self.b.bit(f)
            return
        inc = (self.na >= 0 and self.mbs[self.na].t8x8) + \
            (self.nb >= 0 and self.mbs[self.nb].t8x8)
        self.cab.decision(399 + inc, int(f))

    def _intra_mode(self, mode, pred):
        flag = mode == pred
        rem = mode if mode < pred else mode - 1
        if not self.cab:
            self.b.bit(flag)
            if not flag:
                self.b.u(3, rem)
            return
        self.cab.decision(68, int(flag))
        if not flag:
            for k in range(3):
                self.cab.decision(69, (rem >> k) & 1)

    def _chroma_mode(self, v):
        if not self.cab:
            self.b.ue(v)
            return
        cond = lambda a: a >= 0 and self.mbs[a].intra and \
            self.mbs[a].kind != IPCM and self.mbs[a].chroma_mode != 0  # noqa
        c = self.cab
        c.decision(64 + cond(self.na) + cond(self.nb), int(v > 0))
        if v == 0:
            return
        c.decision(67, int(v > 1))
        if v > 1:
            c.decision(67, int(v == 3))

    # ---------------------------------------------------------- residual

    def _nc_luma(self, bx, by):
        ma, ia = self._blk_nb(bx - 1, by)
        mb, ib = self._blk_nb(bx, by - 1)
        na = self.mbs[ma].nnz[ia] if ma >= 0 else 0
        nb = self.mbs[mb].nnz[ib] if mb >= 0 else 0
        if ma >= 0 and mb >= 0:
            return (na + nb + 1) >> 1
        return na if ma >= 0 else (nb if mb >= 0 else 0)

    def _nc_chroma(self, c, cx, cy):
        ma, ia = self._cblk_nb(cx - 1, cy)
        mb, ib = self._cblk_nb(cx, cy - 1)
        na = self.mbs[ma].nnzc[c][ia] if ma >= 0 else 0
        nb = self.mbs[mb].nnzc[c][ib] if mb >= 0 else 0
        if ma >= 0 and mb >= 0:
            return (na + nb + 1) >> 1
        return na if ma >= 0 else (nb if mb >= 0 else 0)

    def _cbf_luma(self, bx, by):
        ma, ia = self._blk_nb(bx - 1, by)
        mb, ib = self._blk_nb(bx, by - 1)
        intra = self.cur.intra

        def cond(m, idx):
            if m < 0:
                return int(intra)
            n = self.mbs[m]
            if not (n.cbp >> _b8(idx)) & 1:
                return 0
            return int(n.nnz[idx] > 0)
        return cond(ma, ia) + 2 * cond(mb, ib)

    def _cbf_dc(self, bit):
        intra = self.cur.intra

        def cond(m):
            if m < 0:
                return int(intra)
            return (self.mbs[m].dc_cbf >> bit) & 1
        return cond(self.na) + 2 * cond(self.nb)

    def _cbf_chroma(self, c, cx, cy):
        ma, ia = self._cblk_nb(cx - 1, cy)
        mb, ib = self._cblk_nb(cx, cy - 1)
        intra = self.cur.intra

        def cond(m, idx):
            if m < 0:
                return int(intra)
            n = self.mbs[m]
            if (n.cbp >> 4) != 2:
                return 0
            return int(n.nnzc[c][idx] > 0)
        return cond(ma, ia) + 2 * cond(mb, ib)

    def _levels(self, n, must, weight):
        """n coefficients (scan order), sparse; at least one if `must`;
        `weight(k, level)` their dequantised size, kept small enough."""
        r, c = self.rng, self.cfg
        for _ in range(20):
            lv = [0] * n
            count = r.choice((0, 0, 1, 1, 2, 3, 5, 8)) if n > 4 else \
                r.choice((0, 1, 2, 4))
            if r.random() < 0.05:
                count = n
            if must:
                count = max(count, 1)
            for _ in range(count):
                k = r.randrange(n) if r.random() < 0.5 else \
                    r.randrange(min(n, 6))
                v = r.choice((1, 1, 1, 1, 2, 2, 3, 4))
                if c.big_levels and r.random() < 0.04:
                    v = r.randrange(5, 40)
                lv[k] = v if r.random() < 0.5 else -v
            if must and not any(lv):
                lv[0] = 1
            if sum(weight(k, v) for k, v in enumerate(lv) if v) <= 6000:
                return lv
        lv = [0] * n
        if must:
            lv[0] = 1
        return lv

    def _deq_weight(self, scale_list, qp, shift8):
        """|dequantised| of a level at scan position k (upper bound)."""
        def f(k, v):
            return abs(v) * scale_list[k] * 58 * (1 << (qp // 6)) >> \
                (6 if shift8 else 4)
        return f

    def _block_cavlc(self, lv, nc, maxc):
        b = self.b
        pos = [k for k in range(maxc - 1, -1, -1) if lv[k]]
        total = len(pos)
        levels = [lv[k] for k in pos]
        t1 = 0
        for v in levels:
            if abs(v) == 1 and t1 < 3:
                t1 += 1
            else:
                break
        tab = 4 if nc < 0 else (0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8
                                else 3)
        if tab == 4:
            ln = T["kChromaDcCoeffTokenLen"][total * 4 + t1]
            code = T["kChromaDcCoeffTokenBits"][total * 4 + t1]
        else:
            ln = T["kCoeffTokenLen"][tab * 68 + total * 4 + t1]
            code = T["kCoeffTokenBits"][tab * 68 + total * 4 + t1]
        b.u(ln, code)
        if not total:
            return 0
        for i in range(t1):
            b.bit(levels[i] < 0)
        suffix = 1 if total > 10 and t1 < 3 else 0
        for i in range(t1, total):
            v = levels[i]
            code = 2 * v - 2 if v > 0 else -2 * v - 1
            if i == t1 and t1 < 3:
                code -= 2
            if suffix == 0:
                if code < 14:
                    b.u(code + 1, 1)
                elif code < 30:
                    b.u(15, 1)
                    b.u(4, code - 14)
                else:
                    b.u(16, 1)
                    b.u(12, code - 30)
            else:
                if code < (15 << suffix):
                    b.u((code >> suffix) + 1, 1)
                    b.u(suffix, code & ((1 << suffix) - 1))
                else:
                    b.u(16, 1)
                    b.u(12, code - (15 << suffix))
            if suffix == 0:
                suffix = 1
            if abs(v) > (3 << (suffix - 1)) and suffix < 6:
                suffix += 1
        if total < maxc:
            tz = pos[0] + 1 - total
            if maxc == 4:
                ln = T["kChromaDcTotalZerosLen"][(total - 1) * 4 + tz]
                code = T["kChromaDcTotalZerosBits"][(total - 1) * 4 + tz]
            else:
                ln = T["kTotalZerosLen"][(total - 1) * 16 + tz]
                code = T["kTotalZerosBits"][(total - 1) * 16 + tz]
            b.u(ln, code)
            left = tz
            for i in range(total - 1):
                if left <= 0:
                    break
                run = pos[i] - pos[i + 1] - 1
                t = min(left, 7) - 1
                b.u(T["kRunLen"][t * 16 + run], T["kRunBits"][t * 16 + run])
                left -= run
        return total

    def _block_cabac(self, cat, inc, lv):
        c = self.cab
        n = len(lv)
        cbf_off = (0, 4, 8, 12, 16)
        sig_off = (0, 15, 29, 44, 47)
        abs_off = (0, 10, 20, 30, 39)
        nz = [k for k in range(n) if lv[k]]
        if cat != 5:
            c.decision(85 + cbf_off[cat] + inc, int(bool(nz)))
        if not nz:
            return 0
        last = nz[-1]
        for i in range(n - 1):
            if cat == 5:
                sctx, lctx = 402 + SIG8[i], 417 + LAST8[i]
            elif cat == 3:
                sctx, lctx = 105 + 44 + min(i, 2), 166 + 44 + min(i, 2)
            else:
                sctx, lctx = 105 + sig_off[cat] + i, 166 + sig_off[cat] + i
            c.decision(sctx, int(lv[i] != 0))
            if lv[i]:
                c.decision(lctx, int(i == last))
                if i == last:
                    break
        gt1 = eq1 = 0
        base = 426 if cat == 5 else 227 + abs_off[cat]
        for k in reversed(nz):
            a = abs(lv[k]) - 1
            c.decision(base + (0 if gt1 else min(4, 1 + eq1)), int(a > 0))
            if a > 0:
                ctx = base + 5 + min(4 - (1 if cat == 3 else 0), gt1)
                j = 1
                while j < 14:
                    c.decision(ctx, int(a > j))
                    if a <= j:
                        break
                    j += 1
                if a >= 14:
                    c.exp_golomb(a - 14, 0)
            if a == 0:
                eq1 += 1
            else:
                gt1 += 1
            c.bypass(int(lv[k] < 0))
        return len(nz)

    def _residual(self, intra):
        c, r = self.cfg, self.rng
        m = self.cur
        i16 = m.kind == I16x16
        cbp_l, cbp_c = m.cbp & 15, m.cbp >> 4
        if cbp_l or cbp_c or i16:
            d = 0
            if r.random() < 0.3:
                d = r.randrange(-26, 26) if r.random() < 0.15 else \
                    r.randrange(-4, 5)
            nq = (self.qp + d + 52) % 52
            if nq > 42 or (nq < 6 and r.random() < 0.5):
                d = 0
                nq = self.qp
            self._dqp(d)
            self.qp = nq
            self.last_dqp = d
        else:
            self.last_dqp = 0
        qp = self.qp
        lst = 0 if intra else 3
        s4 = self.scale4
        s8 = self.scale8
        if i16:
            lv = self._levels(16, False, lambda k, v: abs(v) * 16 * 64 *
                              s4[0][0] // 16 * (1 << (qp // 6)) // 64)
            if self.cab:
                cnt = self._block_cabac(0, self._cbf_dc(0), lv)
            else:
                cnt = self._block_cavlc(lv, self._nc_luma(0, 0), 16)
            if cnt:
                m.dc_cbf |= 1
        for b8 in range(4):
            bx0, by0 = (b8 & 1) * 2, (b8 >> 1) * 2
            coded = (cbp_l >> b8) & 1
            if m.t8x8:
                if not coded:
                    continue
                w8 = self._deq_weight(s8[0 if intra else 1], qp, True)
                if self.cab:
                    lv = self._levels(64, True, w8)
                    cnt = self._block_cabac(5, 0, lv)
                    for q in range(4):
                        m.nnz[(by0 + (q >> 1)) * 4 + bx0 + (q & 1)] = cnt
                else:
                    lv = self._levels(64, False, w8)
                    for s in range(4):
                        bx, by = bx0 + (s & 1), by0 + (s >> 1)
                        part = [lv[4 * i + s] for i in range(16)]
                        m.nnz[by * 4 + bx] = self._block_cavlc(
                            part, self._nc_luma(bx, by), 16)
                continue
            for s in range(4):
                bx, by = bx0 + (s & 1), by0 + (s >> 1)
                if not coded:
                    continue
                if i16:
                    lv = self._levels(15, False, self._deq_weight(
                        s4[0][1:], qp, False))
                    cnt = self._block_cabac(1, self._cbf_luma(bx, by), lv) \
                        if self.cab else \
                        self._block_cavlc(lv, self._nc_luma(bx, by), 15)
                else:
                    lv = self._levels(16, False, self._deq_weight(
                        s4[lst], qp, False))
                    cnt = self._block_cabac(2, self._cbf_luma(bx, by), lv) \
                        if self.cab else \
                        self._block_cavlc(lv, self._nc_luma(bx, by), 16)
                m.nnz[by * 4 + bx] = cnt
        cq = [CHROMA_QP[max(0, min(51, qp + off))]
              for off in (c.chroma_qp_offset, self.second)]
        if cbp_c:
            for ci in range(2):
                lv = self._levels(4, False, lambda k, v: abs(v) * 4 * 16 *
                                  64 * (1 << (cq[ci] // 6)) // 32)
                cnt = self._block_cabac(3, self._cbf_dc(1 + ci), lv) \
                    if self.cab else self._block_cavlc(lv, -1, 4)
                if cnt:
                    m.dc_cbf |= 2 << ci
        if cbp_c == 2:
            for ci in range(2):
                for k in range(4):
                    cx, cy = k & 1, k >> 1
                    lv = self._levels(15, False, self._deq_weight(
                        s4[lst + 1 + ci][1:], cq[ci], False))
                    cnt = self._block_cabac(4, self._cbf_chroma(ci, cx, cy),
                                            lv) if self.cab else \
                        self._block_cavlc(lv, self._nc_chroma(ci, cx, cy), 15)
                    m.nnzc[ci][k] = cnt

    # ---------------------------------------------------------- refused

    def _b_picture(self) -> List[bytes]:
        """A non-reference B picture of one slice, every macroblock
        skipped (CAVLC or CABAC), after the last picture."""
        c = self.cfg
        b = Bits()
        frame_num = (self.prev_ref_frame_num + 1) % (1 << c.log2_max_frame_num)
        self.poc += 2
        b.ue(0)
        b.ue(1)                         # B
        b.ue(c.pps_base)
        b.u(c.log2_max_frame_num, frame_num)
        if c.poc_type == 0:
            b.u(c.log2_max_poc_lsb, self.poc % (1 << c.log2_max_poc_lsb))
        elif c.poc_type == 1:
            b.se(0)
        b.bit(1)                        # direct_spatial_mv_pred_flag
        b.bit(1)                        # num_ref_idx_active_override
        b.ue(0)
        b.ue(0)
        b.bit(0)
        b.bit(0)                        # no list modification
        qp = 30
        if c.cabac:
            b.ue(0)
        b.se(qp - self.pps_init_qp[0])
        if c.deblocking_control:
            b.ue(0)
            b.se(0)
            b.se(0)
        total = c.mb_w * c.mb_h
        if c.cabac:
            while not b.aligned():
                b.bit(1)
            cab = CabacEnc(b)
            cab.init_contexts(1, qp)
            for a in range(total):
                # mb_skip_flag of B slices: ctxIdx 24..26; with both
                # neighbours skipped (or absent) its increment is 0
                cab.decision(24, 1)
                cab.terminate(int(a == total - 1))
            b.align_zero()
        else:
            b.ue(total)
            b.trailing()
        return [nal_unit(1, 0, b.data())]

    def _field_pair(self) -> List[bytes]:
        """An IDR top field and an I bottom field (SPS 1: frame_mbs_only
        0), every macroblock I_16x16 with no residual, CAVLC."""
        c = self.cfg
        out = []
        for bottom in (0, 1):
            b = Bits()
            b.ue(0)
            b.ue(7)                     # I, all slices
            b.ue(c.pps_base + c.pps_count)
            b.u(c.log2_max_frame_num, 0)
            b.bit(1)                    # field_pic_flag
            b.bit(bottom)
            if not bottom:
                b.ue(1)                 # idr_pic_id
            if c.poc_type == 0:
                b.u(c.log2_max_poc_lsb, bottom)
            elif c.poc_type == 1:
                b.se(0)
            if not bottom:
                b.bit(0)
                b.bit(0)
            else:
                b.bit(0)
            b.se(28 - self.pps_init_qp[0])
            if c.deblocking_control:
                b.ue(1)
            self.mbs = [None] * (c.mb_w * (c.mb_h // 2))
            self.pw = c.mb_w
            self.stype = 2
            self.cab = None
            self.b = b
            for a in range(len(self.mbs)):
                self._begin(a, 0)
                m = self.cur
                m.intra, m.kind = True, I16x16
                modes = [2] + ([0] if self.ib else []) + \
                    ([1] if self.ia else [])
                b.ue(1 + self.rng.choice(modes))
                b.ue(0)                 # chroma DC
                b.se(0)                 # mb_qp_delta
                b.u(1, 1)               # the DC block: coeff_token 0 (nC < 2)
            b.trailing()
            out.append(nal_unit(5 if not bottom else 1, 3, b.data()))
        return out


class _Redo(Exception):
    """A draw left no reference picture in the list; the caller draws
    again."""


# ------------------------------------------------------------------ files

def avcc(stream: Stream, length_size: int = 4,
         with_sets: bool = True) -> bytes:
    sps = stream.sps[0]
    out = bytearray([1, sps[1], sps[2], sps[3], 0xFC | (length_size - 1)])
    sets = stream.sps if with_sets else []
    out.append(0xE0 | len(sets))
    for s in sets:
        out += struct.pack(">H", len(s)) + s
    sets = stream.pps if with_sets else []
    out.append(len(sets))
    for p in sets:
        out += struct.pack(">H", len(p)) + p
    if sps[1] in (100, 110, 122, 144):
        out += bytes([0xFD, 0xF8, 0xF8, 0])
    return bytes(out)


def samples(stream: Stream, length_size: int) -> List[bytes]:
    out = []
    for au in stream.access_units:
        s = bytearray()
        for n in au:
            assert len(n) < (1 << (8 * length_size)), "NAL too long"
            s += len(n).to_bytes(length_size, "big") + n
        out.append(bytes(s))
    return out


def annexb(stream: Stream) -> List[bytes]:
    """Annex B access units, the parameter sets before the first."""
    out = []
    for k, au in enumerate(stream.access_units):
        s = bytearray()
        nals = (stream.sps + stream.pps if k == 0 else []) + au
        for n in nals:
            s += b"\x00\x00\x00\x01" + n
        out.append(bytes(s))
    return out


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def _full(kind, version, flags, payload):
    return _box(kind, bytes([version]) + flags.to_bytes(3, "big") + payload)


def write_mp4(path: Path, stream: Stream, length_size: int = 4,
              entry: bytes = b"avc1", fps: int = 25,
              keyframes: Optional[List[int]] = None, edits=None):
    """An MP4 of one video track: ftyp, mdat, moov (moov last); `edits`
    an edit list of (movie-timescale duration, media time) segments."""
    inband = entry == b"avc3"
    data = samples(stream, length_size)
    if inband:
        # the parameter sets in band, before the first picture
        pre = b"".join(len(n).to_bytes(length_size, "big") + n
                       for n in stream.sps + stream.pps)
        if not stream.access_units[0][:1] or \
                (stream.access_units[0][0][0] & 31) != 7:
            data[0] = pre + data[0]
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) +
                b"isomiso2avc1mp41")
    mdat_payload = b"".join(data)
    mdat_at = len(ftyp) + 8
    w, h = stream.width, stream.height
    n = len(data)
    rec = avcc(stream, length_size, with_sets=not inband)
    visual = (b"\0" * 6 + struct.pack(">H", 1) + b"\0" * 16 +
              struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1) +
              b"\0" * 32 + struct.pack(">Hh", 24, -1) + _box(b"avcC", rec))
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1) + _box(entry, visual))
    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, 512 // fps))
    keys = keyframes if keyframes is not None else [0]
    stss = _full(b"stss", 0, 0, struct.pack(">I", len(keys)) +
                 b"".join(struct.pack(">I", k + 1) for k in keys))
    stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n) +
                 b"".join(struct.pack(">I", len(s)) for s in data))
    stco = _full(b"stco", 0, 0, struct.pack(">II", 1, mdat_at))
    stbl = _box(b"stbl", stsd + stts + stss + stsc + stsz + stco)
    dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1) +
                               _full(b"url ", 0, 1, b"")))
    minf = _box(b"minf", _full(b"vmhd", 0, 1, b"\0" * 8) + dinf + stbl)
    dur = n * (512 // fps)
    mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, 512, dur,
                                           0x55C4, 0))
    hdlr = _full(b"hdlr", 0, 0, b"\0" * 4 + b"vide" + b"\0" * 12 +
                 b"VideoHandler\0")
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    matrix = struct.pack(">9i", 65536, 0, 0, 0, 65536, 0, 0, 0, 1 << 30)
    tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0,
                                            dur * 1000 // 512) +
                 b"\0" * 8 + struct.pack(">hhhH", 0, 0, 0, 0) + matrix +
                 struct.pack(">II", w << 16, h << 16))
    edts = b""
    if edits:
        edts = _box(b"edts", _full(b"elst", 0, 0, struct.pack(
            ">I", len(edits)) + b"".join(struct.pack(">IiI", d, m, 0x10000)
                                         for d, m in edits)))
    trak = _box(b"trak", tkhd + edts + mdia)
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000,
                                            dur * 1000 // 512) +
                 struct.pack(">IH", 0x10000, 0x100) + b"\0" * 10 + matrix +
                 b"\0" * 24 + struct.pack(">I", 2))
    moov = _box(b"moov", mvhd + trak)
    path.write_bytes(ftyp + _box(b"mdat", mdat_payload) + moov)


def write_avi(path: Path, stream: Stream, fourcc: bytes = b"H264",
              fps: int = 25):
    """A plain AVI of one video stream, each chunk an Annex B access unit
    (the parameter sets in the first)."""
    packets = annexb(stream)
    w, h = stream.width, stream.height

    def chunk(cid, data):
        return cid + struct.pack("<I", len(data)) + data + b"\0" * (
            len(data) & 1)

    def lst(kind, data):
        return chunk(b"LIST", kind + data)

    avih = struct.pack("<14I", 1000000 // fps, 0, 0, 0x10, len(packets), 0,
                       1, 0, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIII4H", b"vids", fourcc, 0, 0, 0, 0, 1,
                       fps, 0, len(packets), 0, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3,
                       0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(
        b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi, index = b"", b""
    for p in packets:
        index += b"00dc" + struct.pack("<III", 0x10, 4 + len(movi), len(p))
        movi += chunk(b"00dc", p)
    body = b"AVI " + hdrl + lst(b"movi", movi) + chunk(b"idx1", index)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def make(cfg: Config, seed: int) -> Stream:
    """The stream of (cfg, seed); a draw that left a P slice with no
    reference picture is drawn again from the next sub-seed."""
    for k in range(50):
        try:
            return H264Writer(cfg, seed * 1000 + k).write()
        except _Redo:
            continue
    raise RuntimeError("no stream")

"""Video files read frame by frame as cv2.VideoCapture reads them (cv2 5.0's
FFmpeg backend: FFmpeg 8, libavformat 62.12, libavcodec 62.28, libswscale
9.5), with no cv2 and no FFmpeg.

`frames(path)` yields the BGR uint8 (h, w, 3) frames `cap.read()` returns,
bit for bit and as many. The containers are parsed here, as FFmpeg's
demuxers parse them; the codecs run in the loader core
(`csrc/mpeg4_decode.h`, `csrc/mjpeg_decode.h`, `csrc/h264_decode.h`,
`csrc/video_dsp.h`: the IDCT, motion compensation and swscale's YUV ->
BGR24 that cv2 asks for, with the matrix and range of the stream's VUI).

The container is picked from the file's first bytes, as FFmpeg probes, not
from its suffix:
  ISO BMFF (MP4 / MOV / M4V; libavformat/mov.c): `moov` before or after
    `mdat`; the first video track; the sample tables stsd (mp4v's esds
    DecoderSpecificInfo, or avc1 / avc3's avcC, is the decoder's
    extradata), stts, ctts, stsc,
    stsz / stz2, stco / co64, stss (a sample the file's end cuts comes as
    far as it goes, and reading ends there); an edit list of one segment
    (after any empty ones) as mov_fix_index applies it: decoding starts at the
    keyframe at or before the edit's media time, frames before it or past
    its end are decoded and dropped, the index ends at the first keyframe
    past its end; the display matrix of tkhd (times mvhd's): cv2 rotates
    frames by 90, 180 or 270 degrees (CAP_PROP_ORIENTATION_AUTO).
  RIFF AVI (libavformat/avidec.c): the first `vids` stream (strh / strf,
    BITMAPINFOHEADER fourcc, extradata after it), its `##dc` / `##db`
    chunks read in file order as the demuxer reads an interleaved file
    (LIST `rec ` descended, empty chunks skipped, the AVIX parts of an
    OpenDML file over 1 GiB after the first), a chunk cut by the file's end
    delivered as far as it goes.
Codecs: MPEG-4 Part 2 (mp4v, XVID, DIVX, DX50, FMP4, ...), MJPEG (MJPG,
AVI1, jpeg, ...) and H.264 (avc1, avc3; H264, X264, AVC1, ... in AVI,
whose chunks are Annex B access units): its progressive I and P pictures,
CAVLC and CABAC, 8-bit 4:2:0. A picture goes out as soon as it is
decoded, so a stream whose output order is not its decoding order is
refused and nothing is left to drain at its end. What cv2 reads nothing
of yields nothing here (no error):
a file FFmpeg cannot open (an MP4 whose `moov` never came, a file that is
no container it knows), a fourcc FFmpeg has no decoder for, a stream that
FFmpeg fails on from its first packet. A codec or container feature cv2
reads but the port has not ported raises `VideoUnsupported`
(NotImplementedError) naming its ROADMAP item.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from ..utils import native_loader as nl

Q_H264 = "ROADMAP Q1.13b"
Q_ASP = "ROADMAP Q1.13c"
Q_OTHER = "ROADMAP Q1.13d"


class VideoUnsupported(NotImplementedError):
    """A codec or container feature cv2 reads and the port does not."""


# FFmpeg's codec of a fourcc (riff.c ff_codec_bmp_tags, isom.c
# ff_codec_movvideo_tags): the two decoded here, and the ones cv2 reads
# that are not ported yet, with their ROADMAP item. Any other fourcc: no
# decoder, cv2 opens nothing.
_MPEG4_TAGS = {"FMP4", "DIVX", "DX50", "XVID", "MP4S", "M4S2", "MP4V",
               "UMP4", "RMP4", "3IV2", "SIPP", "XVIX", "DM4V", "WV1F", "SEDG",
               "WAWV", "FFDS", "FVFW", "DCOD", "MVXM", "PM4V", "SMP4", "DXGM",
               "VIDM", "M4T3", "GEOX", "HDX4", "DMK2", "DIGI", "INMC", "EPHV",
               "EM4A", "M4CC", "SN40", "VSPX", "ULDX", "GEOV", "SM4V", "DREX",
               "QMP4", "PLV1", "GLV4", "GMP4", "MNM4", "GTM4"}
_MJPEG_TAGS = {"MJPG", "AVI1", "AVRN", "DMB1", "JPEG", "IJPG", "ACDV",
               "SLMJ", "CJPG", "QIVG", "MJPA"}
_H264_TAGS = {"H264", "X264", "AVC1", "DAVC", "VSSH", "AVC3", "Q264", "V264",
               "GAVC", "UMSV", "TSHD"}
_XVID_TAGS = {"XVID", "XVIX", "RMP4", "ZMP4", "SIPP"}
_UNPORTED = {
    **{t: ("HEVC", Q_OTHER) for t in ("HEVC", "H265", "X265", "HVC1",
                                      "HEV1")},
    **{t: ("VP8", Q_OTHER) for t in ("VP80",)},
    **{t: ("VP9", Q_OTHER) for t in ("VP90", "VP09")},
    **{t: ("AV1", Q_OTHER) for t in ("AV01",)},
    **{t: ("MPEG-1/2 video", Q_OTHER) for t in ("MPG1", "MPG2", "MPEG",
                                                "PIM1", "PIM2", "MMES",
                                                "MPGV", "M2V1", "HDV1")},
    **{t: ("MS-MPEG-4 (DivX 3)", Q_OTHER) for t in ("DIV3", "MP43", "MP42",
                                                    "MPG4", "DIV4", "DIV5",
                                                    "DIV6", "AP41", "COL1",
                                                    "COL0", "MP41")},
    **{t: ("WMV", Q_OTHER) for t in ("WMV1", "WMV2", "WMV3", "WVC1",
                                     "WMVA", "WVP2")},
    **{t: ("H.263", Q_OTHER) for t in ("H263", "S263", "U263", "M263",
                                       "L263", "I263", "X263")},
    **{t: ("MJPEG-B", Q_OTHER) for t in ("MJPB",)},
}


def _codec(fourcc: str) -> Optional[str]:
    """'mpeg4', 'mjpeg', 'h264', None (no decoder); raises for one not
    ported."""
    t = fourcc.upper()
    if t in _MPEG4_TAGS:
        return "mpeg4"
    if t in _MJPEG_TAGS:
        return "mjpeg"
    if t in _H264_TAGS:
        return "h264"
    if t in _UNPORTED:
        name, item = _UNPORTED[t]
        raise VideoUnsupported(f"{name} video ({fourcc!r}) is not decoded "
                               f"by the port yet ({item})")
    return None


class Stream(NamedTuple):
    """The video stream of a file, as the reader decodes it."""
    codec: str                  # 'mpeg4', 'mjpeg' or 'h264'
    fourcc: str
    height: int                 # as the container states it
    extradata: bytes
    packets: List[Tuple[int, int]]   # (file offset, size), decode order
    discard: List[bool]         # per packet: decode, drop the frame
    rotation: int               # cv2's rotation (0, 90, 180, 270)


class _Unreadable(Exception):
    """cv2 opens nothing of the file."""


def _probe(head: bytes) -> Optional[str]:
    """The container FFmpeg's probe picks from the first bytes."""
    if len(head) >= 12 and head[:4] == b"RIFF" and head[8:12] in (
            b"AVI ", b"AVIX", b"AVI\x19", b"AMV "):
        return "avi"
    if len(head) >= 8 and head[4:8] in (b"ftyp", b"moov", b"mdat", b"free",
                                        b"wide", b"skip", b"pnot", b"junk",
                                        b"uuid", b"moof", b"styp"):
        return "mov"
    if head[:4] == b"\x1a\x45\xdf\xa3":
        return "mkv"
    if head[:4] in (b"\x00\x00\x01\xba", b"\x00\x00\x01\xb3"):
        return "mpeg-ps"
    if head[:16] == bytes.fromhex("3026b2758e66cf11a6d900aa0062ce6c"):
        return "asf"
    return None


# ----------------------------------------------------------------- MP4

def _boxes(data: bytes, start: int, end: int):
    """(type, payload start, box end) of the boxes in [start, end); a box
    that overruns `end` is cut there, as FFmpeg reads what there is."""
    at = start
    while at + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, at)
        head = 8
        if size == 1:
            if at + 16 > end:
                return
            size = struct.unpack_from(">Q", data, at + 8)[0]
            head = 16
        elif size == 0:
            size = end - at
        if size < head:
            return
        yield kind.decode("latin-1"), at + head, min(at + size, end)
        at += size


def _child(data, start, end, kind):
    for k, s, e in _boxes(data, start, end):
        if k == kind:
            return s, e
    return None


def _full(data, s):
    """A full box's version and the position after its flags."""
    return data[s], s + 4


def _matrix(data, at):
    return [struct.unpack_from(">i", data, at + 4 * i)[0] for i in range(9)]


def _rotation(matrix) -> int:
    """OpenCV's get_rotation_angle of the display matrix
    (av_display_rotation_get, rounded, in [0, 360)), kept where cv2
    rotates: 90, 180 or 270."""
    a, b, c, d = (v / 65536.0 for v in (matrix[0], matrix[1], matrix[3],
                                        matrix[4]))
    s0, s1 = math.hypot(a, c), math.hypot(b, d)
    if s0 == 0 or s1 == 0:
        return 0
    rot = -math.degrees(math.atan2(b / s1, a / s0))
    angle = -int(np.rint(rot))
    if angle < 0:
        angle += 360
    return angle if angle in (90, 180, 270) else 0


def _mov_stream(data: bytes) -> Stream:
    size = len(data)
    top = list(_boxes(data, 0, size))
    kinds = [k for k, _, _ in top]
    if "moof" in kinds:
        raise VideoUnsupported("fragmented MP4 (moof boxes) is not read by "
                               f"the port yet ({Q_H264})")
    moov = next(((s, e) for k, s, e in top if k == "moov"), None)
    if moov is None:
        raise _Unreadable("moov atom not found")
    if _child(data, *moov, "mvex"):
        raise VideoUnsupported("fragmented MP4 (mvex) is not read by the "
                               f"port yet ({Q_H264})")
    movie_scale, movie_matrix = 1000, [65536, 0, 0, 0, 65536, 0, 0, 0,
                                       1 << 30]
    mvhd = _child(data, *moov, "mvhd")
    if mvhd:
        ver, p = _full(data, mvhd[0])
        movie_scale = struct.unpack_from(">I", data, p + (16 if ver else 8))[0]
        movie_matrix = _matrix(data, p + (28 if ver else 16) + 4 + 2 + 10)
    for k, s, e in _boxes(data, *moov):
        if k != "trak":
            continue
        mdia = _child(data, s, e, "mdia")
        if not mdia:
            continue
        hdlr = _child(data, *mdia, "hdlr")
        if not hdlr or data[hdlr[0] + 8:hdlr[0] + 12] != b"vide":
            continue
        return _mov_track(data, s, e, mdia, movie_scale, movie_matrix)
    raise _Unreadable("no video track")


def _mov_track(data, s, e, mdia, movie_scale, movie_matrix) -> Stream:
    tkhd = _child(data, s, e, "tkhd")
    rotation = 0
    if tkhd:
        ver, p = _full(data, tkhd[0])
        p += 32 if ver else 20          # times, track id, duration
        p += 8 + 2 + 2 + 2 + 2          # reserved, layer, group, volume
        m = _matrix(data, p)
        sh = (16, 16, 30)
        res = [[0] * 3 for _ in range(3)]
        for i in range(3):
            for j in range(3):
                for k in range(3):
                    res[i][j] += (m[i * 3 + k] * movie_matrix[k * 3 + j]) \
                        >> sh[k]
        rotation = _rotation([v for row in res for v in row])
    mdhd = _child(data, *mdia, "mdhd")
    ver, p = _full(data, mdhd[0])
    media_scale = struct.unpack_from(">I", data, p + (16 if ver else 8))[0]
    minf = _child(data, *mdia, "minf")
    stbl = _child(data, *minf, "stbl") if minf else None
    if not stbl:
        raise _Unreadable("no sample table")
    box = {k: (bs, be) for k, bs, be in _boxes(data, *stbl)}
    stsd = box.get("stsd")
    if not stsd:
        raise _Unreadable("no sample description")
    entry = stsd[0] + 8
    fourcc = data[entry + 4:entry + 8].decode("latin-1")
    height = struct.unpack_from(">H", data, entry + 8 + 26)[0]
    extradata = b""
    codec_tag = fourcc
    if fourcc.lower() == "mp4v":
        esds = _child(data, entry + 8 + 78, min(
            stsd[1], entry + struct.unpack_from(">I", data, entry)[0]),
            "esds")
        oti, extradata = _esds(data, *esds) if esds else (0x20, b"")
        codec = {0x20: "mpeg4", 0x6C: "mjpeg"}.get(oti)
        if codec is None:
            what = {0x21: "AVC1", 0x60: "MPG2", 0x61: "MPG2", 0x62: "MPG2",
                    0x63: "MPG2", 0x64: "MPG2", 0x65: "MPG2", 0x6A: "MPG1",
                    0x23: "HEVC", 0xB1: "VP90"}.get(oti)
            if what == "AVC1":
                raise VideoUnsupported("H.264 in an mp4v sample entry is not "
                                       f"read by the port yet ({Q_H264})")
            if what:
                _codec(what)
            raise _Unreadable(f"object type {oti:#x}")
    else:
        codec = _codec({"jpeg": "MJPG", "mjpa": "MJPG", "avc1": "AVC1",
                        "avc3": "AVC3", "hvc1": "HVC1", "hev1": "HEV1",
                        "vp09": "VP90", "av01": "AV01", "s263": "S263",
                        "h263": "H263", "mjpb": "MJPB"}.get(fourcc, fourcc))
        if codec is None:
            raise _Unreadable(f"no decoder for {fourcc!r}")
        if codec == "h264":
            # the avcC box of the visual sample entry: the decoder's
            # extradata (its parameter sets and NAL length size)
            avcc = _child(data, entry + 8 + 78, min(
                stsd[1], entry + struct.unpack_from(">I", data, entry)[0]),
                "avcC")
            if not avcc:
                raise _Unreadable("avc1 without avcC")
            extradata = data[avcc[0]:avcc[1]]
    # the sample table
    def table(name, fmt):
        if name not in box:
            return []
        bs, be = box[name]
        n = struct.unpack_from(">I", data, bs + 4)[0]
        rec = struct.calcsize(fmt)
        n = min(n, (be - bs - 8) // rec)
        return [struct.unpack_from(fmt, data, bs + 8 + i * rec)
                for i in range(n)]
    if "stsz" in box:
        bs, be = box["stsz"]
        fixed, count = struct.unpack_from(">II", data, bs + 4)
        if fixed:
            sizes = [fixed] * count
        else:
            count = min(count, (be - bs - 12) // 4)
            sizes = list(struct.unpack_from(f">{count}I", data, bs + 12))
    elif "stz2" in box:
        raise VideoUnsupported(f"stz2 sample sizes ({Q_H264})")
    else:
        sizes = []
    offsets = [v[0] for v in table("stco", ">I")] or \
        [v[0] for v in table("co64", ">Q")]
    stsc = table("stsc", ">III")
    # samples of each chunk
    positions = []
    n_samples = len(sizes)
    sample = 0
    for ci, off in enumerate(offsets):
        per = 0
        for first, spc, _ in stsc:
            if first - 1 <= ci:
                per = spc
        for _ in range(per):
            if sample >= n_samples:
                break
            positions.append((off, sizes[sample]))
            off += sizes[sample]
            sample += 1
    stts = table("stts", ">II")
    dts, t = [], 0
    for count, delta in stts:
        for _ in range(count):
            dts.append(t)
            t += delta
    dts = (dts + [t] * len(positions))[:len(positions)]
    durations = [b - a for a, b in zip(dts, dts[1:])] + [
        stts[-1][1] if stts else 0]
    ctts = [(c, struct.unpack(">i", struct.pack(">I", o))[0])
            for c, o in table("ctts", ">II")]
    cts_off = [o for c, o in ctts for _ in range(c)]
    cts = [d + (cts_off[i] if i < len(cts_off) else 0)
           for i, d in enumerate(dts)]
    sync = {v[0] - 1 for v in table("stss", ">I")} if "stss" in box else \
        None
    keys = [sync is None or i in sync for i in range(len(positions))]
    discard = [False] * len(positions)
    # a file cut short: the sample the data ends in comes as far as it
    # goes, and the demuxer's reading ends at the first one past the end
    size = len(data)
    for i, (off, n) in enumerate(positions):
        if off >= size:
            positions, keys, cts = positions[:i], keys[:i], cts[:i]
            discard = discard[:i]
            break
        positions[i] = (off, min(n, size - off))
    edts = _child(data, s, e, "edts")
    elst = _child(data, *edts, "elst") if edts else None
    if elst and positions:
        positions, discard = _edit(data, elst, movie_scale, media_scale,
                                   positions, cts, durations, keys)
    return Stream(codec, codec_tag, height, extradata, positions, discard,
                  rotation)


def _edit(data, elst, movie_scale, media_scale, positions, cts, durations,
          keys):
    """mov_fix_index for an edit list of one segment (after empty ones)."""
    ver, p = _full(data, elst[0])
    n = struct.unpack_from(">I", data, p)[0]
    p += 4
    edits = []
    for _ in range(n):
        if ver:
            dur, media = struct.unpack_from(">Qq", data, p)
            p += 16
        else:
            dur, media = struct.unpack_from(">Ii", data, p)
            p += 8
        p += 4  # rate
        edits.append((dur, media))
    real = [(d, m) for d, m in edits if m != -1]
    if len(real) != 1 or edits[-1][1] == -1:
        raise VideoUnsupported("an MP4 edit list of more than one segment "
                               f"is not applied by the port yet ({Q_H264})")
    dur, media = real[0]
    # av_rescale: the edit's duration in the media's time scale, rounded to
    # the nearest unit
    end = media + (dur * media_scale + movie_scale // 2) // movie_scale \
        if movie_scale else media
    # the keyframe at or before the edit's start
    first = 0
    for i, t in enumerate(cts):
        if t <= media and keys[i]:
            first = i
    out, drop = [], []
    for i in range(first, len(positions)):
        t = cts[i]
        out.append(positions[i])
        drop.append(t < media or t >= end)
        if t + durations[i] >= end and keys[i]:
            break       # the first keyframe past the edit's end, kept
    return out, drop


def _esds(data, s, e):
    """(objectTypeIndication, DecoderSpecificInfo) of an esds box."""
    p = s + 4

    def desc(p):
        tag = data[p]
        p += 1
        n = 0
        for _ in range(4):
            b = data[p]
            p += 1
            n = (n << 7) | (b & 0x7F)
            if not b & 0x80:
                break
        return tag, p, n

    tag, p, n = desc(p)
    if tag == 3:                        # ES_Descriptor
        flags = data[p + 2]
        p += 3
        if flags & 0x80:
            p += 2
        if flags & 0x40:
            p += 1 + data[p]
        if flags & 0x20:
            p += 2
        tag, p, n = desc(p)
    if tag != 4:                        # DecoderConfigDescriptor
        return 0x20, b""
    oti = data[p]
    q = p + 13
    info = b""
    if q < p + n:
        tag, q, m = desc(q)
        if tag == 5:
            info = data[q:q + m]
    return oti, info


# ----------------------------------------------------------------- AVI

def _avi_stream(data: bytes) -> Stream:
    size = len(data)
    riff_end = min(size, 8 + struct.unpack_from("<I", data, 4)[0])
    hdrl = None
    movi = []
    at = 12
    # the first RIFF's lists
    while at + 12 <= riff_end:
        cid, csz = struct.unpack_from("<4sI", data, at)
        if cid == b"LIST":
            kind = data[at + 8:at + 12]
            if kind == b"hdrl":
                hdrl = (at + 12, min(size, at + 8 + csz))
            elif kind == b"movi":
                movi.append((at + 12, min(size, at + 8 + csz)))
        at += 8 + csz + (csz & 1)
    if hdrl is None or not movi:
        raise _Unreadable("no AVI header or movi list")
    stream_no, strh, strf = _avi_video(data, *hdrl)
    fcc = strh[4:8].decode("latin-1")
    comp = strf[16:20].decode("latin-1") if len(strf) >= 20 else fcc
    codec = None
    for tag in (comp, fcc):
        if tag.strip("\x00"):
            codec = _codec(tag)
            if codec:
                fcc = tag
                break
    if codec is None:
        raise _Unreadable(f"no decoder for {comp!r}")
    height = struct.unpack_from("<i", strf, 8)[0]
    extradata = strf[40:] if len(strf) > 40 else b""
    # the AVIX parts of an OpenDML file, after the first RIFF
    at = riff_end + (riff_end & 1)
    while at + 12 <= size:
        cid, csz = struct.unpack_from("<4sI", data, at)
        if cid != b"RIFF" or data[at + 8:at + 12] != b"AVIX":
            break
        end = min(size, at + 8 + csz)
        p = at + 12
        while p + 12 <= end:
            lid, lsz = struct.unpack_from("<4sI", data, p)
            if lid == b"LIST" and data[p + 8:p + 12] == b"movi":
                movi.append((p + 12, min(size, p + 8 + lsz)))
            p += 8 + lsz + (lsz & 1)
        at = end + (end & 1)
    ids = {b"%02ddc" % stream_no, b"%02ddb" % stream_no}
    packets = []
    for start, end in movi:
        _avi_chunks(data, start, end, ids, packets)
    return Stream(codec, fcc, abs(height), extradata, packets,
                  [False] * len(packets), 0)


def _avi_video(data, start, end):
    """(stream number, strh, strf) of the first `vids` stream."""
    n = 0
    at = start
    while at + 8 <= end:
        cid, csz = struct.unpack_from("<4sI", data, at)
        if cid == b"LIST" and data[at + 8:at + 12] == b"strl":
            strh = strf = b""
            p, le = at + 12, min(end, at + 8 + csz)
            while p + 8 <= le:
                sid, ssz = struct.unpack_from("<4sI", data, p)
                if sid == b"strh":
                    strh = data[p + 8:p + 8 + ssz]
                elif sid == b"strf":
                    strf = data[p + 8:p + 8 + ssz]
                p += 8 + ssz + (ssz & 1)
            if strh[:4] == b"vids":
                return n, strh, strf
            n += 1
        at += 8 + csz + (csz & 1)
    raise _Unreadable("no video stream")


def _avi_chunks(data, start, end, ids, packets):
    at = start
    size = len(data)
    while at + 8 <= end:
        cid, csz = struct.unpack_from("<4sI", data, at)
        if cid == b"LIST":
            _avi_chunks(data, at + 12, min(end, at + 8 + csz), ids, packets)
        elif cid in ids and csz and at + 8 < size:
            packets.append((at + 8, min(csz, size - at - 8)))
        at += 8 + csz + (csz & 1)


# ----------------------------------------------------------------- reader

def open_stream(path: str) -> Optional[Stream]:
    """The file's video stream; None where cv2 opens nothing of it.
    Raises VideoUnsupported for what cv2 reads and the port does not."""
    try:
        data = Path(path).read_bytes()
    except OSError:
        return None
    return _stream(data)


def _stream(data: bytes) -> Optional[Stream]:
    kind = _probe(data[:64])
    try:
        if kind == "avi":
            return _avi_stream(data)
        if kind == "mov":
            return _mov_stream(data)
    except (_Unreadable, struct.error, IndexError):
        return None
    if kind in ("mkv", "mpeg-ps", "asf"):
        item = Q_H264 if kind == "mkv" else Q_OTHER
        raise VideoUnsupported(f"the {kind} container is not read by the "
                               f"port yet ({item})")
    return None


_MPEG4_TOOLS = {1: "B-VOPs", 2: "S(GMC)-VOPs", 3: "quarter-pel motion",
                4: "interlaced coding", 5: "data partitioning",
                6: "non-rectangular shapes", 7: "scalability",
                8: "complexity estimation", 9: "NEWPRED",
                10: "reduced-resolution VOPs", 11: "a bit depth other than 8",
                12: "the Xvid IDCT (an Xvid-encoded stream)",
                13: "sprites"}
_MJPEG_KINDS = {1: "progressive, arithmetic or lossless frames",
                2: "a precision other than 8 bits",
                3: "a component layout other than one interleaved YCbCr "
                   "scan", 4: "sampling other than 4:2:0 or 4:2:2",
                5: "interlaced (two-field) frames"}


_H264_TOOLS = {1: "B slices", 2: "field or MBAFF (interlaced) coding",
               3: "slice groups (FMO / ASO)", 4: "SP / SI slices",
               5: "data partitioning",
               6: "a chroma format other than 4:2:0",
               7: "a bit depth other than 8",
               8: "the lossless transform bypass",
               9: "gaps in frame_num",
               10: "damaged or cut slice data (FFmpeg conceals it)",
               11: "a first picture that is not an IDR picture",
               12: "an output order other than the decoding order",
               13: "a packet that is not one whole picture",
               14: "a left crop that is not a multiple of 64 columns (cv2 "
                   "rescales the frame)",
               15: "a VUI colour matrix swscale does not convert (YCgCo, "
                   "BT.2020 constant luminance, ...)"}


def _unsupported(stream: Stream, tool: int) -> VideoUnsupported:
    if stream.codec == "h264":
        return VideoUnsupported(
            f"H.264 with {_H264_TOOLS.get(tool, tool)} is not decoded by the "
            f"port yet ({Q_H264})")
    if stream.codec == "mpeg4":
        return VideoUnsupported(
            f"MPEG-4 Part 2 with {_MPEG4_TOOLS.get(tool, tool)} is not "
            f"decoded by the port yet ({Q_ASP})")
    return VideoUnsupported(
        f"MJPEG with {_MJPEG_KINDS.get(tool, tool)} is not decoded by the "
        f"port yet ({Q_OTHER})")


def frames(path: str) -> Iterator[np.ndarray]:
    """The frames cv2.VideoCapture(path).read() returns, BGR uint8."""
    try:
        data = Path(path).read_bytes()
    except OSError:
        return
    stream = _stream(data)
    if stream is None:
        return
    yield from decode(stream, data)


def decode(stream: Stream, data: bytes) -> Iterator[np.ndarray]:
    """The frames of `stream`, whose packets lie in `data` (the file's
    bytes), as cv2 returns them: a frame per decoded picture but those the
    edit list drops, rotated by the display matrix; after a last packet
    that is a VOP not coded, the last picture again (FFmpeg's flush);
    nothing more once a packet fails."""
    lib = nl._lib()
    if stream.codec == "mpeg4":
        flags = (1 if stream.fourcc.upper() in _XVID_TAGS else 0) | \
            (2 if stream.fourcc.upper() == "DIVX" else 0)
        codec = 1
    elif stream.codec == "h264":
        flags, codec = 0, 3
    else:
        flags = stream.height
        codec = 2
    extra = stream.extradata or None
    h = lib.et_video_open(codec, extra, len(stream.extradata), flags)
    if not h:
        return
    info = np.zeros(3, np.int32)
    last, skipped = None, False
    try:
        for (off, n), drop in zip(stream.packets, stream.discard):
            pkt = data[off:off + n]
            r = lib.et_video_decode(h, pkt, len(pkt), info.ctypes.data)
            if r == -4:
                raise _unsupported(stream, int(info[2]))
            if r < 0:
                return          # FFmpeg fails on the packet: cv2 stops
            skipped = r == 0
            if r == 0 or drop:
                continue
            w, ht = int(info[0]), int(info[1])
            out = np.empty((ht, w, 3), np.uint8)
            lib.et_video_bgr(h, out.ctypes.data)
            if stream.rotation == 90:
                out = np.ascontiguousarray(np.rot90(out, -1))
            elif stream.rotation == 180:
                out = np.ascontiguousarray(out[::-1, ::-1])
            elif stream.rotation == 270:
                out = np.ascontiguousarray(np.rot90(out, 1))
            last = out
            yield out
        if skipped and last is not None and stream.codec == "mpeg4":
            # a stream that ends on a VOP with no picture (vop_coded 0):
            # FFmpeg's flush gives the last picture again
            yield last.copy()
    finally:
        lib.et_video_close(h)

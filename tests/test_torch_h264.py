"""The port's H.264 decoder (`csrc/h264_decode.h` through
`data/video_io.py`) against cv2.VideoCapture and JAX's `LoadImages`.

The streams come from `tests/h264_writer.py`, a seeded syntax writer (the
libavcodec inside cv2's wheel decodes H.264 but has no encoder for it):
about twenty of them, CAVLC and CABAC, Baseline / Main / High tools, 48x32
to 176x144, three to six frames, in MP4 (avc1 / avc3, NAL lengths of 2 or
4 bytes) and AVI (Annex B); then the committed fixtures of
`tests/video_fixtures/` through both loaders; then every kind the port
refuses, each after the frames before it.

Tolerance: every frame bit-equal to cv2's, the same count, the same
"#idx" paths as JAX's loader; a refused kind raises NotImplementedError
naming ROADMAP Q1.13b once the frames before it are out, and those equal
cv2's first ones."""

import json
import random
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from efficientteacher_tpu.data.loaders import LoadImages as JaxLoadImages
from efficientteacher_torch.data import video_io
from efficientteacher_torch.data.loaders import LoadImages

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "video_fixtures"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
IMG = 64
sys.path.insert(0, str(REPO / "tests"))
import h264_writer as hw  # noqa: E402


def cv2_frames(path) -> list:
    cap = cv2.VideoCapture(str(path))
    out = []
    while cap.isOpened():
        ok, img = cap.read()
        if not ok:
            break
        out.append(img)
    cap.release()
    return out


def port_frames(path):
    """(frames, the error that ended them or None)."""
    out = []
    try:
        for f in video_io.frames(str(path)):
            out.append(f)
    except NotImplementedError as e:
        return out, e
    return out, None


def assert_frames_equal(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"frame {k}")


# ------------------------------------------------------- writer streams

def _config(seed):
    r = random.Random(seed)
    cabac = seed % 2 == 1
    profile = r.choice((77, 100)) if cabac else r.choice((66, 77, 100))
    high = profile == 100
    mb_w, mb_h = r.randrange(3, 12), r.randrange(2, 10)
    return hw.Config(
        mb_w=mb_w, mb_h=mb_h, frames=r.randrange(3, 7), cabac=cabac,
        profile=profile, poc_type=r.randrange(3),
        num_ref_frames=r.randrange(1, 5), max_slices=r.randrange(1, 4),
        constrained_intra=r.random() < 0.3,
        transform_8x8=high and r.random() < 0.8,
        sps_scaling=high and r.random() < 0.4,
        pps_scaling=high and r.random() < 0.4,
        chroma_qp_offset=r.randrange(-6, 7),
        second_chroma_qp_offset=r.randrange(-6, 7) if high else None,
        deblocking_control=r.random() < 0.8,
        weighted_pred=profile != 66 and r.random() < 0.4,
        crop=(32 if mb_w >= 5 and r.random() < 0.3 else 0, r.randrange(3),
              r.randrange(2), r.randrange(3)),
        full_range=r.choice((None, None, True, False)),
        matrix=r.choice((1, 2, 5, 6, 7, 9)),
        bitstream_restriction=r.random() < 0.3, qp=(10, 42),
        coef_density=r.choice((0.2, 0.4, 0.6)), long_term=True,
        reorder=True, mmco=True, inband=r.random() < 0.3,
        pps_count=r.randrange(1, 3), sps_id=r.randrange(32),
        pps_base=r.randrange(250))


@pytest.mark.parametrize("seed", range(20))
def test_writer_streams_equal_cv2(tmp_path, seed):
    """A seeded stream in MP4 or AVI: the port's frames are cv2's, bit for
    bit and as many."""
    cfg = _config(seed)
    stream = hw.make(cfg, seed)
    if seed % 5 == 4:
        path = tmp_path / "s.avi"
        hw.write_avi(path, stream)
    else:
        path = tmp_path / "s.mp4"
        hw.write_mp4(path, stream, 2 if seed % 3 == 0 else 4,
                     b"avc3" if cfg.inband else b"avc1")
    want = cv2_frames(path)
    got, err = port_frames(path)
    assert err is None
    assert len(want) == cfg.frames
    assert_frames_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_edit_lists_equal_cv2(tmp_path, seed):
    """An edit list of one segment (after an empty one, or not) over a
    stream with IDR pictures inside: decoding starts at the keyframe at or
    before the edit, the frames outside it are dropped, its duration
    rounded to the media's time scale as av_rescale rounds."""
    r = random.Random(seed)
    edits = [(r.randrange(1, 100), -1)] if seed % 2 else []
    edits.append((r.randrange(20, 400), r.choice((0, r.randrange(1, 200)))))
    stream = hw.make(hw.Config(mb_w=3, mb_h=2, frames=r.randrange(4, 9),
                               idr_prob=0.3), seed)
    keys = [i for i, au in enumerate(stream.access_units)
            if any(n[0] & 31 == 5 for n in au)]
    path = tmp_path / "e.mp4"
    hw.write_mp4(path, stream, 4, keyframes=keys, edits=edits)
    got, err = port_frames(path)
    assert err is None
    assert_frames_equal(got, cv2_frames(path))


# ------------------------------------------------------- the fixtures

DECODED = sorted(n for n, e in DIGESTS.items()
                 if n.startswith("h264_") and "refused" not in e)


@pytest.mark.parametrize("name", DECODED)
def test_loadimages_on_h264_fixtures_equals_jax(name):
    """JAX's LoadImages (cv2.VideoCapture) and the port's on each H.264
    fixture: the same `file#idx` paths, equal letterboxed and raw arrays."""
    path = str(FIXTURES / name)
    got = list(LoadImages(path, IMG))
    want = list(JaxLoadImages(path, IMG))
    assert [p for p, *_ in got] == [p for p, *_ in want]
    assert len(got) == DIGESTS[name]["frames"]
    for (p, rgb, img0, rp), (_, jrgb, jimg0, jrp) in zip(got, want):
        np.testing.assert_array_equal(img0, jimg0, err_msg=p)
        np.testing.assert_array_equal(rgb, jrgb, err_msg=p)
        assert rp == jrp


# ------------------------------------------------------- refused kinds

def _sps(sps_id, profile=100, chroma=1, depth=0, lossless=0, mb_w=4,
         mb_h=3, crop=None):
    b = hw.Bits()
    b.u(8, profile)
    b.u(8, 0)
    b.u(8, 40)
    b.ue(sps_id)
    if profile in (100, 110, 122, 244):
        b.ue(chroma)
        if chroma == 3:
            b.bit(0)
        b.ue(depth)
        b.ue(depth)
        b.bit(lossless)
        b.bit(0)
    b.ue(0)                 # log2_max_frame_num 4
    b.ue(0)                 # POC type 0
    b.ue(2)                 # log2_max_pic_order_cnt_lsb 6
    b.ue(1)
    b.bit(0)
    b.ue(mb_w - 1)
    b.ue(mb_h - 1)
    b.bit(1)
    b.bit(1)
    b.bit(crop is not None)
    for v in crop or ():
        b.ue(v)
    b.bit(0)
    b.trailing()
    return hw.nal_unit(7, 3, b.data())


def _pps(pps_id, sps_id, groups=1):
    b = hw.Bits()
    b.ue(pps_id)
    b.ue(sps_id)
    b.bit(0)
    b.bit(0)
    b.ue(groups - 1)
    if groups > 1:
        b.ue(0)             # interleaved map, a run per group
        for _ in range(groups):
            b.ue(0)
    b.ue(0)
    b.ue(0)
    b.bit(0)
    b.u(2, 0)
    b.se(0)
    b.se(0)
    b.se(0)
    b.bit(0)
    b.bit(0)
    b.bit(0)
    b.trailing()
    return hw.nal_unit(8, 3, b.data())


def _slice(pps_id, slice_type=7, nal_type=5, frame_num=0):
    """A slice header (then junk) of the 4x3 streams below."""
    b = hw.Bits()
    b.ue(0)
    b.ue(slice_type)
    b.ue(pps_id)
    b.u(4, frame_num)
    if nal_type == 5:
        b.ue(0)
    b.u(6, 0)
    for v in (0x5A, 0xC3, 0x96, 0x3C):
        b.u(8, v)
    b.trailing()
    return hw.nal_unit(nal_type, 3, b.data())


BASE = dict(mb_w=4, mb_h=3, frames=4, profile=100, log2_max_frame_num=4,
            log2_max_poc_lsb=6, nonref_prob=0.0, i_picture_prob=0.0)


def _refused(kind, tmp_path):
    """(file, frames before the refused picture) of a refused kind."""
    cfg = dict(BASE)
    extra = None
    if kind == "b_slice":
        cfg.update(b_slice_at=2, cabac=True)
    elif kind == "field_pair":
        cfg.update(field_at=2)
    elif kind == "left_crop":
        cfg.update(crop=(1, 0, 0, 0))
    elif kind == "ycgco_matrix":
        cfg.update(full_range=True, matrix=8)
    elif kind == "output_reordered":
        cfg.update(poc_back_at=3, frames=6)
    elif kind == "damaged":
        cfg.update(mb_w=8, mb_h=6, cabac=True, skip_prob=0.0)
    stream = hw.make(hw.Config(**cfg), 11)
    aus = stream.access_units
    k = {"b_slice": 2, "field_pair": 2, "output_reordered": 3}.get(kind, 0)
    if kind == "chroma_422":
        extra = [_sps(1, 122, chroma=2), _pps(1, 1), _slice(1)]
    elif kind == "bit_depth_10":
        extra = [_sps(1, 110, depth=2), _pps(1, 1), _slice(1)]
    elif kind == "lossless":
        extra = [_sps(1, 244, lossless=1), _pps(1, 1), _slice(1)]
    elif kind == "slice_groups":
        extra = [_sps(1), _pps(1, 1, groups=2), _slice(1)]
    elif kind == "sp_slice":
        extra = [_slice(0, slice_type=3, nal_type=1, frame_num=3)]
    elif kind == "data_partitioning":
        extra = [hw.nal_unit(2, 3, bytes([0x88, 0x84, 0x21, 0x80]))]
    if extra:
        aus.append(extra)
        k = len(aus) - 1
    if kind == "frame_num_gap":
        del aus[2]
        k = 2
    elif kind == "no_idr_start":
        del aus[0]
    path = tmp_path / "r.mp4"
    if kind in ("damaged", "two_pictures_in_a_chunk"):
        path = tmp_path / "r.avi"
        if kind == "two_pictures_in_a_chunk":
            aus[1:3] = [aus[1] + aus[2]]
            k = 1
        hw.write_avi(path, stream)
        if kind == "damaged":
            data = path.read_bytes()
            last = data.rindex(b"00dc", 0, data.rindex(b"idx1"))
            size = int.from_bytes(data[last + 4:last + 8], "little")
            path.write_bytes(data[:last + 8 + size // 2])
            k = len(aus) - 1
        return path, k
    hw.write_mp4(path, stream, 4, edits=[(40, 0), (40, 0)]
                 if kind == "edit_list" else None)
    if kind == "nal_length_overflow":
        # the last sample's first NAL length field past 2^31
        data = bytearray(path.read_bytes())
        at = data.find(b"mdat") + 4 + sum(
            len(x) for x in hw.samples(stream, 4)[:-1])
        data[at:at + 4] = b"\xff\xff\xff\xf0"
        path.write_bytes(bytes(data))
        k = len(aus) - 1
    return path, k


REFUSED = ["b_slice", "field_pair", "left_crop", "ycgco_matrix",
           "chroma_422", "bit_depth_10", "lossless", "slice_groups",
           "sp_slice", "data_partitioning", "frame_num_gap", "no_idr_start",
           "damaged", "two_pictures_in_a_chunk", "edit_list",
           "nal_length_overflow", "output_reordered"]


@pytest.mark.parametrize("kind", REFUSED)
def test_refused_kinds_raise_after_the_frames_before(tmp_path, kind):
    """What the port does not decode raises naming ROADMAP Q1.13b, from
    the headers of the refused picture (or, damaged, its data), after the
    frames before it, which are cv2's."""
    path, k = _refused(kind, tmp_path)
    got, err = port_frames(path)
    assert isinstance(err, video_io.VideoUnsupported)
    assert "Q1.13b" in str(err)
    assert len(got) == k
    want = cv2_frames(path)
    assert len(want) >= k
    assert_frames_equal(got, want[:k])
    with pytest.raises(NotImplementedError, match="Q1.13b"):
        list(LoadImages(str(path), IMG))


# --------------------------------------------- out-of-range ue(v) values

HUGE = 0xFFFFFFE0      # a 63-bit Exp-Golomb code, negative as an int32

OUT_OF_RANGE = {
    "sps_id": lambda: _sps(HUGE),
    "pps_id": lambda: _pps(HUGE, 0),
    "pps_sps_id": lambda: _pps(1, HUGE),
    "crop_left": lambda: _sps(0, crop=(HUGE, 0, 0, 0)),
    "crop_right": lambda: _sps(0, crop=(0, HUGE, 0, 0)),
    "crop_top": lambda: _sps(0, crop=(0, 0, HUGE, 0)),
    "crop_bottom": lambda: _sps(0, crop=(0, 0, 0, HUGE)),
    "slice_pps_id": lambda: _slice(HUGE, nal_type=1, frame_num=2),
}


@pytest.mark.parametrize("kind", sorted(OUT_OF_RANGE))
def test_out_of_range_ue_values_are_refused(tmp_path, kind):
    """A parameter set whose id or crop is out of range is dropped, as
    FFmpeg drops it, and the stream decodes on as cv2 decodes it; a slice
    naming such a PPS raises naming Q1.13b after the frames before it."""
    stream = hw.make(hw.Config(**BASE), 11)
    aus = stream.access_units
    if kind == "slice_pps_id":
        aus[2] = [OUT_OF_RANGE[kind]()]
    else:
        aus[2] = [OUT_OF_RANGE[kind]()] + aus[2]
    path = tmp_path / "o.mp4"
    hw.write_mp4(path, stream, 4)
    got, err = port_frames(path)
    want = cv2_frames(path)
    if kind == "slice_pps_id":
        assert isinstance(err, video_io.VideoUnsupported)
        assert "Q1.13b" in str(err)
        assert len(got) == 2
        assert_frames_equal(got, want[:2])
    else:
        assert err is None
        assert len(want) == BASE["frames"]
        assert_frames_equal(got, want)

"""Write the video fixtures the port's reader is held against
(`tests/video_fixtures/`), with cv2's per-frame SHA-256 digests beside them.

    python scripts/make_video_fixtures.py [--out DIR]

Every clip shows the same seeded scene of smooth moving shapes. The main
ones are cv2.VideoWriter's own files, the writers cv2 5.0 has: `mp4v`
(MPEG-4 Part 2 in MP4, 1280x720, 48 frames), `XVID` and `MJPG` (AVI,
320x240), one MP4 whose track header carries a 90-degree display matrix
(cv2 rotates its frames), and the XVID and MJPG clips cut short inside a
frame. Two more exercise what cv2's writer never sets (4MV, resync markers
with adaptive quantisation; MPEG quantisation) and two what the port
refuses (B-VOPs, quarter-pel): their packets come from the libavcodec
inside cv2's wheel, called through ctypes, in a plain AVI written here.

The H.264 clips come from `tests/h264_writer.py`, a seeded syntax writer
(this host's libavcodec has no H.264 encoder): a 1920x1080 High-profile
CABAC clip coded as 1088 rows and cropped as cameras write it, a Baseline
CAVLC clip in AVI (several slices, constrained intra prediction, POC type
2), a Main-profile CABAC clip with four references, list modification,
long-term references, explicit weights and deblocking offsets, a High
CAVLC clip with SPS and PPS scaling lists and both chroma QP offsets, a
full-range BT.709 clip with its parameter sets in band (avc3), and three
the port refuses (a B slice, a field pair, a left crop cv2 rescales).

`digests.json` maps each file to cv2.VideoCapture's frame count, shape and
per-frame digests (of the BGR bytes), and, for the refused ones, the
ROADMAP item the port's NotImplementedError names. Needs cv2 (5.0.0 made
the committed files); the port's tests and chip_smoke.py read only the
committed copies.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import struct
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "video_fixtures"
FPS = 25


def scene(w: int, h: int, n: int, seed: int):
    """n BGR frames: a colour ramp that drifts, and six discs that move."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    shapes = [(rng.uniform(0, w), rng.uniform(0, h), rng.uniform(-9, 9),
               rng.uniform(-7, 7), rng.uniform(0.05, 0.22) * min(w, h),
               rng.integers(0, 256, 3)) for _ in range(6)]
    for t in range(n):
        img = np.stack([xx / w * 180 + 40 + 20 * np.sin(t / 7 + xx / 53),
                        yy / h * 160 + 50,
                        (xx + yy) / (w + h) * 200 + 30], -1)
        for x0, y0, vx, vy, r, c in shapes:
            cx, cy = (x0 + vx * t) % w, (y0 + vy * t) % h
            img[((xx - cx) ** 2 + (yy - cy) ** 2) < r * r] = c
        yield np.clip(img, 0, 255).astype(np.uint8)


def write_cv2(cv2, path: Path, fourcc: str, w: int, h: int, n: int,
              seed: int):
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), FPS,
                         (w, h))
    for img in scene(w, h, n, seed):
        vw.write(img)
    vw.release()


def rotate_mp4(path: Path, matrix) -> None:
    """Set the first track header's display matrix in place."""
    data = bytearray(path.read_bytes())
    at = data.find(b"tkhd")
    version = data[at + 4]
    p = at + 8 + (32 if version else 20) + 16
    struct.pack_into(">9i", data, p, *matrix)
    path.write_bytes(bytes(data))


def cut_inside_frame(path: Path, out: Path, frame: int, frac: float):
    """`path` cut `frac` of the way into the chunk of `frame`."""
    data = path.read_bytes()
    at = data.find(b"movi") + 4
    k = 0
    while True:
        cid, size = struct.unpack_from("<4sI", data, at)
        if cid[2:] in (b"dc", b"db"):
            if k == frame:
                out.write_bytes(data[:at + 8 + int(size * frac)])
                return
            k += 1
        at += 8 + size + (size & 1)


# ------------------------------------------------ libavcodec through ctypes

class _Lavc:
    """The mpeg4 encoder of the libavcodec in cv2's wheel."""

    def __init__(self, cv2):
        libs = Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs"

        def load(stem):
            return ctypes.CDLL(str(next(libs.glob(stem + "-*"))),
                               mode=ctypes.RTLD_GLOBAL)

        self.avu = load("libavutil")
        load("libswresample")
        self.avc = load("libavcodec")
        P = ctypes.c_void_p
        self.avc.avcodec_find_encoder_by_name.restype = P
        self.avc.avcodec_find_encoder_by_name.argtypes = [ctypes.c_char_p]
        self.avc.avcodec_alloc_context3.restype = P
        self.avc.avcodec_alloc_context3.argtypes = [P]
        self.avc.avcodec_open2.argtypes = [P, P, P]
        self.avc.av_packet_alloc.restype = P
        self.avc.avcodec_send_frame.argtypes = [P, P]
        self.avc.avcodec_receive_packet.argtypes = [P, P]
        self.avc.av_packet_unref.argtypes = [P]
        self.avu.av_frame_alloc.restype = P
        self.avu.av_frame_get_buffer.argtypes = [P, ctypes.c_int]
        self.avu.av_opt_set.argtypes = [P, ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_int]

    def encode(self, cv2, w, h, n, seed, options):
        """The packets of n frames of the scene; AVFrame / AVPacket fields
        are read at libavutil 60 / libavcodec 62's offsets."""
        P = ctypes.c_void_p
        codec = self.avc.avcodec_find_encoder_by_name(b"mpeg4")
        ctx = self.avc.avcodec_alloc_context3(codec)
        opts = [("video_size", f"{w}x{h}"), ("pixel_format", "yuv420p"),
                ("time_base", f"1/{FPS}"), *options.items()]
        for k, v in opts:
            if self.avu.av_opt_set(ctx, k.encode(), str(v).encode(), 1):
                raise SystemExit(f"libavcodec refuses {k}={v}")
        if self.avc.avcodec_open2(ctx, codec, None):
            raise SystemExit("cannot open the mpeg4 encoder")
        pkt = self.avc.av_packet_alloc()
        out = []

        def drain():
            while self.avc.avcodec_receive_packet(ctx, pkt) == 0:
                data = ctypes.cast(pkt + 24, ctypes.POINTER(P))[0]
                size = ctypes.cast(pkt + 32, ctypes.POINTER(ctypes.c_int))[0]
                out.append(ctypes.string_at(data, size))
                self.avc.av_packet_unref(pkt)

        for t, bgr in enumerate(scene(w, h, n, seed)):
            yuv = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420)
            planes = (yuv[:h], yuv[h:h + h // 4].reshape(h // 2, w // 2),
                      yuv[h + h // 4:].reshape(h // 2, w // 2))
            frame = self.avu.av_frame_alloc()
            ints = ctypes.cast(frame + 104, ctypes.POINTER(ctypes.c_int))
            ints[0], ints[1], ints[3] = w, h, 0          # yuv420p
            ctypes.cast(frame + 136, ctypes.POINTER(ctypes.c_int64))[0] = t
            if self.avu.av_frame_get_buffer(frame, 0):
                raise SystemExit("av_frame_get_buffer failed")
            data = ctypes.cast(frame, ctypes.POINTER(P))
            stride = ctypes.cast(frame + 64, ctypes.POINTER(ctypes.c_int))
            for k, plane in enumerate(planes):
                plane = np.ascontiguousarray(plane)
                for r in range(plane.shape[0]):
                    ctypes.memmove(data[k] + r * stride[k],
                                   plane[r].ctypes.data, plane.shape[1])
            self.avc.avcodec_send_frame(ctx, frame)
            drain()
        self.avc.avcodec_send_frame(ctx, None)
        drain()
        return out


def write_avi(path: Path, packets, w: int, h: int, fourcc=b"FMP4"):
    """A plain AVI of one video stream: hdrl, movi of 00dc chunks, idx1."""
    def chunk(cid, data):
        return cid + struct.pack("<I", len(data)) + data + b"\0" * (
            len(data) & 1)

    def lst(kind, data):
        return chunk(b"LIST", kind + data)

    avih = struct.pack("<14I", 1000000 // FPS, 0, 0, 0x10, len(packets), 0,
                       1, 0, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIII4H", b"vids", fourcc, 0, 0, 0, 0, 1,
                       FPS, 0, len(packets), 0, 0xFFFFFFFF, 0, 0, 0, w, h)
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


# ------------------------------------------------------------------ main

# name: (writer, arguments); "lavc" entries give the encoder's options
CLIPS = {
    "mp4v_1280x720.mp4": ("cv2", "mp4v", 1280, 720, 48),
    "xvid_320x240.avi": ("cv2", "XVID", 320, 240, 30),
    "mjpg_320x240.avi": ("cv2", "MJPG", 320, 240, 30),
    "mp4v_rot90.mp4": ("cv2", "mp4v", 160, 120, 12),
    "xvid_cut.avi": ("cut", "xvid_320x240.avi", 17, 0.6),
    "mjpg_cut.avi": ("cut", "mjpg_320x240.avi", 21, 0.45),
    "fmp4_mv4_resync.avi": ("lavc", 176, 144, 20,
                            {"flags": "+mv4", "ps": 300, "g": 15, "bf": 0,
                             "b": "100k"}),
    "fmp4_mpeg_quant.avi": ("lavc", 176, 144, 20,
                            {"mpeg_quant": 1, "g": 12, "bf": 0}),
    "fmp4_bframes.avi": ("lavc", 64, 48, 6, {"bf": 2, "g": 12}),
    "fmp4_qpel.avi": ("lavc", 64, 48, 6, {"flags": "+qpel", "bf": 0}),
}

def _h264(**kw):
    import h264_writer as hw
    return hw.Config(**kw)


# name: (seed, NAL length size (0: Annex B in AVI), sample entry, config)
H264_CLIPS = {
    # the scene painted (DC-predicted I_8x8) and panned 2.5 px right and
    # 1 down per frame, 3% of the P macroblocks random syntax (the 8x8
    # transform, every partition): pictures a detector finds objects in
    "h264_high_cabac_1080p.mp4": (1, 4, b"avc1", dict(
        mb_w=120, mb_h=68, frames=24, cabac=True, profile=100,
        transform_8x8=True, crop=(0, 0, 0, 4), i_slice_prob=0.0,
        max_slices=4, num_ref_frames=2, deblocking_control=True,
        deblock_idcs=(0, 0, 2), nonref_prob=0.1, i_picture_prob=0.0,
        paint="scene", pan=(10, 4), skip_prob=0.97, coef_density=0.3,
        intra_in_p=0.1, pcm_prob=0.002, mv_range=16, far_mv_prob=0.01)),
    "h264_baseline_cavlc.avi": (2, 0, None, dict(
        mb_w=20, mb_h=15, frames=20, cabac=False, profile=66, poc_type=2,
        max_slices=4, constrained_intra=True, qp=(20, 36), skip_prob=0.6,
        coef_density=0.25, intra_in_p=0.1, num_ref_frames=1,
        deblocking_control=True)),
    "h264_main_cabac_refs.mp4": (3, 2, b"avc1", dict(
        mb_w=22, mb_h=18, frames=16, cabac=True, profile=77, poc_type=1,
        num_ref_frames=4, reorder=True, long_term=True, mmco=True,
        weighted_pred=True, deblocking_control=True,
        deblock_idcs=(0, 2, 2, 1), qp=(22, 36), skip_prob=0.6,
        coef_density=0.2, max_slices=3)),
    "h264_high_scaling_crop.mp4": (4, 4, b"avc1", dict(
        mb_w=11, mb_h=9, frames=12, cabac=False, profile=100,
        transform_8x8=True, sps_scaling=True, pps_scaling=True,
        pps_count=2, chroma_qp_offset=-2, second_chroma_qp_offset=3,
        crop=(32, 1, 1, 3), qp=(16, 40), coef_density=0.35,
        deblocking_control=True, num_ref_frames=2)),
    "h264_fullrange_bt709.mp4": (5, 1, b"avc3", dict(
        mb_w=6, mb_h=4, frames=8, cabac=True, profile=100,
        transform_8x8=True, full_range=True, matrix=1, inband=True,
        max_slices=4, coef_density=0.15, bitstream_restriction=True)),
    "h264_bframes.mp4": (6, 4, b"avc1", dict(
        mb_w=8, mb_h=6, frames=6, cabac=True, profile=100,
        transform_8x8=True, b_slice_at=4)),
    "h264_interlaced.mp4": (7, 4, b"avc1", dict(
        mb_w=8, mb_h=6, frames=5, cabac=False, profile=77, field_at=3)),
    "h264_left_crop.mp4": (8, 4, b"avc1", dict(
        mb_w=4, mb_h=3, frames=3, cabac=False, profile=66,
        crop=(3, 0, 0, 0))),
}
REFUSED = {"fmp4_bframes.avi": "ROADMAP Q1.13c",
           "fmp4_qpel.avi": "ROADMAP Q1.13c",
           "h264_bframes.mp4": "ROADMAP Q1.13b",
           "h264_interlaced.mp4": "ROADMAP Q1.13b",
           "h264_left_crop.mp4": "ROADMAP Q1.13b"}


def painted(mb_w: int, mb_h: int, seed: int):
    """The scene's first frame at the coded size as the writer's paint
    targets: Y per 8x8, U and V per chroma 4x4 (BT.601 limited), with
    seeded noise: chip_smoke's serving checkpoint is calibrated on noisy
    images, and finds about as many candidates here as there at this
    noise (none on the clean mosaic)."""
    import cv2

    w, h = 16 * mb_w, 16 * mb_h
    yuv = cv2.cvtColor(next(scene(w, h, 1, seed)), cv2.COLOR_BGR2YUV_I420)
    y = yuv[:h].reshape(2 * mb_h, 8, 2 * mb_w, 8).mean((1, 3))
    u = yuv[h:h + h // 4].reshape(2 * mb_h, 4, 2 * mb_w, 4).mean((1, 3))
    v = yuv[h + h // 4:].reshape(2 * mb_h, 4, 2 * mb_w, 4).mean((1, 3))
    rng = np.random.default_rng(seed)
    y = y + rng.normal(0, 24, y.shape)
    u, v = (p + rng.normal(0, 3, p.shape) for p in (u, v))
    return tuple(np.clip(np.rint(p), 0, 255).astype(int).tolist()
                 for p in (y, u, v))


def write_h264(path: Path, seed: int, length: int, entry, config: dict):
    """A writer stream as MP4 (avc1 / avc3, NAL lengths of `length` bytes)
    or, for length 0, Annex B chunks in AVI; a draw with a NAL unit too
    long for its length field is drawn again."""
    sys.path.insert(0, str(ROOT / "tests"))
    import h264_writer as hw

    config = dict(config)
    if config.get("paint") == "scene":
        config["paint"] = painted(config["mb_w"], config["mb_h"], seed)
    for k in range(20):
        stream = hw.make(hw.Config(**config), seed * 100 + k)
        if not length:
            hw.write_avi(path, stream)
            return
        if all(len(n) < (1 << (8 * length)) for au in stream.access_units
               for n in au + stream.sps + stream.pps):
            hw.write_mp4(path, stream, length, entry)
            return
    raise SystemExit(f"{path.name}: no draw fits {length}-byte lengths")
ROT90 = (0, 65536, 0, -65536, 0, 0, 0, 0, 1 << 30)


def cv2_frames(cv2, path: Path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while cap.isOpened():
        ok, img = cap.read()
        if not ok:
            break
        out.append(img)
    cap.release()
    return out


def digests(cv2, out: Path) -> dict:
    table = {}
    for name in [*CLIPS, *H264_CLIPS]:
        frames = cv2_frames(cv2, out / name)
        entry = {"frames": len(frames),
                 "shape": list(frames[0].shape) if frames else None,
                 "sha256": [hashlib.sha256(f.tobytes()).hexdigest()
                            for f in frames]}
        if name in REFUSED:
            entry["refused"] = REFUSED[name]
        table[name] = entry
    return table


def main():
    import cv2

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    out = args.out
    out.mkdir(parents=True, exist_ok=True)
    lavc = None
    for name, (seed, length, entry, config) in H264_CLIPS.items():
        write_h264(out / name, seed, length, entry, config)
    for seed, (name, spec) in enumerate(CLIPS.items()):
        path = out / name
        if spec[0] == "cv2":
            _, fourcc, w, h, n = spec
            write_cv2(cv2, path, fourcc, w, h, n, seed)
            if "rot90" in name:
                rotate_mp4(path, ROT90)
        elif spec[0] == "cut":
            _, src, frame, frac = spec
            cut_inside_frame(out / src, path, frame, frac)
        else:
            _, w, h, n, options = spec
            lavc = lavc or _Lavc(cv2)
            write_avi(path, lavc.encode(cv2, w, h, n, seed, options), w, h)
    table = digests(cv2, out)
    (out / "digests.json").write_text(json.dumps(table, indent=1) + "\n")
    total = sum(p.stat().st_size for p in out.iterdir())
    for name, entry in table.items():
        print(f"{name}: {entry['frames']} frames {entry['shape']} "
              f"{(out / name).stat().st_size} bytes")
    print(f"{total} bytes in {out}")


if __name__ == "__main__":
    main()

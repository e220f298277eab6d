"""The port's video reader (`data/video_io.py` over the loader core's
`csrc/mpeg4_decode.h`, `csrc/mjpeg_decode.h` and `csrc/video_dsp.h`)
against cv2.VideoCapture, through JAX's `LoadImages` (which reads video
with it), and cli.detect on a clip against JAX's detect.py.

Clips are written at test time by cv2.VideoWriter (the writers cv2 5.0 has:
`mp4v` in MP4 / MOV / M4V, `XVID`, `DIVX`, `FMP4` and `MJPG` in AVI) from a
seeded scene, then changed as files in the wild are: the track header's
display matrix set to 90 / 180 / 270 degrees, `moov` moved before `mdat`,
the file cut short inside a frame (at seeded points), `moov` never written.
The committed fixtures of `tests/video_fixtures/` (made by
`scripts/make_video_fixtures.py`, with cv2's per-frame digests) add what
cv2's writer never sets: 4MV with resync markers, MPEG quantisation, two
MPEG-4 streams the port refuses (B-VOPs, quarter-pel), and the H.264
clips of `tests/h264_writer.py` (five decoded, three refused; cli.detect
runs on the 1080p one). `tests/test_torch_h264.py` holds the H.264
decoder to cv2 on writer streams.

Tolerance: every frame bit-equal, the same count, the same "#idx" paths;
an unreadable file yields nothing in both; a codec or tool the port does
not decode raises NotImplementedError naming its ROADMAP item. cli.detect
with --nosave --save-txt prints the same lines and writes the same label
file as JAX's detect.py (run in float32, as the port computes on the CPU);
without --nosave both stop at the first frame, whose canvas no image
writer takes; with class names in Chinese the annotated canvases are
equal whole."""

import hashlib
import importlib.util
import json
import struct
import sys
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.configs import get_cfg as jax_get_cfg
from efficientteacher_tpu.data.loaders import LoadImages as JaxLoadImages
from efficientteacher_tpu.utils.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from efficientteacher_torch.cli import detect as cli_detect
from efficientteacher_torch.data import video_io
from efficientteacher_torch.data.loaders import LoadImages
from efficientteacher_torch.utils.checkpoint import (module_variables,
                                                     save_checkpoint)

from torch_port_helpers import jax_and_port_models, to_jax_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "video_fixtures"
SUP_YAML = REPO / "configs/sup/public/yolov5l_coco.yaml"
IMG = 64
sys.path.insert(0, str(REPO / "scripts"))
import make_video_fixtures as mvf  # noqa: E402


def write_clip(path: Path, fourcc: str, w: int, h: int, n: int, seed=0):
    mvf.write_cv2(cv2, path, fourcc, w, h, n, seed)
    return path


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


def assert_frames_equal(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"frame {k}")


def assert_loaders_equal(source):
    got = list(LoadImages(str(source), IMG))
    want = list(JaxLoadImages(str(source), IMG))
    assert [p for p, *_ in got] == [p for p, *_ in want]
    for (p, rgb, img0, rp), (_, jrgb, jimg0, jrp) in zip(got, want):
        np.testing.assert_array_equal(img0, jimg0, err_msg=p)
        np.testing.assert_array_equal(rgb, jrgb, err_msg=p)
        assert rp == jrp
    return got


@pytest.mark.parametrize("fourcc, ext, w, h, n", [
    ("mp4v", "mp4", 64, 48, 12), ("mp4v", "mov", 98, 62, 10),
    ("mp4v", "m4v", 160, 120, 14), ("XVID", "avi", 96, 64, 12),
    ("DIVX", "avi", 66, 50, 10), ("FMP4", "avi", 130, 98, 10),
    ("MJPG", "avi", 64, 48, 10), ("MJPG", "avi", 98, 62, 8),
    ("mp4v", "mp4", 97, 61, 30)])
def test_written_clips_equal_jax(tmp_path, fourcc, ext, w, h, n):
    """cv2.VideoWriter's clips read as JAX's LoadImages reads them (odd
    sizes are written even by cv2), frame by frame with "#idx" paths."""
    clip = write_clip(tmp_path / f"clip.{ext}", fourcc, w, h, n, seed=n)
    got = assert_loaders_equal(clip)
    assert len(got) == n
    assert got[-1][0] == f"{clip}#{n - 1}"


def _patch_matrix(path: Path, degrees: int) -> None:
    c, s = {90: (0, 1), 180: (-1, 0), 270: (0, -1)}[degrees]
    mvf.rotate_mp4(path, (c * 65536, s * 65536, 0, -s * 65536, c * 65536,
                          0, 0, 0, 1 << 30))


@pytest.mark.parametrize("degrees", [90, 180, 270])
def test_display_matrix_rotates_as_cv2(tmp_path, degrees):
    clip = write_clip(tmp_path / "rot.mp4", "mp4v", 80, 48, 6, seed=degrees)
    _patch_matrix(clip, degrees)
    got = assert_loaders_equal(clip)
    assert got[0][2].shape[:2] == ((80, 48) if degrees != 180 else (48, 80))


def _boxes(data: bytes):
    at, out = 0, {}
    while at < len(data):
        size, kind = struct.unpack_from(">I4s", data, at)
        out[kind] = (at, size)
        at += size
    return out


def test_moov_first_and_last(tmp_path):
    """cv2's MP4 has `moov` after `mdat`; a faststart file has it first
    (the chunk offsets moved with it). Both read alike."""
    clip = write_clip(tmp_path / "last.mp4", "mp4v", 96, 64, 10, seed=3)
    data = clip.read_bytes()
    boxes = _boxes(data)
    (ma, ms), (da, _) = boxes[b"moov"], boxes[b"mdat"]
    moov = bytearray(data[ma:ma + ms])
    k = moov.find(b"stco")
    for j in range(struct.unpack_from(">I", moov, k + 8)[0]):
        off = struct.unpack_from(">I", moov, k + 12 + 4 * j)[0]
        struct.pack_into(">I", moov, k + 12 + 4 * j, off + ms)
    first = tmp_path / "first.mp4"
    first.write_bytes(data[:da] + bytes(moov) + data[da:ma] +
                      data[ma + ms:])
    want = cv2_frames(clip)
    assert_frames_equal(list(video_io.frames(str(first))), want)
    assert_frames_equal(list(video_io.frames(str(clip))), want)
    assert_loaders_equal(first)


@pytest.mark.parametrize("fourcc", ["XVID", "MJPG"])
def test_avi_cut_inside_frames_equals_jax(tmp_path, fourcc):
    """An AVI cut at seeded points, most inside a frame: the frames cv2
    gives, the last one concealed as FFmpeg conceals it (MPEG-4: error
    resilience; MJPEG: what was decoded before the data ran out), and no
    more."""
    clip = write_clip(tmp_path / "full.avi", fourcc, 128, 96, 16, seed=4)
    data = clip.read_bytes()
    rng = np.random.default_rng(sum(map(ord, fourcc)))
    cut = tmp_path / "cut.avi"
    for at in sorted(int(v) for v in rng.integers(len(data) // 3,
                                                  len(data), 12)):
        cut.write_bytes(data[:at])
        assert_frames_equal(list(video_io.frames(str(cut))),
                            cv2_frames(cut))
    assert_loaders_equal(cut)


def test_mpeg4_packet_ends_in_its_header(tmp_path):
    """A last packet cut inside its VOP header: FFmpeg takes it for a VOP
    not coded and gives the last picture again at the end of the stream;
    cut a little later it fails and cv2 stops."""
    clip = write_clip(tmp_path / "full.avi", "XVID", 96, 64, 8, seed=5)
    data = clip.read_bytes()
    stream = video_io.open_stream(str(clip))
    off, _ = stream.packets[5]
    cut = tmp_path / "cut.avi"
    for extra in (4, 5, 6, 8, 12):
        cut.write_bytes(data[:off + extra])
        assert_frames_equal(list(video_io.frames(str(cut))),
                            cv2_frames(cut))


def test_unreadable_files_yield_nothing(tmp_path):
    """What cv2 opens nothing of yields nothing in both loaders: an MP4
    whose `moov` never came, bytes of no container, an empty file, a
    missing one."""
    clip = write_clip(tmp_path / "c.mp4", "mp4v", 64, 48, 5)
    data = clip.read_bytes()
    (tmp_path / "nomoov.mp4").write_bytes(data[:_boxes(data)[b"moov"][0]])
    (tmp_path / "junk.avi").write_bytes(
        np.random.default_rng(0).integers(0, 256, 4096, np.uint8).tobytes())
    (tmp_path / "empty.mov").write_bytes(b"")
    for name in ("nomoov.mp4", "junk.avi", "empty.mov", "missing.mp4"):
        path = tmp_path / name
        assert cv2_frames(path) == []
        assert list(video_io.frames(str(path))) == []
        if path.exists():
            assert list(LoadImages(str(path), IMG)) == [] == list(
                JaxLoadImages(str(path), IMG))


def test_txt_list_and_source_mix_images_and_clips(tmp_path):
    """A `.txt` list of images and clips, and an `a||b` source: images
    first, then the clips, in JAX's order and with its paths."""
    root = tmp_path / "d"
    root.mkdir()
    imgs = []
    for k, (h, w) in enumerate([(40, 56), (64, 48)]):
        p = root / f"{k}.png"
        cv2.imwrite(str(p), np.random.default_rng(k).integers(
            0, 256, (h, w, 3), np.uint8))
        imgs.append(str(p))
    a = write_clip(root / "a.avi", "MJPG", 64, 48, 4, seed=1)
    b = write_clip(root / "b.mp4", "mp4v", 48, 64, 5, seed=2)
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join([str(b), imgs[0], str(a), imgs[1]]))
    got = assert_loaders_equal(lst)
    assert len(got) == 2 + 4 + 5 and got[2][0] == f"{b}#0"
    assert len(LoadImages(str(lst))) == 4
    assert_loaders_equal(f"{imgs[1]}||{a}")


def _avi_with_fourcc(src: Path, dst: Path, fourcc: bytes) -> None:
    data = src.read_bytes().replace(b"XVID", fourcc)
    dst.write_bytes(data)


def test_unported_codecs_raise(tmp_path):
    """A codec or container cv2 reads and the port does not decode yet
    raises NotImplementedError naming its ROADMAP item, where JAX would
    yield frames: H.264's kinds left for Q1.13b's second half (the refused
    fixtures; tests/test_torch_h264.py has every kind), other codecs,
    MKV, fragmented MP4. An Xvid stream in an AVI tagged H264 is H.264 to
    FFmpeg: its decoder finds no slice in it, and cv2, JAX and the port
    all yield nothing."""
    clip = write_clip(tmp_path / "x.avi", "XVID", 64, 48, 4)
    renamed = tmp_path / "H264.avi"
    _avi_with_fourcc(clip, renamed, b"H264")
    assert cv2_frames(renamed) == []
    assert list(video_io.frames(str(renamed))) == []
    assert_loaders_equal(renamed)
    for name, entry in DIGESTS.items():
        if name.startswith("h264_") and "refused" in entry:
            with pytest.raises(NotImplementedError, match="Q1.13b"):
                list(LoadImages(str(FIXTURES / name), IMG))
    for fourcc, item in [(b"WMV3", "Q1.13d"), (b"DIV3", "Q1.13d")]:
        path = tmp_path / f"{fourcc.decode()}.avi"
        _avi_with_fourcc(clip, path, fourcc)
        with pytest.raises(NotImplementedError, match=item):
            list(video_io.frames(str(path)))
        with pytest.raises(NotImplementedError, match=item):
            list(LoadImages(str(path), IMG))
    mkv = tmp_path / "x.mkv"
    mkv.write_bytes(b"\x1a\x45\xdf\xa3" + bytes(60))
    with pytest.raises(NotImplementedError, match="Q1.13b"):
        list(video_io.frames(str(mkv)))
    mp4 = write_clip(tmp_path / "f.mp4", "mp4v", 64, 48, 3).read_bytes()
    frag = tmp_path / "frag.mp4"
    frag.write_bytes(mp4 + struct.pack(">I4s", 8, b"moof"))
    with pytest.raises(NotImplementedError, match="fragmented.*Q1.13b"):
        list(video_io.frames(str(frag)))


DIGESTS = json.loads((FIXTURES / "digests.json").read_text())


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixtures_equal_cv2_and_their_digests(name):
    """Each committed fixture against cv2.VideoCapture now and against the
    digests cv2 recorded when it was made (what chip_smoke.py checks on
    the card's machine); the refused ones raise."""
    entry = DIGESTS[name]
    path = FIXTURES / name
    want = cv2_frames(path)
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in want] == \
        entry["sha256"]
    if "refused" in entry:
        with pytest.raises(NotImplementedError, match=entry["refused"]):
            list(video_io.frames(str(path)))
        return
    assert_frames_equal(list(video_io.frames(str(path))), want)


# ----------------------------------------------------------- cli.detect

OVERRIDES = ["Model.width_multiple", "0.125", "Model.depth_multiple",
             "0.33", "Dataset.img_size", str(IMG)]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One YOLOv5 at width 0.125 whose objectness and first class biases
    are raised so boxes pass conf 0.25, as a port and a JAX checkpoint."""
    root = tmp_path_factory.mktemp("video_detect")
    cfg = jax_get_cfg()
    cfg.merge_from_file(str(SUP_YAML))
    cfg.merge_from_list(OVERRIDES)
    jm, variables, port = jax_and_port_models(cfg)
    with torch.no_grad():
        for conv in port.head.m:
            conv.bias.view(port.head.na, port.head.no)[:, 4] += 5.0
            conv.bias.view(port.head.na, port.head.no)[:, 5:9] += 5.0
    v = module_variables(port)
    save_checkpoint(root / "w.ckpt", params=v["params"],
                    batch_stats=v["batch_stats"])
    jv = to_jax_variables(port.state_dict(), variables)
    jax_save_checkpoint(root / "w_jax.ckpt", params=jv["params"],
                        batch_stats=jv["batch_stats"])
    clip = write_clip(root / "clip.avi", "XVID", 96, 64, 5, seed=6)
    return root, clip


def _jax_detect(argv):
    spec = importlib.util.spec_from_file_location("jax_detect",
                                                  REPO / "detect.py")
    jax_detect = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_detect)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(sys, "argv", ["detect.py", *argv])
        mp.setattr(jnp, "bfloat16", jnp.float32)   # float32, as the port
        jax_detect.main(jax_detect.parse_opt())
    finally:
        mp.undo()


def _runs(root, clip, tag, flags):
    common = ["--cfg", str(SUP_YAML), "--source", str(clip), "--img-size",
              str(IMG), *flags]
    port = ["--weights", str(root / "w.ckpt"), "--save-dir",
            str(root / f"port_{tag}"), *common, *OVERRIDES, "device", "cpu"]
    jax = ["--weights", str(root / "w_jax.ckpt"), "--save-dir",
           str(root / f"jax_{tag}"), *common, *OVERRIDES]
    return port, jax


def _lines(out: str):
    return [ln for ln in out.splitlines() if ": " in ln and "#" in ln]


def test_detect_on_a_clip_equals_jax(weights, capsys):
    """--nosave --save-txt: the same per-frame lines, and the label file
    of the clip's stem (each frame over the one before) equal."""
    root, clip = weights
    port, jax = _runs(root, clip, "nosave", ["--nosave", "--save-txt"])
    capsys.readouterr()
    out_dir, dets, _ = cli_detect.main(port)
    port_out = capsys.readouterr().out
    _jax_detect(jax)
    jax_out = capsys.readouterr().out
    assert _lines(port_out) == _lines(jax_out)
    assert len(_lines(port_out)) == 5 == len(dets)
    assert sum(len(d) for d in dets.values()) >= 5
    got = out_dir / "clip.txt"
    assert got.read_text() == (root / "jax_nosave" / "exp" /
                               "clip.txt").read_text()
    assert sorted(p.name for p in out_dir.iterdir()) == ["clip.txt"]


def test_detect_on_the_h264_1080p_clip_equals_jax(weights, capsys):
    """The committed 1920x1080 High-profile CABAC clip (coded as 1088 rows,
    cropped): --nosave --save-txt prints JAX's lines, frame by frame, and
    writes its label file."""
    root, _ = weights
    clip = FIXTURES / "h264_high_cabac_1080p.mp4"
    port, jax = _runs(root, clip, "h264", ["--nosave", "--save-txt"])
    capsys.readouterr()
    out_dir, dets, _ = cli_detect.main(port)
    port_out = capsys.readouterr().out
    _jax_detect(jax)
    jax_out = capsys.readouterr().out
    assert _lines(port_out) == _lines(jax_out)
    assert len(_lines(port_out)) == DIGESTS[clip.name]["frames"] == len(dets)
    name = f"{clip.stem}.txt"
    assert (out_dir / name).read_text() == (root / "jax_h264" / "exp" /
                                            name).read_text()


def test_detect_without_nosave_stops_at_the_first_frame(weights, capsys):
    """The canvas of "clip.avi#0" would be written as clip.avi: no image
    writer takes it, in JAX (cv2.imwrite raises) nor in the port
    (NotImplementedError), so both stop after the first frame's line
    (ROADMAP F13)."""
    root, clip = weights
    port, jax = _runs(root, clip, "save", ["--save-txt"])
    capsys.readouterr()
    with pytest.raises(NotImplementedError, match="avi"):
        cli_detect.main(port)
    port_out = capsys.readouterr().out
    with pytest.raises(cv2.error):
        _jax_detect(jax)
    jax_out = capsys.readouterr().out
    assert _lines(port_out) == _lines(jax_out) == [f"{clip}#0: " +
                                                   _lines(jax_out)[0].split(
                                                       ": ", 1)[1]]
    port_dir = root / "port_save" / "exp"
    assert sorted(p.name for p in port_dir.iterdir()) == ["clip.txt"]


CJK_NAMES = ["人", "自行车", "汽车", "摩托车", "飞机", "公共汽车", "火车",
             "卡车", "船", "红绿灯"] + [f"类别{i}" for i in range(10, 80)]


def test_detect_canvas_with_chinese_names_equals_jax(weights, tmp_path):
    """Class names in Chinese (the labels cv2 draws from WenQuanYi Micro
    Hei): the annotated canvases of cli.detect equal JAX's detect.py's
    whole, boxes and label text included."""
    from efficientteacher_torch.data import image_io

    root, _ = weights
    text = SUP_YAML.read_text()
    start = text.index("names: [")
    end = text.index("]", start) + 1
    yaml = tmp_path / "cjk.yaml"
    yaml.write_text(text[:start] + "names: [" + ", ".join(
        f"'{n}'" for n in CJK_NAMES) + "]" + text[end:])
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(8)
    for k, (h, w) in enumerate([(96, 128), (120, 90)]):
        cv2.imwrite(str(imgs / f"{k}.png"),
                    rng.integers(0, 256, (h, w, 3), np.uint8))
    writes = {"port": {}, "jax": {}}
    real_port, real_cv2 = image_io.imwrite, cv2.imwrite
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(image_io, "imwrite", lambda p, img: writes["port"]
                   .__setitem__(Path(p).name, np.array(img)))
        cli_detect.main(["--cfg", str(yaml), "--weights",
                         str(root / "w.ckpt"), "--source", str(imgs),
                         "--save-dir", str(tmp_path / "port"), "--img-size",
                         str(IMG), *OVERRIDES, "device", "cpu"])
        mp.setattr(cv2, "imwrite", lambda p, img: writes["jax"]
                   .__setitem__(Path(p).name, np.array(img)) or True)
        _jax_detect(["--cfg", str(yaml), "--weights",
                     str(root / "w_jax.ckpt"), "--source", str(imgs),
                     "--save-dir", str(tmp_path / "jax"), "--img-size",
                     str(IMG), *OVERRIDES])
    finally:
        mp.undo()
    assert image_io.imwrite is real_port and cv2.imwrite is real_cv2
    assert sorted(writes["port"]) == sorted(writes["jax"]) == ["0.png",
                                                               "1.png"]
    for name, canvas in writes["port"].items():
        np.testing.assert_array_equal(canvas, writes["jax"][name],
                                      err_msg=name)

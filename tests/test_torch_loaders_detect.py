"""The port's serving entry point on the CPU against the JAX package's:
`data/loaders.LoadImages` against JAX's (bit-equal), `cli.detect` against
the root `detect.py` on the same weights and images, and the drawing and
JPEG writing that replace cv2's.

`cli.detect` and JAX's `detect.main` run a YOLOv5 at width 0.125 (the
supervised YAML, nc 80, 128 px) whose objectness and first class biases
are raised so that tens of boxes per image pass conf 0.25, from one fp16
checkpoint of the same weights (a JAX and a port file). JAX's detect
computes in bf16: the test runs it in float32 (`jnp.bfloat16` patched),
as the port computes on the CPU, so the label files compare as text.
The sources are JPEG, PNG and WebP (lossless and lossy). Tolerances: the
.txt and .xml files are equal; the crops handed to the writers are
bit-equal; the .webp canvases read back equal to what was written; the
annotated canvases, label text included, are bit-equal; the port's
quality-95 JPEG of a canvas decodes to a PSNR against it within 0.5 dB of
cv2.imwrite's."""

import importlib.util
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
from efficientteacher_torch.data import image_io
from efficientteacher_torch.data.loaders import LoadImages
from efficientteacher_torch.utils import draw
from efficientteacher_torch.utils.checkpoint import (module_variables,
                                                     save_checkpoint)

from torch_port_helpers import jax_and_port_models, to_jax_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SUP_YAML = REPO / "configs/sup/public/yolov5l_coco.yaml"
IMG = 128
# .webp: cv2.imwrite's lossless default, and VP8 at quality 75 ("webp75")
SIZES = [(96, 128, "jpg"), (128, 80, "png"), (150, 200, "jpg"),
         (64, 64, "png"), (101, 77, "jpg"), (90, 120, "webp"),
         (77, 101, "webp75")]
OVERRIDES = ["Model.width_multiple", "0.125", "Model.depth_multiple",
             "0.33", "Dataset.img_size", str(IMG)]


def _write_images(root: Path, seed=0):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, (h, w, ext) in enumerate(SIZES):
        # smooth colour fields with noise, as photos compress
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * (3 + c) + yy * (2 + c)) % 256
                        for c in range(3)], -1).astype(np.float64)
        img += rng.normal(0, 12, img.shape)
        img = img.clip(0, 255).astype(np.uint8)
        p = root / f"{i:04d}.{ext[:4]}"
        cv2.imwrite(str(p), img, [cv2.IMWRITE_WEBP_QUALITY, 75]
                    if ext == "webp75" else [])
        paths.append(str(p))
    return paths


def test_load_images_bit_equal_to_jax(tmp_path):
    paths = _write_images(tmp_path / "imgs")
    (tmp_path / "list.txt").write_text("\n".join(paths[::-1]))
    for source in (str(tmp_path / "imgs"), str(tmp_path / "list.txt"),
                   str(tmp_path / "imgs" / "*.jpg"), paths[1]):
        got = list(LoadImages(source, IMG))
        want = list(JaxLoadImages(source, IMG))
        assert len(got) == len(want) > 0
        for (p, rgb, img0, rp), (jp, jrgb, jimg0, jrp) in zip(got, want):
            assert p == jp and rp == jrp
            np.testing.assert_array_equal(rgb, jrgb)
            np.testing.assert_array_equal(img0, jimg0)
    # a video path is read as cv2.VideoCapture reads it (video frames are
    # held in tests/test_torch_video.py): bytes it opens nothing of yield
    # nothing in both
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"\0" * 16)
    assert list(LoadImages(str(video))) == [] == list(
        JaxLoadImages(str(video)))
    assert len(LoadImages(str(video))) == 1 == len(JaxLoadImages(str(video)))


@pytest.mark.parametrize("seed", range(3))
def test_boxes_and_points_bit_equal_to_cv2(seed):
    """Thickness-2 rectangles and radius-3 filled circles, clipped at the
    edges, degenerate and reversed corners included."""
    rng = np.random.default_rng(seed)
    for _ in range(400):
        h, w = rng.integers(5, 90, 2)
        want = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        got = want.copy()
        for _ in range(rng.integers(1, 8)):
            xa, xb = (int(v) for v in rng.integers(-4, w + 4, 2))
            ya, yb = (int(v) for v in rng.integers(-4, h + 4, 2))
            color = tuple(int(v) for v in rng.integers(0, 255, 3))
            if rng.random() < 0.6:
                cv2.rectangle(want, (xa, ya), (xb, yb), color, 2)
                draw.rectangle(got, (xa, ya), (xb, yb), color)
            else:
                cv2.circle(want, (xa, ya), 3, color, -1)
                draw.circle(got, (xa, ya), color)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def detect_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("detect")
    paths = _write_images(root / "imgs", seed=1)
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
    flags = ["--img-size", str(IMG), "--save-txt", "--save-crop",
             "--save-xml"]

    writes = {"port": [], "jax": []}
    real = image_io.imwrite

    def port_write(path, img):
        writes["port"].append((Path(path), np.array(img)))
        real(path, img)

    image_io.imwrite = port_write
    try:
        out_dir, dets, _ = cli_detect.main(
            ["--cfg", str(SUP_YAML), "--weights", str(root / "w.ckpt"),
             "--source", str(root / "imgs"), "--save-dir",
             str(root / "port"), *flags, *OVERRIDES, "device", "cpu"])
    finally:
        image_io.imwrite = real

    spec = importlib.util.spec_from_file_location("jax_detect",
                                                  REPO / "detect.py")
    jax_detect = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_detect)
    real_cv2 = cv2.imwrite

    def jax_write(path, img):
        writes["jax"].append((Path(path), np.array(img)))
        return real_cv2(path, img)

    argv = ["detect.py", "--cfg", str(SUP_YAML), "--weights",
            str(root / "w_jax.ckpt"), "--source", str(root / "imgs"),
            "--save-dir", str(root / "jax"), *flags, *OVERRIDES]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(sys, "argv", argv)
        mp.setattr(cv2, "imwrite", jax_write)
        mp.setattr(jnp, "bfloat16", jnp.float32)   # float32, as the port
        jax_detect.main(jax_detect.parse_opt())
    finally:
        mp.undo()
    jax_dir = root / "jax" / "exp"
    return out_dir, jax_dir, dets, writes, list(cfg.Dataset.names)


def test_detect_label_files_equal_jax(detect_run):
    out_dir, jax_dir, dets, _, _ = detect_run
    assert sum(len(d) for d in dets.values()) >= 20
    for suffix in (".txt", ".xml"):
        got = sorted(out_dir.glob(f"*{suffix}"))
        want = sorted(jax_dir.glob(f"*{suffix}"))
        assert [p.name for p in got] == [p.name for p in want]
        assert len(got) == len(SIZES)
        for g, w in zip(got, want):
            assert g.read_text() == w.read_text(), g.name


def test_detect_crops_and_canvases_equal_jax(detect_run):
    out_dir, jax_dir, dets, writes, _ = detect_run
    port = {p.relative_to(out_dir): img for p, img in writes["port"]}
    jax = {p.relative_to(jax_dir): img for p, img in writes["jax"]}
    assert sorted(port) == sorted(jax)
    crops = [k for k in port if k.parts[0] == "crops"]
    assert len(crops) >= 20
    for k in crops:
        np.testing.assert_array_equal(port[k], jax[k])
    labels = 0
    for path, det in dets.items():
        k = Path(Path(path).name)
        np.testing.assert_array_equal(port[k], jax[k])
        labels += len(det)
    assert labels >= 20


def test_detect_webp_canvases_read_back(detect_run):
    """The .webp canvases each detect wrote (the port's own lossless
    writer, cv2.imwrite's default) read back equal to the canvas handed to
    the writer, in cv2 and in the port."""
    _, _, _, writes, _ = detect_run
    n = 0
    for side in ("port", "jax"):
        for path, canvas in writes[side]:
            if path.suffix != ".webp" or path.parent.name == "crops":
                continue
            np.testing.assert_array_equal(cv2.imread(str(path)), canvas)
            np.testing.assert_array_equal(image_io.imread(str(path)),
                                          canvas[..., ::-1])
            n += 1
    assert n == 4


def test_port_jpeg_within_psnr_of_cv2(detect_run, tmp_path):
    """The port's writer at quality 95 against cv2.imwrite's on the same
    annotated canvas, each decoded by cv2."""
    _, _, _, writes, _ = detect_run
    for path, canvas in writes["port"]:
        if path.suffix != ".jpg" or path.parent.name == "crops":
            continue
        ours = cv2.imread(str(path))
        ref = tmp_path / "cv2.jpg"
        cv2.imwrite(str(ref), canvas)
        theirs = cv2.imread(str(ref))

        def psnr(x):
            mse = np.mean((x.astype(np.float64) - canvas) ** 2)
            return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))

        # measured: 0.008-0.016 dB below cv2's (23.6-26.9 dB on these
        # noisy canvases, 4:2:0 in both)
        assert psnr(ours) > psnr(theirs) - 0.5, (psnr(ours), psnr(theirs))


def test_imwrite_png_is_lossless_and_refuses_other_suffixes(tmp_path):
    """.png and .webp (lossless, since ROADMAP Q1.9b) read back equal; a
    suffix that is no image format raises."""
    img = np.random.default_rng(0).integers(0, 255, (17, 23, 3), np.uint8)
    for ext in ("png", "webp"):
        image_io.imwrite(str(tmp_path / f"a.{ext}"), img)
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / f"a.{ext}")),
                                      img)
    with pytest.raises(NotImplementedError):
        image_io.imwrite(str(tmp_path / "a.gif"), img)


def test_detect_without_a_card_raises(detect_run, tmp_path):
    """Without `device cpu` cli.detect asks for the card, and there is
    none here: RuntimeError, not a silent CPU run."""
    out_dir, _, _, _, _ = detect_run
    weights = out_dir.parents[1] / "w.ckpt"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_detect.main(["--cfg", str(SUP_YAML), "--weights", str(weights),
                         "--source", str(out_dir.parents[1] / "imgs"),
                         "--save-dir", str(tmp_path), *OVERRIDES])

"""The port's host augmentation (`efficientteacher_torch/data/augment.py`,
the loader core's pixel operations, `datasets.py` / `datasets_ssod.py`
under augment=True, `QuadBatchLoader`) against the JAX package's cv2
route, and `cli.train` on shipped YAMLs as they are written.

Every function gets the same seeded numpy inputs and the same
`random.Random` state on both sides; the port's images are RGB and the
JAX package's BGR, so each port image is compared with the JAX one's
channels reversed. Tolerances: images byte-equal, boxes and labels within
1e-6, M_s and the draws exact. There is no residue: the rotated, sheared
and perspective warps are bit-equal to cv2 5.0.0 too.

The image size is 100 (not a multiple of 16 or 32), so cv2's vector
blocks and their scalar tails, which round differently, both run."""

import random
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from efficientteacher_tpu.configs import get_cfg as jax_get_cfg
from efficientteacher_tpu.data import augment as jaug
from efficientteacher_tpu.data import datasets as jds
from efficientteacher_tpu.data import datasets_ssod as jss
from efficientteacher_torch.cli import train as cli_train
from efficientteacher_torch.configs import get_cfg
from efficientteacher_torch.data import augment as paug
from efficientteacher_torch.data import autoaugment as pautoaug
from efficientteacher_torch.data import datasets as pds
from efficientteacher_torch.data import datasets_ssod as pss
from efficientteacher_torch.utils import native_loader as nl
from efficientteacher_torch.utils.checkpoint import load_checkpoint
import pixel_op_cases
from test_torch_datasets import write_dataset
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
MAIN_YAML = REPO / "configs/ssod/coco-standard/yolov5l_coco_ssod_10_percent.yaml"
CITY_YAML = REPO / "configs/ssod/cityscapes/yolov5l_cityscapes.yaml"
SUP_YAML = REPO / "configs/sup/public/yolov5s_coco.yaml"
IMG = 100
SIZES = [(75, 100, "jpg"), (100, 64, "png"), (120, 160, "jpg"),
         (50, 70, "png"), (100, 100, "jpg"), (90, 100, "jpg"),
         (64, 100, "png"), (100, 80, "jpg")]


def rgb(bgr):
    return np.ascontiguousarray(bgr[..., ::-1])


def photo(rng, h, w):
    """Seeded noise, half of it blurred, with an asymmetric colour ramp
    (R, G, B differ everywhere), uint8 BGR."""
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    img = cv2.GaussianBlur(img, (5, 5), 2) if rng.random() < 0.5 else img
    ramp = np.stack(np.meshgrid(np.linspace(0, 90, w), np.linspace(0, 60, h)),
                    -1)
    img = img.astype(np.float64)
    img[..., 2] += ramp[..., 0]
    img[..., 1] += ramp[..., 1]
    return np.clip(img, 0, 255).astype(np.uint8)


def boxes(rng, n, w, h, cls_col=True):
    xy = rng.uniform(0, 0.6, (n, 2)) * [w, h]
    wh = rng.uniform(0.1, 0.4, (n, 2)) * [w, h]
    out = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    if cls_col:
        out = np.concatenate([rng.integers(0, 5, (n, 1)).astype(np.float32),
                              out], 1)
    return out


def warp_matrix(rng, kind):
    if kind == "axis":
        s = rng.uniform(0.3, 2.0)
        m = np.array([[s, 0, 0], [0, s, 0.0]])
    elif kind == "rotated":
        m = cv2.getRotationMatrix2D((float(rng.uniform(0, 90)),
                                     float(rng.uniform(0, 90))),
                                    rng.uniform(-45, 45), rng.uniform(0.5, 1.5))
    elif kind == "sheared":
        m = np.array([[1, rng.uniform(-0.3, 0.3), 0],
                      [rng.uniform(-0.3, 0.3), 1, 0]])
    else:
        m = np.eye(3)
        m[:2] = cv2.getRotationMatrix2D((50.0, 50.0), rng.uniform(-30, 30),
                                        rng.uniform(0.5, 1.5))
        m[2, :2] = rng.uniform(-2e-3, 2e-3, 2)
    m[:2, 2] += rng.uniform(-40, 40, 2)
    return m


# -- the loader core's pixel operations against cv2 ---------------------------

@pytest.mark.parametrize("kind", ["axis", "rotated", "sheared",
                                  "perspective"])
def test_warp_is_cv2s(kind):
    rng = np.random.default_rng(["axis", "rotated", "sheared",
                                 "perspective"].index(kind))
    for t in range(24):
        img = photo(rng, int(rng.integers(5, 160)), int(rng.integers(5, 160)))
        m = warp_matrix(rng, kind)
        dsize = (int(rng.integers(1, 180)), int(rng.integers(1, 180)))
        border = (114, 128)[t % 2]
        warp = cv2.warpPerspective if kind == "perspective" \
            else cv2.warpAffine
        want = warp(img, m, dsize, borderValue=(border,) * 3)
        np.testing.assert_array_equal(nl.warp(rgb(img), m, dsize, border),
                                      rgb(want))
        # a float32 matrix, as AutoAugment passes it
        if kind != "perspective":
            m32 = m.astype(np.float32)
            np.testing.assert_array_equal(
                nl.warp(rgb(img), m32, dsize, border),
                rgb(cv2.warpAffine(img, m32, dsize,
                                   borderValue=(border,) * 3)))


def test_warp_reads_a_strided_patch():
    rng = np.random.default_rng(1)
    img = rgb(photo(rng, 80, 90))
    patch = img[10:50, 20:61]
    m = np.float32([[1, 0.2, -3], [0, 1, 0]])
    np.testing.assert_array_equal(
        nl.warp(patch, m, (41, 40), 128),
        cv2.warpAffine(np.ascontiguousarray(patch), m, (41, 40),
                       borderValue=(128,) * 3))


@pytest.mark.parametrize("width", [1, 33, 64])
def test_hsv_round_trip_is_cv2s_on_every_colour(width):
    """Every 8-bit colour (2^20 of them at width 1: cv2's row loop is slow)
    through BGR2HSV, a LUT of random gains and HSV2BGR; widths 1 and 33
    run cv2's scalar tail, 64 its vector blocks only."""
    rng = np.random.default_rng(width)
    colours = np.arange(1 << 24, dtype=np.uint32)
    if width == 1:
        colours = rng.choice(colours, 1 << 20, replace=False)
    colours = colours[:len(colours) // width * width]
    bgr = np.stack([(colours >> s) & 255 for s in (0, 8, 16)], -1) \
        .astype(np.uint8).reshape(-1, width, 3)
    x = np.arange(256.0)
    r = rng.uniform(-1, 1, 3) * [0.015, 0.7, 0.4] + 1
    luts = [((x * r[0]) % 180).astype(np.uint8),
            np.clip(x * r[1], 0, 255).astype(np.uint8),
            np.clip(x * r[2], 0, 255).astype(np.uint8)]
    h, s, v = cv2.split(cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))
    want = cv2.cvtColor(cv2.merge([cv2.LUT(c, t) for c, t in
                                   zip((h, s, v), luts)]), cv2.COLOR_HSV2BGR)
    got = rgb(bgr)
    nl.augment_hsv(got, *luts, blue=2)
    np.testing.assert_array_equal(got, rgb(want))


@pytest.mark.parametrize("width", [37, 64, 100])
def test_augment_hsv_matches_jax_on_an_asymmetric_colour(width):
    rng = np.random.default_rng(width)
    img = photo(rng, 45, width)
    img[:, : width // 2] = (30, 140, 220)  # BGR: orange, not a grey
    want = img.copy()
    got = rgb(img)
    jaug.augment_hsv(want, 0.015, 0.7, 0.4, random.Random(3))
    paug.augment_hsv(got, 0.015, 0.7, 0.4, random.Random(3))
    np.testing.assert_array_equal(got, rgb(want))
    # the order matters: the same formula on the port's channels as they
    # are (blue taken for red) gives another image
    wrong = rgb(img)
    r = np.array([random.Random(3).uniform(-1, 1) for _ in range(3)]) \
        * [0.015, 0.7, 0.4] + 1
    x = np.arange(256.0)
    nl.augment_hsv(wrong, ((x * r[0]) % 180).astype(np.uint8),
                   np.clip(x * r[1], 0, 255).astype(np.uint8),
                   np.clip(x * r[2], 0, 255).astype(np.uint8), blue=0)
    assert (wrong != got).any()


def test_gray_filter_equalize_are_cv2s():
    rng = np.random.default_rng(5)
    k = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
    for h, w in [(2, 2), (3, 7), (41, 33), (100, 100), (64, 97)]:
        img = photo(rng, h, w)
        np.testing.assert_array_equal(
            nl.gray(rgb(img)), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
        np.testing.assert_array_equal(
            nl.filter3x3(rgb(img), [[1, 1, 1], [1, 5, 1], [1, 1, 1]], 13),
            rgb(cv2.filter2D(img, -1, k)))
        for c in range(3):
            ch = img[:, :, c]
            np.testing.assert_array_equal(pautoaug.equalize_hist(ch),
                                          cv2.equalizeHist(ch))
    for ch in [np.full((5, 6), 77, np.uint8),
               np.array([[0, 255], [255, 255]], np.uint8),
               np.array([[3, 3, 3, 200]], np.uint8)]:
        np.testing.assert_array_equal(pautoaug.equalize_hist(ch),
                                      cv2.equalizeHist(ch))


@pytest.mark.parametrize("s", [64, 100])
def test_resize_2s_to_s_and_2x_upscale_are_cv2s(s):
    rng = np.random.default_rng(s)
    big = photo(rng, 2 * s, 2 * s)
    np.testing.assert_array_equal(nl.resize(rgb(big), s, s),
                                  rgb(cv2.resize(big, (s, s))))
    small = photo(rng, s, s)
    np.testing.assert_array_equal(
        nl.resize(rgb(small), 2 * s, 2 * s),
        rgb(cv2.resize(small, (2 * s, 2 * s),
                       interpolation=cv2.INTER_LINEAR)))


def test_pixel_op_digests_are_cv2s_and_the_cores():
    """The recorded digests that chip_smoke.py holds the core to on the
    card's machine: cv2 here gives them, and so does the core."""
    assert pixel_op_cases.cv2_digests(cv2) == pixel_op_cases.DIGESTS
    assert pixel_op_cases.check_core(nl) == []


# -- data/augment.py against the JAX module ------------------------------------

PERSPECTIVE_HYP = {
    "axis": {},
    "rotated": {"degrees": 30.0},
    "sheared": {"shear": 10.0},
    "perspective": {"perspective": 0.001, "degrees": 10.0},
}


@pytest.mark.parametrize("kind", list(PERSPECTIVE_HYP))
@pytest.mark.parametrize("border", [(0, 0), (-25, -25)])
def test_random_perspective_matches_jax(kind, border):
    rng = np.random.default_rng(7)
    hyp = dict(translate=0.1, scale=0.9, **PERSPECTIVE_HYP[kind])
    for seed in range(6):
        img = photo(rng, 100, 100) if border == (0, 0) \
            else photo(rng, 150, 150)
        tg = boxes(rng, 6, img.shape[1], img.shape[0])
        jr, pr = random.Random(seed), random.Random(seed)
        ji, jt, jm, js = jaug.random_perspective(
            img, tg.copy(), border=border, rng=jr, return_M=True, **hyp)
        pi, pt, pm, ps = paug.random_perspective(
            rgb(img), tg.copy(), border=border, rng=pr, return_M=True, **hyp)
        np.testing.assert_array_equal(pi, rgb(ji))
        np.testing.assert_allclose(pt, jt, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(pm, jm)
        assert ps == js and pr.getstate() == jr.getstate()


def test_build_affine_and_box_helpers_match_jax():
    rng = np.random.default_rng(8)
    for seed in range(20):
        hyp = dict(degrees=float(rng.uniform(0, 45)),
                   translate=float(rng.uniform(0, 0.3)),
                   scale=float(rng.uniform(0, 0.9)),
                   shear=float(rng.uniform(0, 10)),
                   perspective=float(rng.uniform(0, 1e-3)))
        jm, js = jaug.build_affine(100, 80, rng=random.Random(seed), **hyp)
        pm, ps = paug.build_affine(100, 80, rng=random.Random(seed), **hyp)
        np.testing.assert_array_equal(pm, jm)
        assert ps == js
        b = boxes(rng, 5, 100, 80, cls_col=False)
        for persp in (False, True):
            np.testing.assert_array_equal(
                paug.warp_boxes(b, pm, 100, 80, persp),
                jaug.warp_boxes(b, jm, 100, 80, persp))
        nb = jaug.warp_boxes(b, jm, 100, 80)
        np.testing.assert_array_equal(paug.box_candidates(b.T * js, nb.T),
                                      jaug.box_candidates(b.T * js, nb.T))
        np.testing.assert_array_equal(paug.bbox_ioa(b[0], b),
                                      jaug.bbox_ioa_np(b[0], b))
    lb = boxes(rng, 4, 100, 80)
    np.testing.assert_array_equal(paug.hflip_labels(lb, 100),
                                  jaug.hflip_labels(lb, 100))
    np.testing.assert_array_equal(paug.vflip_labels(lb, 80),
                                  jaug.vflip_labels(lb, 80))
    for center, angle, scale in [((0, 0), 12.5, 0.7), ((50.0, 37.5), -30, 1.0),
                                 ((33.3, 7.1), 90.0, 1.3)]:
        np.testing.assert_array_equal(
            paug.rotation_matrix(center, angle, scale),
            cv2.getRotationMatrix2D(center, angle, scale))


@pytest.mark.parametrize("which", ["mosaic4", "mosaic9", "mixup",
                                   "copy_paste", "cutout"])
def test_composition_items_match_jax(which):
    rng = np.random.default_rng(9)
    s = 100
    for seed in range(4):
        imgs = [photo(rng, int(rng.integers(40, 101)),
                      int(rng.integers(40, 101))) for _ in range(9)]
        lbs = [boxes(rng, int(rng.integers(0, 4)), im.shape[1], im.shape[0])
               for im in imgs]
        jr, pr = random.Random(seed), random.Random(seed)
        if which in ("mosaic4", "mosaic9"):
            fj, fp = getattr(jaug, which), getattr(paug, which)
            jc, jl = fj(imgs, lbs, s, jr)
            pc, pl = fp([rgb(i) for i in imgs], lbs, s, pr)
        elif which == "mixup":
            a, b = photo(rng, s, s), photo(rng, s, s)
            jc, jl = jaug.mixup(a, lbs[0], b, lbs[1], jr)
            pc, pl = paug.mixup(rgb(a), lbs[0], rgb(b), lbs[1], pr)
        elif which == "copy_paste":
            canvas = photo(rng, 2 * s, 2 * s)
            lb = boxes(rng, 6, 2 * s, 2 * s)
            jc, jl = jaug.copy_paste(canvas.copy(), lb.copy(), 0.7, jr)
            pc, pl = paug.copy_paste(rgb(canvas), lb.copy(), 0.7, pr)
        else:
            canvas = photo(rng, s, s)
            jc, pc = canvas.copy(), rgb(canvas)
            jl = jaug.cutout(jc, lbs[0], jr)
            pl = paug.cutout(pc, lbs[0], pr)
        np.testing.assert_array_equal(pc, rgb(jc))
        np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-6)
        assert pr.getstate() == jr.getstate()


# -- whole items, batches and loaders ------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("hostaug")
    return write_dataset(root, SIZES, seed=11, nc=80, name="train")


def yaml_cfgs(yaml, lst, **kw):
    """The port's and JAX's config of `yaml`, pointed at `lst`, shrunk."""
    out = []
    for get in (get_cfg, jax_get_cfg):
        cfg = get()
        cfg.merge_from_file(str(yaml))
        cfg.merge_from_list([
            "Dataset.train", lst, "Dataset.val", lst, "Dataset.target", lst,
            "Dataset.img_size", IMG, "Dataset.max_targets", 16,
            "Dataset.batch_size", 3, "Dataset.workers", 2])
        for k, v in kw.items():
            cfg.merge_from_list([k, v])
        out.append(cfg)
    return out


LABELLED = {
    "main": {},
    "all": {"hyp.mixup": 0.5, "hyp.copy_paste": 0.5, "hyp.degrees": 10.0,
            "hyp.shear": 5.0, "hyp.perspective": 0.0005, "hyp.flipud": 0.5,
            "hyp.mosaic": 0.6},
    "mosaic9": {},
    "mosaic_closed": {},
}


@pytest.mark.parametrize("variant", list(LABELLED))
def test_labelled_items_match_jax(data, variant):
    """The main YAML's hyp, every option of the route turned on, the
    mosaic-9 draw (the datasets' `mosaic9_prob`), and the mosaic closed as
    the trainers' before_epoch closes it for the last no_aug_epochs (the
    mosaic draw is then skipped, as in JAX)."""
    pc, jc = yaml_cfgs(MAIN_YAML, data, **LABELLED[variant])
    port = pds.create_dataloader(pc, "train", seed=4).ds
    ref = jds.create_dataloader(jc, "train", seed=4).ds
    assert port.augment and port.mosaic and ref.augment
    if variant == "mosaic9":
        port.mosaic9_prob = ref.mosaic9_prob = 0.5
    if variant == "mosaic_closed":
        port.mosaic = ref.mosaic = False
    for i in list(range(len(port))) * 2:
        a, b = port[i], ref[i]
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_allclose(a[1], b[1], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(a[2], b[2])
        assert a[3] == b[3]
    assert port.rng.getstate() == ref.rng.getstate()


@pytest.mark.parametrize("yaml", [MAIN_YAML, CITY_YAML])
def test_target_items_match_jax(data, yaml, monkeypatch):
    """The main YAML's ssod_hyp (no labels on the target: cutout and
    AutoAugment draw but never fire) and the cityscapes one (with_gt:
    both fire)."""
    pc, jc = yaml_cfgs(yaml, data)
    port = pss.create_target_dataloader(pc, seed=5).ds
    ref = jss.create_target_dataloader(jc, seed=5).ds
    fired = []
    distort = pautoaug.distort_image_with_autoaugment
    monkeypatch.setattr(pautoaug, "distort_image_with_autoaugment",
                        lambda *a: fired.append(1) or distort(*a))
    for i in list(range(len(port))) * 3:
        a, b = port[i], ref[i]
        for k in (0, 2, 3, 4):
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
        np.testing.assert_allclose(a[1], b[1], rtol=0, atol=1e-6)
    assert port.rng.getstate() == ref.rng.getstate()
    with_gt = yaml == CITY_YAML
    assert bool(fired) == with_gt


def _images(batch, key="images"):
    t = batch[key]
    return t.numpy() if isinstance(t, torch.Tensor) else t


def test_batches_are_a_function_of_seed_epoch_and_batch(data):
    """The port's thread engine at 4 workers, its fork engine and JAX's
    process engine give the same batches, two epochs running, for the
    labelled and the target loaders."""
    pc, jc = yaml_cfgs(MAIN_YAML, data, **{"Dataset.workers": 4})
    for make, mod in ((lambda c, m: pds.create_dataloader(c, "train",
                                                         seed=2), "l"),
                      (lambda c, m: pss.create_target_dataloader(c, seed=2),
                       "u")):
        runs = {}
        for name, cfg, mode in (("threads", pc, "thread"),
                                ("fork", pc, "process"),
                                ("jax", jc, "process")):
            cfg.Dataset.loader = mode
            loader = make(cfg, mode)
            runs[name] = [list(loader) for _ in range(2)]
        for name in ("fork", "jax"):
            for ea, eb in zip(runs["threads"], runs[name], strict=True):
                assert len(ea) == len(eb) == 2
                for ba, bb in zip(ea, eb, strict=True):
                    keys = ("images", "images_ori") if mod == "u" \
                        else ("images",)
                    for k in keys:
                        np.testing.assert_array_equal(
                            _images(ba, k), _images(bb, k),
                            err_msg=f"{name} {k}")
                    for k in ("labels", "mask") + (("M_s",) if mod == "u"
                                                    else ("shapes",)):
                        a, b = ba[k], bb[k]
                        if isinstance(b, np.ndarray):
                            np.testing.assert_allclose(a, b, rtol=0,
                                                       atol=1e-6)
                        else:
                            assert list(a) == list(b), k
                    assert list(ba["indices"]) == list(bb["indices"])
        # a new epoch draws anew
        assert not np.array_equal(_images(runs["threads"][0][0]),
                                  _images(runs["threads"][1][0]))


def test_quad_loader_matches_jax(data):
    pc, jc = yaml_cfgs(MAIN_YAML, data,
                       **{"Dataset.quad": True, "Dataset.batch_size": 2})
    port = pds.create_dataloader(pc, "train", seed=6)
    ref = jds.create_dataloader(jc, "train", seed=6)
    assert type(port).__name__ == type(ref).__name__ == "QuadBatchLoader"
    for _ in range(3):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_images(a), b["images"])
            assert _images(a).shape == (1, 2 * IMG, 2 * IMG, 3)
            np.testing.assert_allclose(a["labels"], b["labels"], rtol=0,
                                       atol=1e-6)
            np.testing.assert_array_equal(a["mask"], b["mask"])
            assert list(a["indices"]) == list(b["indices"])
    # both collates ran: the per-epoch choices of the three epochs
    single = [random.Random(9 * 104729 + e).random() < 0.5
              for e in range(3) for _ in range(2)]
    assert any(single) and not all(single)


# -- cli.train on shipped YAMLs as written -------------------------------------

SHRINK = ["device", "cpu", "Dataset.img_size", "128",
          "Dataset.batch_size", "2", "Dataset.workers", "2",
          "Model.width_multiple", "0.125", "Model.depth_multiple", "0.33"]


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_host")
    sizes = [(96, 128, "jpg"), (128, 100, "png"), (90, 128, "jpg"),
             (128, 128, "png")]
    return {k: write_dataset(root / k, sizes, seed=i, nc=80, name=k)
            for i, k in enumerate(("train", "target", "val"))}


def _run_cli(yaml, root, data, *extra):
    over = SHRINK + ["project", str(root), "name", "run",
                     "Dataset.train", data["train"], "Dataset.val",
                     data["val"], "Dataset.target", data["target"], *extra]
    best = cli_train.main(["--cfg", str(yaml), *over])
    weights = root / "run" / "weights"
    rows = (root / "run" / "results.csv").read_text().splitlines()
    last = load_checkpoint(weights / "last.ckpt")
    for t in last["model"]["params"].values():
        assert torch.isfinite(t.float()).all()
    return best, rows, last


def test_cli_train_runs_the_main_yaml_as_written(cli_data, tmp_path,
                                                 monkeypatch):
    """No Dataset.device_aug override: the host route, one burn-in and one
    mean-teacher epoch."""
    seen = []
    build = pss.SSODBatchLoader._build_batch
    monkeypatch.setattr(pss.SSODBatchLoader, "_build_batch",
                        lambda self, *a: seen.append(self.ds.augment)
                        or build(self, *a))
    best, rows, last = _run_cli(MAIN_YAML, tmp_path, cli_data, "epochs", "2",
                                "hyp.burn_epochs", "1")
    assert [r.split(",")[0] for r in rows[1:]] == ["0", "1"]
    assert last["meta"]["epoch"] == 1 and "student_ema" in last
    assert seen and all(seen) and best >= 0.0


@pytest.mark.parametrize("quad", [False, True])
def test_cli_train_runs_a_supervised_yaml(cli_data, tmp_path, quad):
    best, rows, last = _run_cli(SUP_YAML, tmp_path, cli_data, "epochs", "1",
                                "Dataset.quad", str(quad))
    assert len(rows) == 2 and last["meta"]["epoch"] == 0 and best >= 0.0

"""The port's cv2-free loaders (`efficientteacher_torch/data/`) against the
JAX package's cv2 loaders on one seeded set of JPEGs and PNGs written
with cv2 at mixed sizes, one smaller than the target (upscaled), one
larger (downscaled), the rest landing exactly on it.

Tolerances: images bit-equal (the loader core's resize is cv2's 8-bit
INTER_LINEAR, upscales included); labels, masks, shapes, ratio_pad and
the batch order exact. Also: the PNG decoder and the JPEG decode are
exact against cv2.imread, the labels cache reloads, and the formats the
port does not read raise when the dataset is built."""

import os
from pathlib import Path

import cv2
import numpy as np
import pytest

from efficientteacher_tpu.configs import get_cfg as jax_get_cfg
from efficientteacher_tpu.data import datasets as jax_ds
from efficientteacher_torch.configs import get_cfg
from efficientteacher_torch.data import datasets as port_ds
from efficientteacher_torch.data import image_io
from efficientteacher_torch.data.augment import letterbox
from efficientteacher_torch.utils import native_loader as nl

IMG = 96
# (h, w, ext): exact fits, an upscale (48 x 64) and a downscale (150 x 200)
SIZES = [(72, 96, "jpg"), (96, 72, "png"), (64, 96, "jpg"), (48, 64, "png"),
         (96, 96, "jpg"), (150, 200, "jpg"), (80, 96, "png"), (96, 60, "jpg"),
         (70, 96, "jpg"), (96, 90, "png")]


def write_dataset(root: Path, sizes=SIZES, seed=0, nc=8, name="train",
                  blur=True):
    """images/ + labels/ + a list file of absolute paths; seeded content
    (noise, blurred to look like a photo to JPEG unless `blur` is False)
    and 0-6 boxes per image. Returns the list."""
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "labels").mkdir(parents=True, exist_ok=True)
    paths = []
    for i, (h, w, ext) in enumerate(sizes):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        if blur:
            img = cv2.GaussianBlur(img, (5, 5), 2)
        p = root / "images" / f"{name}{i}.{ext}"
        if ext == "jpg":
            cv2.imwrite(str(p), img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        else:
            cv2.imwrite(str(p), img)
        n = int(rng.integers(0, 7))
        rows = [f"{rng.integers(0, nc)} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}"
                for cx, cy, bw, bh in rng.uniform(0.1, 0.5, (n, 4))]
        (root / "labels" / f"{name}{i}.txt").write_text("\n".join(rows))
        paths.append(str(p))
    lst = root / f"{name}.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst)


def cfgs(lst, **kw):
    out = []
    for get in (get_cfg, jax_get_cfg):
        cfg = get()
        cfg.Dataset.train = cfg.Dataset.val = lst
        cfg.Dataset.img_size = IMG
        cfg.Dataset.nc = 8
        cfg.Dataset.max_targets = 12
        cfg.Dataset.batch_size = 4
        cfg.Dataset.workers = 2
        cfg.hyp.use_aug = False
        for k, v in kw.items():
            node = cfg
            *path, leaf = k.split(".")
            for p in path:
                node = node[p]
            node[leaf] = v
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("ds"))


def assert_batches_equal(port_batches, jax_batches, keys):
    assert len(port_batches) == len(jax_batches) > 0
    for bp, bj in zip(port_batches, jax_batches):
        np.testing.assert_array_equal(np.asarray(bp["images"]),
                                      bj["images"])
        for k in keys:
            if isinstance(bj[k], np.ndarray):
                np.testing.assert_array_equal(bp[k], bj[k], err_msg=k)
            else:
                assert list(bp[k]) == list(bj[k]), k


@pytest.mark.parametrize("ext", ["jpg", "png"])
def test_imread_is_cv2_imread(data, ext):
    paths = [p for p in Path(data).read_text().split() if p.endswith(ext)]
    for p in paths:
        want = cv2.imread(p)[:, :, ::-1]
        got = image_io.imread(p)
        np.testing.assert_array_equal(got, want)
        assert image_io.image_size(p) == (want.shape[1], want.shape[0])


@pytest.mark.parametrize("kind", ["gray", "rgba", "palette"])
def test_png_colour_types_read_as_cv2(tmp_path, kind):
    rng = np.random.default_rng(1)
    p = str(tmp_path / f"{kind}.png")
    if kind == "gray":
        cv2.imwrite(p, rng.integers(0, 256, (33, 47), np.uint8))
    elif kind == "rgba":
        cv2.imwrite(p, rng.integers(0, 256, (33, 47, 4), np.uint8))
    else:
        # a palette PNG written by hand (cv2 never writes one)
        import struct
        import zlib
        pal = rng.integers(0, 256, (16, 3), np.uint8)
        idx = rng.integers(0, 16, (33, 47), np.uint8)
        rows = np.concatenate([np.zeros((33, 1), np.uint8), idx], 1)

        def chunk(kind_, body):
            return (struct.pack(">I", len(body)) + kind_ + body
                    + struct.pack(">I", zlib.crc32(kind_ + body)))
        Path(p).write_bytes(
            b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 47, 33, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", pal.tobytes())
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))
    np.testing.assert_array_equal(image_io.imread(p),
                                  cv2.imread(p)[:, :, ::-1])


def test_resize_and_letterbox_are_cv2s():
    rng = np.random.default_rng(2)
    for (h, w), (nh, nw) in [((48, 64), (72, 96)), ((150, 200), (72, 96)),
                             ((37, 50), (640, 865)), ((200, 100), (100, 50)),
                             ((60, 60), (60, 60))]:
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        np.testing.assert_array_equal(
            nl.resize(img, nw, nh),
            cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR))
    from efficientteacher_tpu.data.augment import letterbox as jax_letterbox
    img = rng.integers(0, 256, (50, 77, 3), np.uint8)
    for shape, kw in [((96, 96), {}), ((64, 128), {"scaleup": False}),
                      ((96, 96), {"auto": True}),
                      ((40, 90), {"scale_fill": True})]:
        got, gr, gp = letterbox(img, shape, **kw)
        want, wr, wp = jax_letterbox(img, shape, **kw)
        np.testing.assert_array_equal(got, want)
        assert (gr, gp) == (wr, wp)


def test_train_loader_matches_jax(data):
    pc, jc = cfgs(data)
    port = port_ds.create_dataloader(pc, "train", augment=False, seed=3)
    ref = jax_ds.create_dataloader(jc, "train", augment=False, seed=3)
    # augment=False loaders keep their order; a shuffled train loader
    # (the trainers' device_aug route) must order batches as JAX does
    assert_batches_equal(list(port), list(ref),
                         ["labels", "mask", "shapes", "indices"])
    p2 = port_ds.BatchLoader(port.ds, 4, shuffle=True, seed=5, workers=3)
    j2 = jax_ds.BatchLoader(ref.ds, 4, shuffle=True, seed=5, workers=3,
                            mode="thread")
    for _ in range(2):  # two epochs: the order depends on seed + epoch
        assert_batches_equal(list(p2), list(j2),
                             ["labels", "mask", "shapes", "indices"])


@pytest.mark.parametrize("sampler", ["class_balance", "dir_balance"])
def test_samplers_match_jax(data, sampler):
    pc, jc = cfgs(data)
    port = port_ds.create_dataloader(pc, "val", augment=False)
    ref = jax_ds.create_dataloader(jc, "val", augment=False)
    p = port_ds.BatchLoader(port.ds, 3, seed=2, sampler_type=sampler)
    j = jax_ds.BatchLoader(ref.ds, 3, seed=2, sampler_type=sampler,
                           mode="thread", workers=1)
    assert p._indices() == j._indices()


def test_process_engine_equals_threads(data):
    pc, _ = cfgs(data)
    ds = port_ds.create_dataloader(pc, "val", augment=False).ds
    threads = port_ds.BatchLoader(ds, 3, seed=1, workers=2, mode="thread")
    procs = port_ds.BatchLoader(ds, 3, seed=1, workers=2, mode="process")
    assert procs._use_processes()
    for a, b in zip(list(threads), list(procs), strict=True):
        assert a["images"].dtype == b["images"].dtype
        np.testing.assert_array_equal(a["images"].numpy(),
                                      b["images"].numpy())
        for k in ("labels", "mask", "indices", "shapes"):
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]))


def test_rect_loader_matches_jax(data):
    pc, jc = cfgs(data, **{"Dataset.rect": True})
    port = port_ds.create_dataloader(pc, "val", augment=False)
    ref = jax_ds.create_dataloader(jc, "val", augment=False)
    assert isinstance(port, port_ds.RectBatchLoader)
    assert port.batch_shapes == ref.batch_shapes
    assert_batches_equal(list(port), list(ref),
                         ["labels", "mask", "shapes", "ratio_pad",
                          "indices", "paths"])


@pytest.mark.parametrize("cache", ["ram", "disk"])
def test_image_caches_give_the_same_batches(data, tmp_path, cache):
    pc, _ = cfgs(data)
    plain = list(port_ds.create_dataloader(pc, "val", augment=False))
    pc.cache = cache
    for _ in range(2):  # the second pass reads the cache
        cached = list(port_ds.create_dataloader(pc, "val", augment=False))
        for a, b in zip(plain, cached, strict=True):
            np.testing.assert_array_equal(a["images"].numpy(),
                                          b["images"].numpy())
            np.testing.assert_array_equal(a["labels"], b["labels"])


def test_labels_cache_reloads(data, monkeypatch):
    pc, _ = cfgs(data)
    ds = port_ds.create_dataloader(pc, "val", augment=False).ds
    assert ds.cache_path.is_file()
    # a second dataset reads the cache: it verifies no image
    calls = []
    monkeypatch.setattr(port_ds, "verify_image_label",
                        lambda *a, **k: calls.append(a))
    again = port_ds.create_dataloader(pc, "val", augment=False).ds
    assert calls == []
    assert again.img_files == ds.img_files
    np.testing.assert_array_equal(again.shapes, ds.shapes)
    for a, b in zip(again.labels, ds.labels, strict=True):
        np.testing.assert_array_equal(a, b)


def test_dataset_statistics_and_items_match_jax(data):
    pc, jc = cfgs(data)
    port = port_ds.create_dataloader(pc, "val", augment=False).ds
    ref = jax_ds.create_dataloader(jc, "val", augment=False).ds
    np.testing.assert_array_equal(port.shapes, ref.shapes)
    np.testing.assert_array_equal(port.cls_ratio_gt, ref.cls_ratio_gt)
    assert port.label_num_per_image == ref.label_num_per_image
    for i in range(len(port)):
        got, want = port[i], ref[i]
        np.testing.assert_array_equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        img, hw0, hw = port.load_image(i)
        img_j, hw0_j, hw_j = ref.load_image(i)
        np.testing.assert_array_equal(img, img_j[:, :, ::-1])
        assert (tuple(hw0), tuple(hw)) == (tuple(hw0_j), tuple(hw_j))


def test_unread_formats_raise_when_the_dataset_is_built(data, tmp_path):
    """WebP (ROADMAP Q1.9b), refused here before, and BMP and 16-bit PNG
    are read (tests/test_torch_webp.py and tests/test_torch_image_formats
    .py hold them to cv2): a split with a .webp builds, its shapes and
    items equal to JAX's. A float TIFF, which raised here until F10 was
    closed, is one cv2.imread reads nothing of: it leaves the port's
    dataset as it leaves JAX's."""
    src = Path(data).read_text().split()[0]
    webp = tmp_path / "images" / "x.webp"
    webp.parent.mkdir()
    cv2.imwrite(str(webp), cv2.imread(src))
    lst = tmp_path / "l.txt"
    lst.write_text(f"{src}\n{webp}\n")
    port = port_ds.LoadImagesAndLabels(str(lst), img_size=IMG, nc=8)
    ref = jax_ds.LoadImagesAndLabels(str(lst), img_size=IMG, nc=8)
    assert len(port) == len(ref) == 2
    np.testing.assert_array_equal(port.shapes, ref.shapes)
    for i in range(2):
        np.testing.assert_array_equal(port[i][0], ref[i][0])
    np.testing.assert_array_equal(image_io.imread(str(webp)),
                                  cv2.imread(str(webp))[..., ::-1])
    tif = tmp_path / "images" / "f.tif"
    assert cv2.imwrite(str(tif), cv2.imread(src).astype(np.float32))
    lst.write_text(f"{src}\n{tif}\n")
    assert cv2.imread(str(tif)) is None
    port = port_ds.LoadImagesAndLabels(str(lst), img_size=IMG, nc=8)
    ref = jax_ds.LoadImagesAndLabels(str(lst), img_size=IMG, nc=8)
    assert port.img_files == ref.img_files == [src]
    np.testing.assert_array_equal(port.shapes, ref.shapes)
    np.testing.assert_array_equal(port[0][0], ref[0][0])
    with pytest.raises(OSError, match="float"):
        image_io.image_size(str(tif))


def test_host_augmentation_raises(data):
    """The host augmentation is ported: create_dataloader augments under
    hyp.use_aug, as JAX's does, with JAX's batches; what still raises is
    a config value it cannot read (an unknown loader engine)."""
    pc, jc = cfgs(data, **{"hyp.use_aug": True, "Dataset.loader": "process"})
    port = port_ds.create_dataloader(pc, "train", seed=3)
    ref = jax_ds.create_dataloader(jc, "train", seed=3)
    assert port.ds.augment and port.ds.mosaic
    assert_batches_equal(list(port), list(ref), ("labels", "mask", "shapes",
                                                 "indices", "paths"))
    pc.Dataset.loader = "fork"
    with pytest.raises(ValueError, match="Dataset.loader"):
        port_ds.create_dataloader(pc, "train")


def test_missing_and_corrupt_files_are_dropped_as_in_jax(data, tmp_path):
    good = Path(data).read_text().split()[:3]
    bad = tmp_path / "images" / "bad.jpg"
    bad.parent.mkdir()
    bad.write_bytes(b"not a jpeg")
    lst = tmp_path / "l.txt"
    lst.write_text("\n".join(good + [str(bad), str(tmp_path / "no.jpg")]))
    port = port_ds.LoadImagesAndLabels(str(lst), img_size=IMG, nc=8)
    ref = jax_ds.LoadImagesAndLabels(str(lst), img_size=IMG, nc=8)
    assert port.img_files == ref.img_files == good
    assert os.path.exists(port.cache_path)


# (h, w as stored, orientation): 6 and 8 turn the image a quarter, 3 half
ROTATED = [(72, 96, 6), (60, 90, 3), (96, 64, 1), (150, 200, 6),
           (96, 96, 3), (50, 80, 8), (96, 72, 6)]


@pytest.fixture(scope="module")
def rotated(tmp_path_factory):
    """JPEGs carrying an Exif orientation (APP1 spliced in by hand), which
    cv2.imread applies and the JAX package's loaders therefore see."""
    from test_torch_jpeg import with_exif_orientation

    root = tmp_path_factory.mktemp("rot")
    lst = write_dataset(root, [(h, w, "jpg") for h, w, _ in ROTATED],
                        seed=4, name="rot")
    for path, (_, _, o) in zip(Path(lst).read_text().split(), ROTATED):
        Path(path).write_bytes(
            with_exif_orientation(Path(path).read_bytes(), o))
    return lst


def test_rotated_jpegs_load_as_jax_loads_them(rotated):
    for p, (h, w, o) in zip(Path(rotated).read_text().split(), ROTATED):
        assert image_io.image_size(p) == ((h, w) if o >= 5 else (w, h))
    pc, jc = cfgs(rotated)
    port = port_ds.create_dataloader(pc, "train", augment=False, seed=3)
    ref = jax_ds.create_dataloader(jc, "train", augment=False, seed=3)
    assert_batches_equal(list(port), list(ref),
                         ["labels", "mask", "shapes", "indices"])
    pc, jc = cfgs(rotated, **{"Dataset.rect": True})
    port = port_ds.create_dataloader(pc, "val", augment=False)
    ref = jax_ds.create_dataloader(jc, "val", augment=False)
    assert port.batch_shapes == ref.batch_shapes
    assert_batches_equal(list(port), list(ref),
                         ["labels", "mask", "shapes", "ratio_pad", "indices",
                          "paths"])


def test_prescale_route_ignores_the_orientation_as_jax_native_does(rotated):
    """Dataset.native_loader: both packages decode a JPEG as stored (the
    JAX native core reads no Exif) with the IDCT prescale, and take (h0,
    w0) from the file while the rect batches come from the labels cache's
    oriented sizes. Labels, shapes, ratio_pad and image sizes exact;
    pixels within 1 (JAX's core resizes in float, the port's as cv2)."""
    pc, jc = cfgs(rotated, **{"Dataset.rect": True,
                              "Dataset.native_loader": True})
    port = port_ds.create_dataloader(pc, "val", augment=False)
    ref = jax_ds.create_dataloader(jc, "val", augment=False)
    got, want = list(port), list(ref)
    assert len(got) == len(want) > 0
    for bp, bj in zip(got, want):
        for k in ("labels", "mask", "shapes", "ratio_pad", "indices"):
            np.testing.assert_array_equal(np.asarray(bp[k]),
                                          np.asarray(bj[k]), err_msg=k)
        a = np.asarray(bp["images"]).astype(int)
        b = np.asarray(bj["images"]).astype(int)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1

"""Labelled dataset and batch loaders without cv2 (counterpart of
`efficientteacher_tpu/data/datasets.py`).

Parity with the JAX module (and through it reference utils/datasets.py):
  - path syntax: .txt list files, directories, globs, `||` concatenation
    with `*N` repetition, `img label` pair lines (`parse_data_path`)
  - label files: images/ -> labels/, rows `cls cx cy w h` normalised,
    filtered and de-duplicated (`verify_image_label`)
  - a labels cache keyed by an md5 of the paths and file sizes
  - `__getitem__` with augment=False: the image resized so its longer side
    is img_size (INTER_LINEAR), letterboxed into the square canvas, labels
    packed to max_targets with a mask
  - `__getitem__` with augment=True: mosaic-4 / mosaic-9 (+ mixup,
    copy_paste) or the letterbox (scaleup), then random_perspective, HSV
    and the flips (`data/augment.py`), with the JAX draws in their order
  - `BatchLoader` (samplers normal / class_balance / dir_balance, an
    epoch's order from `random.Random(seed + epoch)`, as in JAX, so both
    packages yield the same batches), `RectBatchLoader` (aspect-ratio
    buckets with ratio_pad), `QuadBatchLoader` (Dataset.quad),
    `create_dataloader`

Draws: every batch of a `BatchLoader` draws from its own generator,
`random.Random(f"{seed}/{epoch}/{batch}")`, handed to the batch build by
both engines, so a batch is a function of (seed, epoch, batch) alone.
That is the JAX process engine's per-batch reseed (JAX datasets.py:
582-590); JAX's thread engine shares one generator among its workers, so
parity is held against its process engine. `ds[i]` and `QuadBatchLoader`
draw from the dataset's own `random.Random(seed)`, as in JAX.

Images decode through `data/image_io.py`, bit-equal to cv2.imread: JPEG
through the loader core's own decoder, EXIF orientation applied as
cv2.imread applies it; PNG, BMP, TIFF and WebP parsed there, their
pixels through the core (`csrc/raster_decode.h`, `csrc/webp_decode.h`).
They resize through the core, bit-equal to cv2's INTER_LINEAR. On the plain path one core call decodes, resizes and
letterboxes a JPEG straight into its batch slot; image arrays in batches
are uint8 CPU tensors, in pinned memory when the loader's `pin_memory` is
set (`data/parallel_loader.py`). The native sizes come from the image
headers (JAX decodes each image to take its size); a file cv2.imread
reads nothing of is dropped, as in JAX (ROADMAP F10: a header of a kind
cv2 refuses raises OSError); every kind cv2 reads is read. A `.webp` takes the plain route on the prescale path too, as
JAX's `load_image` sends only JPEGs to its native core.

Albumentations is off: the JAX dataset applies it only when the package
imports, and the card's machine has none (ROADMAP Q1.12). Keypoint and id
columns are carried as in JAX.
"""

from __future__ import annotations

import glob
import hashlib
import math
import os
import random
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..utils import native_loader as nl
from . import image_io
from .augment import (augment_hsv, copy_paste, hflip_labels, letterbox,
                      mixup, mosaic4, mosaic9, random_perspective,
                      vflip_labels)
from .image_io import IMG_FORMATS

CACHE_VERSION = "torch-1.0"


def img2label_path(img_path: str) -> str:
    """images/xxx.jpg -> labels/xxx.txt (reference datasets.py:117-121)."""
    sa = os.sep + "images" + os.sep
    sb = os.sep + "labels" + os.sep
    if sa in img_path:
        base = sb.join(img_path.rsplit(sa, 1))
    else:
        base = img_path
    return os.path.splitext(base)[0] + ".txt"


def parse_data_path(path: str) -> List[Tuple[str, Optional[str]]]:
    """Expand the reference's path syntax into (image, label|None) pairs.

    Supports: directory, glob, .txt list file; `a||b` concatenation;
    `entry*3` repetition; `img label` two-column lines
    (reference datasets.py:671-706)."""
    pairs: List[Tuple[str, Optional[str]]] = []
    for part in str(path).split("||"):
        part = part.strip()
        if not part:
            continue
        repeat = 1
        if "*" in part and not any(ch in part for ch in "[]?"):
            stem, _, mult = part.rpartition("*")
            if mult.isdigit():
                part, repeat = stem, int(mult)
        sub: List[Tuple[str, Optional[str]]] = []
        p = Path(part)
        if p.is_dir():
            for f in sorted(glob.glob(str(p / "**" / "*.*"), recursive=True)):
                if f.rsplit(".", 1)[-1].lower() in IMG_FORMATS:
                    sub.append((f, None))
        elif p.is_file() and p.suffix == ".txt":
            parent = str(p.parent) + os.sep
            for line in p.read_text().splitlines():
                line = line.strip()
                if not line:
                    continue
                cols = line.split()
                img = cols[0].replace("./", parent, 1) \
                    if cols[0].startswith("./") else cols[0]
                lbl = cols[1] if len(cols) > 1 else None
                sub.append((img, lbl))
        elif p.is_file():
            sub.append((str(p), None))
        else:
            for f in sorted(glob.glob(part, recursive=True)):
                if f.rsplit(".", 1)[-1].lower() in IMG_FORMATS:
                    sub.append((f, None))
        pairs.extend(sub * repeat)
    if not pairs:
        raise FileNotFoundError(f"no images found in {path!r}")
    return pairs


def get_hash(paths: List[str]) -> str:
    """md5 over paths + sizes (reference datasets.py:112-117)."""
    h = hashlib.md5("".join(paths).encode())
    sizes = sum(os.path.getsize(p) for p in paths if os.path.exists(p))
    h.update(str(sizes).encode())
    return h.hexdigest()


def verify_image_label(img_file: str, label_file: Optional[str], nc: int,
                       num_keypoints: int = 0):
    """Validate one image/label pair (reference verify_image_label).
    Returns (labels (N, 5+2*np) float32, (w, h)) or None for a file that
    is missing, corrupt, of a kind cv2.imread reads nothing of, or under
    10 px."""
    ncol = 5 + 2 * num_keypoints
    try:
        w, h = image_io.image_size(img_file)
    except (OSError, ValueError):
        return None
    if h < 10 or w < 10:
        return None
    if label_file and os.path.isfile(label_file):
        rows = []
        try:
            text = Path(label_file).read_text()
            for line in text.splitlines():
                vals = line.split()
                if len(vals) >= ncol:
                    rows.append([float(v) for v in vals[:ncol]])
                elif len(vals) >= 5:
                    rows.append([float(v) for v in vals[:5]]
                                + [-1.0] * (2 * num_keypoints))
        except (OSError, ValueError):
            return None
        lb = (np.array(rows, np.float32) if rows
              else np.zeros((0, ncol), np.float32))
        if len(lb):
            ok = ((lb[:, 0] >= 0) & (lb[:, 0] < nc)
                  & (lb[:, 1:5] >= 0).all(1) & (lb[:, 1:5] <= 1).all(1))
            lb = lb[ok]
            _, idx = np.unique(lb, axis=0, return_index=True)
            lb = lb[np.sort(idx)]  # dedup, keep order
    else:
        lb = np.zeros((0, ncol), np.float32)
    return lb, (w, h)


class LoadImagesAndLabels:
    """YOLO-format dataset: letterboxed or augmented images and padded
    labels (see the module docstring)."""

    def __init__(
        self,
        path: str,
        img_size: int = 640,
        hyp: Optional[Dict] = None,
        augment: bool = False,
        nc: int = 80,
        max_targets: int = 120,
        single_cls: bool = False,
        cache_dir: Optional[str] = None,
        seed: int = 0,
        cache_images: bool = False,
        num_keypoints: int = 0,
        cache_dir_images: Optional[str] = None,
        mosaic9_prob: float = 0.0,
        num_ids: int = 0,
        pseudo_ids: bool = False,
        native_loader: bool = False,
    ):
        self.num_keypoints = num_keypoints
        self.img_size = img_size
        self.hyp = dict(hyp or {})
        self.augment = augment
        self.nc = nc
        self.max_targets = max_targets
        self.single_cls = single_cls
        # the trainers' before_epoch closes it for the last no_aug_epochs
        self.mosaic = augment and self.hyp.get("mosaic", 0) > 0
        self.mosaic9_prob = mosaic9_prob
        # the draws of `ds[i]` (the loaders hand each batch its own)
        self.rng = random.Random(seed)
        self.cache_images = cache_images
        # the IDCT prescale (the JAX native loader's opt-in, orientation
        # ignored as there): off, every JPEG decodes at full resolution
        # with its EXIF orientation, as cv2.imread does
        self.native_loader = bool(native_loader)
        self._img_cache: Dict[int, tuple] = {}
        self.cache_dir_images = Path(cache_dir_images) if cache_dir_images \
            else None
        if self.cache_dir_images:
            self.cache_dir_images.mkdir(parents=True, exist_ok=True)
        self.with_id = num_ids > 0 or pseudo_ids
        self.pseudo_ids = pseudo_ids

        pairs = parse_data_path(path)
        self.img_files = [p[0] for p in pairs]
        self.label_files = [
            p[1] if p[1] else img2label_path(p[0]) for p in pairs
        ]
        self._load_cache(cache_dir)

        # per-class statistics for LabelMatch (reference datasets.py:760-769)
        all_cls = np.concatenate(
            [lb[:, 0] for lb in self.labels if len(lb)] or [np.zeros(0)]
        )
        counts = np.bincount(all_cls.astype(int),
                             minlength=nc).astype(np.float64)
        total = max(counts.sum(), 1)
        self.cls_ratio_gt = counts / total
        self.label_num_per_image = total / max(len(self.labels), 1)

    # -- label cache ---------------------------------------------------------
    def _load_cache(self, cache_dir: Optional[str]):
        cache_path = (
            Path(cache_dir or Path(self.label_files[0]).parent)
            / (Path(self.img_files[0]).parent.name + ".torch.cache.npy")
        )
        h = get_hash(self.label_files + self.img_files
                     + [str(self.num_keypoints)])
        cache = None
        if cache_path.is_file():
            try:
                data = np.load(cache_path, allow_pickle=True).item()
                if data.get("hash") == h and \
                        data.get("version") == CACHE_VERSION:
                    cache = data
            except (OSError, ValueError, AttributeError):
                cache = None
        if cache is None:
            labels, shapes, keep = [], [], []
            for i, (imf, lbf) in enumerate(zip(self.img_files,
                                               self.label_files)):
                out = verify_image_label(imf, lbf, self.nc,
                                         self.num_keypoints)
                if out is None:
                    continue
                keep.append(i)
                labels.append(out[0])
                shapes.append(out[1])
            cache = {"hash": h, "version": CACHE_VERSION, "keep": keep,
                     "labels": labels, "shapes": shapes}
            try:
                np.save(cache_path, cache)  # best-effort
            except OSError:
                pass
        keep = cache["keep"]
        self.img_files = [self.img_files[i] for i in keep]
        self.label_files = [self.label_files[i] for i in keep]
        self.labels = cache["labels"]
        self.shapes = np.array(cache["shapes"], np.float64).reshape(-1, 2)
        if self.single_cls:
            for lb in self.labels:
                if len(lb):
                    lb[:, 0] = 0
        self.cache_path = cache_path

    def __len__(self):
        return len(self.img_files)

    # -- image io ------------------------------------------------------------
    def _prescaled(self, i: int) -> bool:
        return self.native_loader and \
            image_io.suffix(self.img_files[i]) in image_io.JPEG_SUFFIXES

    def source_hw(self, i: int) -> Tuple[int, int]:
        """(h0, w0) of image i as `load_image` decodes it: the labels
        cache's size (EXIF orientation applied, as cv2.imread applies it),
        except on the prescale route, which decodes a JPEG as stored and
        ignores its orientation, as the JAX native core does (JAX takes
        (h0, w0) there from the core's header read, not from the cache)."""
        w0, h0 = (int(v) for v in self.shapes[i])
        if self._prescaled(i):
            w, h, orientation = nl.jpeg_info(self.img_files[i])
            if nl.oriented_size(w, h, orientation) != (w0, h0):
                raise OSError(f"{self.img_files[i]}: size differs from the "
                              f"labels cache's {(w0, h0)}")
            return h, w
        return h0, w0

    def resized_hw(self, i: int) -> Tuple[int, int]:
        """(h, w) of image i after `load_image`'s resize (longer side ->
        img_size, int() truncation as in JAX)."""
        h0, w0 = self.source_hw(i)
        r = self.img_size / max(h0, w0)
        if r == 1:
            return h0, w0
        return int(h0 * r), int(w0 * r)

    def load_image(self, i: int):
        """(img RGB (h, w, 3), (h0, w0), (h, w)): the image resized so its
        longer side is img_size, INTER_LINEAR (reference datasets.py:1198);
        optional RAM or disk cache of the resized images."""
        if i in self._img_cache:
            return self._img_cache[i]
        h0, w0 = self.source_hw(i)
        npy = (self.cache_dir_images / f"{i}.npy"
               if self.cache_dir_images else None)
        if npy is not None and npy.exists():
            img = np.load(npy)
            return img, (h0, w0), img.shape[:2]
        h, w = self.resized_hw(i)
        img = np.empty((h, w, 3), np.uint8)
        self._decode_into(i, img, 0, 0, w, h, pad_value=-1)
        out = (img, (h0, w0), (h, w))
        if self.cache_images:
            self._img_cache[i] = out
        if npy is not None:
            np.save(npy, img)
        return out

    def _decode_into(self, i, canvas, top, left, new_w, new_h,
                     pad_value=114):
        """Image i decoded, resized to (new_w, new_h) and written at (top,
        left) into `canvas`, which is first filled with `pad_value` (-1:
        not filled)."""
        path = self.img_files[i]
        w0, h0 = (int(v) for v in self.shapes[i])
        if image_io.suffix(path) in image_io.JPEG_SUFFIXES:
            nl.jpeg_letterbox(path, canvas, top, left, new_w, new_h,
                              pad_value, expect_wh=(w0, h0),
                              prescale=self.native_loader,
                              orient=not self.native_loader)
            return
        img = image_io.imread(path)
        if img.shape[:2] != (h0, w0):
            raise OSError(f"{path}: size {img.shape[1::-1]} differs from "
                          f"the labels cache's {(w0, h0)}")
        nl.resize_letterbox(img, canvas, top, left, new_w, new_h, pad_value)

    def letterbox_into(self, i: int, canvas: np.ndarray):
        """Image i letterboxed into the square canvas (img_size, img_size,
        3) as `_load_plain` letterboxes it (scaleup False). Returns the
        letterbox's (dw, dh) and the resized (h, w). Without an image
        cache this is one core call per JPEG: decode, resize, pad."""
        s = self.img_size
        h, w = self.resized_hw(i)
        dw, dh = (s - w) / 2, (s - h) / 2
        top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
        if self.cache_images or self.cache_dir_images:
            img = self.load_image(i)[0]
            nl.resize_letterbox(img, canvas, top, left, w, h)
        else:
            self._decode_into(i, canvas, top, left, w, h)
        return (dw, dh), (h, w)

    def _labels_xyxy_pixels(self, i: int, ratio_w, ratio_h, padw, padh):
        """Normalized xywh -> pixel xyxy in the (resized+padded) frame.
        Keypoint columns (if any) follow in pixel space, invisible = -1;
        a trailing id column follows when with_id."""
        lb = self.labels[i]
        npk = self.num_keypoints
        extra_id = 1 if self.with_id else 0
        out = np.zeros((len(lb), 5 + 2 * npk + extra_id), np.float32)
        if len(lb):
            out[:, 0] = lb[:, 0]
            cx, cy, w, h = lb[:, 1] * ratio_w, lb[:, 2] * ratio_h, \
                lb[:, 3] * ratio_w, lb[:, 4] * ratio_h
            out[:, 1] = cx - w / 2 + padw
            out[:, 2] = cy - h / 2 + padh
            out[:, 3] = cx + w / 2 + padw
            out[:, 4] = cy + h / 2 + padh
            for k in range(npk):
                visible = lb[:, 5 + 2 * k] >= 0
                out[:, 5 + 2 * k] = np.where(
                    visible, lb[:, 5 + 2 * k] * ratio_w + padw, -1.0)
                out[:, 6 + 2 * k] = np.where(
                    visible, lb[:, 6 + 2 * k] * ratio_h + padh, -1.0)
            if self.with_id:
                id_col = 5 + 2 * npk
                if lb.shape[1] > id_col:
                    out[:, id_col] = lb[:, id_col]
                elif self.pseudo_ids:
                    out[:, id_col] = np.arange(len(lb), dtype=np.float32)
                else:
                    out[:, id_col] = -1.0
        return out

    # -- the host augmentation (augment=True) ------------------------------
    def _perspective(self, img, targets, rng, border=(0, 0)):
        hyp = self.hyp
        return random_perspective(
            img, targets, degrees=hyp.get("degrees", 0.0),
            translate=hyp.get("translate", 0.1),
            scale=hyp.get("scale", 0.5), shear=hyp.get("shear", 0.0),
            perspective=hyp.get("perspective", 0.0), border=border, rng=rng)

    def _load_mosaic(self, index: int, rng: random.Random):
        s = self.img_size
        use9 = self.mosaic9_prob > 0 and rng.random() < self.mosaic9_prob
        n_extra = 8 if use9 else 3
        idxs = [index] + [rng.randrange(len(self)) for _ in range(n_extra)]
        imgs, lbs = [], []
        for i in idxs:
            img, _, (h, w) = self.load_image(i)
            imgs.append(img)
            lbs.append(self._labels_xyxy_pixels(i, w, h, 0, 0))
        compose = mosaic9 if use9 else mosaic4
        canvas, merged = compose(imgs, lbs, s, rng)
        cp = self.hyp.get("copy_paste", 0.0)
        if cp > 0 and len(merged):
            canvas, merged = copy_paste(canvas, merged, cp, rng)
        return self._perspective(canvas, merged, rng, (-s // 2, -s // 2))

    def _load_plain(self, index: int, rng: random.Random):
        img, _, (h, w) = self.load_image(index)
        img, ratio, pad = letterbox(img, self.img_size, auto=False,
                                    scaleup=True)
        targets = self._labels_xyxy_pixels(
            index, ratio[0] * w, ratio[1] * h, pad[0], pad[1])
        return self._perspective(img, targets, rng)

    def augmented_item(self, index: int, rng: random.Random):
        """JAX `__getitem__` under augment=True, drawing from `rng`: (img
        RGB (S, S, 3), targets (N, 5+) pixel xyxy, shapes (h0, w0) or None
        for a mosaic)."""
        hyp = self.hyp
        if self.mosaic and rng.random() < hyp.get("mosaic", 0):
            img, targets = self._load_mosaic(index, rng)
            if rng.random() < hyp.get("mixup", 0):
                img2, targets2 = self._load_mosaic(rng.randrange(len(self)),
                                                   rng)
                img, targets = mixup(img, targets, img2, targets2, rng)
            shapes = None
        else:
            img, targets = self._load_plain(index, rng)
            w0, h0 = self.shapes[index]
            shapes = (h0, w0)
        augment_hsv(img, hyp.get("hsv_h", 0), hyp.get("hsv_s", 0),
                    hyp.get("hsv_v", 0), rng)
        if rng.random() < hyp.get("flipud", 0):
            img = np.flipud(img)
            targets = vflip_labels(targets, img.shape[0])
        if rng.random() < hyp.get("fliplr", 0):
            img = np.fliplr(img)
            targets = hflip_labels(targets, img.shape[1])
        return img, targets, shapes

    def load_item_into(self, index: int, canvas: np.ndarray,
                       rng: Optional[random.Random] = None):
        """`__getitem__` with the image written into `canvas`: returns
        (labels, mask, shapes). The augmentation draws from `rng` (default:
        the dataset's own)."""
        if self.augment:
            img, targets, shapes = self.augmented_item(index,
                                                       rng or self.rng)
            canvas[...] = img
            labels, mask = self.pack_labels(targets, img.shape[1],
                                            img.shape[0])
            return labels, mask, shapes
        (dw, dh), (h, w) = self.letterbox_into(index, canvas)
        # ratio (1.0, 1.0): the square letterbox never rescales here
        targets = self._labels_xyxy_pixels(index, 1.0 * w, 1.0 * h, dw, dh)
        w0, h0 = self.shapes[index]
        labels, mask = self.pack_labels(targets, self.img_size,
                                        self.img_size)
        return labels, mask, (h0, w0)

    def __getitem__(self, index: int):
        """(img_u8 RGB (S, S, 3), labels (M, 5) [cls, xywh norm], mask (M,),
        shapes (h0, w0))."""
        s = self.img_size
        img = np.empty((s, s, 3), np.uint8)
        labels, mask, shapes = self.load_item_into(index, img)
        return img, labels, mask, shapes

    def pack_labels(self, targets_xyxy: np.ndarray, w: int, h: int):
        """Pixel xyxy -> padded normalized (M, 5+2*np[+1]) [cls, cxywh, kps,
        id?]."""
        m = self.max_targets
        npk = self.num_keypoints
        extra_id = 1 if getattr(self, "with_id", False) else 0
        labels = np.zeros((m, 5 + 2 * npk + extra_id), np.float32)
        mask = np.zeros((m,), bool)
        n = min(len(targets_xyxy), m)
        if n:
            t = targets_xyxy[:n]
            labels[:n, 0] = t[:, 0]
            labels[:n, 1] = ((t[:, 1] + t[:, 3]) / 2) / w
            labels[:n, 2] = ((t[:, 2] + t[:, 4]) / 2) / h
            labels[:n, 3] = (t[:, 3] - t[:, 1]) / w
            labels[:n, 4] = (t[:, 4] - t[:, 2]) / h
            for k in range(npk):
                if t.shape[1] > 5 + 2 * k:
                    vis = t[:, 5 + 2 * k] >= 0
                    labels[:n, 5 + 2 * k] = np.where(vis, t[:, 5 + 2 * k] / w,
                                                     -1.0)
                    labels[:n, 6 + 2 * k] = np.where(vis, t[:, 6 + 2 * k] / h,
                                                     -1.0)
            if extra_id and t.shape[1] > 5 + 2 * npk:
                labels[:n, 5 + 2 * npk] = t[:, 5 + 2 * npk]
            mask[:n] = True
        return labels, mask


def class_balanced_indices(labels, nc: int, rng: random.Random):
    """Oversample images containing rare classes (the reference's
    BalancedBatchSampler intent, utils/datasets.py:225-292): an index list
    the size of the dataset, per-image weights = mean inverse class
    frequency."""
    n = len(labels)
    counts = np.zeros(nc) + 1e-6
    for lb in labels:
        if len(lb):
            counts += np.bincount(lb[:, 0].astype(int), minlength=nc)
    inv = counts.sum() / counts
    weights = np.ones(n)
    for i, lb in enumerate(labels):
        if len(lb):
            weights[i] = inv[lb[:, 0].astype(int)].mean()
    weights = weights / weights.sum()
    r = np.random.default_rng(rng.randrange(2**31))
    return r.choice(n, size=n, p=weights).tolist()


def dir_balanced_indices(img_files, rng: random.Random):
    """Round-robin across parent directories (the reference's
    DistributeBalancedBatchSampler intent, utils/datasets.py:134-223)."""
    groups: Dict[str, List[int]] = {}
    for i, f in enumerate(img_files):
        groups.setdefault(str(Path(f).parent), []).append(i)
    pools = list(groups.values())
    for pool in pools:
        rng.shuffle(pool)
    out, k = [], 0
    n = len(img_files)
    while len(out) < n:
        pool = pools[k % len(pools)]
        out.append(pool[(k // len(pools)) % len(pool)])
        k += 1
    return out


class BatchLoader:
    """Epoch iterator over a dataset yielding stacked fixed-shape batches
    (replaces the reference's InfiniteDataLoader + torch collate).

    A batch is a dict: "images" a uint8 CPU tensor (B, S, S, 3), pinned
    when `pin_memory` (the copy to the card then reads it directly),
    "labels" float32 (B, M, 5), "mask" bool (B, M), "shapes", "indices",
    "paths". sampler_type: normal | class_balance | dir_balance. mode:
    'thread' (the core decodes into the batch, GIL released), 'process'
    (forked workers and shared-memory slots) or 'auto' (threads: see
    `data/parallel_loader.py`)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 4,
                 workers: int = 2, sampler_type: str = "normal",
                 mode: str = "auto", shard_across_processes: bool = True,
                 pin_memory: bool = False):
        if mode not in ("auto", "thread", "process"):
            raise ValueError(f"Dataset.loader {mode!r}: auto, thread or "
                             "process")
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.workers = max(1, workers)
        self.epoch = 0
        self.seed = seed
        self.sampler_type = sampler_type
        self.mode = mode
        # train loaders take a per-process shard; validation scores the
        # full set in every process
        self.shard_across_processes = shard_across_processes
        self.pin_memory = pin_memory

    def __len__(self):
        n = len(self.ds)
        if self.shard_across_processes:
            from ..parallel.distributed import process_slice

            n = len(process_slice(range(n)))
        return n // self.bs if self.drop_last else math.ceil(n / self.bs)

    def _indices(self):
        rng = random.Random(self.seed + self.epoch)
        if self.sampler_type == "class_balance":
            idx = class_balanced_indices(self.ds.labels, self.ds.nc, rng)
        elif self.sampler_type == "dir_balance":
            idx = dir_balanced_indices(self.ds.img_files, rng)
        else:
            idx = list(range(len(self.ds)))
            if self.shuffle:
                rng.shuffle(idx)
        if not self.shard_across_processes:
            return idx
        from ..parallel.distributed import process_slice

        return process_slice(idx)

    def _batches(self):
        idx = self._indices()
        batches = [idx[i:i + self.bs] for i in range(0, len(idx), self.bs)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.bs]
        return batches

    def _build_batch(self, bidx, images: np.ndarray,
                     rng: random.Random) -> Dict:
        """The batch of `bidx`, its images written into `images`, its
        draws from `rng`; the image field is left for the engine to fill
        in."""
        items = [self.ds.load_item_into(i, images[j], rng)
                 for j, i in enumerate(bidx)]
        return {
            "labels": np.stack([it[0] for it in items]),
            "mask": np.stack([it[1] for it in items]),
            "shapes": [it[2] for it in items],
            "indices": list(bidx),
            "paths": [self.ds.img_files[i] for i in bidx],
        }

    def _image_shape(self, bidx):
        s = self.ds.img_size
        return (len(bidx), s, s, 3)

    def _use_processes(self) -> bool:
        from .parallel_loader import _FORK_OK

        return self.mode == "process" and _FORK_OK

    def _build_task(self, task, images: np.ndarray) -> Dict:
        """Build one task of `__iter__`: (the batch's seed, its batch)."""
        seed, batch = task
        return self._build_batch(batch, images, random.Random(seed))

    def __iter__(self) -> Iterator[Dict]:
        from .parallel_loader import (iter_batches_processes,
                                      iter_batches_threads)

        # the JAX process engine's per-batch seed (JAX BatchLoader._reseed)
        tasks = [(f"{self.seed}/{self.epoch}/{seq}", b)
                 for seq, b in enumerate(self._batches())]
        engine = (iter_batches_processes if self._use_processes()
                  else iter_batches_threads)
        yield from engine(self._build_task, tasks,
                          lambda task: self._image_shape(task[1]),
                          self.workers, self.prefetch,
                          pin_memory=self.pin_memory)
        self.epoch += 1


def create_dataloader(cfg, split: str = "train",
                      augment: Optional[bool] = None,
                      batch_size: Optional[int] = None, seed: int = 0,
                      pin_memory: bool = False):
    """Factory mirroring reference create_dataloader (datasets.py:320-363):
    the dataset augments when `augment` (default: the train split) and
    `hyp.use_aug`."""
    path = getattr(cfg.Dataset, split)
    augment = (split == "train") if augment is None else augment
    ds = LoadImagesAndLabels(
        path,
        img_size=cfg.Dataset.img_size,
        hyp={k: cfg.hyp[k] for k in cfg.hyp},
        augment=augment and cfg.hyp.use_aug,
        nc=cfg.Dataset.nc,
        max_targets=cfg.Dataset.max_targets,
        single_cls=cfg.single_cls,
        seed=seed,
        cache_images=cfg.cache is True or cfg.cache == "ram",
        cache_dir_images=(
            str(Path(path).parent / ".img_cache_torch")
            if cfg.cache == "disk" else None
        ),
        num_keypoints=int(cfg.Dataset.np),
        num_ids=int(cfg.Dataset.num_ids),
        pseudo_ids=bool(cfg.Dataset.pseudo_ids),
        native_loader=bool(cfg.Dataset.native_loader),
    )
    bs = batch_size or cfg.Dataset.batch_size
    if not augment and (cfg.Dataset.rect or cfg.rect):
        return RectBatchLoader(ds, bs, img_size=cfg.Dataset.img_size,
                               pin_memory=pin_memory)
    if augment and cfg.Dataset.quad:
        return QuadBatchLoader(ds, bs // 2, shuffle=True, seed=seed,
                               drop_last=True,
                               sampler_type=cfg.Dataset.sampler_type,
                               pin_memory=pin_memory)
    from ..parallel.distributed import per_process_batch

    return BatchLoader(
        ds,
        per_process_batch(bs) if augment else bs,
        shuffle=augment,
        seed=seed,
        drop_last=augment,
        sampler_type=cfg.Dataset.sampler_type if augment else "normal",
        workers=int(cfg.Dataset.workers),
        mode=str(cfg.Dataset.loader) if augment else "thread",
        shard_across_processes=augment,
        pin_memory=pin_memory,
    )


class RectBatchLoader(BatchLoader):
    """Aspect-ratio-bucketed validation loader (reference rectangular
    batches, utils/datasets.py:772-795): images sort by aspect ratio, each
    batch letterboxes to a shared stride-multiple shape from the batch's
    extreme aspect (pad 0.5 like val.py:255). Each image is resized twice,
    as in JAX: `load_image`, then the letterbox into the batch shape.
    Batches carry "ratio_pad" ((rh, rw), (dw, dh)) per image."""

    def __init__(self, dataset, batch_size: int, img_size: int,
                 stride: int = 32, pad: float = 0.5,
                 pin_memory: bool = False):
        super().__init__(dataset, batch_size, shuffle=False, drop_last=False,
                         pin_memory=pin_memory)
        self.img_size = img_size
        self.stride = stride
        self.pad = pad
        shapes = dataset.shapes  # (N, 2) w, h
        ar = shapes[:, 1] / shapes[:, 0]  # h / w
        self.order = np.argsort(ar)
        n = len(dataset)
        nb = int(math.ceil(n / batch_size))
        self.batch_shapes = []
        self.batches = []
        for bi in range(nb):
            idx = self.order[bi * batch_size:(bi + 1) * batch_size]
            ari = ar[idx]
            mini, maxi = float(ari.min()), float(ari.max())
            shape = [1.0, 1.0]
            if maxi < 1:
                shape = [maxi, 1.0]
            elif mini > 1:
                shape = [1.0, 1.0 / mini]
            h = int(math.ceil(shape[0] * img_size / stride + pad)) * stride
            w = int(math.ceil(shape[1] * img_size / stride + pad)) * stride
            self.batch_shapes.append((min(h, img_size + stride),
                                      min(w, img_size + stride)))
            self.batches.append([int(i) for i in idx])

    def __len__(self):
        return len(self.batches)

    def _batches(self):
        return list(zip(self.batches, self.batch_shapes))

    def _image_shape(self, task):
        bidx, (bh, bw) = task
        return (len(bidx), bh, bw, 3)

    def _build_batch(self, task, images: np.ndarray,
                     rng: random.Random) -> Dict:
        bidx, (bh, bw) = task
        labels, masks, shapes, ratio_pads = [], [], [], []
        for j, i in enumerate(bidx):
            img, (h0, w0), (h, w) = self.ds.load_image(i)
            _, ratio, dwdh = letterbox(img, (bh, bw), auto=False,
                                       scaleup=False, out=images[j])
            t = self.ds._labels_xyxy_pixels(
                i, ratio[0] * w, ratio[1] * h, dwdh[0], dwdh[1])
            lab, m = self.ds.pack_labels(t, bw, bh)
            labels.append(lab)
            masks.append(m)
            shapes.append((h0, w0))
            # the native -> canvas transform, as the reference hands it to
            # scale_coords (val.py:340): the pre-letterbox resize ratio
            ratio_pads.append(((h / h0, w / w0), dwdh))
        return {
            "labels": np.stack(labels),
            "mask": np.stack(masks),
            "shapes": shapes,
            "ratio_pad": ratio_pads,
            "indices": list(bidx),
            "paths": [self.ds.img_files[i] for i in bidx],
        }

    def _use_processes(self) -> bool:
        return False


class QuadBatchLoader(BatchLoader):
    """Quad collate (reference collate_fn4, utils/datasets.py:1170-1194;
    JAX datasets.py:773-837): each output sample covers 4 dataset items,
    either the first upscaled 2x (the core's INTER_LINEAR) or a 2x2 paste
    of all four, giving 2*img_size images at a quarter of the batch count.
    As in JAX, it builds in the calling thread, the items drawing from the
    dataset's generator and the quad choices from a per-epoch one."""

    def __iter__(self):
        idx = self._indices()
        qrng = random.Random((self.seed + 3) * 104729 + self.epoch)
        group = self.bs * 4
        batches = [idx[i:i + group] for i in range(0, len(idx), group)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == group]
        s = self.ds.img_size
        m = self.ds.max_targets
        for bidx in batches:
            images = torch.empty((len(bidx) // 4, 2 * s, 2 * s, 3),
                                 dtype=torch.uint8,
                                 pin_memory=self.pin_memory)
            labels, masks = [], []
            for q, g in enumerate(range(0, len(bidx), 4)):
                items = [self.ds[i] for i in bidx[g:g + 4]]
                lab, msk = quad_collate(items, images.numpy()[q], s, m,
                                        qrng.random() < 0.5)
                labels.append(lab)
                masks.append(msk)
            yield {"images": images, "labels": np.stack(labels),
                   "mask": np.stack(masks), "shapes": [None] * len(labels),
                   "indices": list(bidx)}
        self.epoch += 1


def quad_collate(items, out: np.ndarray, s: int, m: int, single: bool):
    """One quad sample from four `__getitem__` items into `out` (2s, 2s,
    3): the first item upscaled 2x (labels unchanged, being normalised to
    the frame) when `single`, else the 2x2 paste (labels halved and
    offset). Returns (labels (4m, ncol), mask (4m,))."""
    ncol = items[0][1].shape[-1]
    lab = np.zeros((m * 4, ncol), np.float32)
    msk = np.zeros((m * 4,), bool)
    if single:
        nl.resize_letterbox(items[0][0], out, 0, 0, 2 * s, 2 * s,
                            pad_value=-1)
        n = int(items[0][2].sum())
        lab[:n] = items[0][1][items[0][2]]
        msk[:n] = True
        return lab, msk
    out[...] = 0
    w = 0
    for (oy, ox), it in zip([(0, 0), (0, 1), (1, 0), (1, 1)], items):
        out[oy * s:(oy + 1) * s, ox * s:(ox + 1) * s] = it[0]
        sel = it[2]
        n = int(sel.sum())
        if n:
            rows = it[1][sel].copy()
            rows[:, 1] = rows[:, 1] / 2 + ox * 0.5
            rows[:, 2] = rows[:, 2] / 2 + oy * 0.5
            rows[:, 3] /= 2
            rows[:, 4] /= 2
            lab[w:w + n] = rows
            msk[w:w + n] = True
            w += n
    return lab, msk

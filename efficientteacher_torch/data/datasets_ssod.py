"""Unlabelled (SSOD target) dataset and loader (counterpart of
`efficientteacher_tpu/data/datasets_ssod.py`; reference
utils/datasets_ssod.py).

augment=True (the host route, `Dataset.device_aug` False): each item is
a weak / strong pair with its transform record M_s, as in JAX:
  - mosaic (p = ssod_hyp.mosaic): four images on a 2s canvas at a random
    centre, labels at half scale, the canvas resized to s by the core's
    INTER_LINEAR (JAX `_mosaic_pair`, reference load_mosaic_with_M
    :732-792); else the letterbox (scaleup). That is the weak view.
  - strong view: the recorded affine (`build_affine`) warped from the weak
    view, the labels through `warp_boxes` + `box_candidates`, HSV, then
    cutout and AutoAugment, each gated as in JAX: a draw, and labels on
    the target (`with_gt` or SSOD.debug; without them both draws are spent
    and neither fires), then the flips, recorded as flags
  - M_s 13-vector [batch_idx, M (3x3 row-major), scale s, flipud, fliplr]
    (reference :490-591), the batch index stamped at collate.
augment=False (the `Dataset.device_aug` route): raw letterboxed weak views
with an identity record; `ops/augment_device.device_ssod_views` makes the
strong view, its labels and M_s on the card.

A batch: "images" (the strong views) and "images_ori" (the weak views),
uint8 CPU tensors (one tensor under augment=False: the JAX loader's
strong view is then a copy of the weak one), "labels" and "mask" (zeros
unless `with_gt`), "M_s" float32 (B, 13), "indices". The draws come from
the batch's generator, as in `data/datasets.py`.
"""

from __future__ import annotations

import random
from typing import Dict, Optional

import numpy as np

from ..utils import native_loader as nl
from .augment import (augment_hsv, box_candidates, build_affine, cutout,
                      letterbox, mosaic4_tile, warp_boxes, warp_image)
from .datasets import BatchLoader, LoadImagesAndLabels

_IDENTITY_M_S = np.concatenate([[0.0], np.eye(3).reshape(-1),
                                [1.0, 0.0, 0.0]]).astype(np.float32)


class LoadImagesAndFakeLabels(LoadImagesAndLabels):
    """Unlabelled dataset: without `with_gt` its labels are dropped
    (reference datasets_ssod.py:382-393)."""

    def __init__(self, *args, with_gt: bool = False, **kw):
        super().__init__(*args, **kw)
        self.with_gt = with_gt
        if not with_gt:
            self.labels = [np.zeros((0, 5), np.float32) for _ in self.labels]

    def _mosaic_pair(self, index: int, rng: random.Random):
        """The weak view of a mosaic item (s, s, 3) and its labels."""
        s = self.img_size
        idxs = [index] + [rng.randrange(len(self)) for _ in range(3)]
        rng.shuffle(idxs)
        canvas = np.full((s * 2, s * 2, 3), 114, np.uint8)
        merged = []
        yc = int(rng.uniform(s // 2, 2 * s - s // 2))
        xc = int(rng.uniform(s // 2, 2 * s - s // 2))
        for i, di in enumerate(idxs):
            img, _, (h, w) = self.load_image(di)
            (x1a, y1a, x2a, y2a), (x1b, y1b, x2b, y2b) = mosaic4_tile(
                i, xc, yc, w, h, s)
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            padw, padh = x1a - x1b, y1a - y1b
            lb = self.labels[di]
            if len(lb):
                # labels in half-scale pixels: the 2s canvas is resized to
                # s below (reference datasets_ssod.py:768 uses w/2, h/2)
                out = np.zeros((len(lb), 5), np.float32)
                out[:, 0] = lb[:, 0]
                cx = lb[:, 1] * w / 2 + padw / 2
                cy = lb[:, 2] * h / 2 + padh / 2
                bw = lb[:, 3] * w / 2
                bh = lb[:, 4] * h / 2
                out[:, 1], out[:, 2] = cx - bw / 2, cy - bh / 2
                out[:, 3], out[:, 4] = cx + bw / 2, cy + bh / 2
                merged.append(out)
        labels = (np.concatenate(merged, 0) if merged
                  else np.zeros((0, 5), np.float32))
        np.clip(labels[:, 1:5], 0, s * 2, out=labels[:, 1:5])
        return nl.resize(canvas, s, s), labels

    def augmented_pair(self, index: int, rng: random.Random):
        """JAX `__getitem__` under augment=True, drawing from `rng`:
        (strong, labels, mask, weak, M_s), the views RGB (s, s, 3)."""
        hyp = self.hyp
        s = self.img_size
        if rng.random() < hyp.get("mosaic", 0):
            weak, targets = self._mosaic_pair(index, rng)
        else:
            img, _, (h, w) = self.load_image(index)
            weak, ratio, pad = letterbox(img, s, auto=False, scaleup=True)
            targets = self._labels_xyxy_pixels(
                index, ratio[0] * w, ratio[1] * h, pad[0], pad[1])
        m_s = np.zeros(13, np.float32)
        M, sc = build_affine(
            weak.shape[1], weak.shape[0], degrees=hyp.get("degrees", 0.0),
            translate=hyp.get("translate", 0.1),
            scale=hyp.get("scale", 0.5), shear=hyp.get("shear", 0.0),
            perspective=hyp.get("perspective", 0.0), rng=rng)
        persp = hyp.get("perspective", 0.0) > 0
        strong = warp_image(weak, M, (s, s), persp)
        if len(targets):
            old = targets[:, 1:5].copy()
            new = warp_boxes(old, M, s, s, persp)
            keep = box_candidates(old.T * sc, new.T, area_thr=0.1)
            targets = targets[keep]
            targets[:, 1:5] = new[keep]
        m_s[1:10] = M.reshape(-1)
        m_s[10] = sc
        augment_hsv(strong, hyp.get("hsv_h", 0), hyp.get("hsv_s", 0),
                    hyp.get("hsv_v", 0), rng)
        if rng.random() < hyp.get("cutout", 0) and len(targets):
            cutout(strong, targets, rng)
        if rng.random() < hyp.get("autoaugment", 0) and len(targets):
            from .autoaugment import distort_image_with_autoaugment

            strong, targets = distort_image_with_autoaugment(
                strong, targets, hyp.get("autoaugment_policy", "v5"), rng)
        labels, mask = self.pack_labels(targets, s, s)
        # flips on the strong view only, recorded as flags
        # (reference datasets_ssod.py:563-576)
        if rng.random() < hyp.get("flipud", 0):
            strong = np.flipud(strong)
            labels[mask, 2] = 1.0 - labels[mask, 2]
            m_s[11] = 1.0
        if rng.random() < hyp.get("fliplr", 0):
            strong = np.fliplr(strong)
            labels[mask, 1] = 1.0 - labels[mask, 1]
            m_s[12] = 1.0
        return strong, labels, mask, weak, m_s

    def load_item_into(self, index: int, canvas: np.ndarray,
                       rng: Optional[random.Random] = None):
        """augment=False: (labels, mask, M_s) of item `index`, its weak view
        written into `canvas`."""
        labels, mask, _ = super().load_item_into(index, canvas)
        return labels, mask, _IDENTITY_M_S.copy()

    def load_pair_into(self, index: int, strong: np.ndarray,
                       weak: np.ndarray, rng: random.Random):
        """augment=True: (labels, mask, M_s) of item `index`, its views
        written into `strong` and `weak`."""
        s_img, labels, mask, w_img, m_s = self.augmented_pair(index, rng)
        strong[...] = s_img
        weak[...] = w_img
        return labels, mask, m_s

    def __getitem__(self, index: int):
        """(strong, labels, mask, weak, M_s) as the JAX dataset returns them
        (under augment=False the strong view is a copy of the weak one);
        the draws come from the dataset's generator."""
        if self.augment:
            strong, labels, mask, weak, m_s = self.augmented_pair(index,
                                                                  self.rng)
            return (np.ascontiguousarray(strong), labels, mask, weak, m_s)
        s = self.img_size
        weak = np.empty((s, s, 3), np.uint8)
        labels, mask, m_s = self.load_item_into(index, weak)
        return weak.copy(), labels, mask, weak, m_s


class SSODBatchLoader(BatchLoader):
    """Batches of the strong and weak views with labels, mask and M_s;
    M_s[:, 0] is the in-batch index (reference collate_fn,
    datasets_ssod.py:593-602). Under augment the engine's image tensor
    holds both views, (2, B, s, s, 3): strong, then weak."""

    def _image_shape(self, bidx):
        shape = super()._image_shape(bidx)
        return (2, *shape) if self.ds.augment else shape

    def _build_batch(self, bidx, images: np.ndarray,
                     rng: random.Random) -> Dict:
        if self.ds.augment:
            items = [self.ds.load_pair_into(i, images[0][j], images[1][j],
                                            rng)
                     for j, i in enumerate(bidx)]
        else:
            items = [self.ds.load_item_into(i, images[j])
                     for j, i in enumerate(bidx)]
        m_s = np.stack([it[2] for it in items])
        m_s[:, 0] = np.arange(len(items))
        return {
            "labels": np.stack([it[0] for it in items]),
            "mask": np.stack([it[1] for it in items]),
            "M_s": m_s,
            "indices": list(bidx),
        }

    def __iter__(self):
        for batch in super().__iter__():
            views = batch["images"]
            if self.ds.augment:
                batch["images"], batch["images_ori"] = views[0], views[1]
            else:
                batch["images_ori"] = views
            yield batch


def create_target_dataloader(cfg, batch_size: Optional[int] = None,
                             seed: int = 0, augment: bool = True,
                             pin_memory: bool = False):
    """Factory mirroring reference create_target_dataloader
    (utils/datasets_ssod.py:67): the augmentation hyp is
    SSOD.ssod_hyp."""
    hyp = {k: cfg.SSOD.ssod_hyp[k] for k in cfg.SSOD.ssod_hyp}
    with_gt = bool(cfg.SSOD.ssod_hyp.with_gt or cfg.SSOD.debug)
    ds = LoadImagesAndFakeLabels(
        cfg.Dataset.target,
        img_size=cfg.Dataset.img_size,
        hyp=hyp,
        augment=augment,
        nc=cfg.Dataset.nc,
        max_targets=cfg.Dataset.max_targets,
        single_cls=cfg.single_cls,
        seed=seed,
        with_gt=with_gt,
    )
    from ..parallel.distributed import per_process_batch

    return SSODBatchLoader(
        ds, per_process_batch(batch_size or cfg.Dataset.batch_size),
        shuffle=True, seed=seed, drop_last=True,
        workers=int(cfg.Dataset.workers), mode=str(cfg.Dataset.loader),
        pin_memory=pin_memory,
    )

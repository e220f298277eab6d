"""Unlabelled (SSOD target) dataset and loader (counterpart of
`efficientteacher_tpu/data/datasets_ssod.py`), augment=False only: the
loader serves raw letterboxed weak views with an identity transform
record, and `ops/augment_device.device_ssod_views` makes the strong view,
its labels and M_s on the card (the JAX package's `Dataset.device_aug`
route). The host weak/strong pipeline (mosaic pair, recorded affine, HSV,
cutout, AutoAugment, flips) is not ported (ROADMAP, "Next, in order"
item 2.7).

A batch: "images_ori" (the weak views) and "images" are the same uint8
CPU tensor (the JAX loader's strong view is a copy of the weak one under
augment=False), "labels" and "mask" (zeros unless `with_gt`), "M_s"
float32 (B, 13) [index, identity (9), 1, 0, 0], "indices".
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .datasets import HOST_AUG_TODO, BatchLoader, LoadImagesAndLabels

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

    def load_item_into(self, index: int, canvas: np.ndarray):
        """(labels, mask, M_s) of item `index`, its weak view written into
        `canvas`."""
        labels, mask, _ = super().load_item_into(index, canvas)
        return labels, mask, _IDENTITY_M_S.copy()

    def __getitem__(self, index: int):
        """(strong, labels, mask, weak, M_s) as the JAX dataset returns them
        under augment=False (the strong view a copy of the weak one)."""
        s = self.img_size
        weak = np.empty((s, s, 3), np.uint8)
        labels, mask, m_s = self.load_item_into(index, weak)
        return weak.copy(), labels, mask, weak, m_s


class SSODBatchLoader(BatchLoader):
    """Batches of the weak views with labels, mask and M_s; M_s[:, 0] is
    the in-batch index (reference collate_fn, datasets_ssod.py:593-602)."""

    def _build_batch(self, bidx, images: np.ndarray) -> Dict:
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
            batch["images_ori"] = batch["images"]
            yield batch


def create_target_dataloader(cfg, batch_size: Optional[int] = None,
                             seed: int = 0, augment: bool = True,
                             pin_memory: bool = False):
    """Factory mirroring reference create_target_dataloader
    (utils/datasets_ssod.py:67); augment=True raises (HOST_AUG_TODO)."""
    if augment:
        raise NotImplementedError(HOST_AUG_TODO)
    with_gt = bool(cfg.SSOD.ssod_hyp.with_gt or cfg.SSOD.debug)
    ds = LoadImagesAndFakeLabels(
        cfg.Dataset.target,
        img_size=cfg.Dataset.img_size,
        nc=cfg.Dataset.nc,
        max_targets=cfg.Dataset.max_targets,
        single_cls=cfg.single_cls,
        with_gt=with_gt,
    )
    from ..parallel.distributed import per_process_batch

    return SSODBatchLoader(
        ds, per_process_batch(batch_size or cfg.Dataset.batch_size),
        shuffle=True, seed=seed, drop_last=True,
        workers=int(cfg.Dataset.workers), mode=str(cfg.Dataset.loader),
        pin_memory=pin_memory,
    )

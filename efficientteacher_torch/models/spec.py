"""Static model specification derived from the config tree.

A copy of `efficientteacher_tpu/models/spec.py`: importing that module loads
jax (its package `__init__` imports the Flax detector), and this package
must not. `ModelSpec()`'s defaults are YOLOv5l (width 1.0, depth 1.0,
nc 80, 640 px).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    backbone: str = "YoloV5"
    neck: str = "YoloV5"
    head: str = "YoloV5"
    width_multiple: float = 1.0
    depth_multiple: float = 1.0
    nc: int = 80
    num_keypoints: int = 0
    ch: int = 3
    img_size: int = 640
    strides: Tuple[float, ...] = (8.0, 16.0, 32.0)
    # anchors in input pixels, flattened per scale (reference Model.anchors)
    anchors: Tuple[Tuple[float, ...], ...] = (
        (10, 13, 16, 30, 33, 23),
        (30, 61, 62, 45, 59, 119),
        (116, 90, 156, 198, 373, 326),
    )
    backbone_act: str = "SiLU"
    neck_act: str = "SiLU"
    head_act: str = "SiLU"
    neck_in_channels: Tuple[int, ...] = (256, 512, 1024)
    neck_out_channels: Tuple[int, ...] = (256, 512, 1024)
    head_in_channels: Tuple[int, ...] = (128, 256, 512)
    num_decouple: int = 2
    prior_prob: float = 0.01
    reg_max: int = 7
    use_dfl: bool = True
    depth_num_repeats: Tuple[int, ...] = (1, 6, 12, 18, 6)
    neck_num_repeats: Tuple[int, ...] = (12, 12, 12, 12)
    backbone_out_channels: Tuple[int, ...] = (64, 128, 256, 512, 1024)
    train_domain: bool = False
    deploy: bool = False
    vgg_block_type: str = "repvgg"

    @property
    def nl(self) -> int:
        return len(self.anchors)

    @property
    def na(self) -> int:
        return len(self.anchors[0]) // 2


def _normalize_anchors(anchors, strides):
    """Anchor-free configs write `anchors: [1]` or `anchors: 1`
    (e.g. reference configs/sup/public/yolox_coco.yaml:30); normalize to a
    one-anchor-per-scale placeholder so spec.nl/na stay meaningful."""
    if isinstance(anchors, (int, float)):
        anchors = [anchors]
    rows = list(anchors)
    if rows and not isinstance(rows[0], (list, tuple)):
        return tuple((float(s), float(s)) for s in strides)
    return tuple(tuple(float(v) for v in row) for row in rows)


def spec_from_cfg(cfg) -> ModelSpec:
    """ModelSpec from a config tree. Duck-typed: any object with the
    CfgNode's attribute layout works (`efficientteacher_tpu.configs.get_cfg`
    needs no jax and is one such object)."""
    m = cfg.Model
    return ModelSpec(
        backbone=m.Backbone.name,
        neck=m.Neck.name,
        head=m.Head.name,
        width_multiple=float(m.width_multiple),
        depth_multiple=float(m.depth_multiple),
        nc=int(cfg.Dataset.nc),
        num_keypoints=int(cfg.Dataset.np),
        ch=int(m.ch),
        img_size=int(cfg.Dataset.img_size),
        strides=tuple(float(s) for s in m.Head.strides),
        anchors=_normalize_anchors(m.anchors, m.Head.strides),
        backbone_act=m.Backbone.activation,
        neck_act=m.Neck.activation,
        head_act=m.Head.activation,
        neck_in_channels=tuple(int(c) for c in m.Neck.in_channels),
        neck_out_channels=tuple(int(c) for c in m.Neck.out_channels),
        head_in_channels=tuple(int(c) for c in m.Head.in_channels),
        num_decouple=int(m.Head.num_decouple),
        prior_prob=float(m.prior_prob),
        reg_max=int(cfg.Loss.reg_max),
        use_dfl=bool(cfg.Loss.use_dfl),
        depth_num_repeats=tuple(int(n) for n in m.Backbone.num_repeats),
        neck_num_repeats=tuple(int(n) for n in m.Neck.num_repeats),
        backbone_out_channels=tuple(int(c) for c in m.Backbone.out_channels),
        train_domain=bool(cfg.SSOD.train_domain),
        vgg_block_type=(
            "realvgg" if cfg.Model.RealVGGModel
            else "linearadd" if cfg.Model.LinearAddModel
            else "qarep" if cfg.Model.QARepVGGModel
            else "repvgg"
        ),
    )

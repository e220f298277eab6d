"""Detector composition: backbone -> neck -> head (counterpart of
`efficientteacher_tpu/models/detector.py`; reference
models/detector/yolo.py:45-128).

Only the supervised `Model` is ported so far; `SSODModel` and its `NetD`
domain discriminators come with the SSOD slice.
"""

from __future__ import annotations

import torch
from torch import nn

from .backbones import build_backbone_cls
from .common import lecun_normal_
from .heads import build_head_cls
from .necks import build_neck_cls
from .spec import ModelSpec, spec_from_cfg


class Model(nn.Module):
    """Supervised detector (reference yolo.py:45). NCHW input."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        self.backbone = build_backbone_cls(spec.backbone)(spec)
        self.neck = build_neck_cls(spec.neck)(spec, self.backbone.out_channels)
        self.head = build_head_cls(spec.head)(spec, self.neck.out_channels)

    def forward(self, x, decode: bool | None = None):
        """Eval mode (default decode): `(decoded (B, N, no), raw maps)`;
        train mode: raw maps only, as the JAX Model's `train` flag gives."""
        if decode is None:
            decode = not self.training
        return self.head(self.neck(self.backbone(x)), decode=decode)


def build_model(cfg, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda",
                generator: torch.Generator | None = None) -> Model:
    """Build a Model from a ModelSpec or a config tree, on `device`: the
    CUDA card unless the caller asks for another device (`device="cpu"`).
    Raises RuntimeError for a CUDA device when no card is present.

    Weights are made on the CPU from `generator` (flax's default conv init,
    the head's focal-prior bias), then moved, so one seed gives the same
    model on every device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA card is present; pass "
                           "device='cpu' to build on the CPU")
    spec = cfg if isinstance(cfg, ModelSpec) else spec_from_cfg(cfg)
    model = Model(spec)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                lecun_normal_(mod.weight, generator)
    return model.to(device=device, dtype=dtype)

"""Detector composition: backbone -> neck -> head, plus the SSOD model's
domain discriminators (counterpart of `efficientteacher_tpu/models/
detector.py`; reference models/detector/yolo.py:45-128 and
yolo_ssod.py:44-258).
"""

from __future__ import annotations

import torch
from torch import nn

from .backbones import build_backbone_cls
from .common import ImplicitA, ImplicitM, lecun_normal_
from .heads import build_head_cls
from .necks import build_neck_cls
from .spec import ModelSpec, spec_from_cfg


class _GradReverse(torch.autograd.Function):
    """Identity forward, negated gradient (reference GradReverse,
    yolo_ssod.py:158-172; JAX `grad_reverse`, a custom VJP)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


def grad_reverse(x: torch.Tensor) -> torch.Tensor:
    return _GradReverse.apply(x)


class NetD(nn.Module):
    """Per-scale domain discriminator: 1x1 conv -> ReLU -> 1x1 conv -> 2
    channels, no biases (reference yolo_ssod.py:224-238)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 1, bias=False)
        self.conv2 = nn.Conv2d(channels, 2, 1, bias=False)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


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


class SSODModel(Model):
    """SSOD detector: the head's output plus per-scale domain logits of the
    gradient-reversed neck features (reference yolo_ssod.py:105-118). The
    discriminators keep the JAX names `det_8/16/32`, so the weight bridge
    carries them key for key."""

    def __init__(self, spec: ModelSpec):
        super().__init__(spec)
        p3, p4, p5 = (int(c * spec.width_multiple)
                      for c in spec.neck_out_channels)
        self.det_8 = NetD(p3)
        self.det_16 = NetD(p4)
        self.det_32 = NetD(p5)

    def forward(self, x, decode: bool | None = None,
                with_domain: bool = True):
        """`(head output, domain logits per scale or None)`; the head output
        is as `Model.forward` gives it."""
        if decode is None:
            decode = not self.training
        f8, f16, f32 = self.neck(self.backbone(x))
        out = self.head((f8, f16, f32), decode=decode)
        if not with_domain:
            return out, None
        return out, (self.det_8(grad_reverse(f8)),
                     self.det_16(grad_reverse(f16)),
                     self.det_32(grad_reverse(f32)))


def build_model(cfg, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda",
                generator: torch.Generator | None = None) -> Model:
    """Build a Model, or an SSODModel where the spec's `train_domain` says
    so (as the JAX factory does by default), from a ModelSpec or a config
    tree, on `device`: the CUDA card unless the caller asks for another
    device (`device="cpu"`). Raises RuntimeError for a CUDA device when no
    card is present.

    Weights are made on the CPU from `generator` (flax's default conv init,
    fan-in over (in, kh, kw) for a transposed conv too; the heads' biases;
    YOLOv7's implicit tokens N(0, 0.02) and N(1, 0.02), as JAX draws
    them), then moved, so one seed gives the same model on every
    device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA card is present; pass "
                           "device='cpu' to build on the CPU")
    spec = cfg if isinstance(cfg, ModelSpec) else spec_from_cfg(cfg)
    model = (SSODModel if spec.train_domain else Model)(spec)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                lecun_normal_(mod.weight, generator)
            elif isinstance(mod, nn.ConvTranspose2d):
                # (in, out, kh, kw): flax's fan-in is kh * kw * in
                lecun_normal_(mod.weight.transpose(0, 1), generator)
            elif isinstance(mod, (ImplicitA, ImplicitM)):
                mean = 0.0 if isinstance(mod, ImplicitA) else 1.0
                mod.implicit.normal_(mean, 0.02, generator=generator)
    return model.to(device=device, dtype=dtype)

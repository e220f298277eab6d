"""YOLOX decoupled anchor-free head (counterpart of
`efficientteacher_tpu/models/heads/yolox.py`).

Parity with reference models/head/yolox_head.py:40-365:
  - per scale a 1x1 projection `conv{i+1}` to feat_channels (256, width-
    scaled), then depth-scaled stacks of 3x3 convs, separate class
    (`cls{i}`) and box (`reg{i}`) towers (yolox_head.py:103-118)
  - biased 1x1 predictions: class (nc) on the class tower, box (4) and
    objectness (1) on the box tower, with the prior-probability bias
    -log((1-p)/p) on class and objectness (yolox_head.py:169-180)
  - raw maps (B, 1, ny, nx, 5+nc) [xywh, obj, cls] in the port's
    (B, na, ny, nx, no) layout
  - eval decode in float32: xy = (reg + grid) * stride, wh = exp(reg) *
    stride, obj and cls sigmoid (yolox_head.py:341-362)
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..common import Conv, make_divisible
from ..spec import ModelSpec


def prior_bias(prior_prob: float) -> float:
    """The bias whose sigmoid is `prior_prob`."""
    return -math.log((1 - prior_prob) / prior_prob)


def decode_yolox_scale(raw: torch.Tensor, stride: float) -> torch.Tensor:
    """One scale's raw map (B, 1, ny, nx, no) -> (B, ny*nx, no) absolute
    decode, (y, x) order."""
    b, na, ny, nx, no = raw.shape
    gy, gx = torch.meshgrid(
        torch.arange(ny, dtype=torch.float32, device=raw.device),
        torch.arange(nx, dtype=torch.float32, device=raw.device),
        indexing="ij")
    grid = torch.stack([gx, gy], -1)                      # (ny, nx, 2)
    xy = (raw[..., 0:2] + grid) * stride
    wh = torch.exp(raw[..., 2:4]) * stride
    rest = torch.sigmoid(raw[..., 4:])
    return torch.cat([xy, wh, rest], -1).reshape(b, na * ny * nx, no)


class YoloXDetect(nn.Module):
    """Anchor-free decoupled head ('YoloX' in the head factory)."""

    def __init__(self, spec: ModelSpec, in_ch):
        super().__init__()
        self.nc = spec.nc
        self.no = 5 + spec.nc
        self.strides = tuple(spec.strides)
        gw, gd = spec.width_multiple, spec.depth_multiple
        dec_c = make_divisible(256 * gw, 8)  # Head.feat_channels scaled
        self.num_dec = (max(round(spec.num_decouple * gd), 1)
                        if spec.num_decouple > 0 else 0)
        act = {"SiLU": "silu", "ReLU": "relu"}.get(spec.head_act,
                                                   "hard_swish")
        bias = prior_bias(spec.prior_prob)
        heads = {"cls_preds": [], "reg_preds": [], "obj_preds": []}
        for i, c in enumerate(in_ch):
            if self.num_dec > 0:
                setattr(self, f"conv{i + 1}", Conv(c, dec_c, 1, 1, act=act))
                for tower in ("cls", "reg"):
                    setattr(self, f"{tower}{i}", nn.Sequential(*(
                        Conv(dec_c, dec_c, 3, 1, act=act)
                        for _ in range(self.num_dec))))
                c = dec_c
            heads["cls_preds"].append(nn.Conv2d(c, self.nc, 1, bias=True))
            heads["reg_preds"].append(nn.Conv2d(c, 4, 1, bias=True))
            heads["obj_preds"].append(nn.Conv2d(c, 1, 1, bias=True))
        with torch.no_grad():
            for name, convs in heads.items():
                for conv in convs:
                    conv.bias.fill_(0.0 if name == "reg_preds" else bias)
        self.cls_preds = nn.ModuleList(heads["cls_preds"])
        self.reg_preds = nn.ModuleList(heads["reg_preds"])
        self.obj_preds = nn.ModuleList(heads["obj_preds"])

    def forward(self, feats, decode: bool):
        """feats: (P3, P4, P5) NCHW. Returns raw maps [(B, 1, ny, nx, no)];
        with `decode`, `(decoded (B, N, no) float32, raw maps)`."""
        raw = []
        for i, f in enumerate(feats):
            cls_x = reg_x = f
            if self.num_dec > 0:
                f = getattr(self, f"conv{i + 1}")(f)
                cls_x = getattr(self, f"cls{i}")(f)
                reg_x = getattr(self, f"reg{i}")(f)
            x = torch.cat([self.reg_preds[i](reg_x), self.obj_preds[i](reg_x),
                           self.cls_preds[i](cls_x)], 1)
            b, no, ny, nx = x.shape
            raw.append(x.permute(0, 2, 3, 1).reshape(b, 1, ny, nx, no))
        if not decode:
            return raw
        z = [decode_yolox_scale(r.float(), s)
             for r, s in zip(raw, self.strides)]
        return torch.cat(z, 1), raw

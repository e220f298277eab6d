"""YOLOv6 efficient decoupled head (counterpart of
`efficientteacher_tpu/models/heads/yolov6.py`), with the TAL heads' shared
decode (`decode_tal_scale`; reference models/head/yolov6_head.py:173-215)
and the DFL bin expectation it reads (`dfl_project`, JAX
`losses/tal_loss.py`), which the YOLOv8 head and the TAL loss import from
here.

Parity with reference yolov6_head.py:53-381 (tal_build_effidehead_layer
:280-381):
  - per scale a 1x1 stem `stems_{i}`, then 3x3 `cls_convs_{i}` and
    `reg_convs_{i}`, all at the scale's input channels
  - biased 1x1 predictions `cls_preds_{i}` (nc) and `reg_preds_{i}`
    (4*(reg_max+1) DFL bins), their biases 0 (flax's default, as the JAX
    head has them)
  - raw maps (B, 1, ny, nx, bins+nc) [bins, cls]; the eval decode is
    `decode_tal_scale`
"""

from __future__ import annotations

import torch
from torch import nn

from ..common import Conv
from ..spec import ModelSpec


def dfl_project(reg_dist: torch.Tensor, reg_max: int) -> torch.Tensor:
    """(..., 4*(reg_max+1)) bin logits -> (..., 4) expected ltrb distances
    (the proj_conv of yolov6_head.py:94-96)."""
    bins = reg_dist.reshape(reg_dist.shape[:-1] + (4, reg_max + 1))
    proj = torch.arange(reg_max + 1, dtype=torch.float32,
                        device=reg_dist.device)
    return (torch.softmax(bins, -1) * proj).sum(-1)


def decode_tal_scale(raw: torch.Tensor, stride: float, reg_max: int,
                     use_dfl: bool, nc: int) -> torch.Tensor:
    """One scale's raw map (B, 1, ny, nx, 4*(reg_max+1)+nc) -> (B, ny*nx,
    5+nc) [xywh absolute, obj = 1, sigmoid cls]: the DFL expectation (or
    the first 4 bins without DFL) as ltrb distances around the (grid + 0.5)
    anchor points, scaled by the stride."""
    b, na, ny, nx, _ = raw.shape
    nbins = 4 * (reg_max + 1)
    reg = raw[..., :nbins]
    cls = torch.sigmoid(raw[..., nbins:])
    ltrb = dfl_project(reg, reg_max) if use_dfl else reg[..., :4]
    gy, gx = torch.meshgrid(
        torch.arange(ny, dtype=torch.float32, device=raw.device),
        torch.arange(nx, dtype=torch.float32, device=raw.device),
        indexing="ij")
    anc = torch.stack([gx + 0.5, gy + 0.5], -1)          # (ny, nx, 2)
    x1y1 = anc - ltrb[..., 0:2]
    x2y2 = anc + ltrb[..., 2:4]
    cxy = (x1y1 + x2y2) / 2 * stride
    wh = (x2y2 - x1y1) * stride
    obj = torch.ones_like(cxy[..., :1])
    out = torch.cat([cxy, wh, obj, cls], -1)
    return out.reshape(b, na * ny * nx, 5 + nc)


class YoloV6Detect(nn.Module):
    """TAL anchor-free head ('YoloV6' in the head factory)."""

    def __init__(self, spec: ModelSpec, in_ch):
        super().__init__()
        self.nc = spec.nc
        self.reg_max = spec.reg_max
        self.use_dfl = spec.use_dfl
        self.strides = tuple(spec.strides)
        nbins = 4 * (self.reg_max + 1)
        act = {"SiLU": "silu", "ReLU": "relu"}.get(spec.head_act, "relu")
        self.stems = nn.ModuleList(Conv(c, c, 1, 1, act=act) for c in in_ch)
        self.cls_convs = nn.ModuleList(Conv(c, c, 3, 1, act=act)
                                       for c in in_ch)
        self.reg_convs = nn.ModuleList(Conv(c, c, 3, 1, act=act)
                                       for c in in_ch)
        self.cls_preds = nn.ModuleList(nn.Conv2d(c, self.nc, 1, bias=True)
                                       for c in in_ch)
        self.reg_preds = nn.ModuleList(nn.Conv2d(c, nbins, 1, bias=True)
                                       for c in in_ch)
        for conv in (*self.cls_preds, *self.reg_preds):
            nn.init.zeros_(conv.bias)

    def forward(self, feats, decode: bool):
        """feats: (P3, P4, P5) NCHW. Returns raw maps [(B, 1, ny, nx, no)];
        with `decode`, `(decoded (B, N, 5+nc) float32, raw maps)`."""
        raw = []
        for i, f in enumerate(feats):
            x = self.stems[i](f)
            x = torch.cat([self.reg_preds[i](self.reg_convs[i](x)),
                           self.cls_preds[i](self.cls_convs[i](x))], 1)
            b, no, ny, nx = x.shape
            raw.append(x.permute(0, 2, 3, 1).reshape(b, 1, ny, nx, no))
        if not decode:
            return raw
        z = [decode_tal_scale(r.float(), s, self.reg_max, self.use_dfl,
                              self.nc)
             for r, s in zip(raw, self.strides)]
        return torch.cat(z, 1), raw

"""YOLOv8 decoupled TAL head (counterpart of
`efficientteacher_tpu/models/heads/yolov8.py`).

Parity with reference models/head/yolov8_head.py:10-95:
  - per scale a box tower cv2 (two 3x3 Convs at c2 = max(16, ch0/4,
    4*(reg_max+1)), then a biased 1x1 conv to the 4*(reg_max+1) DFL bins)
    and a class tower cv3 (two 3x3 Convs at c3 = max(ch0, nc), then a
    biased 1x1 conv to nc) (yolov8_head.py:76-83)
  - bias init: box 1.0, class log(5/nc/(640/s)^2) (:89-95)
  - raw maps (B, 1, ny, nx, 4*(reg_max+1)+nc) [bins, cls] in the port's
    (B, na, ny, nx, no) layout; the eval decode is the TAL heads' shared
    `decode_tal_scale` ([xywh, 1, cls])

The towers are `cv2_{i}` / `cv3_{i}` sequences, so the JAX package's
`cv2_{i}_{j}` modules carry across by `utils/jax_import.py` as
`cv2_{i}.{j}`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..common import Conv
from ..spec import ModelSpec
from .yolov6 import decode_tal_scale


class YoloV8Detect(nn.Module):
    """TAL anchor-free head ('YoloV8' in the head factory)."""

    def __init__(self, spec: ModelSpec, in_ch):
        super().__init__()
        self.nc = spec.nc
        self.reg_max = spec.reg_max
        self.use_dfl = spec.use_dfl
        self.strides = tuple(spec.strides)
        nbins = 4 * (self.reg_max + 1)
        act = {"SiLU": "silu", "ReLU": "relu"}.get(spec.head_act, "silu")
        c2 = max(16, in_ch[0] // 4, nbins)
        c3 = max(in_ch[0], self.nc)
        for i, (c, s) in enumerate(zip(in_ch, self.strides)):
            box = nn.Sequential(Conv(c, c2, 3, 1, act=act),
                                Conv(c2, c2, 3, 1, act=act),
                                nn.Conv2d(c2, nbins, 1, bias=True))
            cls = nn.Sequential(Conv(c, c3, 3, 1, act=act),
                                Conv(c3, c3, 3, 1, act=act),
                                nn.Conv2d(c3, self.nc, 1, bias=True))
            with torch.no_grad():
                box[2].bias.fill_(1.0)
                cls[2].bias.fill_(math.log(5.0 / self.nc / (640.0 / s) ** 2))
            setattr(self, f"cv2_{i}", box)
            setattr(self, f"cv3_{i}", cls)

    def forward(self, feats, decode: bool):
        """feats: (P3, P4, P5) NCHW. Returns raw maps [(B, 1, ny, nx, no)];
        with `decode`, `(decoded (B, N, 5+nc) float32, raw maps)`."""
        raw = []
        for i, f in enumerate(feats):
            x = torch.cat([getattr(self, f"cv2_{i}")(f),
                           getattr(self, f"cv3_{i}")(f)], 1)
            b, no, ny, nx = x.shape
            raw.append(x.permute(0, 2, 3, 1).reshape(b, 1, ny, nx, no))
        if not decode:
            return raw
        z = [decode_tal_scale(r.float(), s, self.reg_max, self.use_dfl,
                              self.nc)
             for r, s in zip(raw, self.strides)]
        return torch.cat(z, 1), raw

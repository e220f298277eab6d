"""YOLOv7 IDetect head (counterpart of
`efficientteacher_tpu/models/heads/yolov7.py`).

Parity with reference models/head/yolov7_head.py:9-72: the YOLOv5 Detect
head (its biased 1x1 `m_{i}` convs with the focal-prior bias init, its raw
layout and `decode_yolov5_scale`) with learned implicit tokens: ImplicitA
`ia_{i}` added to the head's input, ImplicitM `im_{i}` multiplying the
conv's output (reference common.py:1482-1506).
"""

from __future__ import annotations

import torch
from torch import nn

from ..common import ImplicitA, ImplicitM
from ..spec import ModelSpec
from .yolov5 import YoloV5Detect, decode_yolov5_scale


class YoloV7Detect(YoloV5Detect):
    """Anchor-based IDetect head ('YoloV7' in the head factory)."""

    def __init__(self, spec: ModelSpec, in_ch):
        super().__init__(spec, in_ch)
        self.ia = nn.ModuleList(ImplicitA(c) for c in in_ch)
        self.im = nn.ModuleList(ImplicitM(self.na * self.no) for _ in in_ch)

    def forward(self, feats, decode: bool):
        """feats: (P3, P4, P5) NCHW. Returns raw maps [(B, na, ny, nx, no)];
        with `decode`, `(decoded (B, N, no) float32, raw maps)`."""
        raw = []
        for ia, conv, im, f in zip(self.ia, self.m, self.im, feats):
            x = im(conv(ia(f)))
            b, _, ny, nx = x.shape
            raw.append(x.view(b, self.na, self.no, ny, nx)
                       .permute(0, 1, 3, 4, 2).contiguous())
        if not decode:
            return raw
        z = [decode_yolov5_scale(r, s, self.anchors_px[i], self.nc)
             for i, (r, s) in enumerate(zip(raw, self.strides))]
        return torch.cat(z, 1), raw

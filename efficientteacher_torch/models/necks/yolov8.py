"""YOLOv8 C2f PAN neck (counterpart of
`efficientteacher_tpu/models/necks/yolov8.py`).

Parity with reference models/neck/yolov8_neck.py:20-109: the v5 PAN
without its 1x1 reduce convs (the backbone's P5 and the top-down outputs
are upsampled and concatenated directly), with C2f stages (shortcut off).
"""

from __future__ import annotations

import torch
from torch import nn

from ..backbones.yolov8 import _act_names
from ..common import C2f, Conv, make_divisible, upsample2x
from ..spec import ModelSpec


class YoloV8Neck(nn.Module):
    def __init__(self, spec: ModelSpec, in_ch):
        """`in_ch`: channels of the backbone's (P3, P4, P5) outputs."""
        super().__init__()
        gd, gw = spec.depth_multiple, spec.width_multiple
        w = lambda n: make_divisible(n * gw, 8)  # noqa: E731
        d = lambda n: max(round(n * gd), 1) if n > 1 else n  # noqa: E731
        _, in_p4, _ = (w(c) for c in spec.neck_in_channels)
        out_p3, out_p4, out_p5 = (w(c) for c in spec.neck_out_channels)
        c_p3, c_p4, c_p5 = in_ch
        conv_act, c_act = _act_names(spec.neck_act)

        self.C1 = C2f(c_p5 + c_p4, in_p4, d(3), False, act=c_act)
        self.C2 = C2f(in_p4 + c_p3, out_p3, d(3), False, act=c_act)
        self.conv3 = Conv(out_p3, out_p3, 3, 2, act=conv_act)
        self.C3 = C2f(out_p3 + in_p4, out_p4, d(3), False, act=c_act)
        self.conv4 = Conv(out_p4, out_p4, 3, 2, act=conv_act)
        self.C4 = C2f(out_p4 + c_p5, out_p5, d(3), False, act=c_act)
        self.out_channels = (out_p3, out_p4, out_p5)

    def forward(self, inputs):
        p3, p4, p5 = inputs
        x1 = self.C1(torch.cat([upsample2x(p5), p4], 1))
        x2 = self.C2(torch.cat([upsample2x(x1), p3], 1))
        x3 = self.C3(torch.cat([self.conv3(x2), x1], 1))
        x4 = self.C4(torch.cat([self.conv4(x3), p5], 1))
        return x2, x3, x4

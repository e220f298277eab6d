"""YOLOv5 PAN neck (counterpart of
`efficientteacher_tpu/models/necks/yolov5.py`).

Parity with reference models/neck/yolov5_neck.py:6-109: top-down FPN
(1x1 conv + nearest 2x upsample + concat + C3) followed by bottom-up PAN
(3x3/2 conv + concat + C3). Channel scaling via width_multiple
(reference yolov5_neck.py:78-86).
"""

from __future__ import annotations

import torch
from torch import nn

from ..common import C3, Conv, make_divisible, upsample2x
from ..spec import ModelSpec


def _act_names(activation: str):
    if activation == "SiLU":
        return "silu", "silu"
    if activation == "ReLU":
        return "relu", "relu"
    return "hard_swish", "relu_hswish"


class YoloV5Neck(nn.Module):
    def __init__(self, spec: ModelSpec, in_ch):
        """`in_ch`: channels of the backbone's (P3, P4, P5) outputs."""
        super().__init__()
        gd, gw = spec.depth_multiple, spec.width_multiple
        w = lambda n: make_divisible(n * gw, 8)  # noqa: E731
        d = lambda n: max(round(n * gd), 1) if n > 1 else n  # noqa: E731
        in_p3, in_p4, in_p5 = (w(c) for c in spec.neck_in_channels)
        out_p3, out_p4, out_p5 = (w(c) for c in spec.neck_out_channels)
        c_p3, c_p4, c_p5 = in_ch
        conv_act, c_act = _act_names(spec.neck_act)

        self.conv1 = Conv(c_p5, in_p5 // 2, 1, 1, act=conv_act)
        self.C1 = C3(in_p5 // 2 + c_p4, in_p4, d(3), False, act=c_act)
        self.conv2 = Conv(in_p4, in_p3, 1, 1, act=conv_act)
        self.C2 = C3(in_p3 + c_p3, out_p3, d(3), False, act=c_act)
        self.conv3 = Conv(out_p3, out_p3, 3, 2, act=conv_act)
        self.C3 = C3(out_p3 + in_p3, out_p4, d(3), False, act=c_act)
        self.conv4 = Conv(out_p4, out_p4, 3, 2, act=conv_act)
        self.C4 = C3(out_p4 + in_p5 // 2, out_p5, d(3), False, act=c_act)
        self.out_channels = (out_p3, out_p4, out_p5)

    def forward(self, inputs):
        p3, p4, p5 = inputs
        xp1 = self.conv1(p5)
        x1 = self.C1(torch.cat([upsample2x(xp1), p4], 1))
        xp2 = self.conv2(x1)
        x2 = self.C2(torch.cat([upsample2x(xp2), p3], 1))
        x3 = self.C3(torch.cat([self.conv3(x2), xp2], 1))
        x4 = self.C4(torch.cat([self.conv4(x3), xp1], 1))
        return x2, x3, x4

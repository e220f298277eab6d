"""YOLOv5 CSPDarknet backbone (counterpart of
`efficientteacher_tpu/models/backbones/yolov5.py`).

Architecture parity with reference models/backbone/yolov5_backbone.py:26-98:
6x6/2 stem -> 4 stages of (3x3/2 Conv + C3) -> SPPF, returning (C3, C4, C5)
at strides 8/16/32. Channel/depth scaling via width_multiple/depth_multiple
with make_divisible(...,8) (reference yolov5_backbone.py:90-98).
"""

from __future__ import annotations

from torch import nn

from ..common import C3, SPPF, Conv, make_divisible
from ..spec import ModelSpec


def _act_names(activation: str):
    if activation == "SiLU":
        return "silu", "silu"
    if activation == "ReLU":
        return "relu", "relu"
    return "hard_swish", "relu_hswish"


class YoloV5BackBone(nn.Module):
    def __init__(self, spec: ModelSpec):
        super().__init__()
        gd, gw = spec.depth_multiple, spec.width_multiple
        w = lambda n: make_divisible(n * gw, 8)  # noqa: E731
        d = lambda n: max(round(n * gd), 1) if n > 1 else n  # noqa: E731
        conv_act, c_act = _act_names(spec.backbone_act)

        self.stage1 = Conv(spec.ch, w(64), 6, 2, 2, act=conv_act)
        self.stage2_1 = Conv(w(64), w(128), 3, 2, act=conv_act)
        self.stage2_2 = C3(w(128), w(128), d(3), True, act=c_act)
        self.stage3_1 = Conv(w(128), w(256), 3, 2, act=conv_act)
        self.stage3_2 = C3(w(256), w(256), d(6), True, act=c_act)
        self.stage4_1 = Conv(w(256), w(512), 3, 2, act=conv_act)
        self.stage4_2 = C3(w(512), w(512), d(9), True, act=c_act)
        self.stage5_1 = Conv(w(512), w(1024), 3, 2, act=conv_act)
        self.stage5_2 = C3(w(1024), w(1024), d(3), True, act=c_act)
        self.sppf = SPPF(w(1024), w(1024), 5, act=conv_act)
        self.out_channels = (w(256), w(512), w(1024))

    def forward(self, x):
        x = self.stage2_2(self.stage2_1(self.stage1(x)))
        c3 = self.stage3_2(self.stage3_1(x))
        c4 = self.stage4_2(self.stage4_1(c3))
        c5 = self.sppf(self.stage5_2(self.stage5_1(c4)))
        return c3, c4, c5

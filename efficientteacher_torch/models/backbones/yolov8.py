"""YOLOv8 C2f backbone (counterpart of
`efficientteacher_tpu/models/backbones/yolov8.py`).

Parity with reference models/backbone/yolov8_backbone.py:25-100: the v5
backbone's topology with C2f blocks (shortcut on) and a 768-channel top
stage, returning (C3, C4, C5) at strides 8/16/32.
"""

from __future__ import annotations

from torch import nn

from ..common import SPPF, C2f, Conv, make_divisible
from ..spec import ModelSpec


def _act_names(activation: str):
    if activation == "SiLU":
        return "silu", "silu"
    if activation == "ReLU":
        return "relu", "relu"
    return "hard_swish", "hard_swish"


class YoloV8BackBone(nn.Module):
    def __init__(self, spec: ModelSpec):
        super().__init__()
        gd, gw = spec.depth_multiple, spec.width_multiple
        w = lambda n: make_divisible(n * gw, 8)  # noqa: E731
        d = lambda n: max(round(n * gd), 1) if n > 1 else n  # noqa: E731
        conv_act, c_act = _act_names(spec.backbone_act)

        self.stage1 = Conv(spec.ch, w(64), 6, 2, 2, act=conv_act)
        self.stage2_1 = Conv(w(64), w(128), 3, 2, act=conv_act)
        self.stage2_2 = C2f(w(128), w(128), d(3), True, act=c_act)
        self.stage3_1 = Conv(w(128), w(256), 3, 2, act=conv_act)
        self.stage3_2 = C2f(w(256), w(256), d(6), True, act=c_act)
        self.stage4_1 = Conv(w(256), w(512), 3, 2, act=conv_act)
        self.stage4_2 = C2f(w(512), w(512), d(6), True, act=c_act)
        self.stage5_1 = Conv(w(512), w(768), 3, 2, act=conv_act)
        self.stage5_2 = C2f(w(768), w(768), d(3), True, act=c_act)
        self.sppf = SPPF(w(768), w(768), 5, act=conv_act)
        self.out_channels = (w(256), w(512), w(768))

    def forward(self, x):
        x = self.stage2_2(self.stage2_1(self.stage1(x)))
        c3 = self.stage3_2(self.stage3_1(x))
        c4 = self.stage4_2(self.stage4_1(c3))
        c5 = self.sppf(self.stage5_2(self.stage5_1(c4)))
        return c3, c4, c5

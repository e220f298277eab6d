"""YOLOv7 neck (counterpart of `efficientteacher_tpu/models/necks/yolov7.py`).

Parity with reference models/neck/yolov7_neck.py:6-142: SPPCSPC on P5,
top-down 1x1 reduce + nearest upsample + ELAN_NECK, bottom-up MP / conv
pair downsample concatenated three ways (with the skip), and a RepConv
3x3 on each output. The module names are the reference's layer numbers
(`conv10`, `conv19`, ...).
"""

from __future__ import annotations

import torch
from torch import nn

from ..backbones.yolov7 import v7_act
from ..common import (SPPCSPC, Conv, ELANNeck, RepVGGBlock, make_divisible,
                      max_pool_2x, upsample2x)
from ..spec import ModelSpec


class YoloV7Neck(nn.Module):
    def __init__(self, spec: ModelSpec, in_ch):
        """`in_ch`: channels of the backbone's (P3, P4, P5) outputs."""
        super().__init__()
        w = lambda n: make_divisible(n * spec.width_multiple, 8)  # noqa: E731
        _, _, in_p5 = (w(c) for c in spec.neck_in_channels)
        out_p3, out_p4, out_p5 = (w(c) for c in spec.neck_out_channels)
        act = v7_act(spec.neck_act)
        c0, c1, c2 = in_p5 // 2, in_p5 // 4, in_p5 // 8
        ch3, ch4, ch5 = in_ch
        self.sppcspc = SPPCSPC(ch5, c0, act=act)
        self.conv1 = Conv(c0, c1, 1, 1, act=act)
        self.conv2 = Conv(ch4, c1, 1, 1, act=act)
        self.elan_0 = ELANNeck(2 * c1, c1, 3, 0.5, 0.5, act=act)
        self.conv10 = Conv(c1, c2, 1, 1, act=act)
        self.conv11 = Conv(ch3, c2, 1, 1, act=act)
        self.elan_1 = ELANNeck(2 * c2, c2, 3, 0.5, 0.5, act=act)
        self.conv19 = Conv(c2, c2, 1, 1, act=act)
        self.conv20 = Conv(c2, c2, 1, 1, act=act)
        self.conv21 = Conv(c2, c2, 3, 2, act=act)
        self.elan_2 = ELANNeck(2 * c2 + c1, c1, 3, 0.5, 0.5, act=act)
        self.conv29 = Conv(c1, c1, 1, 1, act=act)
        self.conv30 = Conv(c1, c1, 1, 1, act=act)
        self.conv31 = Conv(c1, c1, 3, 2, act=act)
        self.elan_3 = ELANNeck(2 * c1 + c0, c0, 3, 0.5, 0.5, act=act)
        # the reference's RepConv: the RepVGG block with the neck's act
        self.repconv0 = RepVGGBlock(c2, out_p3, act=act, deploy=spec.deploy)
        self.repconv1 = RepVGGBlock(c1, out_p4, act=act, deploy=spec.deploy)
        self.repconv2 = RepVGGBlock(c0, out_p5, act=act, deploy=spec.deploy)
        self.out_channels = (out_p3, out_p4, out_p5)

    def forward(self, inputs):
        p3, p4, p5 = inputs
        x0 = self.sppcspc(p5)
        x12 = self.elan_0(torch.cat([self.conv2(p4),
                                     upsample2x(self.conv1(x0))], 1))
        x24 = self.elan_1(torch.cat([self.conv11(p3),
                                     upsample2x(self.conv10(x12))], 1))
        x29 = torch.cat([self.conv21(self.conv20(x24)),
                         self.conv19(max_pool_2x(x24)), x12], 1)
        x37 = self.elan_2(x29)
        x42 = torch.cat([self.conv31(self.conv30(x37)),
                         self.conv29(max_pool_2x(x37)), x0], 1)
        x50 = self.elan_3(x42)
        return self.repconv0(x24), self.repconv1(x37), self.repconv2(x50)

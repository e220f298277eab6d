"""YOLOv6 RepPAN neck (counterpart of
`efficientteacher_tpu/models/necks/yolov6.py`).

Parity with reference models/neck/yolov6_neck.py:8-142: SimConv reduce and
ConvTranspose upsample top-down, stride-2 SimConv bottom-up, RepBlock
stages (the reference's SimConv is `Conv` with ReLU). Channels index the concatenated list Backbone.out_channels +
Neck.out_channels (:26-27), as the JAX neck reads it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..common import Conv, RepBlock, Transpose, make_divisible
from ..spec import ModelSpec


class YoloV6Neck(nn.Module):
    def __init__(self, spec: ModelSpec, in_ch):
        """`in_ch`: channels of the backbone's (P3, P4, P5) outputs."""
        super().__init__()
        w = lambda n: make_divisible(n * spec.width_multiple, 8)  # noqa: E731
        d = lambda n: (max(round(n * spec.depth_multiple), 1)  # noqa: E731
                       if n > 1 else n)
        cl = [w(c) for c in spec.backbone_out_channels + spec.neck_out_channels]
        reps = [d(n) for n in spec.depth_num_repeats + spec.neck_num_repeats]
        rep = dict(deploy=spec.deploy, block_type=spec.vgg_block_type)
        c_x2, c_x1, c_x0 = in_ch
        self.reduce_layer0 = Conv(c_x0, cl[6], 1, 1, act="relu")
        self.upsample0 = Transpose(cl[6], cl[6])
        self.Rep_p4 = RepBlock(cl[6] + c_x1, cl[6], reps[5], **rep)
        self.reduce_layer1 = Conv(cl[6], cl[5], 1, 1, act="relu")
        self.upsample1 = Transpose(cl[5], cl[5])
        self.Rep_p3 = RepBlock(cl[5] + c_x2, cl[5], reps[6], **rep)
        self.downsample2 = Conv(cl[5], cl[5], 3, 2, act="relu")
        self.Rep_n3 = RepBlock(2 * cl[5], cl[6], reps[7], **rep)
        self.downsample1 = Conv(cl[6], cl[6], 3, 2, act="relu")
        self.Rep_n4 = RepBlock(2 * cl[6], cl[7], reps[8], **rep)
        self.out_channels = (cl[5], cl[6], cl[7])

    def forward(self, inputs):
        x2, x1, x0 = inputs
        fpn_out0 = self.reduce_layer0(x0)
        f_out0 = self.Rep_p4(torch.cat([self.upsample0(fpn_out0), x1], 1))
        fpn_out1 = self.reduce_layer1(f_out0)
        pan_out2 = self.Rep_p3(torch.cat([self.upsample1(fpn_out1), x2], 1))
        pan_out1 = self.Rep_n3(torch.cat([self.downsample2(pan_out2),
                                          fpn_out1], 1))
        pan_out0 = self.Rep_n4(torch.cat([self.downsample1(pan_out1),
                                          fpn_out0], 1))
        return pan_out2, pan_out1, pan_out0

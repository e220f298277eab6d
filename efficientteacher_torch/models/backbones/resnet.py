"""ResNet-50 backbone (counterpart of
`efficientteacher_tpu/models/backbones/resnet.py`).

Parity with reference models/backbone/resnet.py:230: the torchvision-style
bottleneck ResNet, a 7x7/2 stem and a 3x3/2 max pool, then four stages of
3, 4, 6 and 3 bottlenecks, returning C3 / C4 / C5 (512, 1024, 2048
channels) at strides 8/16/32. Its BatchNorms are torchvision's, eps 1e-5,
momentum 0.1 (flax 0.9), not the YOLO blocks' 1e-3 / 0.03; ReLU
throughout; no width or depth multiple. The bottlenecks are `layer{i}`
lists, so JAX's `layer1_0` is `layer1.0`.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..common import BatchNorm2d, strided_1x1_input
from ..spec import ModelSpec


class _BNConv(nn.Module):
    """Conv (no bias, padding k // 2) + BN (+ ReLU)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, bias=False)
        self.bn = BatchNorm2d(c2, eps=1e-5, momentum=0.1)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class BottleneckRes(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 x4 channels, plus the identity or a
    strided 1x1 downsample, then ReLU."""

    def __init__(self, c1: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _BNConv(c1, planes, 1, 1)
        self.conv2 = _BNConv(planes, planes, 3, stride)
        self.conv3 = _BNConv(planes, planes * 4, 1, 1, act=False)
        if downsample:
            self.downsample = _BNConv(c1, planes * 4, 1, stride, act=False)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        if hasattr(self, "downsample"):
            x = self.downsample(strided_1x1_input(x, self.downsample.conv))
        return F.relu(y + x)


class ResNet50BackBone(nn.Module):
    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.stem = _BNConv(spec.ch, 64, 7, 2)
        c1 = 64
        for li, (planes, blocks, stride) in enumerate(
                [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]):
            layer = []
            for bi in range(blocks):
                layer.append(BottleneckRes(c1, planes,
                                           stride if bi == 0 else 1,
                                           downsample=bi == 0))
                c1 = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
        self.out_channels = (512, 1024, 2048)

    def forward(self, x):
        x = F.max_pool2d(self.stem(x), 3, 2, 1)
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        return c3, c4, self.layer4(c4)

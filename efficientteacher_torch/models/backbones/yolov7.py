"""YOLOv7 ELAN backbone (counterpart of
`efficientteacher_tpu/models/backbones/yolov7.py`).

Parity with reference models/backbone/yolov7_backbone.py:31-87: two
PreConv stem stages, then four ELAN stages (the first without the MP/AUG
downsample), returning the last three at strides 8/16/32.
"""

from __future__ import annotations

from torch import nn

from ..common import ELAN, PreConv, make_divisible
from ..spec import ModelSpec


def v7_act(name: str) -> str:
    """The YOLOv7 modules' activation by config name (JAX `_act`)."""
    return {"SiLU": "silu", "ReLU": "relu", "LeakyReLU": "lrelu"}.get(
        name, "hard_swish")


class YoloV7BackBone(nn.Module):
    def __init__(self, spec: ModelSpec):
        super().__init__()
        w = lambda n: make_divisible(n * spec.width_multiple, 8)  # noqa: E731
        d = lambda n: (max(round(n * spec.depth_multiple), 1)  # noqa: E731
                       if n > 1 else n)
        act = v7_act(spec.backbone_act)
        self.stage0 = PreConv(spec.ch, w(64), 0.5, True, act=act)
        self.stage1 = PreConv(w(64), w(128), 0.5, True, act=act)
        self.elan_0 = ELAN(w(128), w(256), d(2), 0.5, with_mp=False,
                           with_aug=False, act=act)
        self.elan_1 = ELAN(w(256), w(512), d(2), 0.5, act=act)
        self.elan_2 = ELAN(w(512), w(1024), d(2), 0.5, act=act)
        self.elan_3 = ELAN(w(1024), w(1024), d(2), 0.25, act=act)
        self.out_channels = (w(512), w(1024), w(1024))

    def forward(self, x):
        x = self.elan_0(self.stage1(self.stage0(x)))
        c3 = self.elan_1(x)
        c4 = self.elan_2(c3)
        return c3, c4, self.elan_3(c4)

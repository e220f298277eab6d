"""YOLOv6 EfficientRep backbone (counterpart of
`efficientteacher_tpu/models/backbones/yolov6.py`).

Parity with reference models/backbone/yolov6_backbone.py:6-124: a
stride-2 rep-style stem, then four stages `ERBlock_{2..5}` of a stride-2
block and a `RepBlock` (the last with a `SimSPPF`), returning the last
three stages at strides 8/16/32. The block type follows the config's
RealVGGModel / LinearAddModel / QARepVGGModel switch
(`spec.vgg_block_type`); `spec.deploy` builds the fused RepVGG form.
The stages are `nn.Sequential`s named as the reference's literal
`ERBlock_{i}` attributes, so JAX's `ERBlock_2_0` is `ERBlock_2.0`.
"""

from __future__ import annotations

from torch import nn

from ..common import SPPF, VGG_BLOCKS, RepBlock, make_divisible
from ..spec import ModelSpec


class YoloV6BackBone(nn.Module):
    def __init__(self, spec: ModelSpec):
        super().__init__()
        w = lambda n: make_divisible(n * spec.width_multiple, 8)  # noqa: E731
        d = lambda n: (max(round(n * spec.depth_multiple), 1)  # noqa: E731
                       if n > 1 else n)
        ch = [w(c) for c in spec.backbone_out_channels]
        reps = [d(n) for n in spec.depth_num_repeats]
        block = VGG_BLOCKS[spec.vgg_block_type]
        kw = dict(deploy=spec.deploy)
        self.stem = block(spec.ch, ch[0], s=2, **kw)
        for i in range(1, 5):
            stage = [block(ch[i - 1], ch[i], s=2, **kw),
                     RepBlock(ch[i], ch[i], reps[i],
                              block_type=spec.vgg_block_type, **kw)]
            if i == 4:
                stage.append(SPPF(ch[i], ch[i], 5, act="relu"))  # SimSPPF
            setattr(self, f"ERBlock_{i + 1}", nn.Sequential(*stage))
        self.out_channels = tuple(ch[2:])

    def forward(self, x):
        x = self.ERBlock_2(self.stem(x))
        c3 = self.ERBlock_3(x)
        c4 = self.ERBlock_4(c3)
        return c3, c4, self.ERBlock_5(c4)

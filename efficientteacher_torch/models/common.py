"""Shared building blocks of the ported models, as torch modules (NCHW).

Counterparts of `efficientteacher_tpu/models/common.py` (reference:
models/backbone/common.py — Conv:471, Bottleneck:534, C3:566, C2f:594,
SPPF:682, RepVGGBlock:1002, Transpose:1159, MP:1191, SPPCSPC:1199,
ImplicitA/M:1482/1495, AUG:1507, ELAN:1523, PreConv:1557, ELAN_NECK:1576,
RealVGGBlock:1612, LinearAddBlock:1650). The blocks of the ported
families: YOLOv5, YOLOX, YOLOv8, YOLOv7 and YOLOv6. The reference's
SimConv and SimSPPF are `ConvBase` and `SPPF` with `act="relu"`, and
YOLOv7's RepConv is `RepVGGBlock` with the configured activation.

  - Submodule names follow the reference state_dict (`conv`, `bn`, `cv1`,
    `m.0`, ...), so a checkpoint exported from the JAX package
    (`utils/jax_import.py`) loads with `strict=True`.
  - BatchNorm uses the reference's overrides eps 1e-3 and momentum 0.03
    (utils/torch_utils.py:167-169; JAX common.py:85-86), and in train mode
    updates its running variance with the biased batch variance, as flax
    does (`BatchNorm2d` below).
  - Torch modules need their input channels up front, where Flax infers
    them; every block takes `c1`.
  - The pools are `F.max_pool2d` (SPPF and SPPCSPC `(k, 1, k // 2)`, the
    YOLOv7 MP `(2, 2)`). The JAX package's custom-VJP pools (`ops/pool.py`)
    exist only for GSPMD spatial sharding and are not ported; they split a
    window's gradient among tied maxima, where `F.max_pool2d` gives it to
    one (the same wherever the ties are ReLU zeros, ReLU'(0) = 0).
  - A `ConvTranspose2d` weight is (in, out, kh, kw) and flax's
    `nn.ConvTranspose` kernel (kh, kw, in, out) unflipped: the bridge flips
    it (`utils/jax_import.py`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.distributed import world_size


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round a channel count up to a multiple (reference
    utils/general.py:470)."""
    return int(math.ceil(x / divisor) * divisor)


def autopad(k: int, p: int | None = None) -> int:
    return k // 2 if p is None else p


def get_activation(name) -> nn.Module:
    """Activation registry (reference common.py get_activation)."""
    if name in (True, "silu", "swish"):
        return nn.SiLU()
    table = {
        "relu": nn.ReLU,
        "lrelu": lambda: nn.LeakyReLU(0.1),
        "relu6": nn.ReLU6,
        "hard_swish": nn.Hardswish,
        "hard_sigmoid": nn.Hardsigmoid,
        "sigmoid": nn.Sigmoid,
        "identity": nn.Identity,
        False: nn.Identity,
        None: nn.Identity,
    }
    if name not in table:
        raise KeyError(f"unsupported activation: {name!r}")
    return table[name]()


def split_c3_act(act):
    """C3-style paired activations, e.g. 'relu_hswish' = inner relu, final
    hard_swish (reference common.py:573-584)."""
    pairs = {
        "relu_silu": ("relu", "silu"),
        "relu_lrelu": ("relu", "lrelu"),
        "relu_hswish": ("relu", "hard_swish"),
    }
    return pairs.get(act, (act, act))


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train-mode running-variance update uses the
    biased batch variance, as flax's `nn.BatchNorm` does (JAX
    common.py:101-105); PyTorch's uses the unbiased one, n/(n-1) larger
    (14% at n = 8, a 2x2 map of a batch of 2). Both normalize with the
    biased statistics, so outputs are unchanged.

    PyTorch's update `(1-m) r + m v n/(n-1)` is made on a copy of the
    running variance scaled by n/(n-1) (the copy is the tensor autograd
    saves), which gives `((1-m) r0 + m v) n/(n-1)`; one multiply by
    (n-1)/n writes that back into the buffer. Two per-channel ops, no
    second pass over the activations. `momentum=None` (the cumulative
    average of `utils/eval_regimes.calibrate_bn`) uses m = 1 /
    num_batches_tracked, as PyTorch does."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        m = (self.momentum if self.momentum is not None
             else 1.0 / float(self.num_batches_tracked))
        if world_size() > 1:
            return self._synced(x, m)
        n = x.numel() // x.shape[1]
        var = self.running_var * (n / (n - 1))
        out = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                           True, m, self.eps)
        torch.mul(var, (n - 1) / n, out=self.running_var)
        return out

    def _synced(self, x, m: float):
        """Train mode under DDP with more than one rank: the global batch's
        statistics, as JAX's BatchNorm always reduces over the global
        batch (`efficientteacher_tpu/parallel/mesh.py:9-11`). Mean, then
        the biased variance about it, each summed over the ranks by an
        all-reduce that autograd passes back (every rank holds as many
        images), in float32; the running statistics take the biased
        variance, as above."""
        from torch.distributed.nn.functional import all_reduce

        xf = x.float()
        n = xf.numel() // xf.shape[1] * world_size()
        mean = all_reduce(xf.sum((0, 2, 3))) / n
        d = xf - mean[None, :, None, None]
        var = all_reduce((d * d).sum((0, 2, 3))) / n
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        scale = self.weight * torch.rsqrt(var + self.eps)
        out = d * scale[None, :, None, None] + self.bias[None, :, None, None]
        return out.to(x.dtype)


class ConvBase(nn.Module):
    """Conv2d + BatchNorm + activation (reference Conv, common.py:471)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 p: int | None = None, g: int = 1, act="silu"):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p), groups=g,
                              bias=False)
        self.bn = BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = get_activation(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


# The reference names this block `Conv`.
Conv = ConvBase


class Bottleneck(nn.Module):
    """Standard residual bottleneck (reference common.py:534)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k=(1, 3), e: float = 0.5, act="silu"):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBase(c1, c_, k[0], 1, act=act)
        self.cv2 = ConvBase(c_, c2, k[1], 1, g=g, act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs (reference common.py:566)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5, act="silu"):
        super().__init__()
        inner_act, last_act = split_c3_act(act)
        c_ = int(c2 * e)
        self.cv1 = ConvBase(c1, c_, 1, 1, act=inner_act)
        self.cv2 = ConvBase(c1, c_, 1, 1, act=inner_act)
        self.cv3 = ConvBase(2 * c_, c2, 1, 1, act=last_act)
        self.m = nn.Sequential(*(
            Bottleneck(c_, c_, shortcut, g, e=1.0, act=inner_act)
            for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C2f(nn.Module):
    """CSP bottleneck with 2 convs, YOLOv8's (reference common.py:594):
    cv1 to 2c channels, split in halves, n 3x3-3x3 bottlenecks chained on
    the second half, every piece concatenated into cv2."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 g: int = 1, e: float = 0.5, act="silu"):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = ConvBase(c1, 2 * self.c, 1, 1, act=act)
        self.cv2 = ConvBase((2 + n) * self.c, c2, 1, 1, act=act)
        self.m = nn.ModuleList(
            Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0, act=act)
            for _ in range(n))

    def forward(self, x):
        ys = list(self.cv1(x).split(self.c, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling - fast (reference common.py:682)."""

    def __init__(self, c1: int, c2: int, k: int = 5, act="silu"):
        super().__init__()
        inner_act, last_act = split_c3_act(act)
        c_ = c1 // 2
        self.k = k
        self.cv1 = ConvBase(c1, c_, 1, 1, act=inner_act)
        self.cv2 = ConvBase(4 * c_, c2, 1, 1, act=last_act)

    def forward(self, x):
        x = self.cv1(x)
        y1 = F.max_pool2d(x, self.k, 1, self.k // 2)
        y2 = F.max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = F.max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None):
    """Flax's default conv kernel init (variance 1/fan_in, truncated at two
    standard deviations), so a seeded port model has the JAX package's
    weight statistics — and with them its candidate density at eval."""
    fan_in = weight[0].numel()
    # 0.8796... = std of a unit normal truncated to [-2, 2] (flax's
    # variance_scaling correction)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool (reference MP, common.py:1191)."""
    return F.max_pool2d(x, 2, 2)


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-3, momentum=0.03)


def strided_1x1_input(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """The input of a strided 1x1 branch: PyTorch's CPU backward of a 1x1
    conv with stride 2 on a channels-last input corrupts the heap (torch
    2.13.0+cpu; stride 1 and 3x3 are fine), so on the CPU such an input is
    made contiguous first. The values are the same; CUDA inputs pass."""
    if x.device.type == "cpu" and conv.stride != (1, 1):
        return x.contiguous()
    return x


class RepVGGBlock(nn.Module):
    """RepVGG training-time block: 3x3 + 1x1 + identity-BN branches, the
    identity only where c1 == c2 and s == 1 (reference common.py:1002).
    With `deploy` it is the single biased 3x3 conv `rbr_reparam` that
    `utils/reparam.py` fuses the branches into."""

    def __init__(self, c1: int, c2: int, s: int = 1, act="relu",
                 deploy: bool = False):
        super().__init__()
        self.act = get_activation(act)
        if deploy:
            self.rbr_reparam = nn.Conv2d(c1, c2, 3, s, 1, bias=True)
            nn.init.zeros_(self.rbr_reparam.bias)
            return
        self.rbr_dense_conv = nn.Conv2d(c1, c2, 3, s, 1, bias=False)
        self.rbr_dense_bn = _bn(c2)
        self.rbr_1x1_conv = nn.Conv2d(c1, c2, 1, s, 0, bias=False)
        self.rbr_1x1_bn = _bn(c2)
        self.rbr_identity = _bn(c1) if c1 == c2 and s == 1 else None

    def forward(self, x):
        if hasattr(self, "rbr_reparam"):
            return self.act(self.rbr_reparam(x))
        one = self.rbr_1x1_conv(strided_1x1_input(x, self.rbr_1x1_conv))
        y = self.rbr_dense_bn(self.rbr_dense_conv(x)) + self.rbr_1x1_bn(one)
        if self.rbr_identity is not None:
            y = y + self.rbr_identity(x)
        return self.act(y)


class RealVGGBlock(nn.Module):
    """Plain conv3x3 + BN + ReLU, the RepOpt target topology (reference
    common.py:1612), trained with `train/repopt.py`'s gradient masks.
    `deploy` is accepted and unused: it has one branch already."""

    def __init__(self, c1: int, c2: int, s: int = 1, act="relu",
                 deploy: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, 3, s, 1, bias=False)
        self.bn = _bn(c2)
        self.act = get_activation(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class LinearAddBlock(nn.Module):
    """CSLA / RepScale block (reference common.py:1650): scale_conv *
    conv3x3 + scale_1x1 * conv1x1 (+ scale_identity * x where c1 == c2 and
    s == 1), then BN + ReLU. The per-channel scales are direct 1-D
    parameters of the block, initialised to 1; RepOpt reads them
    (`train/repopt.py`). `deploy` is accepted and unused."""

    def __init__(self, c1: int, c2: int, s: int = 1, act="relu",
                 deploy: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, 3, s, 1, bias=False)
        self.scale_conv = nn.Parameter(torch.ones(c2))
        self.conv_1x1 = nn.Conv2d(c1, c2, 1, s, 0, bias=False)
        self.scale_1x1 = nn.Parameter(torch.ones(c2))
        self.scale_identity = (nn.Parameter(torch.ones(c2))
                               if c1 == c2 and s == 1 else None)
        self.bn = _bn(c2)
        self.act = get_activation(act)

    def forward(self, x):
        def ch(v):
            return v.view(1, -1, 1, 1)

        y = self.conv(x) * ch(self.scale_conv)
        y = y + self.conv_1x1(strided_1x1_input(x, self.conv_1x1)) \
            * ch(self.scale_1x1)
        if self.scale_identity is not None:
            y = y + x * ch(self.scale_identity)
        return self.act(self.bn(y))


VGG_BLOCKS = {
    "repvgg": RepVGGBlock,
    "realvgg": RealVGGBlock,
    "linearadd": LinearAddBlock,
    # QARepVGG shares the RepVGG train topology (JAX common.py:835-842)
    "qarep": RepVGGBlock,
}


class RepBlock(nn.Module):
    """A YOLOv6 EfficientRep stage: `conv1` then n - 1 `block`s of the
    `block_type` (reference yolov6_backbone.py:29-36)."""

    def __init__(self, c1: int, c2: int, n: int = 1, act="relu",
                 deploy: bool = False, block_type: str = "repvgg"):
        super().__init__()
        block = VGG_BLOCKS[block_type]
        self.conv1 = block(c1, c2, act=act, deploy=deploy)
        self.block = nn.Sequential(*(block(c2, c2, act=act, deploy=deploy)
                                     for _ in range(n - 1)))

    def forward(self, x):
        return self.block(self.conv1(x))


class Transpose(nn.Module):
    """ConvTranspose 2x upsample, k 2 s 2, biased (reference
    common.py:1159)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.upsample_transpose = nn.ConvTranspose2d(c1, c2, 2, 2, bias=True)
        nn.init.zeros_(self.upsample_transpose.bias)

    def forward(self, x):
        return self.upsample_transpose(x)


class ImplicitA(nn.Module):
    """Learned additive (1, C, 1, 1) token (YOLOv7 IDetect, reference
    common.py:1482); `build_model` draws it N(0, 0.02)."""

    def __init__(self, channels: int):
        super().__init__()
        self.implicit = nn.Parameter(torch.zeros(1, channels, 1, 1))

    def forward(self, x):
        return x + self.implicit.to(x.dtype)


class ImplicitM(nn.Module):
    """Learned multiplicative (1, C, 1, 1) token (reference
    common.py:1495); `build_model` draws it N(1, 0.02)."""

    def __init__(self, channels: int):
        super().__init__()
        self.implicit = nn.Parameter(torch.ones(1, channels, 1, 1))

    def forward(self, x):
        return x * self.implicit.to(x.dtype)


class AUG(nn.Module):
    """YOLOv7 downsample merge (reference common.py:1507):
    concat(conv3x3/2(conv1x1(x)), conv1x1(maxpool(x)))."""

    def __init__(self, c1: int, c2: int, act="silu"):
        super().__init__()
        self.cv0 = ConvBase(c1, c2, 1, 1, act=act)
        self.cv1 = ConvBase(c1, c2, 1, 1, act=act)
        self.cv2 = ConvBase(c2, c2, 3, 2, act=act)

    def forward(self, mp_x, x):
        return torch.cat([self.cv2(self.cv1(x)), self.cv0(mp_x)], 1)


class PreConv(nn.Module):
    """YOLOv7 stem stage (reference common.py:1557): an optional 3x3 conv
    to c2 * e, then a 3x3/2 conv to c2."""

    def __init__(self, c1: int, c2: int, e: float = 0.5,
                 with_aug: bool = True, act="silu"):
        super().__init__()
        if with_aug:
            c_ = int(c2 * e)
            self.cv0 = ConvBase(c1, c_, 3, 1, act=act)
            c1 = c_
        self.cv1 = ConvBase(c1, c2, 3, 2, act=act)

    def forward(self, x):
        if hasattr(self, "cv0"):
            x = self.cv0(x)
        return self.cv1(x)


class ELAN(nn.Module):
    """YOLOv7 backbone ELAN stage (reference common.py:1523): an optional
    MP (+ AUG) downsample, two 1x1 branches, two n-deep 3x3 chains, a
    4-way concat and a 1x1 merge. `c_` follows the input's channels."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5,
                 with_mp: bool = True, with_aug: bool = True, act="silu"):
        super().__init__()
        c_ = int(c1 * e)
        self.with_mp = with_mp
        if with_mp and with_aug:
            self.aug = AUG(c1, int(c1 * 0.5), act=act)
            c1 = 2 * int(c1 * 0.5)
        self.cv0 = ConvBase(c1, c_, 1, 1, act=act)
        self.cv1 = ConvBase(c1, c_, 1, 1, act=act)
        self.m0 = nn.Sequential(*(ConvBase(c_, c_, 3, 1, act=act)
                                  for _ in range(n)))
        self.m1 = nn.Sequential(*(ConvBase(c_, c_, 3, 1, act=act)
                                  for _ in range(n)))
        self.cv2 = ConvBase(4 * c_, c2, 1, 1, act=act)

    def forward(self, x):
        if hasattr(self, "aug"):
            x = self.aug(max_pool_2x(x), x)
        elif self.with_mp:
            x = max_pool_2x(x)
        x0 = self.cv0(x)
        x1 = self.cv1(x)
        x2 = self.m0(x1)
        x3 = self.m1(x2)
        return self.cv2(torch.cat([x3, x2, x1, x0], 1))


class ELANNeck(nn.Module):
    """YOLOv7 neck ELAN block (reference ELAN_NECK, common.py:1576): two
    1x1 branches, a 3x3 chain of n + 1 convs at c_ * e_m, every output
    concatenated in reverse order, a 1x1 merge."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 0.5,
                 e_m: float = 0.5, act="silu"):
        super().__init__()
        c_ = int(c1 * e)
        c_m = int(c_ * e_m)
        self.n = n
        self.cv0 = ConvBase(c1, c_, 1, 1, act=act)
        self.cv1 = ConvBase(c1, c_, 1, 1, act=act)
        self.cv2 = ConvBase(c_, c_m, 3, 1, act=act)
        for i in range(n):
            setattr(self, f"m{i}", ConvBase(c_m, c_m, 3, 1, act=act))
        self.cv3 = ConvBase(2 * c_ + (n + 1) * c_m, c2, 1, 1, act=act)

    def forward(self, x):
        outs = [self.cv0(x), self.cv1(x)]
        x2 = self.cv2(outs[1])
        outs.append(x2)
        for i in range(self.n):
            x2 = getattr(self, f"m{i}")(x2)
            outs.append(x2)
        return self.cv3(torch.cat(outs[::-1], 1))


class SPPCSPC(nn.Module):
    """YOLOv7 CSP spatial pyramid pooling (reference common.py:1199)."""

    def __init__(self, c1: int, c2: int, k=(5, 9, 13), e: float = 0.5,
                 act="silu"):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.k = tuple(k)
        self.cv1 = ConvBase(c1, c_, 1, 1, act=act)
        self.cv2 = ConvBase(c1, c_, 1, 1, act=act)
        self.cv3 = ConvBase(c_, c_, 3, 1, act=act)
        self.cv4 = ConvBase(c_, c_, 1, 1, act=act)
        self.cv5 = ConvBase((1 + len(self.k)) * c_, c_, 1, 1, act=act)
        self.cv6 = ConvBase(c_, c_, 3, 1, act=act)
        self.cv7 = ConvBase(2 * c_, c2, 1, 1, act=act)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        ys = [x1] + [F.max_pool2d(x1, k, 1, k // 2) for k in self.k]
        y1 = self.cv6(self.cv5(torch.cat(ys, 1)))
        return self.cv7(torch.cat([y1, self.cv2(x)], 1))

"""Shared building blocks of the ported models, as torch modules (NCHW).

Counterparts of `efficientteacher_tpu/models/common.py` (reference:
models/backbone/common.py — Conv:471, Bottleneck:534, C3:566, C2f:594,
SPPF:682). Only the blocks of the ported families (YOLOv5, YOLOX, YOLOv8)
are here so far.

  - Submodule names follow the reference state_dict (`conv`, `bn`, `cv1`,
    `m.0`, ...), so a checkpoint exported from the JAX package
    (`utils/jax_import.py`) loads with `strict=True`.
  - BatchNorm uses the reference's overrides eps 1e-3 and momentum 0.03
    (utils/torch_utils.py:167-169; JAX common.py:85-86), and in train mode
    updates its running variance with the biased batch variance, as flax
    does (`BatchNorm2d` below).
  - Torch modules need their input channels up front, where Flax infers
    them; every block takes `c1`.
  - SPPF pools with `F.max_pool2d(k, 1, k // 2)`. The JAX package's
    custom-VJP pool (`ops/pool.py`) exists only for GSPMD spatial sharding
    and is not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


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
        n = x.numel() // x.shape[1]
        var = self.running_var * (n / (n - 1))
        out = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                           True, m, self.eps)
        torch.mul(var, (n - 1) / n, out=self.running_var)
        return out


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

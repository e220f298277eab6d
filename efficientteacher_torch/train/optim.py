"""Optimizer schedule and parameter groups (counterpart of
`efficientteacher_tpu/train/optim.py`; reference trainer/trainer.py:193-251):
  - three groups: `weight` (conv and linear kernels, weight-decayed), `bias`
    (every bias) and `bn` (BatchNorm scales and any other parameter, no
    decay) (trainer.py:200-214)
  - one-cycle cosine or linear epoch schedule (utils/general.py:480-482)
  - per-iteration warmup: the bias lr falls from warmup_bias_lr, the others
    rise from 0, momentum ramps warmup_momentum -> momentum
    (trainer.py:388-397)

The update itself (Nesterov SGD, torch semantics, or AdamW with
`adam=True`, fused with gradient accumulation and the EMA chain) is
`train_state.apply_gradients_accumulating`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
from torch import nn

GROUPS = ("weight", "bias", "bn")


def one_cycle(y1: float = 0.0, y2: float = 1.0, steps: int = 100):
    """Sinusoidal ramp y1 -> y2 (reference utils/general.py:480)."""
    return lambda x: ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1


def linear_lf(lrf: float, epochs: int):
    """Linear schedule (reference trainer.py:242)."""
    return lambda x: (1 - x / max(epochs - 1, 1)) * (1.0 - lrf) + lrf


def param_group_labels(model: nn.Module) -> List[str]:
    """The group of each of `model.parameters()`, in order. By module type,
    not by name: BatchNorm's scale is also called `weight` in PyTorch.
    Conv, transposed conv and Linear `weight` -> "weight"; any `bias` ->
    "bias"; everything else (BatchNorm scales, the implicit tokens, the
    LinearAdd scales) -> "bn" (JAX param_group_label: `kernel`, `bias`,
    the rest)."""
    label = {}
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if name == "bias":
                label[id(p)] = "bias"
            elif name == "weight" and isinstance(
                    mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                label[id(p)] = "weight"
            else:
                label[id(p)] = "bn"
    return [label[id(p)] for p in model.parameters()]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 0.0005  # already nominal-batch scaled by caller
    adam: bool = False
    warmup_epochs: float = 0.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    epochs: int = 300
    linear_lr: bool = False
    # SSOD multi-step schedule: lr x0.1 at each milestone epoch
    multi_step: bool = False
    milestones: Tuple[int, ...] = ()

    @classmethod
    def from_cfg(cls, cfg, scaled_weight_decay: float):
        """From any attribute tree with the config's layout."""
        return cls(
            lr0=float(cfg.hyp.lr0), lrf=float(cfg.hyp.lrf),
            momentum=float(cfg.hyp.momentum),
            weight_decay=scaled_weight_decay, adam=bool(cfg.adam),
            warmup_epochs=float(cfg.hyp.warmup_epochs),
            warmup_momentum=float(cfg.hyp.warmup_momentum),
            warmup_bias_lr=float(cfg.hyp.warmup_bias_lr),
            epochs=int(cfg.epochs), linear_lr=bool(cfg.linear_lr),
            multi_step=bool(cfg.SSOD.multi_step_lr),
            milestones=tuple(int(m) for m in cfg.SSOD.milestones))

    def lf(self, epoch: float) -> float:
        if self.multi_step:
            return 0.1 ** sum(epoch >= m for m in self.milestones)
        f = (linear_lf(self.lrf, self.epochs) if self.linear_lr
             else one_cycle(1.0, self.lrf, self.epochs))
        return f(epoch)

    def schedule(self, ni: int, epoch: float, nw: int) -> Dict[str, float]:
        """{lr_bias, lr_rest, momentum} for global iteration `ni` at
        fractional `epoch`, with `nw` warmup iterations."""
        base = self.lr0 * self.lf(epoch)
        if nw > 0 and ni <= nw:
            def ramp(start, end):
                return float(np.interp(ni, [0, nw], [start, end]))

            return {"lr_bias": ramp(self.warmup_bias_lr, base),
                    "lr_rest": ramp(0.0, base),
                    "momentum": ramp(self.warmup_momentum, self.momentum)}
        return {"lr_bias": base, "lr_rest": base, "momentum": self.momentum}

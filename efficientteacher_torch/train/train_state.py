"""Training state: the student model, the optimizer's buffers, gradient
accumulation and the EMA chain (counterpart of
`efficientteacher_tpu/train/train_state.py`; reference
utils/torch_utils.py:308-424 ModelEMA, SemiSupModelEMA, CosineEMA).

The JAX package keeps pytrees; here the student's parameters and BatchNorm
statistics live in its `nn.Module`, and each EMA is a float32 copy of that
module (eval mode, no gradients), so the teacher runs as the EMA module
itself. Updates are in place.

EMA semantics, as the JAX package's:
  - the EMA's decay ramps, d = decay * (1 - exp(-updates / 2000)), with
    `updates` counted on fired optimizer steps only (torch_utils.py:322-324)
  - it covers parameters and BatchNorm running statistics, not
    `num_batches_tracked` (torch_utils.py:334-338)
  - the semi-EMA (the SSOD teacher chain) blends the new EMA with a
    constant decay (torch_utils.py:366-372)
  - `cosine_ema_decay` is CosineEMA's per-epoch decay (torch_utils.py:404)

Counters are Python integers: whether a step fires is known on the host,
so a held step costs one accumulation and nothing else (the JAX package
selects with `where` instead, to keep one traced program).

The optimizer is Nesterov SGD, or AdamW with `adam=True` (JAX
optim.py:144-182, reference trainer.py:213): betas (momentum, 0.999),
eps 1e-8, bias correction by the count of fired steps, the decoupled decay
on the `weight` group only; `momentum_buf` then holds the first moment and
`second_moment` the second. Accumulation, warmup and the EMA chain are
SGD's.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..parallel.distributed import all_reduce_
from .optim import GROUPS, OptimizerConfig, param_group_labels


def bn_stats(module: nn.Module) -> List[torch.Tensor]:
    """Running mean and variance of every BatchNorm of `module`, in order."""
    out = []
    for m in module.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm) \
                and m.track_running_stats:
            out += [m.running_mean, m.running_var]
    return out


@dataclasses.dataclass
class EMAState:
    module: nn.Module  # float32, eval mode, requires no gradients
    updates: int = 0

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.module.parameters())

    @property
    def stats(self) -> List[torch.Tensor]:
        return bn_stats(self.module)


def init_ema(model: nn.Module) -> EMAState:
    """A float32 copy of `model` (never an alias of its tensors)."""
    module = copy.deepcopy(model).float().eval().requires_grad_(False)
    return EMAState(module)


def cosine_ema_decay(epoch: int, epochs: int, decay_start: float,
                     decay_end: float = 0.9999) -> float:
    """CosineEMA per-epoch decay (reference torch_utils.py:404-414)."""
    return decay_end + (decay_start - decay_end) * (
        1 + math.cos(math.pi * epoch / epochs)) / 2


@dataclasses.dataclass
class TrainState:
    model: nn.Module                 # the student: params + BN statistics
    groups: List[str]                # param_group_labels(model)
    momentum_buf: List[torch.Tensor]  # float32, one per parameter
    acc_grads: List[torch.Tensor]    # float32, one per parameter
    ema: Optional[EMAState]
    acc_count: int = 0   # micro-steps accumulated since the last fired step
    step: int = 0        # global iteration counter (ni)
    opt_step: int = 0    # fired optimizer steps
    # AdamW's second moment, float32, one per parameter (None under SGD)
    second_moment: Optional[List[torch.Tensor]] = None
    # the one buffer `acc_grads` are views of: the DDP all-reduce's
    acc_flat: Optional[torch.Tensor] = None

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())


def create_train_state(model: nn.Module, oc: OptimizerConfig,
                       with_ema: bool = True) -> TrainState:
    params = list(model.parameters())
    if any(p.dtype != torch.float32 for p in params):
        raise TypeError("the port trains float32 master weights; compute "
                        "in bf16 by autocast")
    zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
    acc_flat, acc_grads = _flat_views(params)
    return TrainState(model=model, groups=param_group_labels(model),
                      momentum_buf=zeros(), acc_grads=acc_grads,
                      ema=init_ema(model) if with_ema else None,
                      second_moment=zeros() if oc.adam else None,
                      acc_flat=acc_flat)


def _flat_views(params: List[torch.Tensor]):
    """One zeroed float32 buffer and, per parameter, a view of it with the
    parameter's shape and strides (channels-last kernels stay so)."""
    flat = torch.zeros(sum(p.numel() for p in params), dtype=torch.float32,
                       device=params[0].device)
    views, off = [], 0
    for p in params:
        views.append(flat.as_strided(p.shape, p.stride(), off))
        off += p.numel()
    return flat, views


def _blend_(dst: List[torch.Tensor], src: List[torch.Tensor], d) -> None:
    """dst = dst * d + (1 - d) * src, both factors rounded to float32 as
    the JAX package forms them."""
    d = np.float32(d)
    torch._foreach_mul_(dst, float(d))
    torch._foreach_add_(dst, src, alpha=float(np.float32(1.0) - d))


def _adamw_(p, g, m, v, lr: float, wd: float, b1: float, t: int) -> None:
    """One AdamW update of p, m and v in place, from the summed gradient
    g. The bias corrections are formed in float32, as JAX forms them."""
    b2, eps = 0.999, 1e-8
    f32 = np.float32
    bc1 = float(f32(1.0) - f32(b1) ** f32(t))
    bc2 = float(f32(1.0) - f32(b2) ** f32(t))
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1.0 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    step = torch._foreach_div(m, bc1)
    torch._foreach_div_(step, denom)
    if wd:
        torch._foreach_mul_(p, 1.0 - lr * wd)
    torch._foreach_add_(p, step, alpha=-lr)


@torch.no_grad()
def apply_gradients_accumulating(
        state: TrainState, grads: Sequence[Optional[torch.Tensor]],
        oc: OptimizerConfig, *, lr_bias: float, lr_rest: float,
        momentum: float, accumulate: int, ema_decay: float,
        semi_decay: Optional[float] = None) -> TrainState:
    """Add `grads` (one per parameter; None counts as zero) to the float32
    accumulators; every `accumulate`-th call fires (reference
    trainer.py:381-404, JAX train_state.py:160-295):

      - Nesterov SGD, torch semantics, on the summed gradient:
        dg = acc + wd p (wd on the `weight` group only), buf = mu buf + dg,
        p -= lr (dg + mu buf), lr_bias for the `bias` group, lr_rest else;
      - the accumulators are zeroed;
      - EMA <- new params and the model's BatchNorm statistics (ramped);
      - with `semi_decay` and a semi-EMA: semi-EMA <- new EMA (constant).

    With `oc.adam`, AdamW instead on the summed gradient g (JAX
    optim.py:144-182): m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    p = p (1 - lr wd) - lr m^ / (sqrt(v^) + eps), m^ and v^ bias-corrected
    by the fired-step count, b1 the configured momentum (not the warmup's).

    A held call changes nothing but the accumulators and the counters. The
    model's BatchNorm statistics are whatever its forward left. Under DDP
    the accumulators (one buffer) are summed over the ranks before a
    fired step, whenever a group exists: every rank then applies the
    global batch's gradient. Returns `state`, updated in place."""
    params = state.params
    live = [i for i, g in enumerate(grads) if g is not None]
    torch._foreach_add_([state.acc_grads[i] for i in live],
                        [grads[i].float() for i in live])
    state.acc_count += 1
    state.step += 1
    if state.acc_count < accumulate:
        return state
    state.acc_count = 0
    state.opt_step += 1
    # DDP: the global batch's gradient, once per optimizer step
    all_reduce_(state.acc_flat)
    for group in GROUPS:
        idx = [i for i, g in enumerate(state.groups) if g == group]
        if not idx:
            continue
        p = [params[i] for i in idx]
        dg = [state.acc_grads[i] for i in idx]  # becomes dg, then the step
        buf = [state.momentum_buf[i] for i in idx]
        lr = lr_bias if group == "bias" else lr_rest
        wd = oc.weight_decay if group == "weight" else 0.0
        if oc.adam:
            _adamw_(p, dg, buf, [state.second_moment[i] for i in idx],
                    lr, wd, oc.momentum, state.opt_step)
            continue
        if wd:
            torch._foreach_add_(dg, p, alpha=wd)
        torch._foreach_mul_(buf, momentum)
        torch._foreach_add_(buf, dg)
        torch._foreach_add_(dg, buf, alpha=momentum)
        torch._foreach_add_(p, dg, alpha=-lr)
    torch._foreach_zero_(state.acc_grads)
    if state.ema is None:
        return state
    ema = state.ema
    ema.updates += 1
    f32 = np.float32
    d = f32(ema_decay) * (f32(1.0) - np.exp(f32(-ema.updates) / f32(2000.0)))
    _blend_(ema.params, params, d)
    _blend_(ema.stats, bn_stats(state.model), d)
    semi = getattr(state, "semi_ema", None)
    if semi_decay is not None and semi is not None:
        semi.updates += 1
        _blend_(semi.params, ema.params, semi_decay)
        _blend_(semi.stats, ema.stats, semi_decay)
    return state

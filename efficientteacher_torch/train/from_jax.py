"""Train-state bridge from the JAX package: a JAX TrainState /
SSODTrainState, as numpy trees, -> the port's train state, so both
packages can start from one state. The weights go through
`utils/jax_import.py`; no jax is imported."""

from __future__ import annotations

import torch

from ..utils.jax_import import params_from_jax, state_dict_from_jax
from .optim import param_group_labels
from .ssod_step import SSODTrainState
from .train_state import EMAState, TrainState, _flat_views, init_ema


def _ema_from_jax(model: torch.nn.Module, ema) -> EMAState:
    out = init_ema(model)
    out.module.load_state_dict(
        state_dict_from_jax(ema.params, ema.batch_stats), strict=True)
    out.updates = int(ema.updates)
    return out


def train_state_from_jax(jax_state, model: torch.nn.Module) -> TrainState:
    """A JAX `TrainState` or `SSODTrainState` whose leaves are numpy arrays
    (any object with its attribute layout) -> the port's state around
    `model`, which takes the JAX params and batch stats (strict=True):
    Nesterov momentum buffers (AdamW's two moments, when the JAX state
    holds {"m", "v"}), accumulated gradients, the EMA and semi-EMA
    (parameters and statistics) and the counters."""
    s = jax_state
    model.load_state_dict(state_dict_from_jax(s.params, s.batch_stats),
                          strict=True)
    buf = s.opt.momentum_buf
    adam = isinstance(buf, dict) and set(buf) == {"m", "v"}
    acc_flat, acc_grads = _flat_views(list(model.parameters()))
    torch._foreach_copy_(acc_grads, params_from_jax(model, s.acc_grads))
    fields = dict(
        model=model, groups=param_group_labels(model),
        momentum_buf=params_from_jax(model, buf["m"] if adam else buf),
        second_moment=params_from_jax(model, buf["v"]) if adam else None,
        acc_grads=acc_grads, acc_flat=acc_flat,
        ema=_ema_from_jax(model, s.ema) if s.ema is not None else None,
        acc_count=int(s.acc_count), step=int(s.step),
        opt_step=int(s.opt.step))
    if not hasattr(s, "semi_ema"):
        return TrainState(**fields)
    return SSODTrainState(**fields, semi_ema=(
        _ema_from_jax(model, s.semi_ema) if s.semi_ema is not None
        else None))

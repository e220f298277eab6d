"""Supervised train step: forward, loss, backward, accumulated Nesterov SGD
and the EMA (counterpart of `efficientteacher_tpu/train/supervised.py`;
reference trainer/trainer.py:413-440).

Images arrive uint8 NHWC and are scaled on the device. The forward runs in
`compute_dtype`: bf16 by autocast on the card (float32 master weights, no
GradScaler needed for bf16), float32 in the parity tests. The loss runs in
float32 outside autocast. The loss family is a hook, as in JAX:
`detection_loss(raw, labels, mask) -> (loss, parts)`. With RepOpt's
`grad_masks` (`train/repopt.py`) the gradients are multiplied by the masks
after the backward and before they are accumulated (JAX
supervised.py:85-90).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.detector import SSODModel
from ..utils.precision import autocast
from .optim import OptimizerConfig
from .repopt import apply_grad_masks
from .train_state import TrainState, apply_gradients_accumulating


class Schedule(NamedTuple):
    """Per-iteration scalars, computed on the host."""

    lr_bias: float
    lr_rest: float
    momentum: float
    accumulate: int
    ema_decay: float = 0.9999

    @classmethod
    def make(cls, lr_bias, lr_rest, momentum, accumulate, ema_decay=0.9999):
        return cls(float(lr_bias), float(lr_rest), float(momentum),
                   int(accumulate), float(ema_decay))


def to_input(images_u8: torch.Tensor, compute_dtype: torch.dtype,
             norm_scale: float) -> torch.Tensor:
    """uint8 NHWC -> NCHW in `compute_dtype`, divided by `norm_scale` on the
    device (a view: channels-last strides)."""
    return images_u8.permute(0, 3, 1, 2).to(compute_dtype) / norm_scale


def forward_train(model, x, compute_dtype, **kwargs):
    """The model in train mode on `x`, under autocast for bf16 / fp16."""
    model.train()
    with autocast(x.device, compute_dtype):
        return model(x, decode=False, **kwargs)


def grads_of(loss: torch.Tensor, state: TrainState):
    """d loss / d params, one per parameter; None for parameters the loss
    does not reach, which count as zero gradients, as `jax.grad` gives
    them: decay and momentum still move them on a fired step."""
    return torch.autograd.grad(loss, state.params, allow_unused=True)


def apply_grads(state: TrainState, grads, oc: OptimizerConfig,
                sched: Schedule, semi_decay: Optional[float] = None) -> None:
    """`apply_gradients_accumulating` with the schedule's scalars."""
    apply_gradients_accumulating(
        state, grads, oc, lr_bias=sched.lr_bias, lr_rest=sched.lr_rest,
        momentum=sched.momentum, accumulate=sched.accumulate,
        ema_decay=sched.ema_decay, semi_decay=semi_decay)


def make_supervised_train_step(
        opt_cfg: OptimizerConfig, detection_loss, norm_scale: float = 255.0,
        compute_dtype: torch.dtype = torch.bfloat16, grad_masks=None):
    """(state, images_u8, labels, label_mask, sched) -> (state, parts).

    `detection_loss(raw, labels, mask) -> (loss, parts)` is the loss family
    (the reference's Loss.type dispatch, trainer.py:320-327; the trainer's
    `build_loss` picks it: for anchor heads the YOLOv5 `compute_loss` with
    its anchors_grid). An SSODModel trains here without its
    discriminators. The model is the state's. `grad_masks`: one mask or
    None per parameter (`train/repopt.build_grad_masks`)."""

    def train_step(state: TrainState, images, labels, label_mask,
                   sched: Schedule):
        model = state.model
        ssod = isinstance(model, SSODModel)
        raw = forward_train(model, to_input(images, compute_dtype,
                                            norm_scale), compute_dtype,
                            **({"with_domain": False} if ssod else {}))
        if ssod:
            raw = raw[0]
        loss, parts = detection_loss(raw, labels, label_mask)
        grads = grads_of(loss, state)
        if grad_masks is not None:
            # RepOptimizer (reference RepOptimizer.py:163-178)
            grads = apply_grad_masks(grads, grad_masks)
        apply_grads(state, grads, opt_cfg, sched)
        return state, detached(parts)

    return train_step


def detached(parts: dict) -> dict:
    """A loss's parts, cut from the graph (they are returned as metrics)."""
    return {k: v.detach() if torch.is_tensor(v) else v
            for k, v in parts.items()}

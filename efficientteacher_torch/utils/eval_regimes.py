"""Serving weight regimes and candidate-density instrumentation
(counterpart of `efficientteacher_tpu/utils/eval_regimes.py`).

Three deterministic regimes of the YOLOv5l eval program, which load the
selection and NMS kernels at three candidate densities:

  representative: a fresh seeded init. The head puts objectness at the
    focal prior log(8/grid^2) (reference initialize_biases,
    models/head/yolov5_head.py:36-45): the sparse field a converged
    detector shows at the 0.001 eval gate — for this init, an empty one.
  mid:            `mid_density`: BatchNorm statistics calibrated on a
    seeded batch, then every head objectness bias shifted by
    MID_OBJ_SHIFT, so that the field holds 10^3-10^4 candidates per image —
    the density between the two others, which no JAX record covers.
  saturated:      `saturate_obj` raises every objectness bias by +10,
    lighting every (anchor, class) pair (2,016,000 per image at 640 px):
    the selection's worst case.

Why the mid regime calibrates first: in the fresh init each conv + SiLU
layer shrinks the activations (BN holds the init's unit running variance),
so the head's input is constant across positions and images — in bf16
exactly constant. Every (anchor, class) pair of a head level then has the
same score, and a bias shift alone lights whole levels at once (0, 96,000,
480,000 or 2,016,000 candidates per image; measured on the card). Scaling
the kernels instead flips the network from that collapse straight to
saturation (x1.4: collapsed, x1.5: every sigmoid at 0 or 1). Calibrated BN
keeps the activations at unit scale, so the scores vary with the image and
a shift moves the density smoothly. The calibrated random network is
chaotic, though: it amplifies rounding, so the exact density depends on the
dtype and on the convolution algorithms. It is a load for the kernels, not
a model; chip_smoke.py checks that it lands in range.

`make_density_fn` gates with ops/nms._pair_scores itself, so its numbers
describe exactly what the selection kernel sees.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..eval.validator import InferFn
from ..models.heads import (YoloV5Detect, YoloV6Detect, YoloV8Detect,
                            YoloXDetect)
from ..models.spec import ModelSpec
from ..ops.nms import _pair_scores
from .precision import autocast

# Objectness-bias shift of the mid regime, chosen on an H100 for the seed-0
# YOLOv5l init of `build_model`, calibrated on chip_smoke.py's batch (8
# noise images, seed 1) and served in bf16: it lands the field at ~3,300
# candidates per image (PERF.md), inside 10^3-10^4.
MID_OBJ_SHIFT = -4.0


def yolov5l_spec() -> ModelSpec:
    """The YOLOv5l @640 spec every serving measurement runs on
    (`ModelSpec()`'s defaults; JAX yolov5l_eval_cfg)."""
    return ModelSpec()


def shift_obj(state, delta: float, no: int = 85) -> Dict[str, torch.Tensor]:
    """Copy of a state_dict (or a module's) with every head objectness bias
    raised by `delta`. Head output biases are the 1-D `bias` entries under
    a `head` path whose size is a multiple of `no` = 5 + nc."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    out = {}
    for key, v in state.items():
        if (key.endswith("bias") and "head" in key.lower() and v.ndim == 1
                and v.numel() % no == 0):
            v = v.detach().clone().view(-1, no)
            v[:, 4] += delta
            v = v.view(-1)
        out[key] = v
    return out


def shift_score_bias(head, delta: float) -> None:
    """Raise, in place, the biases that gate a head's eval scores by
    `delta`: objectness for the YOLOv5 (and YOLOv7 IDetect, before its
    ImplicitM) and YOLOX heads, the class biases for the YOLOv8 and YOLOv6
    heads, whose decoded objectness is the constant 1."""
    with torch.no_grad():
        if isinstance(head, YoloV6Detect):
            for conv in head.cls_preds:
                conv.bias += delta
        elif isinstance(head, YoloV5Detect):
            for conv in head.m:
                conv.bias.view(head.na, head.no)[:, 4] += delta
        elif isinstance(head, YoloXDetect):
            for conv in head.obj_preds:
                conv.bias += delta
        elif isinstance(head, YoloV8Detect):
            for i in range(len(head.strides)):
                getattr(head, f"cv3_{i}")[2].bias += delta
        else:
            raise NotImplementedError(type(head).__name__)


def saturate_obj(state, no: int = 85, delta: float = 10.0):
    """The saturated regime: every head objectness bias +10."""
    return shift_obj(state, delta, no)


@torch.no_grad()
def calibrate_bn(model, images_u8, compute_dtype=torch.bfloat16) -> None:
    """Set every BatchNorm's running statistics, in place, to the batch
    statistics of one train-mode forward over `images_u8` (NHWC uint8)."""
    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # cumulative average: one batch = its statistics
    was_training = model.training
    model.train()
    try:
        x = images_u8.permute(0, 3, 1, 2).to(compute_dtype) / 255.0
        with autocast(x.device, compute_dtype):
            model(x, decode=False)
    finally:
        model.train(was_training)
        for m, mom in zip(bns, momenta):
            m.momentum = mom


def mid_density(model, images_u8, shift: float = MID_OBJ_SHIFT,
                compute_dtype=torch.bfloat16):
    """The mid regime's state_dict: `model`'s weights with BatchNorm
    calibrated on `images_u8` and objectness biases shifted by `shift`.
    The model itself is left as it was."""
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    calibrate_bn(model, images_u8, compute_dtype)
    out = {k: v.clone()
           for k, v in shift_obj(model, shift, model.head.no).items()}
    model.load_state_dict(saved)
    return out


def make_density_fn(model, nc: int, conf_thres: float = 0.001,
                    compute_dtype: torch.dtype = torch.bfloat16):
    """(images_u8 NHWC) -> (mean candidates per image, max live 128-wide
    rows of the flat (anchor, class) lattice), as Python numbers."""

    forward = InferFn(model, 255.0, compute_dtype, {}).forward

    @torch.inference_mode()
    def density(images_u8):
        score, _, _ = _pair_scores(forward(images_u8), nc, conf_thres, False,
                                   0, False, None)
        keep = score > 0
        b, n = keep.shape
        rows = torch.nn.functional.pad(keep, (0, (-n) % 128))
        rows = rows.view(b, -1, 128).any(-1)
        return (float(keep.sum()) / b, int(rows.sum(-1).max()))

    return density

"""Deploy-time reparameterization: conv + BN fusion and RepVGG branch fusion
(counterpart of `efficientteacher_tpu/utils/reparam.py`; reference
Model.fuse, models/detector/yolo.py:95-128, and
RepVGGBlock.switch_to_deploy, models/backbone/common.py:1002-1120).

`fuse_repvgg_state_dict` rewrites every RepVGG block of a port state_dict
(the YOLOv6 RepVGG / QARep blocks, YOLOv7's RepConv) into its deploy
form, one biased 3x3 conv `rbr_reparam`: 3x3 + BN, 1x1 + BN (padded to
the centre tap) and the identity BN (a centre-tap identity kernel) folded
and summed. `deploy_model` loads that into the `spec.deploy=True` model,
which serves two convolutions fewer per block. The blocks' BN eps is
1e-3. Tensors keep their device; the arithmetic is float32, in JAX's
order. `cli.export --include deploy torchscript onnx` serves the fused
model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

EPS = 1e-3


def fuse_conv_bn(weight: torch.Tensor, bn_weight: torch.Tensor,
                 bn_bias: torch.Tensor, bn_mean: torch.Tensor,
                 bn_var: torch.Tensor, eps: float = EPS,
                 conv_bias: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold BN into an OIHW conv: (weight', bias')."""
    t = bn_weight / torch.sqrt(bn_var + eps)       # per output channel
    w = weight * t.view(-1, 1, 1, 1)
    b = bn_bias - bn_mean * t
    if conv_bias is not None:
        b = b + conv_bias * t
    return w, b


def _identity_kernel_3x3(channels: int, like: torch.Tensor) -> torch.Tensor:
    k = torch.zeros(channels, channels, 3, 3, dtype=like.dtype,
                    device=like.device)
    o = torch.arange(channels, device=like.device)
    k[o, o, 1, 1] = 1.0
    return k


def _bn_of(sd: Dict[str, torch.Tensor], prefix: str):
    return tuple(sd[f"{prefix}.{leaf}"] for leaf in
                 ("weight", "bias", "running_mean", "running_var"))


def fuse_repvgg_block(sd: Dict[str, torch.Tensor], prefix: str,
                      eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """One RepVGG block's trained tensors (`prefix.rbr_*`) -> (3x3 weight,
    bias)."""
    w3, b3 = fuse_conv_bn(sd[f"{prefix}.rbr_dense_conv.weight"],
                          *_bn_of(sd, f"{prefix}.rbr_dense_bn"), eps)
    w1, b1 = fuse_conv_bn(sd[f"{prefix}.rbr_1x1_conv.weight"],
                          *_bn_of(sd, f"{prefix}.rbr_1x1_bn"), eps)
    w = w3 + nn.functional.pad(w1, (1, 1, 1, 1))
    b = b3 + b1
    if f"{prefix}.rbr_identity.weight" in sd:
        wid, bid = fuse_conv_bn(_identity_kernel_3x3(w3.shape[0], w3),
                                *_bn_of(sd, f"{prefix}.rbr_identity"), eps)
        w = w + wid
        b = b + bid
    return w, b


def fuse_repvgg_state_dict(sd: Dict[str, torch.Tensor], eps: float = EPS
                           ) -> Dict[str, torch.Tensor]:
    """A state_dict with every RepVGG block (a prefix holding
    `rbr_dense_conv.weight`) in its deploy form `prefix.rbr_reparam.
    {weight, bias}`; the fused branches' tensors and BN statistics are
    dropped, every other entry is kept."""
    blocks = [k[: -len(".rbr_dense_conv.weight")] for k in sd
              if k.endswith(".rbr_dense_conv.weight")]
    out = {}
    fused = {f"{p}.rbr_" for p in blocks}
    for k, v in sd.items():
        if not any(k.startswith(f) for f in fused):
            out[k] = v
    for p in blocks:
        w, b = fuse_repvgg_block(sd, p, eps)
        out[f"{p}.rbr_reparam.weight"] = w
        out[f"{p}.rbr_reparam.bias"] = b
    return out


@torch.no_grad()
def deploy_model(model: nn.Module, eps: float = EPS) -> nn.Module:
    """The `spec.deploy=True` model (eval mode, float32, on `model`'s
    device) holding `model`'s weights with every RepVGG block fused."""
    from ..models.detector import build_model

    spec = dataclasses.replace(model.spec, deploy=True)
    dev = next(model.parameters()).device
    sd = {k: v.float() for k, v in model.state_dict().items()}
    out = build_model(spec, device=dev)
    out.load_state_dict(fuse_repvgg_state_dict(sd, eps), strict=True)
    return out.eval()

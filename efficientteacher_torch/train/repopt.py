"""RepOptimizer: gradient-reparameterized training of RealVGG models
(counterpart of `efficientteacher_tpu/train/repopt.py`; reference
models/optimizers/RepOptimizer.py:18-180, RepOpt-VGG).

A plain conv3x3 network (`Model.RealVGGModel`) trains with per-kernel
gradient masks made from the per-channel scales of a LinearAdd ("CSLA",
`Model.LinearAddModel`) checkpoint, `Model.RepScale_weight`, so that SGD
on the plain topology trains as the multi-branch net would:

  mask = s_conv^2 (every tap) + s_1x1^2 (the centre tap)
         + 1 on the centre tap's diagonal (identity branch, c1 == c2)
  grad(conv3x3) *= mask                                  (:163-178)

A run from scratch (`weights` empty) also re-initialises the 3x3 kernels
to the fused CSLA equivalent (:142-160).

Blocks are matched by module name: a RealVGG block and the LinearAdd block
in the same place of the same spec share it (the JAX package matches by
tree path, the same place). Weights are OIHW here. The re-initialisation
draws from one numpy generator in the JAX trainer's order (its params
tree after `jax.tree.map`: keys sorted at every level), so one seed gives
JAX's kernels.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.common import RealVGGBlock

Scales = Dict[str, Tuple[torch.Tensor, ...]]


def extract_scales(params: Dict[str, torch.Tensor]) -> Scales:
    """Named parameters of a LinearAdd model -> {block name: (s_identity,
    s_1x1, s_conv)}, or (s_1x1, s_conv) for a block without the identity
    branch (reference extract_scales, :18-29), float32 on the CPU."""
    out = {}
    for k in params:
        if not k.endswith(".scale_conv"):
            continue
        block = k[: -len(".scale_conv")]
        get = lambda leaf: params[f"{block}.{leaf}"].detach().float().cpu()  # noqa: E731
        sc = (get("scale_1x1"), get("scale_conv"))
        if f"{block}.scale_identity" in params:
            sc = (get("scale_identity"),) + sc
        out[block] = sc
    return out


def _real_vgg_blocks(model: nn.Module, scales: Scales):
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, RealVGGBlock) and name in scales]


def _jax_order(name: str):
    """A module name as the JAX tree path sorts it: `m.0` is `m_0`."""
    parts = []
    for p in name.split("."):
        if p.isdigit() and parts:
            parts[-1] = f"{parts[-1]}_{p}"
        else:
            parts.append(p)
    return tuple(parts)


def build_grad_masks(model: nn.Module, scales: Scales
                     ) -> List[Optional[torch.Tensor]]:
    """One entry per `model.parameters()`: the RepOpt mask (float32, the
    kernel's shape and device) for the 3x3 kernel of each RealVGG block
    that has scales, None (the gradient as it is) elsewhere."""
    masks = {}
    for name, m in _real_vgg_blocks(model, scales):
        sc = scales[name]
        w = m.conv.weight
        s_1x1, s_conv = sc[-2], sc[-1]
        mask = torch.ones(w.shape, dtype=torch.float32) \
            * (s_conv ** 2).view(-1, 1, 1, 1)
        mask[:, :, 1, 1] += (s_1x1 ** 2).view(-1, 1)
        if len(sc) == 3:
            ids = torch.arange(min(w.shape[0], w.shape[1]))
            mask[ids, ids, 1, 1] += 1.0
        masks[id(w)] = mask.to(w.device)
    return [masks.get(id(p)) for p in model.parameters()]


def apply_grad_masks(grads, masks):
    """grads * masks, entry by entry; a None mask or gradient passes."""
    return [g if m is None or g is None else g * m
            for g, m in zip(grads, masks)]


@torch.no_grad()
def reinitialize_from_scales(model: nn.Module, scales: Scales,
                             rng: Optional[np.random.Generator] = None
                             ) -> None:
    """Re-initialise each scaled RealVGG block's 3x3 kernel to the fused
    CSLA equivalent, in place (reference reinitialize, :142-160): k *
    s_conv, plus a He-normal 1x1 kernel * s_1x1 on the centre tap, plus
    s_identity on its diagonal."""
    rng = rng or np.random.default_rng(0)
    blocks = sorted(_real_vgg_blocks(model, scales),
                    key=lambda nm: _jax_order(nm[0]))
    for name, m in blocks:
        sc = scales[name]
        w = m.conv.weight
        co, ci = w.shape[:2]
        k1 = rng.normal(0, np.sqrt(2.0 / ci), (1, 1, ci, co)).astype(
            np.float32)
        k1 = torch.from_numpy(k1.transpose(3, 2, 0, 1))       # HWIO -> OIHW
        s_1x1, s_conv = sc[-2], sc[-1]
        k = w.detach().float().cpu() * s_conv.view(-1, 1, 1, 1)
        k[:, :, 1:2, 1:2] += k1 * s_1x1.view(-1, 1, 1, 1)
        if len(sc) == 3:
            ids = torch.arange(min(ci, co))
            k[ids, ids, 1, 1] += sc[0][: len(ids)]
        w.copy_(k)


def load_repscale_scales(path: str) -> Scales:
    """`Model.RepScale_weight` -> the block scales: a port checkpoint
    (`utils/checkpoint.py`) or a reference `.pt` (`utils/torch_import.py`)
    of a LinearAdd model, its EMA preferred (reference
    trainer/trainer.py:219-236)."""
    from ..utils.torch_import import read_variables

    scales = extract_scales(read_variables(path)["params"])
    if not scales:
        raise ValueError(
            f"no LinearAdd/CSLA scale branches found in {path!r} — "
            "RepScale_weight must point at a model trained with "
            "Model.LinearAddModel: True")
    return scales

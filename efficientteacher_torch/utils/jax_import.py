"""Weight bridge from the JAX package: Flax param trees -> this port's
state_dict (the whole train state: `train/from_jax.py`).

The counterpart of `efficientteacher_tpu/utils/torch_import.py:246
export_to_torch_state_dict`, rewritten in numpy without jax (that module's
package imports jax). The Flax modules keep the reference's state_dict
names, so the map is mechanical:

  - kernels HWIO -> OIHW, `scale`/`kernel` -> `weight`; a biased conv's
    (flax `nn.Conv` with bias: the YOLOv5 / YOLOv7 Detect convs, the
    YOLOX, YOLOv6 and YOLOv8 prediction convs, RepVGG's fused
    `rbr_reparam`) `bias` stays `bias`;
  - by the leaf's owner, not its rank: the kernel of a flax
    `nn.ConvTranspose` (the YOLOv6 neck's `upsample_transpose`), (kh, kw,
    in, out) and applied unflipped, is `ConvTranspose2d`'s (in, out, kh,
    kw) flipped in both spatial axes, k[::-1, ::-1].transpose(2, 3, 0, 1);
    YOLOv7's `implicit` tokens (1, 1, 1, C) are (1, C, 1, 1); the
    LinearAdd scale vectors (`scale_conv`, `scale_1x1`,
    `scale_identity`) are 1-D and cross as they are;
  - batch stats `mean`/`var` -> `running_mean`/`running_var`;
  - `m_0` -> `m.0`, except modules whose reference name literally holds
    `_<digit>` (`stage2_1`, ...) and the SSOD model's discriminators
    `det_8/16/32`, which the port names as the JAX package does; only the
    last `_<digit>` splits, so YOLOv8's `cv2_0_1` is `cv2_0.1` and YOLOX's
    `cls_preds_0` is `cls_preds.0`;
  - plus `num_batches_tracked` for every BatchNorm, which
    `nn.BatchNorm2d` registers and `load_state_dict(strict=True)` requires.

The trees are nested dicts whose leaves are arrays (numpy, or anything
`np.asarray` takes).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# Module attributes whose names LITERALLY contain _<digit> in the reference
# source (a copy of torch_import._LITERAL_UNDERSCORE), plus the port's
# SSODModel discriminators.
_LITERAL_UNDERSCORE = frozenset(
    ["det_8", "det_16", "det_32"]
    + [f"ERBlock_{i}" for i in range(2, 6)]
    + [f"c_{i}" for i in range(4)]
    + [f"elan_{i}" for i in range(4)]
    + [f"stage{s}_{i}" for s in range(2, 6) for i in (1, 2)]
    + ["stem_1", "stem_3"]
)


def _torch_path(path) -> list:
    parts = []
    for p in path:
        if ("_" in p and p.rsplit("_", 1)[-1].isdigit()
                and p not in _LITERAL_UNDERSCORE):
            parts.extend(p.rsplit("_", 1))
        else:
            parts.append(p)
    return parts


# owners of the kernels that flax's nn.ConvTranspose holds
_TRANSPOSED_CONVS = frozenset(["upsample_transpose"])


def _torch_layout(path, arr: np.ndarray) -> np.ndarray:
    """A Flax leaf's array in the layout of the port's tensor of that
    name, chosen by the leaf's name and its owner's."""
    if path[-1] == "implicit":
        return arr.reshape(1, -1, 1, 1)
    if path[-1] == "kernel" and len(path) > 1 \
            and path[-2] in _TRANSPOSED_CONVS:
        return np.ascontiguousarray(arr[::-1, ::-1].transpose(2, 3, 0, 1))
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)                  # HWIO -> OIHW
    if arr.ndim == 2:
        return arr.T
    return arr


def _walk(node, path, out):
    if isinstance(node, dict):
        for k, v in node.items():
            _walk(v, path + [k], out)
    else:
        out.append((path, np.asarray(node)))


def state_dict_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """Flax `params` and `batch_stats` trees -> this port's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    leaves = []
    _walk(params, [], leaves)
    for path, arr in leaves:
        leaf = {"scale": "weight", "kernel": "weight"}.get(path[-1], path[-1])
        key = ".".join(_torch_path(path[:-1]) + [leaf])
        out[key] = torch.tensor(_torch_layout(path, arr),
                                dtype=torch.float32)
    leaves = []
    _walk(batch_stats, [], leaves)
    for path, arr in leaves:
        prefix = ".".join(_torch_path(path[:-1]))
        leaf = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        out[f"{prefix}.{leaf}"] = torch.tensor(arr, dtype=torch.float32)
        out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return out


def params_from_jax(model: torch.nn.Module, tree) -> List[torch.Tensor]:
    """A params-shaped tree (momentum, accumulated gradients, gradients)
    as one float32 tensor per `model.parameters()` entry, on its device."""
    sd = state_dict_from_jax(tree, {})
    named = list(model.named_parameters())
    differ = set(sd) ^ {n for n, _ in named}
    if differ:
        raise KeyError(f"tree and model differ at {sorted(differ)}")
    return [torch.empty_like(p, dtype=torch.float32).copy_(sd[n])
            for n, p in named]

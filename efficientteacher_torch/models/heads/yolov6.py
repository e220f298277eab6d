"""The TAL heads' shared decode (counterpart of `decode_tal_scale` in
`efficientteacher_tpu/models/heads/yolov6.py`; reference
models/head/yolov6_head.py:173-215) and the DFL bin expectation it reads
(`dfl_project`, JAX `losses/tal_loss.py`), which the TAL loss imports
from here. The YOLOv8 head decodes with it now;
the YOLOv6 head itself (`YoloV6Detect`) is not ported yet (ROADMAP
Q1.10)."""

from __future__ import annotations

import torch


def dfl_project(reg_dist: torch.Tensor, reg_max: int) -> torch.Tensor:
    """(..., 4*(reg_max+1)) bin logits -> (..., 4) expected ltrb distances
    (the proj_conv of yolov6_head.py:94-96)."""
    bins = reg_dist.reshape(reg_dist.shape[:-1] + (4, reg_max + 1))
    proj = torch.arange(reg_max + 1, dtype=torch.float32,
                        device=reg_dist.device)
    return (torch.softmax(bins, -1) * proj).sum(-1)


def decode_tal_scale(raw: torch.Tensor, stride: float, reg_max: int,
                     use_dfl: bool, nc: int) -> torch.Tensor:
    """One scale's raw map (B, 1, ny, nx, 4*(reg_max+1)+nc) -> (B, ny*nx,
    5+nc) [xywh absolute, obj = 1, sigmoid cls]: the DFL expectation (or
    the first 4 bins without DFL) as ltrb distances around the (grid + 0.5)
    anchor points, scaled by the stride."""
    b, na, ny, nx, _ = raw.shape
    nbins = 4 * (reg_max + 1)
    reg = raw[..., :nbins]
    cls = torch.sigmoid(raw[..., nbins:])
    ltrb = dfl_project(reg, reg_max) if use_dfl else reg[..., :4]
    gy, gx = torch.meshgrid(
        torch.arange(ny, dtype=torch.float32, device=raw.device),
        torch.arange(nx, dtype=torch.float32, device=raw.device),
        indexing="ij")
    anc = torch.stack([gx + 0.5, gy + 0.5], -1)          # (ny, nx, 2)
    x1y1 = anc - ltrb[..., 0:2]
    x2y2 = anc + ltrb[..., 2:4]
    cxy = (x1y1 + x2y2) / 2 * stride
    wh = (x2y2 - x1y1) * stride
    obj = torch.ones_like(cxy[..., :1])
    out = torch.cat([cxy, wh, obj, cls], -1)
    return out.reshape(b, na * ny * nx, 5 + nc)

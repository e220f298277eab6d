"""YOLOv5 anchor-based Detect head (counterpart of
`efficientteacher_tpu/models/heads/yolov5.py`).

Parity with reference models/head/yolov5_head.py:7-159:
  - per-scale 1x1 conv to na*(5+nc+2*np) channels (bias on)
  - focal-prior bias init (obj: log(8/(640/s)^2), cls: log(0.6/(nc-0.99)))
    (reference yolov5_head.py:36-45)
  - raw maps in the reference torch layout (B, na, ny, nx, no); the JAX
    package lays them out (B, ny, nx, na, no)
  - eval decode in float32: xy=(2*sig-0.5+grid)*stride,
    wh=(2*sig)^2*anchor_px (reference yolov5_head.py:70-79), flattened in
    the reference's (anchor, y, x) order
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..spec import ModelSpec


def _detect_bias_init(na: int, no: int, nc: int,
                      stride: float) -> torch.Tensor:
    """Per-scale focal-prior bias (reference yolov5_head.py:41-44)."""
    b = np.zeros((na, no), np.float32)
    b[:, 4] += math.log(8.0 / (640.0 / stride) ** 2)
    b[:, 5 : 5 + nc] += math.log(0.6 / (nc - 0.99))
    return torch.from_numpy(b.reshape(-1))


def decode_yolov5_scale(raw: torch.Tensor, stride: float,
                        anchors_px: torch.Tensor, nc: int) -> torch.Tensor:
    """Decode one scale's raw map (B, na, ny, nx, no) to absolute
    xywh+scores (B, na*ny*nx, no) in float32, (anchor, y, x) order."""
    raw = raw.float()
    b, na, ny, nx, no = raw.shape
    y = torch.sigmoid(raw[..., : 5 + nc])
    gy, gx = torch.meshgrid(
        torch.arange(ny, dtype=torch.float32, device=raw.device),
        torch.arange(nx, dtype=torch.float32, device=raw.device),
        indexing="ij")
    grid = torch.stack([gx, gy], -1)                   # (ny, nx, 2)
    anchors = anchors_px.float().view(1, na, 1, 1, 2)
    xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * stride
    wh = (y[..., 2:4] * 2.0) ** 2 * anchors
    out = [xy, wh, y[..., 4:]]
    if no > 5 + nc:
        # keypoint channels -> absolute pixels (JAX heads/yolov5.py:531-545:
        # kp_px = raw * anchors_px + cell_px, a deliberate fix over the
        # reference, whose eval decode zeroes these channels)
        npk2 = no - 5 - nc
        kp = raw[..., 5 + nc :].reshape(b, na, ny, nx, npk2 // 2, 2)
        kp = kp * anchors[..., None, :] + (grid * stride)[:, :, None, :]
        out.append(kp.reshape(b, na, ny, nx, npk2))
    return torch.cat(out, -1).reshape(b, na * ny * nx, no)


class YoloV5Detect(nn.Module):
    """Anchor-based detection head ('YoloV5' in the head factory)."""

    def __init__(self, spec: ModelSpec, in_ch):
        super().__init__()
        self.nc = spec.nc
        self.no = spec.nc + 2 * spec.num_keypoints + 5
        self.strides = tuple(spec.strides)
        anchors = np.asarray(spec.anchors, np.float32)
        anchors = anchors.reshape(len(spec.anchors), -1, 2)  # (nl, na, 2) px
        self.na = anchors.shape[1]
        # not part of the state_dict: the JAX export drops the reference's
        # anchors/anchor_grid buffers, and the spec defines them
        self.register_buffer("anchors_px", torch.from_numpy(anchors),
                             persistent=False)
        self.m = nn.ModuleList(
            nn.Conv2d(c, self.na * self.no, 1, bias=True) for c in in_ch)
        with torch.no_grad():
            for conv, s in zip(self.m, self.strides):
                conv.bias.copy_(
                    _detect_bias_init(self.na, self.no, self.nc, s))

    def forward(self, feats, decode: bool):
        """feats: (P3, P4, P5) NCHW. Returns raw maps [(B, na, ny, nx, no)];
        with `decode`, `(decoded (B, N, no) float32, raw maps)`."""
        raw = []
        for conv, f in zip(self.m, feats):
            x = conv(f)
            b, _, ny, nx = x.shape
            raw.append(x.view(b, self.na, self.no, ny, nx)
                       .permute(0, 1, 3, 4, 2).contiguous())
        if not decode:
            return raw
        z = [decode_yolov5_scale(r, s, self.anchors_px[i], self.nc)
             for i, (r, s) in enumerate(zip(raw, self.strides))]
        return torch.cat(z, 1), raw

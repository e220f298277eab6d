"""Eval inference: uint8 images -> forward -> decode -> NMS (counterpart of
`efficientteacher_tpu/eval/validator.py`).

Parity with reference val.py:148-465: multi-label NMS at conf 0.001 /
IoU 0.6 (val.py:335); detections are rescaled to native image space before
matching (val.py:340-376, `_scale_to_native`).

Ported so far: `make_infer_fn` and `_scale_to_native`. `run` (the mAP
accumulation) follows with the metrics. The JAX version's `mesh` argument
is dropped: the port runs on one card; data parallelism comes with DDP.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.nms import NMSOutput, batched_nms
from ..utils.precision import autocast


def _scale_to_native(boxes: np.ndarray, letterbox_hw: Tuple[int, int],
                     native_hw: Tuple[int, int],
                     ratio_pad=None) -> np.ndarray:
    """Undo letterbox: boxes xyxy in the square frame -> native pixels
    (reference utils/general.py:702-718 scale_coords). `ratio_pad` =
    ((rh, rw), (dw, dh)) is the loader's recorded transform, used like the
    reference's explicit ratio_pad (gain = rh, val.py:340); without it the
    gain is recomputed for a tight letterbox."""
    lh, lw = letterbox_hw
    nh, nw = native_hw
    if ratio_pad is not None:
        gain = ratio_pad[0][0]
        padw, padh = ratio_pad[1]
    else:
        gain = min(lh / nh, lw / nw)
        padw = (lw - nw * gain) / 2
        padh = (lh - nh * gain) / 2
    out = boxes.copy()
    out[:, [0, 2]] = (out[:, [0, 2]] - padw) / gain
    out[:, [1, 3]] = (out[:, [1, 3]] - padh) / gain
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, nw)
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, nh)
    return out


class InferFn:
    """uint8 NHWC images (B, H, W, 3) on the model's device -> NMSOutput.

    `forward` and `nms` are the two halves of `__call__`, so a caller can
    run NMS twice on one decoded tensor (kernels against plain versions).
    """

    def __init__(self, model: torch.nn.Module, norm_scale: float,
                 compute_dtype: torch.dtype, nms_kwargs: dict):
        self.model = model
        self.norm_scale = norm_scale
        self.compute_dtype = compute_dtype
        self.nms_kwargs = nms_kwargs

    @torch.inference_mode()
    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        """Decoded predictions (B, N, no), float32. The model runs in eval
        mode (BN on stored stats) and in `compute_dtype`: autocast for bf16
        and fp16, otherwise the model's own dtype, which must then be
        `compute_dtype`. The head decodes in float32. NHWC is permuted to
        NCHW as a view, so the input keeps channels-last strides."""
        x = images_u8.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = x / self.norm_scale
        was_training = self.model.training
        self.model.eval()
        try:
            with autocast(x.device, self.compute_dtype):
                decoded, _ = self.model(x, decode=True)
        finally:
            self.model.train(was_training)
        return decoded

    @torch.inference_mode()
    def nms(self, decoded: torch.Tensor, use_kernels: bool = True
            ) -> NMSOutput:
        return batched_nms(decoded, use_kernels=use_kernels,
                           **self.nms_kwargs)

    def __call__(self, images_u8: torch.Tensor) -> NMSOutput:
        return self.nms(self.forward(images_u8))


def make_infer_fn(model, nc: int, conf_thres: float, iou_thres: float,
                  max_det: int, max_nms: int, norm_scale: float,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  num_points: int = 0, selection: str | None = None
                  ) -> InferFn:
    """`selection`: candidate-selection engine (ops/nms.py batched_nms);
    None auto-picks the compaction kernel's engine on CUDA.
    `num_points > 0`: keypoint models — keypoint channels ride through NMS,
    with the reference landmark path's obj-only gate and single-label
    selection (val.py:333, general.py:791)."""
    return InferFn(model, norm_scale, compute_dtype, dict(
        nc=nc, conf_thres=conf_thres, iou_thres=iou_thres,
        multi_label=num_points == 0, max_nms=max_nms, max_det=max_det,
        n_extra=2 * num_points, obj_gate=num_points > 0, selection=selection))

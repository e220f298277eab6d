"""End-user inference wrappers: AutoShape, Detections, Ensemble,
attempt_load (counterpart of `efficientteacher_tpu/models/autoshape.py`;
reference models/backbone/common.py:800-960, experimental.py:73-128).

`AutoShape` takes image paths, BGR arrays or a list of them, letterboxes
them to one batch, runs the model's eval forward and the single-label
`batched_nms` at max_nms 2048 (the greedy-NMS kernel on the card) and
scales the boxes back to each image's pixels. `Detections` holds the
results with xyxy / xywh views and render / save / crop / print, drawing
as cv2 draws (`utils/draw.py`) and writing through `image_io.imwrite`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..data.augment import letterbox
from ..data.image_io import imread, imwrite
from ..eval.validator import InferFn, _scale_to_native
from ..utils import draw


class Detections:
    """Per-image detection results (reference common.py:884-960)."""

    def __init__(self, imgs, preds, names):
        self.imgs = imgs                      # original BGR images
        self.preds = preds                    # list of (n, 6) xyxy conf cls
        self.names = names
        self.n = len(imgs)

    @property
    def xyxy(self) -> List[np.ndarray]:
        return self.preds

    @property
    def xywh(self) -> List[np.ndarray]:
        out = []
        for p in self.preds:
            q = p.copy()
            q[:, 0] = (p[:, 0] + p[:, 2]) / 2
            q[:, 1] = (p[:, 1] + p[:, 3]) / 2
            q[:, 2] = p[:, 2] - p[:, 0]
            q[:, 3] = p[:, 3] - p[:, 1]
            out.append(q)
        return out

    def _name(self, c: int):
        return self.names[c] if c < len(self.names) else str(c)

    def render(self) -> List[np.ndarray]:
        rendered = []
        for img, det in zip(self.imgs, self.preds):
            img = img.copy()
            for *xyxy, conf, cls in det:
                c = int(cls)
                draw.box_label(img, xyxy, f"{self._name(c)} {conf:.2f}",
                               draw.color_of(c))
            rendered.append(img)
        return rendered

    def save(self, save_dir: Union[str, Path] = "runs/detect"):
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        for i, img in enumerate(self.render()):
            imwrite(str(save_dir / f"image{i}.jpg"), img)

    def crop(self) -> List[List[np.ndarray]]:
        out = []
        for img, det in zip(self.imgs, self.preds):
            crops = []
            for *xyxy, conf, cls in det:
                x1, y1, x2, y2 = (max(0, int(v)) for v in xyxy)
                crops.append(img[y1:y2, x1:x2].copy())
            out.append(crops)
        return out

    def print(self):
        for i, det in enumerate(self.preds):
            counts = {}
            for c in det[:, 5].astype(int):
                counts[c] = counts.get(c, 0) + 1
            desc = ", ".join(f"{v} {self._name(k)}" for k, v in counts.items())
            print(f"image {i}: {desc or 'no detections'}")

    def __len__(self):
        return self.n


class AutoShape:
    """Arbitrary-input inference wrapper (reference common.py:800-880)
    around `model` (eval mode, on its device): paths or BGR arrays in,
    Detections in each image's own pixels out. `compute_dtype`: bf16
    autocast on the card, the model's float32 on the CPU (as cli.val)."""

    conf = 0.25
    iou = 0.45
    max_det = 300

    def __init__(self, model: nn.Module, names: Optional[Sequence[str]] = None,
                 img_size: int = 640, norm_scale: float = 255.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.model = model
        self.nc = model.spec.nc
        self.names = list(names or [str(i) for i in range(self.nc)])
        self.img_size = img_size
        self.norm_scale = norm_scale
        self.compute_dtype = compute_dtype

    def infer_fn(self) -> InferFn:
        """The forward + NMS at the current conf / iou / max_det."""
        return InferFn(self.model, self.norm_scale, self.compute_dtype, dict(
            nc=self.nc, conf_thres=self.conf, iou_thres=self.iou,
            max_det=self.max_det, max_nms=2048))

    def __call__(self, inputs, size: Optional[int] = None) -> Detections:
        size = size or self.img_size
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        imgs0 = [np.ascontiguousarray(imread(str(item))[..., ::-1])
                 if isinstance(item, (str, Path)) else np.asarray(item)
                 for item in inputs]
        batch = np.stack([letterbox(im[..., ::-1], size, auto=False)[0]
                          for im in imgs0])
        device = next(self.model.parameters()).device
        out = self.infer_fn()(torch.from_numpy(batch).to(device))
        dets = out.detections.cpu().numpy()
        valid = out.valid.cpu().numpy()
        preds = []
        for i, im0 in enumerate(imgs0):
            det = dets[i][valid[i]].copy()
            if len(det):
                det[:, :4] = _scale_to_native(det[:, :4], (size, size),
                                              im0.shape[:2])
            preds.append(det)
        return Detections(imgs0, preds, self.names)


class Ensemble(nn.Module):
    """Same-architecture models whose decoded predictions are averaged
    before NMS (reference experimental.py Ensemble:110-128). Called as a
    Model is, it gives (mean decoded, None)."""

    def __init__(self, models: Sequence[nn.Module]):
        super().__init__()
        self.models = nn.ModuleList(models)
        self.spec = models[0].spec

    def forward(self, x, decode: bool = True):
        outs = [m(x, decode=True)[0] for m in self.models]
        return torch.stack(outs).mean(0), None


def attempt_load(weights, cfg, device: torch.device | str = "cuda"
                 ) -> nn.Module:
    """The config's detector (without the SSOD discriminators) in eval
    mode on `device` (the card unless the caller asks for the CPU), with
    the weights of a port checkpoint or a reference `.pt` (the EMA
    preferred, every tensor matched); a list of them gives an Ensemble
    (reference experimental.py:73-128)."""
    from ..utils.torch_import import load_weights_into
    from .detector import build_model
    from .spec import ModelSpec, spec_from_cfg

    spec = cfg if isinstance(cfg, ModelSpec) else spec_from_cfg(cfg)
    spec = dataclasses.replace(spec, train_domain=False)
    paths = [weights] if isinstance(weights, (str, Path)) else list(weights)
    models = []
    for p in paths:
        model = build_model(spec, device=device)
        load_weights_into(model, p, strict=True)
        models.append(model.eval())
    return models[0] if len(models) == 1 else Ensemble(models).eval()

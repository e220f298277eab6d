"""Validation runner: forward + NMS on the device, mAP accumulation on the
host (counterpart of `efficientteacher_tpu/eval/validator.py`).

Parity with reference val.py:148-465 `val.run`:
  - multi-label NMS at conf 0.001 / iou 0.6 (val.py:335)
  - detections rescaled to native image space before matching
    (val.py:340-376, `_scale_to_native`)
  - IoU@[.5:.95] TP matrix via process_batch
  - returns ((P, R, mAP50, mAP), per-class maps, cls_thr) where cls_thr are
    the per-class best-F1 thresholds the SSOD trainer consumes (val.py:462-465)

Only the compact (max_det, 6) detections and their `valid` mask cross to
the host, one batch behind the device (see `run`). The JAX version's `mesh`
argument is dropped: the port runs on one card; data parallelism comes with
DDP, where rank 0 alone validates the whole set, as the reference does
(`train/trainer.py`). COCO JSON output and COCOeval (`save_json`,
`coco_gt_json`, `is_coco`) are as in JAX (`eval/coco.py`). Keypoint models
(`num_points`): the landmark NMS, the keypoints scaled to native pixels
per coordinate (`_scale_landmarks_to_native`) and, with `val_kp`, OKS true
positives (`eval/keypoint_metrics.py`). With `plots_dir` the PR / F1 / P /
R curves are written there (`eval/metrics.ap_per_class`, matplotlib).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.detector import SSODModel
from ..ops.nms import NMSOutput, batched_nms
from ..parallel.distributed import to_device
from ..utils.precision import autocast
from .coco import (coco80_to_coco91_class, coco_image_id,
                   detections_to_json, run_cocoeval)
from .keypoint_metrics import process_batch_kp
from .metrics import ConfusionMatrix, ap_per_class, process_batch

LOGGER = logging.getLogger(__name__)


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


def _scale_landmarks_to_native(kps: np.ndarray, letterbox_hw, native_hw,
                               ratio_pad=None,
                               preserve_invisible: bool = False
                               ) -> np.ndarray:
    """Interleaved (N, 2 np) keypoint pixels in the letterboxed frame ->
    native pixels, each coordinate clamped to the image (reference
    utils/general.py:717-750; JAX validator.py:109). With
    `preserve_invisible` (the ground truth's path) coordinates < 0, the
    dataset's mark of an invisible point, stay -1."""
    lh, lw = letterbox_hw
    nh, nw = native_hw
    if ratio_pad is not None:
        gain = ratio_pad[0][0]
        padw, padh = ratio_pad[1]
    else:
        gain = min(lh / nh, lw / nw)
        padw = (lw - nw * gain) / 2
        padh = (lh - nh * gain) / 2
    out = kps.astype(np.float32).copy()
    invisible = out < 0
    out[:, 0::2] = ((out[:, 0::2] - padw) / gain).clip(0, nw)
    out[:, 1::2] = ((out[:, 1::2] - padh) / gain).clip(0, nh)
    if preserve_invisible:
        out[invisible] = -1.0
    return out


def _gt_keypoints(lab: np.ndarray, num_points: int, letterbox_hw,
                  native_hw, ratio_pad) -> np.ndarray:
    """The labels' normalised keypoint columns -> native pixels, invisible
    points -1 (JAX validator.py:274-285)."""
    n2 = 2 * num_points
    if not len(lab):
        return np.zeros((0, n2), np.float32)
    lh, lw = letterbox_hw
    gt_kp = lab[:, 5:5 + n2].astype(np.float32).copy()
    inv = gt_kp < 0
    gt_kp[:, 0::2] *= lw
    gt_kp[:, 1::2] *= lh
    gt_kp[inv] = -1.0
    return _scale_landmarks_to_native(gt_kp, letterbox_hw, native_hw,
                                      ratio_pad=ratio_pad,
                                      preserve_invisible=True)


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
                if isinstance(self.model, SSODModel):
                    (decoded, _), _ = self.model(x, decode=True,
                                                 with_domain=False)
                else:
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


def run(
    model,
    loader,
    nc: int,
    conf_thres: float = 0.001,
    iou_thres: float = 0.6,
    max_det: int = 300,
    max_nms: int = 30000,
    norm_scale: float = 255.0,
    compute_dtype: torch.dtype = torch.bfloat16,
    save_json: Optional[str] = None,
    coco_gt_json: Optional[str] = None,
    confusion: bool = False,
    is_coco: bool = False,
    plots_dir=None,
    num_points: int = 0,
    val_kp: bool = False,
    names=(),
    selection: Optional[str] = None,
):
    """Evaluate `model` (its own weights, on its own device) over `loader`,
    an iterable of batch dicts: "images" uint8 (B, H, W, 3), "labels"
    (B, M, 5) [cls, xywh normalised to the letterboxed frame], "mask"
    (B, M) bool, "shapes" (B,) native (h, w) or None, and optionally
    "ratio_pad" (B,) ((rh, rw), (dw, dh)). Returns ((mp, mr, map50, map),
    per_class_maps, cls_thr), plus the ConfusionMatrix with `confusion`.

    The host folds batch i into the mAP accumulators while the device
    works on batch i + 1 (`_host_batch` runs one batch behind); only
    `detections` and `valid` are copied to the host. The time spent
    waiting on the device and the host metrics' time are logged per image
    ("Speed: ..."), as the JAX version does, and so is the number of
    detections counted.

    save_json: path for COCO-format predictions, as JAX writes them: the
    rows are built in the host fold from the native-pixel detections,
    image_id from the filename stem of `batch["paths"]` (else the
    dataset index in `batch["indices"]`, else the running count), and,
    when is_coco, category_id through the 80->91 map; the file is written
    once at the end. COCOeval runs on it when coco_gt_json is given
    (pycocotools if present, else the re-scorer of `eval/coco.py`) and
    its (mAP@0.5, mAP@[.5:.95]) is printed.

    num_points > 0: a keypoint model; its detections carry 2 num_points
    keypoint columns through the landmark NMS (reference val.py:333),
    scaled to native pixels. val_kp: the true positives are OKS matches
    over [.5:.95] (reference process_batch_oks, val.py:80-96) instead of
    box IoU; the labels then carry the keypoint columns after [cls, xywh].

    plots_dir: the PR / F1 / P / R curves of the run, labelled by `names`
    (the class names), as JAX writes them; ImportError without
    matplotlib, raised before the first batch.

    `selection` names the JAX NMS's candidate-selection engine: the port
    has one, exact, so "pallas" and "exact" are it and "approx" (JAX's
    approximate top-k) is served exactly too (ROADMAP Q1.12)."""
    if selection not in (None, "pallas", "exact", "approx"):
        raise ValueError(f"selection {selection!r}: pallas, exact or approx")
    if selection == "approx":
        LOGGER.info("selection 'approx' runs the exact selection")
    if plots_dir is not None:
        from ..utils.plots import pyplot

        pyplot()  # no matplotlib: fail before the run, not after it
    device = next(model.parameters()).device
    infer = make_infer_fn(model, nc, conf_thres, iou_thres, max_det, max_nms,
                          norm_scale, compute_dtype, num_points=num_points)
    n2 = 2 * num_points
    class_map = (coco80_to_coco91_class() if is_coco
                 else list(range(max(nc, 1000))))
    iouv = np.linspace(0.5, 0.95, 10)
    stats = []
    json_preds = []
    cm = ConfusionMatrix(nc) if confusion else None
    t_infer = 0.0
    t_host = 0.0
    n_images = 0
    shape = None

    def _host_batch(out: NMSOutput, batch, bs, lh, lw, base_idx):
        """Materialize one batch's device output and fold it into the mAP
        accumulators."""
        nonlocal t_infer, t_host
        t0 = time.perf_counter()
        dets = out.detections.cpu().numpy()[:bs]
        valid = out.valid.cpu().numpy()[:bs]
        t_infer += time.perf_counter() - t0  # device wait, if any
        t0 = time.perf_counter()

        for bi in range(bs):
            det = dets[bi][valid[bi]]
            lab = batch["labels"][bi][batch["mask"][bi]]  # (n, 5) cls+xywhn
            shapes = batch["shapes"][bi]
            native_hw = shapes if shapes is not None else (lh, lw)
            rp = batch.get("ratio_pad")
            rp = rp[bi] if rp is not None else None
            # labels: normalized xywh on the letterboxed frame -> native xyxy
            if len(lab):
                lxyxy = np.zeros((len(lab), 5), np.float32)
                lxyxy[:, 0] = lab[:, 0]
                cx, cy, w, h = lab[:, 1] * lw, lab[:, 2] * lh, \
                    lab[:, 3] * lw, lab[:, 4] * lh
                lxyxy[:, 1], lxyxy[:, 2] = cx - w / 2, cy - h / 2
                lxyxy[:, 3], lxyxy[:, 4] = cx + w / 2, cy + h / 2
                lxyxy[:, 1:] = _scale_to_native(
                    lxyxy[:, 1:], (lh, lw), native_hw, ratio_pad=rp)
            else:
                lxyxy = np.zeros((0, 5), np.float32)
            if len(det):
                det = det.copy()
                det[:, :4] = _scale_to_native(
                    det[:, :4], (lh, lw), native_hw, ratio_pad=rp)
                if num_points > 0:  # keypoints follow [xyxy, conf, cls]
                    det[:, 6:6 + n2] = _scale_landmarks_to_native(
                        det[:, 6:6 + n2], (lh, lw), native_hw,
                        ratio_pad=rp)
            if cm is not None:
                cm.process_batch(det, lxyxy)
            if save_json is not None and len(det):
                paths = batch.get("paths")
                indices = batch.get("indices")
                img_id = coco_image_id(
                    paths[bi] if paths else None,
                    indices[bi] if indices is not None else base_idx + bi)
                json_preds.extend(
                    detections_to_json(det[:, :6], img_id, class_map))
            if num_points > 0 and val_kp:
                gt_kp = _gt_keypoints(np.asarray(lab), num_points, (lh, lw),
                                      native_hw, rp)
                correct = process_batch_kp(
                    det[:, 6:6 + n2].reshape(-1, num_points, 2),
                    det[:, 4] if len(det) else np.zeros(0),
                    det[:, 5] if len(det) else np.zeros(0),
                    gt_kp.reshape(-1, num_points, 2), lxyxy[:, 0], iouv)
            else:
                correct = process_batch(det, lxyxy, iouv)
            stats.append((
                correct,
                det[:, 4] if len(det) else np.zeros(0),
                det[:, 5] if len(det) else np.zeros(0),
                lxyxy[:, 0],
            ))
        t_host += time.perf_counter() - t0

    pending = None
    for batch in loader:
        images = batch["images"]
        bs = images.shape[0]
        base_idx = n_images
        n_images += bs
        shape = shape or images.shape[:3]
        t0 = time.perf_counter()
        out = infer(to_device(images, device))
        t_infer += time.perf_counter() - t0  # dispatch, and the NMS's syncs
        if pending is not None:
            _host_batch(*pending)
        pending = (out, batch, bs, images.shape[1], images.shape[2],
                   base_idx)
    if pending is not None:
        _host_batch(*pending)

    if n_images:
        LOGGER.info(
            "Speed: %.1f ms inference+NMS (device wait), %.1f ms host "
            "metrics per image at shape (%d, %d, %d)",
            t_infer / n_images * 1e3, t_host / n_images * 1e3,
            *shape)

    n_det = sum(len(s[1]) for s in stats)
    LOGGER.info("Detections: %d over %d images", n_det, n_images)
    if save_json is not None:
        with open(save_json, "w") as f:
            json.dump(json_preds, f)
        # COCOeval on the saved JSON (reference val.py:427-452); the
        # vendor-free re-scorer when pycocotools is absent
        if coco_gt_json:
            j50, j = run_cocoeval(save_json, coco_gt_json)
            print(f"COCOeval: mAP@0.5 {j50:.4f}  mAP@[.5:.95] {j:.4f}")

    stats = [np.concatenate(x, 0) for x in zip(*stats)]
    if len(stats) and stats[0].any():
        p, r, ap, f1, ap_class, cls_thr = ap_per_class(
            *stats, plot_dir=plots_dir, names=names)
        ap50, ap_all = ap[:, 0], ap.mean(1)
        mp, mr, map50, map_ = p.mean(), r.mean(), ap50.mean(), ap_all.mean()
        maps = np.zeros(nc)
        for i, c in enumerate(ap_class):
            maps[c] = ap_all[i]
    else:
        mp = mr = map50 = map_ = 0.0
        maps = np.zeros(nc)
        cls_thr = [conf_thres] * nc
    out = ((float(mp), float(mr), float(map50), float(map_)), maps, cls_thr)
    if cm is not None:
        return out + (cm,)
    return out

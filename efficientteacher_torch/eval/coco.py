"""COCO interop: official-format prediction JSON + vendor-free evaluation
(a copy of `efficientteacher_tpu/eval/coco.py`, numpy only; the port keeps
its own copy because that package's `__init__` imports JAX).

Parity targets:
  - coco80_to_coco91_class (reference utils/general.py:537-546): the val2017
    annotation file uses the 91-id paper numbering while models emit 80
    contiguous class indices.
  - save_one_json (reference val.py:67-74): image_id is the filename stem
    (int when numeric, e.g. COCO's 000000139.jpg -> 139).
  - COCOeval summary (reference val.py:427-452): when pycocotools is absent,
    `evaluate_predictions_json` re-scores the same JSON pair with the
    port's ap_per_class machinery (eval/metrics.py) so the mAP-parity
    workflow (SURVEY §4.1) is not blocked on a vendored dependency.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def coco80_to_coco91_class() -> List[int]:
    """80 contiguous train indices -> 91 COCO paper category ids
    (reference utils/general.py:537-546)."""
    return [
        1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20,
        21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
        41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
        59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79,
        80, 81, 82, 84, 85, 86, 87, 88, 89, 90,
    ]


def coco_image_id(path: Optional[str], fallback: int):
    """Filename stem as image_id (reference val.py:67-74);
    int when numeric so official COCO GT ids match."""
    if not path:
        return int(fallback)
    stem = Path(path).stem
    return int(stem) if stem.isnumeric() else stem


def detections_to_json(det: np.ndarray, image_id, class_map: Sequence[int]):
    """(n, 6) [xyxy conf cls] native-pixels -> COCO result dicts
    (xywh top-left, reference val.py:69-74)."""
    out = []
    for *xyxy, conf, cls in det.tolist():
        out.append({
            "image_id": image_id,
            "category_id": int(class_map[int(cls)]),
            "bbox": [
                round(float(xyxy[0]), 3),
                round(float(xyxy[1]), 3),
                round(float(xyxy[2] - xyxy[0]), 3),
                round(float(xyxy[3] - xyxy[1]), 3),
            ],
            "score": round(float(conf), 5),
        })
    return out


def _xywh_to_xyxy(b) -> List[float]:
    return [b[0], b[1], b[0] + b[2], b[1] + b[3]]


def evaluate_predictions_json(
    pred_json: str, gt_json: str
) -> Tuple[float, float]:
    """Score a COCO predictions file against a COCO GT file WITHOUT
    pycocotools: returns (mAP@0.5, mAP@[.5:.95]).

    Uses the same greedy IoU matching as the in-loop validator
    (eval/metrics.py process_batch); area-range/maxdet stratification of the
    official COCOeval is not reproduced — this is the [all]/[maxDets=100]
    row only.
    """
    from .metrics import ap_per_class, process_batch

    with open(gt_json) as f:
        gt = json.load(f)
    with open(pred_json) as f:
        preds = json.load(f)

    cat_ids = sorted({c["id"] for c in gt.get("categories", [])})
    if not cat_ids:
        cat_ids = sorted({a["category_id"] for a in gt["annotations"]})
    cat_to_idx = {c: i for i, c in enumerate(cat_ids)}

    gt_by_img: Dict[object, list] = {}
    for a in gt["annotations"]:
        if a.get("iscrowd"):
            continue
        row = [cat_to_idx[a["category_id"]]] + _xywh_to_xyxy(a["bbox"])
        gt_by_img.setdefault(a["image_id"], []).append(row)
    pred_by_img: Dict[object, list] = {}
    for p in preds:
        if p["category_id"] not in cat_to_idx:
            continue
        row = _xywh_to_xyxy(p["bbox"]) + [p["score"],
                                          cat_to_idx[p["category_id"]]]
        pred_by_img.setdefault(p["image_id"], []).append(row)

    iouv = np.linspace(0.5, 0.95, 10)
    stats = []
    img_ids = [im["id"] for im in gt.get("images", [])] or sorted(
        set(gt_by_img) | set(pred_by_img)
    )
    for iid in img_ids:
        labels = np.array(gt_by_img.get(iid, np.zeros((0, 5))), np.float32)
        labels = labels.reshape(-1, 5)
        det = np.array(pred_by_img.get(iid, np.zeros((0, 6))), np.float32)
        det = det.reshape(-1, 6)
        if len(det):
            det = det[det[:, 4].argsort()[::-1]]
        correct = process_batch(det, labels, iouv)
        stats.append((
            correct,
            det[:, 4] if len(det) else np.zeros(0),
            det[:, 5] if len(det) else np.zeros(0),
            labels[:, 0],
        ))
    stats = [np.concatenate(x, 0) for x in zip(*stats)]
    if not len(stats) or not stats[0].any():
        return 0.0, 0.0
    _, _, ap, _, _, _ = ap_per_class(*stats)
    return float(ap[:, 0].mean()), float(ap.mean(1).mean())


def run_cocoeval(pred_json: str, gt_json: str) -> Tuple[float, float]:
    """Official pycocotools COCOeval when available, else the vendor-free
    re-scorer. Returns (mAP@0.5, mAP@[.5:.95])."""
    try:
        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval
    except ImportError:
        return evaluate_predictions_json(pred_json, gt_json)
    gt = COCO(gt_json)
    dt = gt.loadRes(pred_json)
    ev = COCOeval(gt, dt, "bbox")
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return float(ev.stats[1]), float(ev.stats[0])


def yolo_labels_to_coco_gt(img_files: Sequence[str], out_path: str,
                           nc: int, is_coco: bool = False) -> str:
    """Write a COCO ground-truth file for a YOLO-format split: each image's
    size from its header (EXIF orientation applied, as the loaders see it),
    its boxes from the label file beside it (`cls cx cy w h`, normalised),
    image ids as `coco_image_id` gives them and category ids as
    `validator.run` maps them (80->91 when is_coco). Returns `out_path`.
    Lets `validator.run(coco_gt_json=...)` score a split that has no COCO
    annotation file."""
    from ..data.datasets import img2label_path
    from ..data.image_io import image_size

    class_map = coco80_to_coco91_class() if is_coco else list(range(nc))
    images, anns = [], []
    for i, path in enumerate(img_files):
        w, h = image_size(path)
        image_id = coco_image_id(path, i)
        images.append({"id": image_id, "width": w, "height": h,
                       "file_name": Path(path).name})
        label = Path(img2label_path(path))
        rows = label.read_text().split("\n") if label.is_file() else []
        for row in rows:
            v = row.split()
            if len(v) < 5:
                continue
            c, cx, cy, bw, bh = int(float(v[0])), *map(float, v[1:5])
            box = [(cx - bw / 2) * w, (cy - bh / 2) * h, bw * w, bh * h]
            anns.append({"id": len(anns) + 1, "image_id": image_id,
                         "category_id": int(class_map[c]), "bbox": box,
                         "area": box[2] * box[3], "iscrowd": 0})
    with open(out_path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c, "name": str(c)}
                                  for c in class_map[:nc]]}, f)
    return out_path

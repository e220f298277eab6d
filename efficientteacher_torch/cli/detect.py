"""Inference CLI (counterpart of the root `detect.py`; reference
detect.py:34-...).

    python -m efficientteacher_torch.cli.detect --cfg <yaml> \
        --weights best.ckpt --source img_or_dir [--conf-thres 0.25 \
        --iou-thres 0.45 --save-dir runs/detect] [key value ...]

Reads images, directories, globs, `.txt` lists and video files frame by
frame (`data/loaders.py LoadImages`), letterboxes each image, runs the
eval forward
and the single-label NMS at max_nms 2048 (the greedy-NMS kernel on the
card) one image at a time, scales the detections back to the image's
pixels, and writes into `<save-dir>/exp[N]`: the annotated image under
its source's name and suffix (`utils/draw.py`, written by
`image_io.imwrite`: `.jpg` / `.jpeg`, `.png`, `.bmp` byte-equal to
cv2.imwrite's, `.tif` / `.tiff` as cv2 writes them, `.webp` lossless as
cv2.imwrite's default, its pixels read back equal), and with --save-txt the
YOLO-format labels, --save-crop the detections' crops, --save-xml
PASCAL-VOC annotations, as JAX's detect.py writes them. A video frame
("clip.mp4#7") writes under its file's stem, each frame over the one
before, as JAX's does; its annotated canvas would go to "clip.mp4", which
no image writer takes: without --nosave the run stops at the first frame
(NotImplementedError), where JAX's stops on cv2.imwrite's error (ROADMAP
F13: the reference writes a video with cv2.VideoWriter). Keypoint models
(`Dataset.np`) carry their points through the NMS with the obj-only gate
and draw them. --visualize writes each image's pyramid feature maps
(`utils/plots.feature_visualization`, needs matplotlib).

Weights: a port checkpoint or a reference `.pt` (`models/autoshape.
attempt_load`). It runs on the CUDA card in bf16 (as cli.val) unless the
override `device cpu` is given; without a card it raises RuntimeError.
`main` returns (the run directory, {path: detections (n, 6 + 2 np)},
{"read", "infer", "write": ms per image}).
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

from . import compute_dtype, resolve_device


def parse_opt(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m efficientteacher_torch.cli.detect")
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--weights", type=str, required=True)
    parser.add_argument("--source", type=str, required=True)
    parser.add_argument("--img-size", type=int, default=640)
    parser.add_argument("--conf-thres", type=float, default=0.25)
    parser.add_argument("--iou-thres", type=float, default=0.45)
    parser.add_argument("--max-det", type=int, default=300)
    parser.add_argument("--classes", type=int, nargs="+", default=None,
                        help="keep only these class indices")
    parser.add_argument("--agnostic-nms", action="store_true",
                        help="class-agnostic NMS")
    parser.add_argument("--save-dir", type=str, default="runs/detect")
    parser.add_argument("--save-txt", action="store_true")
    parser.add_argument("--save-crop", action="store_true",
                        help="save cropped detection patches")
    parser.add_argument("--save-xml", action="store_true",
                        help="save PASCAL-VOC style XML annotations")
    parser.add_argument("--nosave", action="store_true")
    parser.add_argument("--visualize", action="store_true",
                        help="write pyramid feature-map grids per image")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def _write_txt(path: Path, det, h0: int, w0: int) -> None:
    lines = []
    for row in det:
        xyxy, conf, cls = row[:4], row[4], row[5]
        cx = (xyxy[0] + xyxy[2]) / 2 / w0
        cy = (xyxy[1] + xyxy[3]) / 2 / h0
        bw = (xyxy[2] - xyxy[0]) / w0
        bh = (xyxy[3] - xyxy[1]) / h0
        lines.append(f"{int(cls)} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f} "
                     f"{conf:.4f}")
    path.write_text("\n".join(lines))


def _write_xml(path: Path, det, names, h0: int, w0: int) -> None:
    objs = "".join(
        f"<object><name>{names[int(c)] if int(c) < len(names) else int(c)}"
        f"</name><bndbox><xmin>{int(x1)}</xmin><ymin>{int(y1)}</ymin>"
        f"<xmax>{int(x2)}</xmax><ymax>{int(y2)}</ymax></bndbox>"
        f"</object>"
        for x1, y1, x2, y2, cf, c in det[:, :6])
    path.write_text(f"<annotation><size><width>{w0}</width>"
                    f"<height>{h0}</height></size>{objs}</annotation>")


def main(argv=None):
    opt = parse_opt(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    import numpy as np
    import torch

    from ..configs import get_cfg
    from ..data.image_io import imwrite
    from ..data.loaders import LoadImages
    from ..eval.validator import (InferFn, _scale_landmarks_to_native,
                                  _scale_to_native)
    from ..models.autoshape import attempt_load
    from ..utils import draw
    from ..utils.general import increment_path

    cfg = get_cfg()
    cfg.merge_from_file(opt.cfg)
    if opt.opts:
        cfg.merge_from_list(opt.opts)
    cfg.freeze()
    device = resolve_device(cfg.device)
    model = attempt_load(opt.weights, cfg, device=device)
    nc = model.spec.nc
    names = list(cfg.Dataset.names) or [str(i) for i in range(nc)]
    save_dir = increment_path(Path(opt.save_dir) / "exp", mkdir=True)

    # keypoint models: the keypoint columns ride through NMS with the
    # obj-only candidate gate (reference detect.py:206)
    npk = int(cfg.Dataset.np)
    infer = InferFn(model, float(cfg.Dataset.norm_scale),
                    compute_dtype(device), dict(
                        nc=nc, conf_thres=opt.conf_thres,
                        iou_thres=opt.iou_thres, max_det=opt.max_det,
                        max_nms=2048, n_extra=2 * npk, obj_gate=npk > 0,
                        classes=tuple(opt.classes) if opt.classes else None,
                        agnostic=opt.agnostic_nms))
    size = (opt.img_size, opt.img_size)
    results, speed = {}, {"read": 0.0, "infer": 0.0, "write": 0.0}
    t0 = time.perf_counter()
    for img_path, rgb, img0, _ in LoadImages(opt.source, opt.img_size):
        t1 = time.perf_counter()
        # a video frame's files are its file's (JAX's split("#")[0])
        source = Path(img_path.split("#")[0])
        stem = source.stem
        x = torch.from_numpy(rgb).to(device)[None]
        if opt.visualize:
            from ..utils.plots import feature_visualization

            with torch.inference_mode():
                xin = (x.permute(0, 3, 1, 2).float()
                       / float(cfg.Dataset.norm_scale))
                feats = model.neck(model.backbone(xin))
            feature_visualization(
                [f.permute(0, 2, 3, 1).float().cpu().numpy() for f in feats],
                save_dir / f"{stem}_features.png")
        out = infer(x)
        det = out.detections[0][out.valid[0]].cpu().numpy()
        t2 = time.perf_counter()
        if len(det):
            det[:, :4] = _scale_to_native(det[:, :4], size, img0.shape[:2])
            if npk:
                det[:, 6:6 + 2 * npk] = _scale_landmarks_to_native(
                    det[:, 6:6 + 2 * npk], size, img0.shape[:2])
        print(f"{img_path}: {len(det)} detections")
        h0, w0 = img0.shape[:2]
        if opt.save_txt:
            _write_txt(save_dir / (stem + ".txt"), det, h0, w0)
        if opt.save_crop and len(det):
            crop_dir = save_dir / "crops"
            crop_dir.mkdir(exist_ok=True)
            for j, row in enumerate(det):
                x1, y1 = max(0, int(row[0])), max(0, int(row[1]))
                x2, y2 = int(row[2]), int(row[3])
                if x2 > x1 and y2 > y1:
                    imwrite(str(crop_dir / f"{stem}_{j}.jpg"),
                            img0[y1:y2, x1:x2])
        if opt.save_xml:
            _write_xml(save_dir / (stem + ".xml"), det, names, h0, w0)
        if not opt.nosave:
            for row in det:
                c = int(row[5])
                color = draw.color_of(c)
                draw.box_label(img0, row[:4],
                               f"{names[c] if c < len(names) else c} "
                               f"{row[4]:.2f}", color)
                for k in range(npk):
                    draw.circle(img0, (row[6 + 2 * k], row[7 + 2 * k]),
                                color)
            imwrite(str(save_dir / source.name), img0)
        results[img_path] = det
        t3 = time.perf_counter()
        speed["read"] += t1 - t0
        speed["infer"] += t2 - t1
        speed["write"] += t3 - t2
        t0 = time.perf_counter()
    n = max(len(results), 1)
    speed = {k: v / n * 1e3 for k, v in speed.items()}
    logging.getLogger(__name__).info(
        "Speed: %.1f ms read + letterbox, %.1f ms forward + NMS, %.1f ms "
        "draw + write per image", speed["read"], speed["infer"],
        speed["write"])
    print(f"results saved to {save_dir}")
    return save_dir, results, speed


if __name__ == "__main__":
    main()

"""Validation CLI (counterpart of the root `val.py`; reference
val.py:468-512).

    python -m efficientteacher_torch.cli.val --cfg <yaml> \
        --weights runs/train/exp/weights/best.ckpt [key value ...]

Builds the config's model, loads the checkpoint's EMA (the teacher of an
SSOD run; a port checkpoint or a reference `.pt`, `utils/torch_import.py`,
every tensor of the model matched) and runs `validator.run` over `create_dataloader(cfg, "val",
augment=False)` (the rect loader under `Dataset.rect`), on the CUDA card
unless the override `device cpu` is given. It takes the JAX CLI's flags:
--save-json writes the COCO-format predictions (80->91 category ids when
the model has 80 classes and the val path names coco) and --coco-gt runs
COCOeval on them (`eval/coco.py`); --val-kp scores the keypoints of a
`Dataset.np` model by OKS (`eval/keypoint_metrics.py`). --plots DIR writes
the PR / F1 / P / R curves there (matplotlib; without it ImportError).
--selection approx runs the exact selection. Prints and returns (P, R, mAP50, mAP50-95).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

from . import compute_dtype, resolve_device


def parse_opt(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m efficientteacher_torch.cli.val")
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--weights", type=str, required=True)
    parser.add_argument("--conf-thres", type=float, default=0.001)
    parser.add_argument("--iou-thres", type=float, default=0.6)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--save-json", type=str, default=None)
    parser.add_argument("--coco-gt", type=str, default=None)
    parser.add_argument("--confusion", action="store_true",
                        help="print the confusion matrix")
    parser.add_argument("--plots", type=str, default=None, metavar="DIR")
    parser.add_argument("--val-kp", action="store_true")
    parser.add_argument("--selection", type=str, default=None,
                        choices=["pallas", "exact", "approx"])
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv=None):
    opt = parse_opt(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    import numpy as np

    from ..configs import get_cfg
    from ..data.datasets import create_dataloader
    from ..eval import validator
    from ..models import build_model, spec_from_cfg
    from ..utils.torch_import import load_weights_into

    cfg = get_cfg()
    cfg.merge_from_file(opt.cfg)
    if opt.opts:
        cfg.merge_from_list(opt.opts)
    cfg.freeze()
    device = resolve_device(cfg.device)
    # the detector alone, as JAX's val builds it (ssod=False): an SSOD
    # checkpoint's discriminators are not read
    spec = dataclasses.replace(spec_from_cfg(cfg), train_domain=False)
    model = build_model(spec, device=device)
    # a port checkpoint or a reference .pt, its EMA preferred; every
    # tensor of the model must be found
    load_weights_into(model, opt.weights, strict=True)
    model.eval()
    loader = create_dataloader(cfg, "val", augment=False,
                               batch_size=opt.batch_size,
                               pin_memory=device.type == "cuda")
    # COCO val set -> 80->91 category ids in the JSON (reference val.py:263)
    is_coco = opt.save_json is not None and spec.nc == 80 \
        and "coco" in str(cfg.Dataset.val).lower()
    out = validator.run(
        model, loader, nc=spec.nc, conf_thres=opt.conf_thres,
        iou_thres=opt.iou_thres, norm_scale=float(cfg.Dataset.norm_scale),
        compute_dtype=compute_dtype(device), save_json=opt.save_json,
        coco_gt_json=opt.coco_gt, confusion=opt.confusion, is_coco=is_coco,
        plots_dir=opt.plots, names=list(cfg.Dataset.names),
        num_points=int(cfg.Dataset.np), val_kp=opt.val_kp,
        selection=opt.selection,
    )
    results = out[0]
    print("P=%.4f R=%.4f mAP50=%.4f mAP50-95=%.4f" % results)
    if opt.confusion:
        print("confusion matrix (pred x true):")
        with np.printoptions(precision=0, suppress=True):
            print(out[3].matrix)
    return results


if __name__ == "__main__":
    main()

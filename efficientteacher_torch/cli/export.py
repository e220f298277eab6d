"""Export CLI (counterpart of the root `export.py`; reference export.py:78-94
and deploy/model_convert.py).

    python -m efficientteacher_torch.cli.export --cfg <yaml> \
        --weights best.ckpt --include params deploy torch torchscript onnx \
        --img-size 640 [key value ...]

(--include takes every word up to the next flag: give another flag after
it, before the overrides.)

Formats, written beside the weights (or at --out's stem):
  params       `<stem>.params.ckpt`: the stripped eval checkpoint (EMA
               preferred, fp16)
  deploy       `<stem>.deploy.ckpt`: the RepVGG-fused deploy model
               (`utils/reparam.deploy_model`)
  torch        `<stem>.state_dict.npz`: the reference-named flat state_dict
               (float32), loadable without the port
  torchscript  `<stem>.torchscript`: the deploy model traced by
               `torch.jit.trace` (NCHW float input / 255 -> decoded
               predictions), the framework's own frozen serving graph; it
               runs on the device it was exported on (the decode's grids
               are traced there)
  onnx         `<stem>.onnx`: the deploy model written by
               `export/onnx_graph.py` at --opset (13), traced on the host
               (the file does not depend on the device), with the decode,
               no BatchNormalization node; cv2.dnn runs it

`saved_model`, `pb`, `tflite` and `--int8` go through jax2tf in the JAX
package; the port has no TensorFlow converter, so they raise
NotImplementedError (ROADMAP Q1.12). Weights: a port checkpoint or a
reference `.pt`. Runs on the CUDA card unless the override `device cpu` is
given. `main` returns {format: {"path", "seconds"}}; the ONNX entry also
has "nodes", its op census.
"""

from __future__ import annotations

import argparse
import copy
import logging
import time
from pathlib import Path

LOGGER = logging.getLogger(__name__)

FORMATS = ["params", "deploy", "torch", "torchscript", "onnx", "saved_model",
           "pb", "tflite"]
TF_FORMATS = ("saved_model", "pb", "tflite")


def parse_opt(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m efficientteacher_torch.cli.export")
    p.add_argument("--cfg", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--include", nargs="+", default=["params"],
                   choices=FORMATS)
    p.add_argument("--opset", type=int, default=13,
                   help="ONNX opset (reference export.py default 13)")
    p.add_argument("--int8", action="store_true",
                   help="full-integer TFLite quantization (not ported)")
    p.add_argument("--data-dir", default=None,
                   help="int8 representative images (not ported)")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--out", default=None, help="output stem")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_opt(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    tf = [f for f in opt.include if f in TF_FORMATS] + (
        ["--int8"] if opt.int8 else [])
    if tf:
        raise NotImplementedError(
            f"{tf}: the JAX package makes these through jax2tf; the port "
            f"has no TensorFlow converter (ROADMAP Q1.12). Export "
            f"torchscript or onnx")
    import numpy as np
    import torch

    from ..configs import get_cfg
    from ..models.autoshape import attempt_load
    from ..utils.checkpoint import module_variables, save_checkpoint
    from ..utils.reparam import deploy_model
    from ..utils.torch_import import read_variables, reference_name
    from . import resolve_device

    cfg = get_cfg()
    cfg.merge_from_file(opt.cfg)
    if opt.opts:
        cfg.merge_from_list(opt.opts)
    cfg.freeze()
    device = resolve_device(cfg.device)
    stem = Path(opt.out or opt.weights).with_suffix("")
    done = {}

    def finish(fmt, path, t0, **extra):
        done[fmt] = {"path": path, "seconds": time.perf_counter() - t0,
                     **extra}
        LOGGER.info("%s -> %s (%.1f s)", fmt, path, done[fmt]["seconds"])

    if "params" in opt.include or "torch" in opt.include:
        t0 = time.perf_counter()
        variables = read_variables(opt.weights)
        if "params" in opt.include:
            out = stem.with_suffix(".params.ckpt")
            save_checkpoint(out, params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            cfg_yaml=cfg.dump())
            finish("params", out, t0)
        if "torch" in opt.include:
            t0 = time.perf_counter()
            sd = {reference_name(k): v.numpy()
                  for g in ("params", "batch_stats")
                  for k, v in variables[g].items()}
            out = stem.with_suffix(".state_dict.npz")
            np.savez(out, **sd)
            finish("torch", out, t0)

    if not {"deploy", "torchscript", "onnx"} & set(opt.include):
        return done
    t0 = time.perf_counter()
    fused = deploy_model(attempt_load(opt.weights, cfg, device=device))
    LOGGER.info("RepVGG-fused deploy model built in %.1f s",
                time.perf_counter() - t0)
    if "deploy" in opt.include:
        t0 = time.perf_counter()
        v = module_variables(fused)
        out = stem.with_suffix(".deploy.ckpt")
        save_checkpoint(out, params=v["params"],
                        batch_stats=v["batch_stats"], cfg_yaml=cfg.dump())
        finish("deploy", out, t0)
    example = torch.zeros((opt.batch, 3, opt.img_size, opt.img_size),
                          device=device)
    if "torchscript" in opt.include:
        from ..export.onnx_graph import Decoded

        t0 = time.perf_counter()
        with torch.no_grad():
            ts = torch.jit.trace(Decoded(fused).eval(), example)
        out = stem.with_suffix(".torchscript")
        ts.save(str(out))
        finish("torchscript", out, t0)
    if "onnx" in opt.include:
        from ..export.onnx_graph import export_onnx

        t0 = time.perf_counter()
        out = stem.with_suffix(".onnx")
        # the file is the same whatever the device: traced on the host
        census = export_onnx(copy.deepcopy(fused).cpu(), example.cpu(), out,
                             opset=opt.opset)
        finish("onnx", out, t0, nodes=census)
        LOGGER.info("onnx: opset %d, %d nodes %s", opt.opset,
                    sum(census.values()), census)
    return done


if __name__ == "__main__":
    main()

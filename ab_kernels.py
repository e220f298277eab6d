#!/usr/bin/env python3
"""The port's NMS-path kernels against those of another checkout of the
repo, on one CUDA card: the same inputs, the same timers, one process.

    mkdir -p smoke_tree/parent
    git archive <parent commit> | tar -x -C smoke_tree/parent
    python3 ab_kernels.py smoke_tree/parent

Each tree builds its kernels from its own `efficientteacher_torch/csrc/`
into its own `_build/`; the other tree's package is loaded under another
name. The inputs are chip_smoke.py's: batch 0 of each weight regime of
YOLOv5l b32@640 bf16, its lattice (32, 2,016,000) and the K1 input
(32, 30208) that the selection gives. Per regime, each measurement runs in
the order other, this, this, other:

  - greedy_nms_keep_cuda and threshold_compact_cuda: device time (CUDA
    graph of 50 launches, `chip_smoke.event_ms(graph=True)`) and eager
    calls (`event_ms`, host costs included);
  - the count of the first bisection pass's 8 thresholds: the other
    tree's count (its plain `_count_ge` where it has no `count_ge_cuda`)
    against this tree's `count_ge_cuda`, eager and graphed;
  - the whole NMS (`InferFn.nms`), host clock (`chip_smoke.time_ms`).

Every output is compared between the trees and must be equal. Prints one
line per measurement and, as the last line, a JSON object with every
median. Exits non-zero without a card or on any mismatch.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

OTHER = "et_other"  # the other tree's package name in this process


def load_other(root: Path):
    """The other checkout's `efficientteacher_torch`, imported as OTHER."""
    init = root / "efficientteacher_torch" / "__init__.py"
    if not init.exists():
        raise SystemExit(f"ab_kernels: no efficientteacher_torch in {root}")
    spec = importlib.util.spec_from_file_location(
        OTHER, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = mod
    spec.loader.exec_module(mod)
    return {m: importlib.import_module(f"{OTHER}.{m}")
            for m in ("ops.nms_cuda", "ops.select_cuda", "eval.validator")}


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    other = load_other(Path(sys.argv[1]).resolve())

    from efficientteacher_torch.ops.nms import _finish_pairs, _pair_scores
    from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
    from efficientteacher_torch.ops.select_cuda import (
        _SLACK, _T_BISECT, count_ge_cuda, exact_topk_rows,
        threshold_compact_cuda)

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)} torch={torch.__version__}"
          f" | {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False

    # chip_smoke draws its K1 test fields from the generator first: draw
    # them too, so that the images (and the lattices) are chip_smoke's
    g = torch.Generator().manual_seed(cs.SEED)
    for _ in cs.random_nms_fields(torch, g, "cpu"):
        pass
    model, regimes, infer, images = cs.serving_setup(torch, dev, g)
    o_infer = other["eval.validator"].make_infer_fn(
        model, nc=cs.NC, conf_thres=cs.CONF, iou_thres=cs.IOU,
        max_det=cs.MAX_DET, max_nms=cs.MAX_NMS, norm_scale=255.0,
        compute_dtype=torch.bfloat16)
    o_nms = other["ops.nms_cuda"].greedy_nms_keep_cuda
    o_sel = other["ops.select_cuda"]
    o_compact = o_sel.threshold_compact_cuda
    o_count = getattr(o_sel, "count_ge_cuda", o_sel._count_ge)

    cap = -(-(cs.MAX_NMS + _SLACK) // 128) * 128
    zero = torch.zeros(cs.B, device=dev)
    inf = torch.full((cs.B,), float("inf"), device=dev)
    fr = torch.arange(1, _T_BISECT + 1, dtype=torch.float32,
                      device=dev) / (_T_BISECT + 1)
    result = {}
    for name, sd in regimes.items():
        model.load_state_dict(sd)
        decoded = infer.forward(images[0])
        flat, boxes_xyxy, _ = _pair_scores(decoded, cs.NC, cs.CONF, False, 0,
                                           False, None)
        ts, ti = exact_topk_rows(flat, cs.MAX_NMS)
        nms_boxes, cand_valid, _ = _finish_pairs(ts, ti, boxes_xyxy, None,
                                                 cs.NC, False, 256)
        taus = (fr[None, :] * flat.max(1).values[:, None]).contiguous()
        k1 = (nms_boxes, cand_valid, cs.IOU, 256, cs.MAX_DET)
        k2 = (flat, zero, inf, cap)
        pairs = {
            "greedy_nms_keep": (lambda: o_nms(*k1),
                                lambda: greedy_nms_keep_cuda(*k1)),
            "threshold_compact": (lambda: o_compact(*k2),
                                  lambda: threshold_compact_cuda(*k2)),
            "count_8": (lambda: o_count(flat, taus),
                        lambda: count_ge_cuda(flat, taus)),
            "nms": (lambda: o_infer.nms(decoded), lambda: infer.nms(decoded)),
        }
        for what, (fo, fc) in pairs.items():
            a, b = fo(), fc()
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                print(f"ab_kernels: {what} differs between the trees in "
                      f"regime {name}", file=sys.stderr)
                return 1
        row = result[name] = {}
        for what, (fo, fc) in pairs.items():
            timers = ({"host_ms": lambda f: cs.time_ms(torch, f, reps=5)}
                      if what == "nms" else
                      {"graph_ms": lambda f: cs.event_ms(torch, f,
                                                         graph=True)[0],
                       "eager_ms": lambda f: cs.event_ms(torch, f)[0]})
            for tname, timer in timers.items():
                t = [timer(f) for f in (fo, fc, fc, fo)]
                row[f"{what}.{tname}"] = {"other": [t[0], t[3]],
                                          "this": [t[1], t[2]]}
                print(f"[ab] {name}: {what} {tname}: other {t[0]:.4f} / "
                      f"{t[3]:.4f}, this {t[1]:.4f} / {t[2]:.4f} | {card}")
    print(json.dumps({"card": card, "ab": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: YOLOv5l eval serving.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `efficientteacher_torch/csrc/`, checks
each against its plain PyTorch version, serves YOLOv5l (nc 80) b32@640 in
bf16 through `make_infer_fn` (conf 0.001, IoU 0.6, max_nms 30000, max_det
300) for 3 batches in each of three weight regimes, and times the forward,
the NMS and each kernel against its plain version.

Phases print one or more lines each, prefixed by the phase. The line before
the last is a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}. Any failed check exits non-zero before
that. Without a CUDA card it exits 2 and prints no result. Imports neither
jax nor the JAX package. Weights are the port's own seeded init.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

B, IMG, NC = 32, 640, 80
CONF, IOU, MAX_NMS, MAX_DET = 0.001, 0.6, 30000, 300
N_BATCHES = 3
SEED = 0


class SmokeFailure(Exception):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def time_ms(torch, fn, reps=5, warmup=1):
    """Median wall time of `fn` in ms, each run ended by a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def random_nms_fields(torch, g, dev):
    """K1 inputs at the two K of the main path (eval 30208, SSOD 2048):
    class-offset xyxy boxes in score order, with empty, sparse, mid and
    dense validity, with and without holes."""
    for k in (2048, 30208):
        xy = torch.rand(B, k, 2, generator=g) * 600
        wh = torch.rand(B, k, 2, generator=g) * 190 + 10
        cls = torch.randint(0, NC, (B, k, 1), generator=g).float() * 7680.0
        boxes = (torch.cat([xy, xy + wh], -1) + cls).to(dev)
        holes = torch.rand(B, k, generator=g) < 0.3
        for name, n in (("empty", 0), ("sparse", 9), ("mid", 3000),
                        ("dense", k)):
            for holed in (False, True):
                valid = torch.zeros(B, k, dtype=torch.bool)
                valid[:, :n] = True
                if holed:
                    valid &= ~holes
                yield k, f"{name}{'+holes' if holed else ''}", boxes, \
                    valid.to(dev)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2

    from efficientteacher_torch.eval.validator import make_infer_fn
    from efficientteacher_torch.models import build_model
    from efficientteacher_torch.ops import _build
    from efficientteacher_torch.ops.nms import _finish_pairs, _pair_scores
    from efficientteacher_torch.ops.nms_cuda import (greedy_nms_keep,
                                                     greedy_nms_keep_cuda)
    from efficientteacher_torch.ops.select_cuda import (
        _SLACK, check_exact_topk, exact_topk_elems, exact_topk_rows,
        threshold_compact, threshold_compact_cuda)
    from efficientteacher_torch.utils.eval_regimes import (
        make_density_fn, mid_density, saturate_obj, yolov5l_spec)

    # 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else "nvidia-smi gave nothing"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # heuristic (not timed) algorithm choice: the mid regime's density
    # depends on the convolutions' rounding (utils/eval_regimes.py)
    torch.backends.cudnn.benchmark = False
    print(f"[device] {kind} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(card)
    print(f"[device] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # 2. kernel build
    t0 = time.perf_counter()
    built = _build.library()
    print(f"[build] {len(built.sources)} sources from "
          f"{built.sources[0].parent} -> {built.path.name}: nvcc "
          f"{built.seconds:.1f} s, load {time.perf_counter() - t0:.1f} s")
    for line in built.log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")

    g = torch.Generator().manual_seed(SEED)

    # 3. K1 against its plain version
    k1_err = 0
    for k, field, boxes, valid in random_nms_fields(torch, g, dev):
        for stop_at in (None, MAX_DET):
            got = greedy_nms_keep_cuda(boxes, valid, IOU, 256, stop_at)
            ref = greedy_nms_keep(boxes, valid, IOU, 256, stop_at)
            err = int((got != ref).sum())
            k1_err = max(k1_err, err)
            print(f"[k1] K={k} {field:13s} stop_at={stop_at}: kept "
                  f"{int(got.sum())}, rows differing {err}")
            require(err == 0, f"K1 mask differs at K={k} {field}")

    # 4-5. the slice: YOLOv5l b32@640 bf16 in three weight regimes
    model = build_model(yolov5l_spec(), device=dev,
                        generator=torch.Generator().manual_seed(SEED))
    model = model.to(memory_format=torch.channels_last)
    base = {kk: v.clone() for kk, v in model.state_dict().items()}
    calib = torch.randint(0, 256, (8, IMG, IMG, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(1))
    regimes = {"representative": base,
               "mid": mid_density(model, calib.to(dev)),
               "saturated": saturate_obj(base)}
    infer = make_infer_fn(model, nc=NC, conf_thres=CONF, iou_thres=IOU,
                          max_det=MAX_DET, max_nms=MAX_NMS, norm_scale=255.0,
                          compute_dtype=torch.bfloat16)
    density = make_density_fn(model, NC, CONF)
    images = [torch.randint(0, 256, (B, IMG, IMG, 3), generator=g,
                            dtype=torch.uint8).to(dev)
              for _ in range(N_BATCHES)]

    for name, sd in regimes.items():  # warm-up: allocator, cuDNN handles
        model.load_state_dict(sd)
        infer(images[0])
    torch.cuda.synchronize()

    greedy_nms_keep_cuda.launches = 0
    threshold_compact_cuda.launches = 0
    outputs = {}
    for name, sd in regimes.items():
        model.load_state_dict(sd)
        outputs[name] = [infer(im) for im in images]
    torch.cuda.synchronize()
    launches = {"k1": greedy_nms_keep_cuda.launches,
                "k2": threshold_compact_cuda.launches}
    print(f"[slice] launches on the main path: greedy_nms_keep "
          f"{launches['k1']}, threshold_compact {launches['k2']}")
    require(launches["k1"] > 0 and launches["k2"] > 0,
            "a kernel of the path was not launched")

    k2_err = 0.0
    lattices = {}
    for name, sd in regimes.items():
        model.load_state_dict(sd)
        per_batch = [density(im) for im in images]
        cands = sum(c for c, _ in per_batch) / len(per_batch)
        rows = max(r for _, r in per_batch)
        if name == "mid":
            require(1e3 <= cands <= 1e4,
                    f"mid regime holds {cands:.1f} candidates/img")
        for bi, (im, out) in enumerate(zip(images, outputs[name])):
            det, val = out
            require(det.shape == (B, MAX_DET, 6) and val.shape == (B, MAX_DET),
                    f"{name}: output shapes {tuple(det.shape)}")
            require(bool(torch.isfinite(det).all()), f"{name}: non-finite")
            require(int(val.sum(1).max()) <= MAX_DET, f"{name}: > max_det")
            decoded = infer.forward(im)
            ref = infer.nms(decoded, use_kernels=False)
            again = infer.nms(decoded)
            same = (torch.equal(again.detections, ref.detections)
                    and torch.equal(again.valid, ref.valid))
            require(same, f"{name} batch {bi}: kernel and plain NMS differ")
            if bi == 0:
                lattices[name] = decoded
        print(f"[slice] {name}: candidates/img {cands:.1f} (per batch "
              f"{', '.join(f'{c:.1f}' for c, _ in per_batch)}), max live "
              f"rows {rows}, detections/img "
              f"{float(outputs[name][0].valid.sum(1).float().mean()):.1f}; "
              f"{N_BATCHES} batches finite, <= {MAX_DET}/img, kernel NMS "
              f"== plain NMS")

    # K2 against its plain version, on the real (32, 2,016,000) lattices
    cap = -(-(MAX_NMS + _SLACK) // 128) * 128
    zero = torch.zeros(B, device=dev)
    half = torch.full((B,), 0.5, device=dev)
    inf = torch.full((B,), float("inf"), device=dev)
    flats = {}
    for name, decoded in lattices.items():
        flat, boxes_xyxy, _ = _pair_scores(decoded, NC, CONF, False, 0, False,
                                           None)
        flats[name] = (flat, boxes_xyxy)
        live = (torch.nn.functional.pad(flat, (0, (-flat.shape[1]) % 128),
                                        value=-1.0)
                .view(B, -1, 128) > 0).any(-1).float().contiguous()
        for what, args in (("elements", (flat, zero, inf, cap)),
                           ("rows", (live, half, inf, 1024))):
            ks, ki = threshold_compact_cuda(*args)
            ps, pi = threshold_compact(*args)
            err = float((ks - ps).abs().max())
            require(torch.equal(ks, ps) and torch.equal(ki, pi),
                    f"K2 {what} buffer differs in regime {name}")
            k2_err = max(k2_err, err, float((ki - pi).abs().max()))
            print(f"[k2] {name}: {what} buffer {tuple(ks.shape)} bit-equal, "
                  f"{int((ks > 0).sum(1).max())} survivors kept (max/img)")
        for engine in (exact_topk_rows, exact_topk_elems):
            ts, ti = engine(flat, MAX_NMS)
            check_exact_topk(flat, MAX_NMS, ts, ti)
            print(f"[k2] {name}: {engine.__name__} meets the exact top-k "
                  f"contract against torch.topk over the lattice")

    # 6. times (median of warm runs, ms)
    def fwd():
        infer.forward(images[0])

    t_fwd = time_ms(torch, fwd, reps=10, warmup=3)
    print(f"[time] forward bf16 b{B}@{IMG}: {t_fwd:.3f} ms/batch | {card}")
    times = {}
    for name, sd in regimes.items():
        decoded = lattices[name]
        t_k = time_ms(torch, lambda: infer.nms(decoded))
        t_p = time_ms(torch, lambda: infer.nms(decoded, use_kernels=False))
        flat, boxes_xyxy = flats[name]
        ts, ti = exact_topk_rows(flat, MAX_NMS)
        nms_boxes, cand_valid, _ = _finish_pairs(ts, ti, boxes_xyxy, None,
                                                 NC, False, 256)
        k1 = (nms_boxes, cand_valid, IOU, 256, MAX_DET)
        k2 = (flat, zero, inf, cap)
        times[name] = {
            "k1": time_ms(torch, lambda: greedy_nms_keep_cuda(*k1)),
            "k1_plain": time_ms(torch, lambda: greedy_nms_keep(*k1)),
            "k2": time_ms(torch, lambda: threshold_compact_cuda(*k2)),
            "k2_plain": time_ms(torch, lambda: threshold_compact(*k2)),
        }
        tt = times[name]
        print(f"[time] {name}: NMS kernels {t_k:.3f} ms, plain {t_p:.3f} ms"
              f" | greedy_nms_keep (32, {nms_boxes.shape[1]}) kernel "
              f"{tt['k1']:.3f} ms, plain {tt['k1_plain']:.3f} ms | "
              f"threshold_compact (32, {flat.shape[1]}) kernel "
              f"{tt['k2']:.3f} ms, plain {tt['k2_plain']:.3f} ms | {card}")

    mid = times["mid"]
    print(json.dumps({"kernels": [
        {"name": "greedy_nms_keep", "route": "cuda",
         "source": "efficientteacher_torch/csrc/nms.cu",
         "replaces": "efficientteacher_tpu/ops/nms_pallas.py:138",
         "launches": launches["k1"], "max_abs_err": float(k1_err),
         "ms": mid["k1"], "plain_ms": mid["k1_plain"]},
        {"name": "threshold_compact", "route": "cuda",
         "source": "efficientteacher_torch/csrc/select.cu",
         "replaces": "efficientteacher_tpu/ops/select_pallas.py:218",
         "launches": launches["k2"], "max_abs_err": k2_err,
         "ms": mid["k2"], "plain_ms": mid["k2_plain"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)

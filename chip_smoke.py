#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: YOLOv5l eval serving.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `efficientteacher_torch/csrc/`, checks
each against its plain PyTorch version, serves YOLOv5l (nc 80) b32@640 in
bf16 through `make_infer_fn` (conf 0.001, IoU 0.6, max_nms 30000, max_det
300) for 3 batches in each of three weight regimes, counts the kernels'
launches and the selection engine's tiers on that run, and times the
forward, the NMS, the selection engine against `torch.topk`, and each
kernel against its plain version and its bound (bytes over 3.35 TB/s,
fp32 operations over 67 TFLOP/s: the H100 SXM's published peaks; bytes
count each input read once and each output written once, and for K1 only
the boxes of the tiles its sweep reaches). Kernel times are CUDA-event
medians over 5 repeats of a CUDA graph of 50 launches (device time: a
wrapper's host call costs more than a small kernel); plain versions and
`torch.topk` are timed as 5 x 50 eager calls.

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
HBM_BYTES_S = 3.35e12    # H100 SXM device memory
FP32_OPS_S = 67e12       # H100 SXM fp32 outside the tensor cores
IOU_OPS = 12             # fp32 operations of one IoU test (ops/boxes.py)


class SmokeFailure(Exception):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def event_ms(torch, fn, launches=50, repeats=5, graph=False):
    """(median, min, max) over `repeats` of the CUDA-event time of
    `launches` back-to-back calls, per call, in ms, after one warm-up.
    graph=True captures the calls in a CUDA graph and times its replays:
    the device time of a kernel's launches without the host's (a wrapper's
    Python and ctypes call take ~20-30 us, more than a small kernel)."""
    fn()
    torch.cuda.synchronize()
    run = None
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(launches):
                fn()
        g.replay()
        torch.cuda.synchronize()
        run = g.replay
    per = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if run is not None:
            run()
        else:
            for _ in range(launches):
                fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / launches)
    return statistics.median(per), min(per), max(per)


def bound(nbytes, ops=0.0):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and fp32
    operations / fp32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nms_iou_tests(torch, box_iou, boxes, valid, keep, tile, stop_at, thr):
    """(IoU tests, rows swept) that greedy NMS needs on these inputs: each
    valid row of the swept tiles against the rows kept before it, in
    order, up to its first suppressing one (all of them for a kept row);
    the swept rows are those whose boxes must be read."""
    total = swept = 0
    for b in range(boxes.shape[0]):
        rows = torch.nonzero(valid[b])[:, 0]
        if rows.numel() == 0:
            continue
        valid_tiles = int(rows[-1]) // tile + 1
        kept_per_tile = keep[b, :valid_tiles * tile].view(-1, tile).sum(1)
        end, cnt = 0, 0
        for ti in range(valid_tiles):
            if stop_at is not None and cnt >= stop_at:
                break
            cnt += int(kept_per_tile[ti])
            end = (ti + 1) * tile
        swept += end
        rows = rows[rows < end]
        kept = torch.nonzero(keep[b, :end])[:, 0]
        if kept.numel() == 0:
            continue
        before = kept[None, :] < rows[:, None]
        sup = (box_iou(boxes[b, rows], boxes[b, kept]) > thr) & before
        first = sup.int().argmax(1) + 1
        total += int(torch.where(sup.any(1), first, before.sum(1)).sum())
    return total, swept


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


def serving_setup(torch, dev, g):
    """(model, regimes, infer, images): YOLOv5l from the seeded init on
    `dev`, channels-last; its three weight regimes as state dicts; the
    eval infer function at the reference settings; N_BATCHES uint8
    batches drawn from `g`."""
    from efficientteacher_torch.eval.validator import make_infer_fn
    from efficientteacher_torch.models import build_model
    from efficientteacher_torch.utils.eval_regimes import (
        mid_density, saturate_obj, yolov5l_spec)

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
    images = [torch.randint(0, 256, (B, IMG, IMG, 3), generator=g,
                            dtype=torch.uint8).to(dev)
              for _ in range(N_BATCHES)]
    return model, regimes, infer, images


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2

    from efficientteacher_torch.ops import _build, select_cuda
    from efficientteacher_torch.ops.boxes import box_iou
    from efficientteacher_torch.ops.nms import _finish_pairs, _pair_scores
    from efficientteacher_torch.ops.nms_cuda import (greedy_nms_keep,
                                                     greedy_nms_keep_cuda)
    from efficientteacher_torch.ops.select_cuda import (
        _SLACK, _T_BISECT, _TINY, _count_ge, check_exact_topk,
        count_ge_cuda, exact_topk_elems, exact_topk_rows, threshold_compact,
        threshold_compact_cuda)
    from efficientteacher_torch.utils.eval_regimes import make_density_fn

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
            ref = greedy_nms_keep(boxes, valid, IOU, 256, stop_at)
            got = greedy_nms_keep_cuda(boxes, valid, IOU, 256, stop_at)
            err = int((got != ref).sum())
            k1_err = max(k1_err, err)
            print(f"[k1] K={k} {field:13s} stop_at={stop_at}: kept "
                  f"{int(ref.sum())}, rows differing {err}")
            require(err == 0, f"K1 mask differs at K={k} {field}")

    # 4-5. the slice: YOLOv5l b32@640 bf16 in three weight regimes
    model, regimes, infer, images = serving_setup(torch, dev, g)
    density = make_density_fn(model, NC, CONF)

    for name, sd in regimes.items():  # warm-up: allocator, cuDNN handles
        model.load_state_dict(sd)
        infer(images[0])
    torch.cuda.synchronize()

    wrappers = {"greedy_nms_keep": greedy_nms_keep_cuda,
                "threshold_compact": threshold_compact_cuda,
                "count_ge": count_ge_cuda}
    for fn in wrappers.values():
        fn.launches = 0
    outputs, tiers = {}, {}
    for name, sd in regimes.items():
        model.load_state_dict(sd)
        select_cuda.tier_counts.clear()
        outputs[name] = [infer(im) for im in images]
        tiers[name] = dict(sorted(select_cuda.tier_counts.items()))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"[slice] launches on the main path: "
          f"{', '.join(f'{n} {c}' for n, c in launches.items())}")
    print(f"[slice] selection tiers per regime ({N_BATCHES} batches each): "
          f"{'; '.join(f'{n} {t}' for n, t in tiers.items())}; "
          f"fallbacks to torch.topk after bisection: "
          f"{sum(t.get('elems:fallback_topk', 0) for t in tiers.values())}")
    require(all(c > 0 for c in launches.values()),
            f"a kernel of the path was not launched: {launches}")

    lattices = {}
    for name, sd in regimes.items():
        model.load_state_dict(sd)
        per_batch = [density(im) for im in images]
        cands = sum(c for c, _ in per_batch) / len(per_batch)
        live_rows = max(r for _, r in per_batch)
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
              f"rows {live_rows}, detections/img "
              f"{float(outputs[name][0].valid.sum(1).float().mean()):.1f}; "
              f"{N_BATCHES} batches finite, <= {MAX_DET}/img, kernel NMS "
              f"== plain NMS")

    # K2 and the count against their plain versions, on the real
    # (32, 2,016,000) lattices
    cap = -(-(MAX_NMS + _SLACK) // 128) * 128
    zero = torch.zeros(B, device=dev)
    half = torch.full((B,), 0.5, device=dev)
    inf = torch.full((B,), float("inf"), device=dev)
    fr = torch.arange(1, _T_BISECT + 1, dtype=torch.float32,
                      device=dev) / (_T_BISECT + 1)
    flats = {}
    k2_err = count_err = 0
    for name, decoded in lattices.items():
        flat, boxes_xyxy, _ = _pair_scores(decoded, NC, CONF, False, 0, False,
                                           None)
        # the first bisection pass's thresholds, as the element engine
        # forms them
        taus = (fr[None, :] * flat.max(1).values[:, None]).contiguous()
        flats[name] = (flat, boxes_xyxy, taus)
        live = (torch.nn.functional.pad(flat, (0, (-flat.shape[1]) % 128),
                                        value=-1.0)
                .view(B, -1, 128) > 0).any(-1).float().contiguous()
        for what, args in (("elements", (flat, zero, inf, cap)),
                           ("rows", (live, half, inf, 1024))):
            ks, ki = threshold_compact_cuda(*args)
            ps, pi = threshold_compact(*args)
            k2_err = max(k2_err, float((ks - ps).abs().max()),
                         float((ki - pi).abs().max()))
            require(torch.equal(ks, ps) and torch.equal(ki, pi),
                    f"K2 {what} buffer differs in regime {name}")
            print(f"[k2] {name}: {what} buffer {tuple(ks.shape)} bit-equal, "
                  f"{int((ks > 0).sum(1).max())} survivors kept (max/img)")
        tiny = torch.full((B, 1), _TINY, device=dev)
        for what, t in (("bisection pass", taus), ("total", tiny)):
            got, ref = count_ge_cuda(flat, t), _count_ge(flat, t)
            count_err = max(count_err, int((got - ref).abs().max()))
            require(torch.equal(got, ref),
                    f"count_ge differs ({what}, {name})")
        require(torch.equal(count_ge_cuda(flat, tiny)[:, 0],
                            (flat > 0).sum(1, dtype=torch.int32)),
                f"count_ge total != (s > 0).sum in regime {name}")
        print(f"[count] {name}: T={taus.shape[1]} bisection pass and the "
              f"candidate total bit-equal to the plain count")
        for engine in (exact_topk_rows, exact_topk_elems):
            ts, ti = engine(flat, MAX_NMS)
            check_exact_topk(flat, MAX_NMS, ts, ti)
            print(f"[k2] {name}: {engine.__name__} meets the exact top-k "
                  f"contract against torch.topk over the lattice")

    # 6. times: host clock for the forward and the NMS (median of warm
    # runs); CUDA events for the kernels, the engine and torch.topk
    def fwd():
        infer.forward(images[0])

    t_fwd = time_ms(torch, fwd, reps=10, warmup=3)
    print(f"[time] forward bf16 b{B}@{IMG}: {t_fwd:.3f} ms/batch | {card}")
    rows = {}
    for name in regimes:
        decoded = lattices[name]
        t_k = time_ms(torch, lambda: infer.nms(decoded))
        t_p = time_ms(torch, lambda: infer.nms(decoded, use_kernels=False))
        flat, boxes_xyxy, taus = flats[name]
        ts, ti = exact_topk_rows(flat, MAX_NMS)
        nms_boxes, cand_valid, _ = _finish_pairs(ts, ti, boxes_xyxy, None,
                                                 NC, False, 256)
        k1 = (nms_boxes, cand_valid, IOU, 256, MAX_DET)
        k2 = (flat, zero, inf, cap)
        keep = greedy_nms_keep(*k1)
        n_b, n_k = B * nms_boxes.shape[1], flat.numel()
        tests, swept = nms_iou_tests(torch, box_iou, nms_boxes, cand_valid,
                                     keep, 256, MAX_DET, IOU)
        rows[name] = {
            "greedy_nms_keep": (
                event_ms(torch, lambda: greedy_nms_keep_cuda(*k1), graph=True),
                event_ms(torch, lambda: greedy_nms_keep(*k1)),
                bound(n_b * 2 + swept * 16, IOU_OPS * tests), None),
            "threshold_compact": (
                event_ms(torch, lambda: threshold_compact_cuda(*k2),
                         graph=True),
                event_ms(torch, lambda: threshold_compact(*k2)),
                bound(n_k * 4 + B * cap * 8),
                event_ms(torch, lambda: torch.topk(flat, MAX_NMS, 1))),
            "count_ge": (
                event_ms(torch, lambda: count_ge_cuda(flat, taus),
                         graph=True),
                event_ms(torch, lambda: _count_ge(flat, taus)),
                bound(n_k * 4 + taus.numel() * 8,
                      2 * n_k * taus.shape[1]), None),
        }
        t_eager = event_ms(torch, lambda: greedy_nms_keep_cuda(*k1))
        t_engine = event_ms(torch, lambda: exact_topk_rows(flat, MAX_NMS))
        print(f"[time] {name}: NMS kernels {t_k:.3f} ms, plain {t_p:.3f} ms"
              f" | selection engine {t_engine[0]:.3f} ms, torch.topk "
              f"{rows[name]['threshold_compact'][3][0]:.3f} ms | "
              f"greedy_nms_keep (32, {nms_boxes.shape[1]}) called eagerly "
              f"{t_eager[0]:.4f} ms/call; {tests} IoU tests needed | {card}")
        for kname, (t, tp, (b_ms, b_by), lib) in rows[name].items():
            print(f"[time] {name}: {kname} kernel {t[0]:.4f} ms "
                  f"[{t[1]:.4f}, {t[2]:.4f}], plain {tp[0]:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}, {b_ms / t[0]:.0%} of it)"
                  + (f", torch.topk {lib[0]:.4f} ms" if lib else "")
                  + f" | {card}")

    # the regime in which each kernel does its main-path work: K1 and the
    # element compaction in mid, the bisection's count in saturated
    where = {"greedy_nms_keep": "mid", "threshold_compact": "mid",
             "count_ge": "saturated"}
    meta = {
        "greedy_nms_keep": ("efficientteacher_torch/csrc/nms.cu",
                            "efficientteacher_tpu/ops/nms_pallas.py:138",
                            float(k1_err)),
        "threshold_compact": ("efficientteacher_torch/csrc/select.cu",
                              "efficientteacher_tpu/ops/select_pallas.py:218",
                              k2_err),
        "count_ge": ("efficientteacher_torch/csrc/select.cu",
                     "efficientteacher_tpu/ops/select_pallas.py:247",
                     float(count_err)),
    }
    kernels = []
    for kname, regime in where.items():
        t, tp, (b_ms, b_by), lib = rows[regime][kname]
        src, replaces, err = meta[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": float(err), "ms": t[0], "ms_min": t[1],
            "ms_max": t[2], "plain_ms": tp[0], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib[0] if lib else None, "regime": regime})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)

#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: YOLOv5l eval serving and
the YOLOv5l mean-teacher training step.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `efficientteacher_torch/csrc/`, checks
each against its plain PyTorch version, then drives the port's two main
paths, each with the kernels' launch counts set to 0 just before it and
read just after:

  - eval: serves YOLOv5l (nc 80) b32@640 in bf16 through `make_infer_fn`
    (conf 0.001, IoU 0.6, max_nms 30000, max_det 300) for 3 batches in
    each of three weight regimes, and counts the selection engine's tiers;
  - train: the YOLOv5l SSOD model (16 labelled + 16 unlabelled images @640,
    bf16 autocast, float32 master weights, the constants of
    configs/ssod/coco-standard/yolov5l_coco_ssod_10_percent.yaml) takes 4
    burn-in steps, seeds its teacher from the EMA and takes 12 SSOD steps
    at accumulate 2, with K1 in every step's pseudo-label NMS at
    (16, 2048); then it profiles a held + fired pair, times the step with
    PyTorch's own BatchNorm forward beside the port's, and times the
    pseudo labels and K1 at the run's load and at a sparser one.

It times the forward, the NMS, the selection engine against `torch.topk`,
the training steps and their phases (CUDA events), and each kernel
against its plain version and its bound (bytes over 3.35 TB/s, fp32
operations over 67 TFLOP/s: the H100 SXM's published peaks; bytes count
each input read once and each output written once, and for K1 only the
boxes of the tiles its sweep reaches). Kernel times are CUDA-event
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

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace as NS

B, IMG, NC = 32, 640, 80
CONF, IOU, MAX_NMS, MAX_DET = 0.001, 0.6, 30000, 300
N_BATCHES = 3
SEED = 0
HBM_BYTES_S = 3.35e12    # H100 SXM device memory
FP32_OPS_S = 67e12       # H100 SXM fp32 outside the tensor cores
IOU_OPS = 12             # fp32 operations of one IoU test (ops/boxes.py)

# The training phase: configs/ssod/coco-standard/yolov5l_coco_ssod_10_percent
# .yaml over the defaults of efficientteacher_tpu/configs/defaults.py (the
# card's machine has no yaml), as an attribute tree for the from_cfg
# factories; batch 16 labelled + 16 unlabelled, as bench.py runs it.
SSOD_CFG = NS(
    single_cls=False, adam=False, epochs=60, linear_lr=False,
    Dataset=NS(nc=NC, np=0, img_size=IMG),
    hyp=NS(lr0=0.01, lrf=1.0, momentum=0.937, warmup_epochs=0,
           warmup_momentum=0.8, warmup_bias_lr=0.1),
    Loss=NS(box=0.05, cls=0.3, obj=0.7, cls_pw=1.0, obj_pw=1.0,
            fl_gamma=0.0, label_smoothing=0.0, anchor_t=4.0,
            single_targets=False, kp_loss_weight=10.0),
    SSOD=NS(nms_conf_thres=0.1, nms_iou_thres=0.65, teacher_loss_weight=3.0,
            box_loss_weight=0.05, obj_loss_weight=0.7, cls_loss_weight=0.3,
            ignore_thres_high=0.6, ignore_thres_low=0.1, focal_loss=0.0,
            uncertain_aug=True, ignore_obj=False, multi_label=False,
            pseudo_label_with_obj=True, pseudo_label_with_bbox=True,
            pseudo_label_with_cls=False, with_da_loss=False,
            da_loss_weights=0.01, ema_rate=0.999, max_pseudo_labels=100,
            multi_step_lr=False, milestones=[10, 20]))
B_SUP = B_UN = 16
ACCUMULATE = 2           # nominal batch 64 / 32 images per step
WEIGHT_DECAY = 0.0005    # hyp.weight_decay * 32 * ACCUMULATE / 64
BURN_IN_STEPS, SSOD_STEPS = 4, 12   # the first 2 of each tune cuDNN
# teacher helper (`pseudo_label_teacher`): class biases +CLS_SHIFT; the
# objectness shift puts OBJ_TARGET anchors per image above objectness 0.5;
# the EMA's update counter as deep into training (decay 0.9999)
CLS_SHIFT, OBJ_TARGET, EMA_UPDATES = 4.0, 200, 20000
# OBJ_TARGET is a chosen load, near the cap of 100 pseudo labels per image
# (no trained teacher is at hand to take a density from). The pseudo-label
# phase is timed again at a sparser load: COCO train2017's objects per
# image (860,001 boxes in 118,287 images).
PL_SPARSE = 860001 / 118287


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


def synthetic_labels(torch, g, b, m=60):
    """Seeded labels as bench.py:170-181 makes them: 1-19 boxes per image,
    classes 0-79, centres in [0.2, 0.8], sizes in [0.05, 0.45)."""
    labels = torch.zeros(b, m, 5)
    mask = torch.zeros(b, m, dtype=torch.bool)
    for bi in range(b):
        n = int(torch.randint(1, 20, (1,), generator=g))
        labels[bi, :n, 0] = torch.randint(0, NC, (n,), generator=g).float()
        labels[bi, :n, 1:3] = torch.rand(n, 2, generator=g) * 0.6 + 0.2
        labels[bi, :n, 3:5] = torch.rand(n, 2, generator=g) * 0.4 + 0.05
        mask[bi, :n] = True
    return labels, mask


def m_s_records(torch, b):
    """(b, 13) weak -> strong records [idx, M (9), s, ud, lr]: the first
    half the identity, the second a 0.5 scale about the image centre with
    the left-right flip."""
    out = torch.zeros(b, 13)
    out[:, 0] = torch.arange(b).float()
    half = torch.tensor([[0.5, 0.0, IMG / 4], [0.0, 0.5, IMG / 4],
                         [0.0, 0.0, 1.0]])
    for i in range(b):
        scaled = i >= b // 2
        out[i, 1:10] = (half if scaled else torch.eye(3)).flatten()
        out[i, 10] = 0.5 if scaled else 1.0
        out[i, 12] = float(scaled)
    return out


def pseudo_label_teacher(torch, state, weak):
    """Make the EMA teacher of `state` give pseudo labels at conf 0.1 (the
    seeded init's class prior is sigmoid(-4.9) = 0.007, so it gives none):
    calibrate its BatchNorm on the weak batch (`calibrate_bn`, so the
    scores vary with the image), raise every class bias by CLS_SHIFT, then
    every objectness bias by the shift that puts OBJ_TARGET anchors per
    image (of 25,200) above objectness 0.5 on that batch. Its update
    counter is set to EMA_UPDATES, so its ramped decay is 0.9999 as deep
    into training, and the teacher stays such a teacher over the steps;
    from a counter near 0 the decay is ~0.001 and the teacher would follow
    the student, which the objectness loss drives to silence on noise
    images. Returns the objectness shift."""
    from efficientteacher_torch.train.supervised import to_input
    from efficientteacher_torch.utils.eval_regimes import calibrate_bn

    teacher = state.ema.module
    calibrate_bn(teacher, weak)
    head = teacher.head
    x = to_input(weak, torch.bfloat16, 255.0)
    with torch.no_grad():
        for conv in head.m:
            conv.bias.view(head.na, head.no)[:, 5:] += CLS_SHIFT
        with torch.autocast("cuda", dtype=torch.bfloat16):
            raw, _ = teacher(x, decode=False, with_domain=False)
        obj = torch.cat([r[..., 4].float().flatten(1) for r in raw], 1)
        q = 1.0 - OBJ_TARGET / obj.shape[1]
        shift = -float(torch.quantile(obj.flatten(), q))
    shift_teacher_obj(torch, teacher, shift)
    state.ema.updates = EMA_UPDATES
    return shift


def profile_ssod_steps(torch, step, step_ms, card, top=10):
    """One held + one fired SSOD step under torch.profiler: the device's
    busy time per step (the union of the trace's device intervals) and the
    kernels by device time. The idle share is that busy time against
    `step_ms`, the step's time without the profiler (which adds host time
    of its own and so stretches the traced steps); the traced window's own
    share is printed beside it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ACCUMULATE):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    if not spans:
        print("[profile] train: the trace holds no device time")
        return
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    busy /= 1e3
    span = (end - spans[0][0]) / 1e3
    per_step = busy / ACCUMULATE
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    print(f"[profile] train: {ACCUMULATE} SSOD steps (held + fired) under "
          f"torch.profiler: device busy {busy:.1f} ms ({per_step:.1f} ms "
          f"per step), {sum(e.count for e in kernels)} device events; "
          f"against the unprofiled step ({step_ms:.1f} ms) the device is "
          f"idle {1 - per_step / step_ms:.1%}; in the traced window (wall "
          f"{wall:.1f} ms, device span {span:.1f} ms, both stretched by the "
          f"profiler) idle {1 - busy / wall:.1%} of the wall | {card}")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:top]:
        print(f"[profile] train:   {e.self_device_time_total / 1e3:8.2f} ms "
              f"{e.count:6d}x {e.key[:90]}")


def bn_ab_steps(torch, step, card, rounds=3):
    """The SSOD step with the port's `BatchNorm2d` (flax's biased
    running-variance update, two extra per-channel ops per layer) against
    PyTorch's own `nn.BatchNorm2d.forward`, in one process: blocks of one
    held + fired pair, in the order port, PyTorch, PyTorch, port per
    round. Per step: host ms (ended by a synchronize) and the student
    forward + backward phase by CUDA events; medians and every sample."""
    from efficientteacher_torch.models.common import BatchNorm2d

    own = BatchNorm2d.forward
    host = {"port": [], "pytorch": []}
    student = {"port": [], "pytorch": []}
    try:
        for variant in ("port", "pytorch", "pytorch", "port") * rounds:
            BatchNorm2d.forward = (own if variant == "port"
                                   else torch.nn.BatchNorm2d.forward)
            for _ in range(ACCUMULATE):
                events = {}

                def mark(name):
                    events[name] = torch.cuda.Event(enable_timing=True)
                    events[name].record()

                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(on_phase=mark)
                torch.cuda.synchronize()
                host[variant].append((time.perf_counter() - t0) * 1e3)
                student[variant].append(events["pseudo_labels"].elapsed_time(
                    events["student_fwd_bwd"]))
    finally:
        BatchNorm2d.forward = own
    med = {k: statistics.median(v) for k, v in host.items()}
    med_s = {k: statistics.median(v) for k, v in student.items()}
    print(f"[time] train: SSOD step with the port's BatchNorm2d "
          f"{med['port']:.1f} ms (student forward + backward "
          f"{med_s['port']:.2f}), with PyTorch's own forward "
          f"{med['pytorch']:.1f} ms ({med_s['pytorch']:.2f}); medians of "
          f"{len(host['port'])} steps each, interleaved; port - PyTorch "
          f"{med['port'] - med['pytorch']:+.1f} ms host, "
          f"{med_s['port'] - med_s['pytorch']:+.2f} ms student | {card}")
    for k in host:
        print(f"[time] train:   {k} BatchNorm2d steps, host ms: "
              + ", ".join(f"{t:.1f}" for t in host[k])
              + "; student ms: " + ", ".join(f"{t:.1f}" for t in student[k]))
    # one layer alone: a train-mode forward on a P5-sized map (small, so
    # the call's host cost shows), eager, CUDA events
    bn = BatchNorm2d(512, eps=1e-3, momentum=0.03).cuda().train()
    x = torch.randn(32, 512, 20, 20, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True).to(memory_format=torch.channels_last)
    per_call = {}
    try:
        for variant in ("port", "pytorch", "pytorch", "port"):
            BatchNorm2d.forward = (own if variant == "port"
                                   else torch.nn.BatchNorm2d.forward)
            per_call.setdefault(variant, []).append(
                event_ms(torch, lambda: bn(x), launches=200)[0] * 1e3)
    finally:
        BatchNorm2d.forward = own
    print(f"[time] train: one BatchNorm2d train-mode forward (32, 512, 20, "
          f"20) bf16, eager: port {min(per_call['port']):.1f} us, PyTorch's "
          f"{min(per_call['pytorch']):.1f} us per call (the faster of two "
          f"blocks each) | {card}")


def teacher_decoded(torch, teacher, weak):
    """The teacher's decoded predictions on the weak batch, as the step's
    teacher phase makes them (eval mode, bf16 autocast, no gradients)."""
    from efficientteacher_torch.train.supervised import to_input

    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        (decoded, _), _ = teacher(to_input(weak, torch.bfloat16, 255.0),
                                  decode=True, with_domain=False)
    return decoded


def pseudo_label_load(torch, decoded, m_s):
    """Pseudo labels of `decoded` through K1 against the plain path (bit
    for bit), K1 at (16, 2048) on its candidates against
    `greedy_nms_keep`, and the times: `create_pseudo_labels` (eager, CUDA
    events), K1 (CUDA graph), its plain version and its bound."""
    from efficientteacher_torch.ops.boxes import box_iou
    from efficientteacher_torch.ops.nms import _prep_candidates_single
    from efficientteacher_torch.ops.nms_cuda import (greedy_nms_keep,
                                                     greedy_nms_keep_cuda)
    from efficientteacher_torch.ssod.pseudo_label import create_pseudo_labels

    s = SSOD_CFG.SSOD
    kw = dict(img_size=IMG, nc=NC, conf_thres=s.nms_conf_thres,
              iou_thres=s.nms_iou_thres, max_pl=s.max_pseudo_labels)
    got = create_pseudo_labels(decoded, m_s, **kw)
    ref = create_pseudo_labels(decoded, m_s, use_kernels=False, **kw)
    require(all(torch.equal(a, b) for a, b in zip(got, ref)),
            "pseudo labels through K1 differ from the plain path")
    nms_boxes, cand_valid, _ = _prep_candidates_single(
        decoded.float(), NC, s.nms_conf_thres, 2048, True, 256, False)
    require(nms_boxes.shape == (B_UN, 2048, 4),
            f"K1's SSOD input is {tuple(nms_boxes.shape)}")
    k1 = (nms_boxes, cand_valid, s.nms_iou_thres, 256, s.max_pseudo_labels)
    keep = greedy_nms_keep(*k1)
    k1_err = int((greedy_nms_keep_cuda(*k1) != keep).sum())
    require(k1_err == 0, f"K1 at (16, 2048) differs in {k1_err} rows")
    tests, swept = nms_iou_tests(torch, box_iou, nms_boxes, cand_valid, keep,
                                 256, s.max_pseudo_labels, s.nms_iou_thres)
    return {
        "pl_img": float(got.mask.sum()) / B_UN,
        "valid_img": float(cand_valid.sum(1).float().mean()),
        "kept": int(keep.sum()), "tests": tests, "k1_err": k1_err,
        "pl_ms": event_ms(torch, lambda: create_pseudo_labels(
            decoded, m_s, **kw), launches=20),
        "k1": event_ms(torch, lambda: greedy_nms_keep_cuda(*k1), graph=True),
        "k1_plain": event_ms(torch, lambda: greedy_nms_keep(*k1)),
        "bound": bound(B_UN * 2048 * 2 + swept * 16, IOU_OPS * tests)}


def shift_teacher_obj(torch, teacher, delta):
    """Raise every objectness bias of the teacher's head by `delta`."""
    head = teacher.head
    with torch.no_grad():
        for conv in head.m:
            conv.bias.view(head.na, head.no)[:, 4] += delta


def sparse_teacher(torch, teacher, weak, m_s, iters=12):
    """Lower the teacher's objectness biases, by bisection, until its
    pseudo labels per image come nearest PL_SPARSE. Returns (shift, pseudo
    labels per image) of the nearest."""
    from efficientteacher_torch.ssod.pseudo_label import create_pseudo_labels

    s = SSOD_CFG.SSOD
    kw = dict(img_size=IMG, nc=NC, conf_thres=s.nms_conf_thres,
              iou_thres=s.nms_iou_thres, max_pl=s.max_pseudo_labels)
    lo, hi, at, best = -12.0, 0.0, 0.0, None
    for _ in range(iters):
        mid = (lo + hi) / 2
        shift_teacher_obj(torch, teacher, mid - at)
        at = mid
        pl = float(create_pseudo_labels(teacher_decoded(torch, teacher, weak),
                                        m_s, **kw).mask.sum()) / B_UN
        if best is None or abs(pl - PL_SPARSE) < abs(best[1] - PL_SPARSE):
            best = (mid, pl)
        lo, hi = (mid, hi) if pl < PL_SPARSE else (lo, mid)
    shift_teacher_obj(torch, teacher, best[0] - at)
    return best


def train_phase(torch, dev, card):
    """The training main path (see the module docstring), its checks and
    times. Returns K1's kernels-line entry at the SSOD shape (16, 2048)."""
    from efficientteacher_torch.losses.ssod_loss import SSODLossConfig
    from efficientteacher_torch.losses.yolov5_loss import YoloV5LossConfig
    from efficientteacher_torch.models import build_model
    from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
    from efficientteacher_torch.train.optim import OptimizerConfig
    from efficientteacher_torch.train.ssod_step import (
        create_ssod_train_state, make_burn_in_train_step,
        make_ssod_train_step, seed_teacher_from_ema)
    from efficientteacher_torch.train.supervised import Schedule
    from efficientteacher_torch.train.train_state import cosine_ema_decay
    from efficientteacher_torch.utils.eval_regimes import yolov5l_spec

    cfg, s = SSOD_CFG, SSOD_CFG.SSOD
    t_setup = time.perf_counter()
    spec = dataclasses.replace(yolov5l_spec(), train_domain=True)
    model = build_model(spec, device=dev,
                        generator=torch.Generator().manual_seed(SEED))
    model = model.to(memory_format=torch.channels_last)
    g = torch.Generator().manual_seed(2)
    labels, mask = (t.to(dev) for t in synthetic_labels(torch, g, B_SUP))
    sup, strong, weak = (
        torch.randint(0, 256, (b, IMG, IMG, 3), dtype=torch.uint8,
                      generator=g).to(dev) for b in (B_SUP, B_UN, B_UN))
    m_s = m_s_records(torch, B_UN).to(dev)
    thr_high = torch.full((NC,), s.ignore_thres_high, device=dev)
    thr_low = torch.full((NC,), s.ignore_thres_low, device=dev)
    anchors = (torch.tensor(spec.anchors).view(spec.nl, spec.na, 2)
               / torch.tensor(spec.strides).view(-1, 1, 1)).to(dev)
    oc = OptimizerConfig.from_cfg(cfg, WEIGHT_DECAY)
    sup_cfg = YoloV5LossConfig.from_cfg(cfg)
    burn = make_burn_in_train_step(sup_cfg, anchors, oc)
    ssod = make_ssod_train_step(
        sup_cfg, SSODLossConfig.from_cfg(cfg), anchors, oc, spec,
        nms_conf_thres=s.nms_conf_thres, nms_iou_thres=s.nms_iou_thres,
        max_pl=s.max_pseudo_labels, multi_label=s.multi_label,
        teacher_loss_weight=s.teacher_loss_weight,
        da_loss_weight=s.da_loss_weights, with_da_loss=s.with_da_loss)
    state = create_ssod_train_state(model, oc)
    # the semi-EMA's decay in the first epoch after burn-in (10 epochs)
    semi_decay = cosine_ema_decay(0, cfg.epochs - 10, s.ema_rate)
    n_params = sum(p.numel() for p in state.params) / 1e6
    print(f"[train] YOLOv5l SSOD model ({n_params:.1f} M params) "
          f"b{B_SUP}+{B_UN}@{IMG} bf16 autocast, accumulate {ACCUMULATE}; "
          f"set-up {time.perf_counter() - t_setup:.1f} s")
    # the reference trainer lets cuDNN pick its algorithms by timing them
    torch.backends.cudnn.benchmark = True
    torch.cuda.reset_peak_memory_stats()

    def tensors():
        return (state.params, state.ema.params, state.semi_ema.params)

    steps = []
    greedy_nms_keep_cuda.launches = 0
    for i in range(BURN_IN_STEPS + SSOD_STEPS):
        burn_in = i < BURN_IN_STEPS
        if i == BURN_IN_STEPS:
            seed_teacher_from_ema(state)
            obj_shift = pseudo_label_teacher(torch, state, weak)
            print(f"[train] teacher seeded from the EMA; helper: BN "
                  f"calibrated on the weak batch, class biases "
                  f"+{CLS_SHIFT}, objectness biases {obj_shift:+.3f}, EMA "
                  f"updates {EMA_UPDATES}")
        sched = Schedule(**oc.schedule(state.step, 0.0, 0),
                         accumulate=ACCUMULATE)
        before = [[t.detach().clone() for t in ts] for ts in tensors()]
        opt0, k0 = state.opt_step, greedy_nms_keep_cuda.launches
        events = {}

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        if burn_in:
            state, parts = burn(state, sup, labels, mask, weak, sched)
        else:
            state, out = ssod(state, sup, labels, mask, strong, weak, m_s,
                              thr_high, thr_low, sched, semi_decay,
                              on_phase=mark)
            parts = out.metrics
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        fired = state.opt_step > opt0
        require(fired == ((i + 1) % ACCUMULATE == 0),
                f"step {i}: fired={fired} at accumulate {ACCUMULATE}")
        losses = {k: float(v) for k, v in parts.items()}
        require(all(v == v and abs(v) != float("inf")
                    for v in losses.values()), f"step {i}: losses {losses}")
        # held: all bit-identical; fired: every parameter moves (decay
        # moves even those the loss does not reach), and the EMAs move
        # (a blend by 1e-4 can leave a tensor whose student barely moved
        # bit-identical, so not every EMA tensor need change)
        moved = []
        for what, b, a in zip(("params", "EMA", "semi-EMA"), before,
                              tensors()):
            n_moved = sum(not torch.equal(x, y) for x, y in zip(b, a))
            moves = fired and not (burn_in and what == "semi-EMA")
            ok = (n_moved == len(b) if what == "params" else n_moved > 0) \
                if moves else n_moved == 0
            require(ok, f"step {i} ({'fired' if fired else 'held'}): "
                        f"{n_moved}/{len(b)} {what} tensors moved")
            moved.append(f"{n_moved}/{len(b)}")
        row = {"i": i, "burn_in": burn_in, "fired": fired, "ms": ms,
               "loss": losses.get("total", losses.get("loss")),
               "moved": moved}
        if not burn_in:
            launches = greedy_nms_keep_cuda.launches - k0
            per_img = out.pseudo_mask.sum(1)
            require(launches == 1, f"step {i}: K1 launched {launches} times")
            require(int(per_img.sum()) > 0, f"step {i}: no pseudo label")
            names = list(events)
            row.update(
                pseudo=int(per_img.sum()), pseudo_min=int(per_img.min()),
                phases={b: events[a].elapsed_time(events[b])
                        for a, b in zip(names, names[1:])})
        steps.append(row)
        print(f"[train] step {i} {'burn-in' if burn_in else 'ssod'} "
              f"{'fired' if fired else 'held'}: {ms:.1f} ms, loss "
              f"{row['loss']:.4f}, tensors moved (params, EMA, semi-EMA) "
              f"{', '.join(moved)}"
              + (f", pseudo labels {row['pseudo']} (min/img "
                 f"{row['pseudo_min']}), phases " + ", ".join(
                     f"{k} {v:.1f}" for k, v in row["phases"].items())
                 if not burn_in else ""))
    k1_launches = greedy_nms_keep_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    require(k1_launches == SSOD_STEPS,
            f"K1 launched {k1_launches} times in {SSOD_STEPS} SSOD steps")

    warm = [r for r in steps if not r["burn_in"]][2:]  # after cuDNN tuning
    spread = [r["ms"] for r in warm]
    held = statistics.median(r["ms"] for r in warm if not r["fired"])
    fired = statistics.median(r["ms"] for r in warm if r["fired"])
    per_step = (held + fired) / 2
    phase = {k: statistics.median(r["phases"][k] for r in warm)
             for k in warm[0]["phases"]}
    opt_fired = statistics.median(r["phases"]["optimizer"] for r in warm
                                  if r["fired"])
    pl_img = statistics.mean(r["pseudo"] for r in steps
                             if not r["burn_in"]) / B_UN
    burn_ms = [r["ms"] for r in steps if r["burn_in"]]
    burn_warm = statistics.mean(burn_ms[2:])
    print(f"[time] train: SSOD step {per_step:.1f} ms (median held "
          f"{held:.1f}, fired {fired:.1f}; {len(warm)} warm steps in "
          f"[{min(spread):.1f}, {max(spread):.1f}], host clock), "
          f"{(B_SUP + B_UN) / per_step * 1e3:.1f} img/s; burn-in "
          f"step {burn_warm:.1f} ms (mean of the warm held + fired pair; "
          f"all: {', '.join(f'{t:.1f}' for t in burn_ms)}) | {card}")
    print(f"[time] train: SSOD step phases by CUDA events, median ms: "
          f"teacher forward {phase['teacher']:.2f}, pseudo labels (NMS + "
          f"warp) {phase['pseudo_labels']:.2f}, student forward + backward "
          f"{phase['student_fwd_bwd']:.2f}, optimizer + EMA chain "
          f"{phase['optimizer']:.2f} (fired {opt_fired:.2f}) | {card}")
    print(f"[train] peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated); pseudo labels per image "
          f"{pl_img:.1f}; K1 launches in {SSOD_STEPS} SSOD steps "
          f"{k1_launches} | {card}")

    def run_ssod(on_phase=None):
        ssod(state, sup, labels, mask, strong, weak, m_s, thr_high, thr_low,
             Schedule(**oc.schedule(state.step, 0.0, 0),
                      accumulate=ACCUMULATE), semi_decay, on_phase=on_phase)

    # with the loop's tuned cuDNN algorithms
    bn_ab_steps(torch, run_ssod, card)
    profile_ssod_steps(torch, run_ssod, per_step, card)
    torch.backends.cudnn.benchmark = False

    # K1 and the pseudo labels against the plain versions, on the final
    # teacher's output: at the run's load, then at the sparse one
    teacher = state.ema.module
    loads = {"dense": pseudo_label_load(
        torch, teacher_decoded(torch, teacher, weak), m_s)}
    sparse_shift, _ = sparse_teacher(torch, teacher, weak, m_s)
    loads["sparse"] = pseudo_label_load(
        torch, teacher_decoded(torch, teacher, weak), m_s)
    for name, ld in loads.items():
        t, tp, (b_ms, b_by) = ld["k1"], ld["k1_plain"], ld["bound"]
        print(f"[train] {name} load"
              + (f" (objectness biases {sparse_shift:+.3f} more, aimed at "
                 f"{PL_SPARSE:.1f}/img)" if name == "sparse" else "")
              + f": {ld['pl_img']:.1f} pseudo labels/img; pseudo labels "
              f"through K1 == plain path; K1 ({B_UN}, 2048) on the path's "
              f"candidates ({ld['valid_img']:.0f} valid/img, {ld['kept']} "
              f"kept, {ld['tests']} IoU tests) == greedy_nms_keep")
        print(f"[time] train: {name} load: create_pseudo_labels "
              f"{ld['pl_ms'][0]:.3f} ms; greedy_nms_keep ({B_UN}, 2048) "
              f"kernel {t[0]:.4f} ms [{t[1]:.4f}, {t[2]:.4f}], plain "
              f"{tp[0]:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{b_ms / t[0]:.1%} of it) | {card}")
    ld = loads["dense"]
    t, (b_ms, b_by) = ld["k1"], ld["bound"]
    return {"name": "greedy_nms_keep", "route": "cuda",
            "source": "efficientteacher_torch/csrc/nms.cu",
            "replaces": "efficientteacher_tpu/ops/nms_pallas.py:138",
            "launches": k1_launches,
            "max_abs_err": float(max(d["k1_err"] for d in loads.values())),
            "ms": t[0], "ms_min": t[1], "ms_max": t[2],
            "plain_ms": ld["k1_plain"][0], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "path": "train",
            "shape": [B_UN, 2048]}


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
            "library_ms": lib[0] if lib else None, "path": "eval",
            "regime": regime})

    # 7. the training main path
    kernels.append(train_phase(torch, dev, card))
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

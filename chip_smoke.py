#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: YOLOv5l eval serving, the
YOLOv5l mean-teacher training step, the SSOD trainer around it reading
its data from disk (and with its remaining options), and the model zoo's
supervised trainer.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `efficientteacher_torch/csrc/`, checks
each against its plain PyTorch version, then drives the port's main
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
    pseudo labels and K1 at the run's load and at a sparser one;
  - data: the loader core's own JPEG decoder (no libjpeg on that
    machine) against cv2's digests of the fixtures in
    tests/test_torch_jpeg.py; then a seeded dataset (256 labelled, 256
    unlabelled, 64 val images at COCO-like sizes, ~7 boxes each; three in
    four JPEG, quality 90 4:2:0, written by the core's own writer, the
    rest PNG; numeric file stems, COCO's image ids) in smoke_data/
    (removed at the end); `[data]` times decode + letterbox for the
    thread and process engines at 1 and 8 workers on the mixed split,
    on its JPEGs and on its PNGs, each batch held against a
    single-threaded pass;
    `[aug]` times device_augment_batch and device_ssod_views at 32@640
    and holds the card's output against the CPU's on the same draws;
  - trainer: `SSODTrainer` on the main YAML (`ssod_cfg`, read without
    PyYAML) and its batch, 32 + 32, with `Dataset.device_aug`, its loaders
    reading the dataset from disk: 1 burn-in and 2 mean-teacher epochs of
    8 steps, 2 val batches of 32 at each epoch end (the val detections
    held against the plain NMS), last/best checkpoints, then a trainer
    resumed from last.ckpt for one epoch (its epoch, best fitness, EMA
    updates and weights held against the checkpoint); it times the loop's
    steps against the same step function called bare, the input copy, the
    loop's waits on the loaders, validator.run (device wait and host
    metrics), the save() calls and the steps during a checkpoint write;
  - hostaug: the host augmentation route (`Dataset.device_aug` False,
    as every shipped YAML is written): the loader core's pixel operations
    against cv2 5.0.0's digests (tests/pixel_op_cases.py), the labelled
    and unlabelled host loaders' img/s on the JPEGs at 32@640 for threads
    at 1 and 8 workers and 8 processes (each epoch held against the
    single-threaded one) and with `cache ram`, then `SSODTrainer` on the
    main YAML without the override (1 burn-in + 1 mean-teacher epoch of 8
    steps, 32 + 32): its step in the loop, the loaders' wait per step and
    peak memory beside the trainer phase's device_aug route;
  - cli: `cli.train` on the YAML file as written (the host augmentation)
    for one SSOD epoch, then `cli.val
    --save-json --coco-gt` on its best.ckpt and on a mid-density copy,
    held equal to validator.run, against a COCO ground-truth file written
    from the val split's label files; the JSON holds exactly the
    detections validator.run counted, and the vendor-free COCO re-scorer's
    mAP pair is printed beside validator.run's;
  - zoo: the zoo families from their shipped YAMLs as written but the
    data paths (configs/sup/public/): YOLOX-s (yolox_coco.yaml) and
    YOLOv8-m (yolov8m_coco.yaml) at batch 64 for 2 steps, YOLOv7-L
    (yolov7l_coco.yaml) and YOLOv6-s (yolov6s_coco.yaml) at 64 for 4,
    YOLOv7-s-SimOTA (yolov7s_coco_simota.yaml) and the YOLOv6-s RepOpt
    finetune (yolov6s_coco_repopt_finetune.yaml, its RepScale_weight a
    seeded LinearAdd YOLOv6-s written first, its masks checked) at 128
    for 2, @640: `Trainer` for one epoch on the smoke dataset (host
    augmentation), its epoch-end validation at a mid density held against
    the plain NMS, `cli.val` on the best.ckpt it saved equal to
    validator.run, the eval program on a saturated copy and, for YOLOv7-L
    and YOLOv6-s, on its RepVGG-fused deploy model (`utils/reparam.py`;
    float32 outputs against the unfused model's); step ms, img/s, the
    loss and its assignment's ms, peak memory, forward and NMS ms, and K1,
    K2 and the count against their plain versions at the mid and
    saturated lattices (672,000 scores per image; YOLOv7-L's 2,016,000);
  - ssod-opts: the SSOD trainer's remaining options and the last YAML.
    A: SSODTrainer on the main YAML (device_aug, 32 + 32) with
    `SSOD.pseudo_label_type: LabelMatch`, `SSOD.use_ota: True` and one
    extra teacher (a seeded YOLOv5l's port checkpoint, made a teacher; its
    class names a permutation of Dataset.names with some dropped): 1
    burn-in + 2 SSOD epochs of 4 steps with epoch-end validation, then a
    resumed epoch; K1 launches 3 times per SSOD step (the two teachers'
    NMS at (32, 2048), the class-agnostic merge at (32, 256)), each
    recorded merge held against greedy_nms_keep; LabelMatch's thresholds
    after each refresh and across the resume; the step in the loop and
    bare, with its phases and the SimOTA matches by CUDA events. B:
    configs/ssod/cityscapes/yolov5l_cityscapes.yaml as written but the data
    paths and 1 epoch (nc 8, 960 px, batch 16, autoanchor, the DA loss,
    burn_epochs 0) on the smoke images with their classes mod 8: the
    anchor check's BPR and whether it adopted new anchors, the step ms.
    C: yolov7l_coco.yaml with `Loss.assigner_type: SimOTA` and `adam:
    True` at 64@640: step ms, the SimOTA share, peak memory;
  - ptbridge: a seeded YOLOv5l (main YAML, nc 80) at the mid density
    pickled as the reference saves it (fp16 `model` and `ema` module
    trees, the port's classes under `models.*` only while saving):
    `cli.val` on it equals `cli.val` on a port checkpoint of the same fp16
    weights (results and COCO JSON rows), each batch's NMS == the plain
    NMS; configs/ssod/voc/yolov5l_voc_burn.yaml warm-started from it (1
    burn-in epoch of 4 steps at 32 + 32, the smoke images' classes mod
    20; the YAML: 96, 300 epochs) and yolov5l_transfer_ssod.yaml from an
    nc 365 `.pt` (matched counts, the head skipped on shape);
  - ddp: the trainer cell's config (main YAML, 32 + 32, device_aug)
    through `cli.train` in a process of its own (`--ddp-child`), 1
    burn-in + 1 SSOD epoch of 4 steps, once in a world-size-1 NCCL group
    (torchrun's environment given by hand) and once without: losses and
    final weights against each other, step ms of both;
  - kp: configs/sup/public/yolov5l_coco.yaml with Dataset.np 5 (nc 80,
    batch 32) on a keypoint copy of the smoke images (5 seeded points in
    each box): 3 warm + 2 timed steps, then `cli.val --val-kp` at the mid
    density, its landmark NMS held against the plain NMS and its K1
    launches timed;
  - formats: the lossless image formats and the JPEG kinds (no cv2 or
    Pillow on that machine): every fixture of tests/test_torch_jpeg.py and
    tests/test_torch_image_formats.py decoded to cv2's digests; the val
    split written twice, in PNG and cycling through BMP and TIFF (the
    port's writers), 16-bit and Adam7 PNG and JPEG 4:1:1 / 4:4:0 / RGB /
    CMYK / YCCK (the tests' own encoder), the PNG copy holding each
    file's decoded pixels; `cli.val` (YOLOv5l, main YAML, bf16, the mid
    density) on both gives the same results, K1, K2 and the count
    launched and held against their plain versions; `cli.detect
    --save-txt` over .bmp / .tif / .png sources writes each canvas under
    its suffix (read back equal) and the PNG copies' label files; and
    decode img/s through `load_image` at 1 and 8 threads per kind at
    640x480. Since PR 15 also WebP: the fixtures of tests/test_torch_webp.py
    to cv2's digests; the val split written a third time, cycling
    through lossless VP8L, VP8 at the port's qualities 75 and 90, VP8X +
    a VP8L-coded ALPH + VP8, and VP8X + an EXIF Orientation 6 over a
    turned VP8L (the port's writers), with its own PNG copy: cli.val on
    both equal, K1, K2 and the count held as on the other splits;
    cli.detect over .webp sources too (canvases written as .webp, read
    back equal); the WebP kinds' decode img/s and file sizes. The TIFF
    kinds of ROADMAP Q1.9c too: the fixtures of
    tests/test_torch_tiff_kinds.py (JPEG-in-TIFF, CCITT and damaged CCITT,
    CMYK, CIELab, YCbCr, signed samples, FillOrder 2, zero-sample
    compressions) to cv2's digests; the val split written a fourth time,
    cycling through that module's writers (JPEG-in-TIFF through the port's
    JPEG writer in strips and tiles, YCbCr 2 x 2 and 4 x 2, CMYK, CIELab
    of 8 and 16 bits, FillOrder 2, Group 3 fax, signed samples) with its
    own PNG copy: cli.val on both equal, K1, K2 and the count held as on
    the other splits (`tiff: cli.val` on the kernels line); the new
    kinds' decode img/s. The damaged and rare JPEGs too (ROADMAP F11, F12,
    Q1.9c's JPEG half): the fixtures of tests/test_torch_jpeg_damaged.py
    (cut-short and partial progressive files, arithmetic coding, lossless,
    damaged TIFF strips) to cv2's digests at every scale; the val split
    written a fifth time, cycling through tests/jpeg_writers.py's
    SPLIT_KINDS (cut short, a progressive file cut in a scan, one ended
    after four scans, SOF9, SOF10 with restarts, lossless RGB; written by
    numpy in 8 processes) with its own PNG copy: cli.val on both equal,
    K1, K2 and the count held as on the other splits (`jpeg kinds:
    cli.val`), the lossless files equal to their sources and the
    arithmetic ones to the same coefficients Huffman-coded; their decode
    img/s. The last TIFF kinds cv2 reads (ROADMAP Q1.9d) too: their
    fixtures in tests/test_torch_tiff_kinds.py, and the val split written
    a sixth time, cycling through SGILog LogL (strips), SGILog LogLuv
    (tiles), SGILog24 LogLuv and ThunderScan in tiles (which libtiff reads
    as palette entry 0) with its own PNG copy: cli.val on both equal, K1,
    K2 and the count held as on the other splits (`q1.9d tiff: cli.val`).

`[serve]` also draws the fixed label cases of tests/text_cases.py (every
printable ASCII character, the COCO names with confidences in their
detect.py colours, labels cut at each edge, Latin, Cyrillic and Hebrew,
CJK, Greek and Hangul from cv2's second font) with `utils/draw.py` (cv2
5.0's putText faces: Rubik at 14 px, weight 400, and WenQuanYi Micro Hei)
and requires cv2 5.0.0's digests, then times drawing one image's labels.

`[video]` (after `[serve]`, on its checkpoint) decodes the video fixtures
of tests/video_fixtures/ with `data/video_io.py` (MPEG-4 Part 2 and MJPEG
in MP4 and AVI, a rotated one, two cut short, H.264 in MP4 and AVI from
Baseline CAVLC to 1080p High CABAC, five refused) to cv2 5.0.0's
per-frame digests and times each at 1 thread, then runs cli.detect with
--nosave --save-txt on the 48-frame 1280x720 mp4v clip and on the
24-frame 1920x1080 H.264 clip: K1 once per frame, each frame's NMS and
every K1 call held against the plain versions, ms/frame and its host
share (`video: cli.detect` and `video h264: cli.detect` on the kernels
line).

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
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

B, IMG, NC = 32, 640, 80
CONF, IOU, MAX_NMS, MAX_DET = 0.001, 0.6, 30000, 300
N_BATCHES = 3
SEED = 0
HBM_BYTES_S = 3.35e12    # H100 SXM device memory
FP32_OPS_S = 67e12       # H100 SXM fp32 outside the tensor cores
IOU_OPS = 12             # fp32 operations of one IoU test (ops/boxes.py)

MAIN_YAML = (Path(__file__).resolve().parent
             / "configs/ssod/coco-standard/yolov5l_coco_ssod_10_percent.yaml")


def ssod_cfg(*overrides):
    """The main SSOD config (the port's get_cfg() merged with MAIN_YAML,
    read without PyYAML), then `overrides` (dotted key, value pairs)."""
    from efficientteacher_torch.configs import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(MAIN_YAML))
    cfg.merge_from_list(list(overrides))
    return cfg


# The train phase's batch: 16 labelled + 16 unlabelled, as bench.py runs it
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


# back-to-back calls per timing of a plain version, fewer than a kernel's
# 50 (a plain call takes ms) to keep the script under its limit
PLAIN_LAUNCHES = 10


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


def lattice_checks(torch, decoded, name, nc=NC):
    """K2 (element and row buffers) and the count (a bisection pass's
    thresholds and the candidate total) against their plain versions on
    the multi-label lattice of `decoded` at the eval gate. Returns (flat
    lattice, its boxes, the bisection thresholds, K2's and the count's
    largest error)."""
    from efficientteacher_torch.ops.nms import _pair_scores
    from efficientteacher_torch.ops.select_cuda import (
        _SLACK, _T_BISECT, _TINY, _count_ge, count_ge_cuda, threshold_compact,
        threshold_compact_cuda)

    dev = decoded.device
    flat, boxes_xyxy, _ = _pair_scores(decoded, nc, CONF, False, 0, False,
                                       None)
    b = flat.shape[0]
    cap = -(-(MAX_NMS + _SLACK) // 128) * 128
    # the first bisection pass's thresholds, as the element engine forms them
    fr = torch.arange(1, _T_BISECT + 1, dtype=torch.float32,
                      device=dev) / (_T_BISECT + 1)
    taus = (fr[None, :] * flat.max(1).values[:, None]).contiguous()
    live = (torch.nn.functional.pad(flat, (0, (-flat.shape[1]) % 128),
                                    value=-1.0)
            .view(b, -1, 128) > 0).any(-1).float().contiguous()
    zero = torch.zeros(b, device=dev)
    half = torch.full((b,), 0.5, device=dev)
    inf = torch.full((b,), float("inf"), device=dev)
    k2_err = count_err = 0
    for what, args in (("elements", (flat, zero, inf, cap)),
                       ("rows", (live, half, inf, 1024))):
        ks, ki = threshold_compact_cuda(*args)
        ps, pi = threshold_compact(*args)
        k2_err = max(k2_err, float((ks - ps).abs().max()),
                     float((ki - pi).abs().max()))
        require(torch.equal(ks, ps) and torch.equal(ki, pi),
                f"K2 {what} buffer differs in {name}")
        print(f"[k2] {name}: {what} buffer {tuple(ks.shape)} bit-equal, "
              f"{int((ks > 0).sum(1).max())} survivors kept (max/img)")
    tiny = torch.full((b, 1), _TINY, device=dev)
    for what, t in (("bisection pass", taus), ("total", tiny)):
        got, ref = count_ge_cuda(flat, t), _count_ge(flat, t)
        count_err = max(count_err, int((got - ref).abs().max()))
        require(torch.equal(got, ref), f"count_ge differs ({what}, {name})")
    require(torch.equal(count_ge_cuda(flat, tiny)[:, 0],
                        (flat > 0).sum(1, dtype=torch.int32)),
            f"count_ge total != (s > 0).sum in {name}")
    print(f"[count] {name}: T={taus.shape[1]} bisection pass and the "
          f"candidate total bit-equal to the plain count")
    return flat, boxes_xyxy, taus, k2_err, float(count_err)


def kernel_rows(torch, flat, boxes_xyxy, taus, nc=NC):
    """Each kernel of the eval NMS on one lattice: ((kernel, its range),
    plain, (bound, bound_by), library or None) by name, with K1 on the
    rows engine's candidates; also K1's arguments, its IoU tests and the
    rows where its mask differs from the plain one (required 0)."""
    from efficientteacher_torch.ops.boxes import box_iou
    from efficientteacher_torch.ops.nms import _finish_pairs
    from efficientteacher_torch.ops.nms_cuda import (greedy_nms_keep,
                                                     greedy_nms_keep_cuda)
    from efficientteacher_torch.ops.select_cuda import (
        _SLACK, _count_ge, count_ge_cuda, exact_topk_rows, threshold_compact,
        threshold_compact_cuda)

    b, dev = flat.shape[0], flat.device
    cap = -(-(MAX_NMS + _SLACK) // 128) * 128
    zero = torch.zeros(b, device=dev)
    inf = torch.full((b,), float("inf"), device=dev)
    ts, ti = exact_topk_rows(flat, MAX_NMS)
    nms_boxes, cand_valid, _ = _finish_pairs(ts, ti, boxes_xyxy, None, nc,
                                             False, 256)
    k1 = (nms_boxes, cand_valid, IOU, 256, MAX_DET)
    k2 = (flat, zero, inf, cap)
    keep = greedy_nms_keep(*k1)
    k1_err = int((greedy_nms_keep_cuda(*k1) != keep).sum())
    require(k1_err == 0, f"K1 at {tuple(keep.shape)} differs in {k1_err} "
            f"rows")
    n_b, n_k = b * nms_boxes.shape[1], flat.numel()
    tests, swept = nms_iou_tests(torch, box_iou, nms_boxes, cand_valid, keep,
                                 256, MAX_DET, IOU)
    rows = {
        "greedy_nms_keep": (
            event_ms(torch, lambda: greedy_nms_keep_cuda(*k1), graph=True),
            event_ms(torch, lambda: greedy_nms_keep(*k1),
                     launches=PLAIN_LAUNCHES),
            bound(n_b * 2 + swept * 16, IOU_OPS * tests), None),
        "threshold_compact": (
            event_ms(torch, lambda: threshold_compact_cuda(*k2), graph=True),
            event_ms(torch, lambda: threshold_compact(*k2),
                     launches=PLAIN_LAUNCHES),
            bound(n_k * 4 + b * cap * 8),
            event_ms(torch, lambda: torch.topk(flat, MAX_NMS, 1))),
        "count_ge": (
            event_ms(torch, lambda: count_ge_cuda(flat, taus), graph=True),
            event_ms(torch, lambda: _count_ge(flat, taus),
                     launches=PLAIN_LAUNCHES),
            bound(n_k * 4 + taus.numel() * 8, 2 * n_k * taus.shape[1]),
            None),
    }
    return rows, k1, tests, k1_err


def print_kernel_rows(name, rows, card):
    for kname, (t, tp, (b_ms, b_by), lib) in rows.items():
        print(f"[time] {name}: {kname} kernel {t[0]:.4f} ms "
              f"[{t[1]:.4f}, {t[2]:.4f}], plain {tp[0]:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}, {b_ms / t[0]:.0%} of it)"
              + (f", torch.topk {lib[0]:.4f} ms" if lib else "")
              + f" | {card}")


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
    from efficientteacher_torch.utils.eval_regimes import (calibrate_bn,
                                                           shift_score_bias)

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
    shift_score_bias(teacher.head, shift)
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
    """Pseudo labels of `decoded` (B images) through K1 against the plain
    path (bit for bit), K1 at (B, 2048) on its candidates against
    `greedy_nms_keep`, and the times: `create_pseudo_labels` (eager, CUDA
    events), K1 (CUDA graph), its plain version and its bound."""
    from efficientteacher_torch.ops.boxes import box_iou
    from efficientteacher_torch.ops.nms import _prep_candidates_single
    from efficientteacher_torch.ops.nms_cuda import (greedy_nms_keep,
                                                     greedy_nms_keep_cuda)
    from efficientteacher_torch.ssod.pseudo_label import create_pseudo_labels

    s = ssod_cfg().SSOD
    kw = dict(img_size=IMG, nc=NC, conf_thres=s.nms_conf_thres,
              iou_thres=s.nms_iou_thres, max_pl=s.max_pseudo_labels)
    got = create_pseudo_labels(decoded, m_s, **kw)
    ref = create_pseudo_labels(decoded, m_s, use_kernels=False, **kw)
    require(all(torch.equal(a, b) for a, b in zip(got, ref)),
            "pseudo labels through K1 differ from the plain path")
    nms_boxes, cand_valid, _ = _prep_candidates_single(
        decoded.float(), NC, s.nms_conf_thres, 2048, True, 256, False)
    b = decoded.shape[0]
    require(nms_boxes.shape == (b, 2048, 4),
            f"K1's SSOD input is {tuple(nms_boxes.shape)}")
    k1 = (nms_boxes, cand_valid, s.nms_iou_thres, 256, s.max_pseudo_labels)
    keep = greedy_nms_keep(*k1)
    k1_err = int((greedy_nms_keep_cuda(*k1) != keep).sum())
    require(k1_err == 0, f"K1 at ({b}, 2048) differs in {k1_err} rows")
    tests, swept = nms_iou_tests(torch, box_iou, nms_boxes, cand_valid, keep,
                                 256, s.max_pseudo_labels, s.nms_iou_thres)
    return {
        "pl_img": float(got.mask.sum()) / b,
        "valid_img": float(cand_valid.sum(1).float().mean()),
        "kept": int(keep.sum()), "tests": tests, "k1_err": k1_err,
        "pl_ms": event_ms(torch, lambda: create_pseudo_labels(
            decoded, m_s, **kw), launches=20),
        "k1": event_ms(torch, lambda: greedy_nms_keep_cuda(*k1), graph=True),
        "k1_plain": event_ms(torch, lambda: greedy_nms_keep(*k1),
                             launches=PLAIN_LAUNCHES),
        "bound": bound(b * 2048 * 2 + swept * 16, IOU_OPS * tests)}


def sparse_teacher(torch, teacher, weak, m_s, iters=12):
    """Lower the teacher's objectness biases, by bisection, until its
    pseudo labels per image come nearest PL_SPARSE. Returns (shift, pseudo
    labels per image) of the nearest."""
    from efficientteacher_torch.ssod.pseudo_label import create_pseudo_labels
    from efficientteacher_torch.utils.eval_regimes import shift_score_bias

    s = ssod_cfg().SSOD
    kw = dict(img_size=IMG, nc=NC, conf_thres=s.nms_conf_thres,
              iou_thres=s.nms_iou_thres, max_pl=s.max_pseudo_labels)
    lo, hi, at, best = -12.0, 0.0, 0.0, None
    for _ in range(iters):
        mid = (lo + hi) / 2
        shift_score_bias(teacher.head, mid - at)
        at = mid
        pl = float(create_pseudo_labels(teacher_decoded(torch, teacher, weak),
                                        m_s, **kw).mask.sum()) / weak.shape[0]
        if best is None or abs(pl - PL_SPARSE) < abs(best[1] - PL_SPARSE):
            best = (mid, pl)
        lo, hi = (mid, hi) if pl < PL_SPARSE else (lo, mid)
    shift_score_bias(teacher.head, best[0] - at)
    return best


def train_phase(torch, dev, card):
    """The training step's path (see the module docstring), its checks and
    times. Returns K1's kernels-line entry at the SSOD shape (16, 2048) and
    the bare steps' img/s: {"ssod": ..., "burn_in": ...}."""
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

    cfg = ssod_cfg()
    s = cfg.SSOD
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
    entry = {"name": "greedy_nms_keep", "route": "cuda",
             "source": "efficientteacher_torch/csrc/nms.cu",
             "replaces": "efficientteacher_tpu/ops/nms_pallas.py:138",
             "launches": k1_launches,
             "max_abs_err": float(max(d["k1_err"] for d in loads.values())),
             "ms": t[0], "ms_min": t[1], "ms_max": t[2],
             "plain_ms": ld["k1_plain"][0], "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": None, "path": "train",
             "shape": [B_UN, 2048]}
    return entry, {"ssod": (B_SUP + B_UN) / per_step * 1e3,
                   "burn_in": B_SUP / burn_warm * 1e3}

# The dataset the data, aug, trainer and CLI phases read, written at run
# time from SEED into DATA_DIR (gitignored, removed at the end): labelled,
# unlabelled and val splits at COCO-like native sizes (w, h), with
# bench.py-style boxes (classes 0-79, centres in [0.2, 0.8], sizes in
# [0.05, 0.45)) at 1-13 per image, 7 on average (COCO train2017: 7.3).
# Three images in four are JPEG (quality 90, 4:2:0, written by the loader
# core's own writer), the rest PNG (zlib).
DATA_DIR = Path(__file__).resolve().parent / "smoke_data"
SPLITS = {"labelled": 256, "unlabelled": 256, "val": 64}
NATIVE_WH = [(640, 480), (480, 640), (640, 427), (500, 375), (640, 640)]
DATA_WORKERS = (1, 8)    # the two ends; the script has a time limit


def write_split(root: Path, name: str, n: int, seed: int, first_id: int):
    """Images, YOLO label files and a list file of one split; returns the
    list file and the number of JPEGs. Three in four images are JPEG
    (quality 90, 4:2:0, the loader core's writer), the rest PNG; file
    stems are the numbers first_id + i (COCO's image ids). Content: a
    per-image colour gradient with mild noise, each box a filled
    rectangle of its own colour (so the files compress as photos do, not
    as noise)."""
    import numpy as np

    from efficientteacher_torch.data import image_io
    from efficientteacher_torch.utils import native_loader as nl

    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "labels").mkdir(parents=True, exist_ok=True)
    specs = []
    for i in range(n):
        w, h = NATIVE_WH[i % len(NATIVE_WH)]
        k = int(rng.integers(1, 14))
        boxes = np.concatenate([
            rng.integers(0, NC, (k, 1)), rng.uniform(0.2, 0.8, (k, 2)),
            rng.uniform(0.05, 0.45, (k, 2))], 1)
        ext = "jpg" if i % 4 != 3 else "png"
        specs.append((root / "images" / f"{first_id + i}.{ext}", w, h,
                      boxes, int(rng.integers(2**31))))

    def write(spec):
        path, w, h, boxes, s = spec
        r = np.random.default_rng(s)
        ys = np.arange(h, dtype=np.float32)[:, None, None]
        xs = np.arange(w, dtype=np.float32)[None, :, None]
        img = (r.uniform(40, 215, 3) + r.uniform(-0.15, 0.15, 3) * xs
               + r.uniform(-0.15, 0.15, 3) * ys).astype(np.float32)
        img = img + r.normal(0, 4, (h, w, 3)).astype(np.float32)
        for _, cx, cy, bw, bh in boxes:
            x1, x2 = (int(np.clip(v * w, 0, w)) for v in (cx - bw / 2,
                                                          cx + bw / 2))
            y1, y2 = (int(np.clip(v * h, 0, h)) for v in (cy - bh / 2,
                                                          cy + bh / 2))
            img[y1:y2, x1:x2] = r.uniform(0, 255, 3) \
                + r.normal(0, 8, (y2 - y1, x2 - x1, 3))
        img = np.clip(img, 0, 255).astype(np.uint8)
        if path.suffix == ".jpg":
            nl.jpeg_write(str(path), img, 90)
        else:
            image_io.write_png(str(path), img, level=1)
        (root / "labels" / f"{path.stem}.txt").write_text("".join(
            f"{int(c)} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}\n"
            for c, cx, cy, bw, bh in boxes))

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(write, specs))
    lst = root / f"{name}.txt"
    lst.write_text("".join(f"{spec[0]}\n" for spec in specs))
    return lst, sum(spec[0].suffix == ".jpg" for spec in specs)


def jpeg_probe(torch):
    """The JPEG route where the smoke runs: the loader core with its own
    decoder (it links no libjpeg; `ldd` checks), held against cv2's
    digests of the fixtures of tests/test_torch_jpeg.py (baseline 4:2:0 /
    4:2:2 / 4:4:4 / grey, progressive, restart intervals, an EXIF
    orientation, partial MCUs; scales 1, 1/2, 1/4, 1/8); a dataset drops
    a JPEG kind libjpeg refuses (12-bit) and reads an arithmetic-coded
    one. Also records which of cv2, PIL and yaml import there (the port
    uses none) and nvJPEG's header and library."""
    import tempfile

    from efficientteacher_torch.data.datasets import LoadImagesAndLabels
    from efficientteacher_torch.ops._build import HOST_FLAGS, host_library
    from efficientteacher_torch.utils import native_loader as nl

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_jpeg import FIXTURES, check_fixtures

    built = host_library()
    ldd = subprocess.run(["ldd", str(built.path)], capture_output=True,
                         text=True, timeout=60).stdout
    linked = sorted(line.split()[0] for line in ldd.splitlines() if line)
    require(not any("jpeg" in lib for lib in linked),
            f"the loader core links {linked}")
    probe = subprocess.run(
        [sys.executable, "-c",
         "import importlib\n"
         "for m in ('cv2', 'PIL', 'yaml'):\n"
         "    try:\n"
         "        importlib.import_module(m); print(m, 'imports')\n"
         "    except Exception as e:\n"
         "        print(m, 'does not import:', type(e).__name__)"],
        capture_output=True, text=True, timeout=120).stdout
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    nvjpeg_h = (cuda / "include" / "nvjpeg.h").exists()
    nvjpeg_so = sorted(p.name for p in (cuda / "lib64").glob("libnvjpeg.so*"))
    print(f"[data] loader core {built.path.name} built in "
          f"{built.seconds:.1f} s from "
          f"{', '.join(p.name for p in built.sources)}"
          f" ({' '.join(HOST_FLAGS)}; links {', '.join(linked)}: no "
          f"libjpeg); {'; '.join(probe.split(chr(10))[:3])}; nvjpeg.h "
          f"{'present' if nvjpeg_h else 'absent'}, libnvjpeg "
          f"{', '.join(nvjpeg_so) or 'absent'}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        bad = check_fixtures(tmp)
        dt = time.perf_counter() - t0
        require(not bad, f"decoder differs from cv2's digests: {bad}")
        n = sum(len(d) for _, d in FIXTURES.values())
        print(f"[data] JPEG decoder == cv2.imread's digests on {n} decodes "
              f"of {len(FIXTURES)} fixtures ({', '.join(FIXTURES)}) x scales"
              f" 1, 1/2, 1/4, 1/8 in {dt * 1e3:.1f} ms")
        # what libjpeg refuses (a 12-bit file) leaves the dataset, as cv2's
        # None leaves JAX's; an arithmetic-coded one (SOF9) is read
        import numpy as np

        import jpeg_writers as jw

        rgb = np.full((24, 40, 3), 90, np.uint8)
        rgb[:, 20:] = 160
        (Path(tmp) / "images").mkdir()
        paths = [Path(tmp) / "images" / f"{k}.jpg"
                 for k in ("arith", "precision_12")]
        paths[0].write_bytes(jw.encode(jw.ycc(rgb), [(1, 1)] * 3,
                                       arith=True))
        paths[1].write_bytes(jw.encode(
            [p.astype(np.int64) * 16 for p in jw.ycc(rgb)], [(1, 1)] * 3,
            precision=12))
        lst = Path(tmp) / "l.txt"
        lst.write_text("".join(f"{p}\n" for p in paths))
        ds = LoadImagesAndLabels(str(lst), img_size=IMG, nc=NC)
        require(ds.img_files == [str(paths[0])],
                f"the dataset kept {ds.img_files}")
        try:
            nl.jpeg_info(str(paths[1]))
        except OSError as e:
            print(f"[data] a dataset drops a JPEG kind libjpeg refuses, as "
                  f"JAX's drops cv2's None ({e}), and reads an arithmetic-"
                  f"coded one")
        else:
            raise SmokeFailure("a 12-bit JPEG was read")


def write_dataset(torch):
    """Write the smoke's dataset; returns {split: list file}."""
    jpeg_probe(torch)
    if DATA_DIR.exists():
        shutil.rmtree(DATA_DIR)
    t0 = time.perf_counter()
    lists, n_jpeg = {}, 0
    for k, (name, n) in enumerate(SPLITS.items()):
        lists[name], j = write_split(DATA_DIR / name, name, n, SEED + k,
                                     (k + 1) * 100000)
        n_jpeg += j
    total = sum(SPLITS.values())
    mb = sum(f.stat().st_size for f in DATA_DIR.rglob("images/*")) / 1e6
    print(f"[data] wrote {total} images ({n_jpeg} JPEG, {total - n_jpeg} "
          f"PNG; {', '.join(f'{k} {v}' for k, v in SPLITS.items())}; "
          f"native sizes {NATIVE_WH}) and their labels, {mb:.0f} MB, in "
          f"{time.perf_counter() - t0:.1f} s")
    return lists


def loader_rates(torch, ds, engines):
    """img/s of decode + letterbox at T_BATCH@IMG into pinned memory for
    each (engine, workers) in `engines`, every batch held against one
    single-threaded pass (whose rate is returned first)."""
    from efficientteacher_torch.data.datasets import BatchLoader

    t0 = time.perf_counter()
    ref = list(BatchLoader(ds, T_BATCH, shuffle=False, workers=1,
                           mode="thread"))
    rates = {"single": len(ds) / (time.perf_counter() - t0)}
    for mode, w in engines:
        loader = BatchLoader(ds, T_BATCH, shuffle=False, workers=w,
                             mode=mode, pin_memory=True)
        t0 = time.perf_counter()
        n = 0
        for bi, b in enumerate(loader):
            require(b["images"].is_pinned(), f"{mode}: not pinned")
            require(torch.equal(b["images"], ref[bi]["images"])
                    and (b["labels"] == ref[bi]["labels"]).all(),
                    f"{mode} x {w}: batch {bi} differs from the "
                    f"single-threaded one")
            n += b["images"].shape[0]
        rates[(mode, w)] = n / (time.perf_counter() - t0)
    return ref, rates


def data_phase(torch, lists, card):
    """Host decode + letterbox throughput at 32@640 for the thread and
    process engines at 1 and 8 workers (and threads at 16): on the
    labelled split (3/4 JPEG), on its JPEGs alone and on its PNGs alone,
    each epoch's batches held against one single-threaded pass. The
    trainer's loop needs about 276 img/s (32 + 32 per step)."""
    from efficientteacher_torch.data.datasets import LoadImagesAndLabels

    engines = [(m, w) for m in ("thread", "process") for w in DATA_WORKERS]
    t0 = time.perf_counter()
    ds = LoadImagesAndLabels(str(lists["labelled"]), img_size=IMG, nc=NC)
    t_cache = time.perf_counter() - t0
    ref, rates = loader_rates(torch, ds, engines)
    labels = sum(int(b["mask"].sum()) for b in ref)
    print(f"[data] labelled split: {len(ds)} images, {labels} boxes "
          f"({labels / len(ds):.2f}/img), labels cache built in "
          f"{t_cache:.2f} s; one single-threaded pass "
          f"{rates.pop('single'):.1f} img/s; host cores {os.cpu_count()}")
    print(f"[data] decode + letterbox at {T_BATCH}@{IMG} into pinned "
          f"memory, img/s by engine x workers: " + ", ".join(
              f"{m} {w} {r:.1f}" for (m, w), r in rates.items())
          + f"; every batch == the single-threaded pass | {card}")
    root = Path(lists["labelled"]).parent
    for ext in ("jpg", "png"):
        lst = root / f"only_{ext}.txt"
        lst.write_text("".join(
            f"{p}\n" for p in Path(lists["labelled"]).read_text().split()
            if p.endswith(ext)))
        sub = LoadImagesAndLabels(str(lst), img_size=IMG, nc=NC)
        extra = [("thread", 16)] if ext == "jpg" else []
        _, rates = loader_rates(torch, sub, engines + extra)
        kind = {"jpg": "JPEG", "png": "PNG"}[ext]
        print(f"[data] {kind} alone ({len(sub)} images): decode + "
              f"letterbox img/s, single-threaded {rates.pop('single'):.1f}; "
              f"by engine x workers: " + ", ".join(
                  f"{m} {w} {r:.1f}" for (m, w), r in rates.items())
              + f"; every batch == the single-threaded pass | {card}")


def aug_phase(torch, dev, lists, card):
    """device_augment_batch and device_ssod_views at 32@640 on the first
    labelled and unlabelled batches: ms per batch by CUDA events, device
    operations per call (torch.profiler), and the card's output against
    the CPU's on the same draws (images within 1 LSB, boxes 1e-4, masks
    exact, M_s 1e-5)."""
    from torch.profiler import ProfilerActivity, profile

    from efficientteacher_torch.data.datasets import (BatchLoader,
                                                      LoadImagesAndLabels)
    from efficientteacher_torch.data.datasets_ssod import (
        LoadImagesAndFakeLabels, SSODBatchLoader)
    from efficientteacher_torch.ops import augment_device as A

    cfg = ssod_cfg()
    hyp = {k: cfg.hyp[k] for k in cfg.hyp}
    ssod_hyp = {k: cfg.SSOD.ssod_hyp[k] for k in cfg.SSOD.ssod_hyp}
    mo = int(cfg.Dataset.max_targets)
    kw = dict(img_size=IMG, nc=NC, max_targets=mo)
    sb = next(iter(BatchLoader(LoadImagesAndLabels(
        str(lists["labelled"]), **kw), T_BATCH, shuffle=False)))
    tb = next(iter(SSODBatchLoader(LoadImagesAndFakeLabels(
        str(lists["unlabelled"]), **kw), T_BATCH, shuffle=False)))
    g = torch.Generator(device=dev)
    cases = {
        "device_augment_batch": (A.draw_augment, A.augment_batch, hyp, sb,
                                 "images"),
        "device_ssod_views": (A.draw_ssod, A.ssod_views, ssod_hyp, tb,
                              "images_ori")}
    for name, (draw, fn, h, batch, key) in cases.items():
        args = (batch[key].to(dev), torch.from_numpy(batch["labels"]).to(dev),
                torch.from_numpy(batch["mask"]).to(dev))

        def call():
            g.manual_seed(A.step_seed(2, 0, 1))
            return fn(*args, h, draw(g, T_BATCH, IMG, h, dev), max_out=mo)

        t = event_ms(torch, call, launches=10, repeats=5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        ops = sum(1 for e in prof.events() if e.device_type == cuda)
        top = sorted((e for e in prof.key_averages() if e.device_type == cuda),
                     key=lambda e: e.self_device_time_total, reverse=True)
        busy = sum(e.self_device_time_total for e in top) / 1e3
        # the same draws through the CPU
        g.manual_seed(A.step_seed(2, 0, 1))
        draws = draw(g, T_BATCH, IMG, h, dev)
        got = fn(*args, h, draws, max_out=mo)

        def cpu(d):
            return {k: cpu(v) if isinstance(v, dict) else v.cpu()
                    for k, v in d.items()}

        torch.set_num_threads(os.cpu_count() or 1)
        t0 = time.perf_counter()
        want = fn(*(a.cpu() for a in args), h, cpu(draws), max_out=mo)
        t_cpu = time.perf_counter() - t0
        errs = []
        for x, y in zip(got, want):
            x = x.cpu()
            if x.dtype == torch.uint8:
                errs.append(int((x.int() - y.int()).abs().max()))
                require(errs[-1] <= 1, f"{name}: image off by {errs[-1]}")
            elif x.dtype == torch.bool:
                require(torch.equal(x, y), f"{name}: masks differ")
            else:
                e = float((x - y).abs().max())
                require(torch.allclose(x, y, rtol=1e-5, atol=1e-4),
                        f"{name}: boxes or M_s off by {e}")
                errs.append(e)
        nbytes = sum(a.numel() * a.element_size() for a in args) + sum(
            x.numel() * x.element_size() for x in got)
        print(f"[aug] {name} {T_BATCH}@{IMG}: {t[0]:.3f} ms/batch (min "
              f"{t[1]:.3f}, max {t[2]:.3f}; CUDA events over 10 calls x 5) "
              f"with its draws, {ops} device operations per call (kernels, "
              f"copies, memsets); reads + writes {nbytes / 1e6:.0f} MB "
              f"(bound {nbytes / HBM_BYTES_S * 1e3:.3f} ms); the card == "
              f"the CPU on the same draws (max |d| per output "
              f"{', '.join(f'{e:g}' for e in errs)}; CPU {t_cpu:.1f} s) "
              f"| {card}")
        print(f"[aug] {name}: device busy {busy:.3f} ms in the traced call; "
              f"by device time: " + "; ".join(
                  f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f}"
                  f" ms" for e in top[:5]) + f" | {card}")


# The trainer phase: SSODTrainer at the YAML's own batch (32 + 32, so
# accumulate 2), 1 burn-in epoch + 2 mean-teacher epochs, then a resumed
# trainer for one more; T_STEPS labelled and T_STEPS target batches per
# epoch (the target loader drives the SSOD epochs: epoch_adaptor) and
# T_VAL val batches of 32 at each epoch end.
T_BATCH = 32
T_STEPS = SPLITS["labelled"] // T_BATCH
T_VAL = -(-SPLITS["val"] // T_BATCH)
T_EPOCHS, T_BURN = 3, 1


class TimedLoader:
    """A loader whose iteration records the host time each `next()` waits
    (in `waits`); `len` and `.ds` as the loader's."""

    def __init__(self, loader, waits):
        self.loader, self.waits, self.ds = loader, waits, loader.ds

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.waits.append((time.perf_counter() - t0) * 1e3)
                yield batch
        finally:
            it.close()


class RecordingInfer:
    """An eval InferFn that keeps each batch's decoded predictions and its
    NMS output, so they can be held against the plain NMS afterwards."""

    def __init__(self, infer, records):
        self.infer, self.records = infer, records

    def __call__(self, images_u8):
        decoded = self.infer.forward(images_u8)
        out = self.infer.nms(decoded)
        self.records.append((decoded, out))
        return out


def smoke_trainer(torch):
    """The SSODTrainer class of the phase: its own loaders from disk (set
    by `build_dataloader`, each wrapped in a `TimedLoader` when it
    trains), the train phase's teacher helper, and a log of its steps,
    epochs, loader waits, validations and checkpoint saves."""
    import logging

    from efficientteacher_torch.eval import validator
    from efficientteacher_torch.ops.nms import _pair_scores
    from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
    from efficientteacher_torch.ops.select_cuda import (count_ge_cuda,
                                                        threshold_compact_cuda)
    from efficientteacher_torch.parallel.distributed import to_device
    from efficientteacher_torch.train.ssod_trainer import SSODTrainer

    wrappers = {"greedy_nms_keep": greedy_nms_keep_cuda,
                "threshold_compact": threshold_compact_cuda,
                "count_ge": count_ge_cuda}

    class SpeedLog(logging.Handler):
        """Keeps the args of validator.run's "Speed" line: ms per image
        waiting on the device, ms per image of host metrics."""

        def __init__(self):
            super().__init__()
            self.last = None

        def emit(self, record):
            if record.getMessage().startswith("Speed"):
                self.last = record.args[:2]

    class SmokeTrainer(SSODTrainer):
        def __init__(self, *args, **kw):
            self.log = {"steps": [], "epochs": [], "vals": [], "saves": [],
                        "waits": [], "ssod_waits": []}
            self.helped = False
            super().__init__(*args, **kw)

        def train(self):
            self.raw_loaders = self.train_loader, self.target_loader
            self.train_loader = TimedLoader(self.train_loader,
                                            self.log["waits"])
            self.target_loader = TimedLoader(self.target_loader,
                                             self.log["waits"])
            return super().train()

        def _train_ssod_epoch(self):
            n0 = len(self.log["waits"])
            super()._train_with_unlabeled()
            self.log["ssod_waits"] += self.log["waits"][n0:]

        def build_step(self):
            super().build_step()
            self.raw_burn_step, self.raw_ssod_step = (self.burn_step,
                                                      self.ssod_step)
            self.burn_step = self._timed(self.burn_step, "burn-in")
            self.ssod_step = self._timed(self.ssod_step, "ssod")
            save = self.checkpointer.save

            def timed_save(path, **kw):
                t0 = time.perf_counter()
                save(path, **kw)
                self.log["saves"].append(
                    (str(path).rsplit("/", 1)[-1], self.epoch,
                     (time.perf_counter() - t0) * 1e3))

            self.checkpointer.save = timed_save

        def _timed(self, step, kind):
            """The step, logged without a sync: the host time from its
            call to the next step's (the loop's iteration), whether a
            checkpoint write was in flight, its K1 launches, and its
            losses and pseudo labels as device tensors (read after the
            epoch)."""
            def run(state, *args):
                now = time.perf_counter()
                steps = self.log["steps"]
                if steps and steps[-1]["epoch"] == self.epoch:
                    steps[-1]["ms"] = (now - steps[-1]["t0"]) * 1e3
                k0 = greedy_nms_keep_cuda.launches
                row = {"kind": kind, "epoch": self.epoch, "t0": now,
                       "in_flight": self.checkpointer.in_flight()}
                state, out = step(state, *args)
                row["k1"] = greedy_nms_keep_cuda.launches - k0
                row["losses"] = out if kind == "burn-in" else out.metrics
                if kind == "ssod":
                    row["pseudo"] = out.pseudo_count
                steps.append(row)
                return state, out
            return run

        def _train_with_unlabeled(self):
            if not self.helped and self.start_epoch <= self.burn_epochs:
                # in the run that seeds: the train phase's teacher helper
                # on the pseudo-label teacher (the EMA), and the serving
                # phase's mid density at the eval gate for the semi-EMA
                # (the validated teacher), calibrated on val images (the
                # density the validations then see); a resumed run takes
                # both from last.ckpt
                weak = to_device(
                    next(iter(self.raw_loaders[1]))["images_ori"],
                    self.device)
                pseudo_label_teacher(torch, self.state, weak)
                calib = next(iter(self.val_loader))["images"][:8]
                self.val_shift = mid_val_teacher(
                    torch, self.state.semi_ema.module, calib.to(self.device))
            self.helped = True
            self._train_ssod_epoch()

        def train_in_epoch(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n0 = len(self.log["steps"])
            super().train_in_epoch()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            steps = self.log["steps"][n0:]
            steps[-1]["ms"] = (time.perf_counter() - steps[-1]["t0"]) * 1e3
            for r in steps:
                r["losses"] = {k: float(v) for k, v in r["losses"].items()}
                if "pseudo" in r:
                    r["pseudo"] = int(r["pseudo"])
            self.log["epochs"].append({"epoch": self.epoch, "ms": ms,
                                       "kind": steps[0]["kind"],
                                       "steps": len(steps)})

        def _validate(self, ema):
            records = []
            speed = SpeedLog()
            vlog = logging.getLogger(validator.__name__)
            level = vlog.level
            vlog.setLevel(logging.INFO)
            vlog.addHandler(speed)
            make = validator.make_infer_fn
            validator.make_infer_fn = \
                lambda *a, **k: RecordingInfer(make(*a, **k), records)
            c0 = {n: w.launches for n, w in wrappers.items()}
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                results = super()._validate(ema)
                ms = (time.perf_counter() - t0) * 1e3
            finally:
                validator.make_infer_fn = make
                vlog.removeHandler(speed)
                vlog.setLevel(level)
            launches = {n: w.launches - c0[n] for n, w in wrappers.items()}
            # each batch's detections against the plain NMS on its own
            # decoded tensor (outside the timed call)
            infer = make(ema.module, NC, CONF, IOU, MAX_DET, MAX_NMS, 255.0,
                         self.compute_dtype)
            cands = []
            for bi, (decoded, out) in enumerate(records):
                ref = infer.nms(decoded, use_kernels=False)
                require(torch.equal(ref.detections, out.detections)
                        and torch.equal(ref.valid, out.valid),
                        f"epoch {self.epoch} val batch {bi}: detections "
                        f"differ from the plain NMS")
                score = _pair_scores(decoded, NC, CONF, False, 0, False,
                                     None)[0]
                cands.append(float((score > 0).sum()) / decoded.shape[0])
            self.log["vals"].append({
                "epoch": self.epoch, "ms": ms, "batches": len(records),
                "launches": launches, "speed": speed.last, "cands": cands,
                "dets": float(sum(int(o.valid.sum()) for _, o in records))
                / sum(o.valid.shape[0] for _, o in records),
                "results": results})
            self.val_decoded = records[0][0]
            return results

    return SmokeTrainer


def mid_val_teacher(torch, module, calib, target=3300.0, iters=12,
                    shift=None, conf=CONF):
    """Give `module` (the validated teacher) the serving phase's mid
    density at the eval gate: BatchNorm calibrated on `calib`, then its
    head's score biases (objectness; the YOLOv8 head's classes:
    `shift_score_bias`) shifted, by bisection, until the candidates per image
    on `calib` come nearest `target` (on a log scale). The trainer's
    burn-in moves the weights away from the init that MID_OBJ_SHIFT was
    chosen for (its objectness loss on noise images silences the head),
    so the shift is searched here. `shift(head, delta)` moves the biases
    (default `shift_score_bias`); `conf` is the gate the candidates pass.
    Returns (shift, candidates/img)."""
    import math

    from efficientteacher_torch.utils.eval_regimes import (calibrate_bn,
                                                           make_density_fn,
                                                           shift_score_bias)

    shift = shift or shift_score_bias
    calibrate_bn(module, calib)
    density = make_density_fn(module, NC, conf)
    lo, hi, at, best = -12.0, 12.0, 0.0, None
    for _ in range(iters):
        mid = (lo + hi) / 2
        shift(module.head, mid - at)
        at = mid
        cands = density(calib)[0]
        miss = abs(math.log(cands + 1.0) - math.log(target))
        if best is None or miss < best[2]:
            best = (mid, cands, miss)
        lo, hi = (mid, hi) if cands < target else (lo, mid)
    shift(module.head, best[0] - at)
    return best[:2]


def bare_ssod_args(torch, t):
    """One SSOD step's arguments, as trainer `t`'s loop makes them under
    device_aug: a batch of each of its loaders, copied to the card and
    augmented there. Also the host batches ("batches")."""
    from efficientteacher_torch.ops.augment_device import (device_ssod_views,
                                                           step_seed)

    sb, tb = (next(iter(loader)) for loader in t.raw_loaders)
    sup = t._to_device(sb["images"], sb["labels"], sb["mask"])
    un = t._to_device(tb["images_ori"], tb["labels"], tb["mask"])
    ni = t.global_step
    s_args = t.augment(*sup, 2, ni)
    t.aug_gen.manual_seed(step_seed(2, ni, 1))
    strong, _, _, weak, m_s = device_ssod_views(
        t.aug_gen, un[0], un[1].float(), un[2], t.ssod_hyp,
        max_out=int(t.cfg.Dataset.max_targets))
    return {"sup": s_args, "strong": strong, "weak": weak, "m_s": m_s,
            "sched": t._schedule(ni), "semi": t._semi_decay(),
            "batches": (sb, tb)}


def bare_trainer_steps(torch, trainer, pairs=3):
    """The trainer's own step functions called directly, `pairs` held +
    fired pairs each, on one batch from each of its loaders, copied and
    augmented on the card beforehand, each step ended by a synchronize:
    the bare steps at the trainer's batch, beside its loop. Also the
    loop's input copy for one SSOD step (six arrays, 79 MB at 32 + 32 @
    640 under device_aug: images from pinned memory): host ms of the
    calls, and ms until the copies land. Returns medians {"ssod",
    "burn_in", "copy_host", "copy_done"} and the copy's "copy_mb"."""
    from efficientteacher_torch.ops.augment_device import (device_ssod_views,
                                                           step_seed)

    t = trainer
    a = bare_ssod_args(torch, t)
    sb, tb = a["batches"]
    copies = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sup = t._to_device(sb["images"], sb["labels"], sb["mask"])
        un = t._to_device(tb["images_ori"], tb["labels"], tb["mask"])
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        copies.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
    s_args, sched, semi = a["sup"], a["sched"], a["semi"]
    out = {}
    for kind, step, args in (
            ("ssod", t.raw_ssod_step,
             (*s_args, a["strong"], a["weak"], a["m_s"], t.cls_thr_high,
              t.cls_thr_low, sched, semi)),
            ("burn_in", t.raw_burn_step, (*s_args, None, sched, semi))):
        ms = []
        for _ in range(2 * pairs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.state, _ = step(t.state, *args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[kind] = statistics.median(ms[2:])  # after a warm pair
    out["copy_mb"] = sum(a.numel() * a.element_size()
                         for a in (*sup, *un)) / 1e6
    out["copy_host"] = statistics.median(c[0] for c in copies[1:])
    out["copy_done"] = statistics.median(c[1] for c in copies[1:])
    return out


def data_overrides(lists):
    """The smoke dataset's splits, as overrides of the main config."""
    return ["Dataset.train", str(lists["labelled"]),
            "Dataset.target", str(lists["unlabelled"]),
            "Dataset.val", str(lists["val"])]


def trainer_phase(torch, dev, card, bare, lists):
    """The trainer main path: SSODTrainer (the main YAML's config and batch,
    reading the smoke dataset from disk with device augmentation) through
    burn-in, seeding, two mean-teacher epochs with epoch-end validation
    and last/best checkpoints, then resume for one more epoch. Checks and
    prints its numbers beside the bare step's (`bare`, img/s); returns the
    kernels-line entries of this path and its `route_numbers`."""
    import gc
    import tempfile

    from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
    from efficientteacher_torch.ops.select_cuda import (count_ge_cuda,
                                                        threshold_compact_cuda)
    from efficientteacher_torch.utils.checkpoint import load_checkpoint

    gc.collect()
    torch.cuda.empty_cache()
    t_setup = time.perf_counter()
    wrappers = {"greedy_nms_keep": greedy_nms_keep_cuda,
                "threshold_compact": threshold_compact_cuda,
                "count_ge": count_ge_cuda}
    with tempfile.TemporaryDirectory() as tmp:
        cls = smoke_trainer(torch)
        cfg = ssod_cfg("epochs", T_EPOCHS, "hyp.burn_epochs", T_BURN,
                       "project", tmp, "name", "ssod",
                       "Dataset.device_aug", True, *data_overrides(lists))
        trainer = cls(cfg, device=dev)
        require(trainer.accumulate == max(round(64 / T_BATCH), 1)
                and trainer.batch_size == T_BATCH and trainer.device_aug
                and trainer.nb == T_STEPS
                and len(trainer.target_loader) == T_STEPS
                and len(trainer.val_loader) == T_VAL,
                f"accumulate {trainer.accumulate}, batch "
                f"{trainer.batch_size}, {trainer.nb} steps")
        print(f"[trainer] SSODTrainer on the main config (YOLOv5l, nc {NC}, "
              f"{IMG} px, bf16), batch {T_BATCH} + {T_BATCH}, accumulate "
              f"{trainer.accumulate}; {T_BURN} burn-in + "
              f"{T_EPOCHS - T_BURN} SSOD epochs of {T_STEPS} steps, "
              f"{T_VAL} val batches, from the smoke dataset on disk with "
              f"Dataset.device_aug; set-up "
              f"{time.perf_counter() - t_setup:.1f} s")
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.backends.cudnn.benchmark = True
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        trainer.train()
        t_train = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        weights = trainer.save_dir / "weights"
        last = load_checkpoint(weights / "last.ckpt")
        best = load_checkpoint(weights / "best.ckpt")
        meta = last["meta"]
        require(meta["epoch"] == T_EPOCHS - 1 and meta["has_ema"]
                and meta["has_optimizer"], f"last.ckpt meta {meta}")
        require(set(last) == {"model", "ema", "student_ema", "optimizer",
                              "meta"}, f"last.ckpt holds {sorted(last)}")
        require(set(best) == {"model", "ema", "meta"},
                f"best.ckpt holds {sorted(best)}")
        csv_rows = trainer.results_csv.read_text().splitlines()[1:]
        require([int(r.split(",")[0]) for r in csv_rows]
                == list(range(T_EPOCHS)), f"results.csv rows {csv_rows}")

        # resume from last.ckpt for one more epoch
        t0 = time.perf_counter()
        cfg2 = ssod_cfg("epochs", T_EPOCHS + 1, "hyp.burn_epochs", T_BURN,
                        "project", tmp, "name", "resumed", "resume", True,
                        "weights", str(weights / "last.ckpt"),
                        "Dataset.device_aug", True, *data_overrides(lists))
        resumed = cls(cfg2, device=dev)
        st, was = resumed.state, trainer.state
        require(resumed.start_epoch == T_EPOCHS
                and resumed.best_fitness == meta["best_fitness"]
                == trainer.best_fitness
                and st.semi_ema.updates == meta["ema_updates"]
                == was.semi_ema.updates
                and st.ema.updates == last["student_ema"]["updates"]
                == was.ema.updates
                and st.opt_step == was.opt_step
                and resumed.teacher_seeded,
                f"resume: epoch {resumed.start_epoch}, best "
                f"{resumed.best_fitness} / {meta['best_fitness']}, semi-EMA "
                f"updates {st.semi_ema.updates} / {meta['ema_updates']}, "
                f"EMA updates {st.ema.updates} / {was.ema.updates}, "
                f"optimizer steps {st.opt_step} / {was.opt_step}")
        for what, module in (("model", st.model),
                             ("student_ema", st.ema.module),
                             ("ema", st.semi_ema.module)):
            for name, p in module.named_parameters():
                require(torch.equal(p.cpu(),
                                    last[what]["params"][name].float()),
                        f"resume: {what} {name} is not the saved tensor")
        for (name, _), buf in zip(st.model.named_parameters(),
                                  st.momentum_buf):
            require(torch.equal(buf.cpu(),
                                last["optimizer"]["momentum_buf"][name]),
                    f"resume: momentum of {name} is not the saved tensor")
        resumed.train()
        t_resume = time.perf_counter() - t0
        rows2 = resumed.results_csv.read_text().splitlines()[1:]
        require([int(r.split(",")[0]) for r in rows2] == [T_EPOCHS],
                f"resumed results.csv rows {rows2}")
        launches = {n: w.launches for n, w in wrappers.items()}
        print(f"[trainer] launches on the trainer path (train + resume): "
              f"{', '.join(f'{n} {c}' for n, c in launches.items())}; the "
              f"validated semi-EMA's objectness shifted "
              f"{trainer.val_shift[0]:+.3f} ({trainer.val_shift[1]:.0f} "
              f"candidates/img on its calibration batch)")
        log = {k: trainer.log[k] + resumed.log[k] for k in trainer.log}
        own = bare_trainer_steps(torch, resumed)

    # checks over both runs
    for r in log["steps"]:
        require(all(v == v and abs(v) != float("inf")
                    for v in r["losses"].values()),
                f"epoch {r['epoch']} {r['kind']} step: losses {r['losses']}")
    ssod = [r for r in log["steps"] if r["kind"] == "ssod"]
    k1_steps = sum(r["k1"] for r in ssod)
    require(all(r["k1"] == 1 for r in ssod),
            f"K1 launches per SSOD step {[r['k1'] for r in ssod]}")
    require(all(r["k1"] == 0 for r in log["steps"] if r["kind"] != "ssod"),
            "K1 launched in a burn-in step")
    require(all(r["pseudo"] > 0 for r in ssod),
            f"pseudo labels per SSOD step {[r['pseudo'] for r in ssod]}")
    vals = log["vals"]
    require(len(vals) == T_EPOCHS + 1 and all(
        v["launches"]["greedy_nms_keep"] >= v["batches"] == T_VAL
        and v["launches"]["threshold_compact"] >= 1 for v in vals),
        f"val launches {[v['launches'] for v in vals]}")
    for r in log["epochs"]:
        imgs = r["steps"] * T_BATCH * (2 if r["kind"] == "ssod" else 1)
        steps = [x for x in log["steps"] if x["epoch"] == r["epoch"]]
        print(f"[trainer] epoch {r['epoch']} {r['kind']}: {r['steps']} "
              f"steps in {r['ms']:.1f} ms, {imgs / r['ms'] * 1e3:.1f} img/s; "
              f"step ms (host, call to call) "
              + ", ".join(f"{x['ms']:.1f}{'*' if x['in_flight'] else ''}"
                          for x in steps)
              + "; losses " + ", ".join(
                  f"{x['losses'].get('total', x['losses'].get('loss')):.3f}"
                  for x in steps)
              + ("; pseudo labels/img " + ", ".join(
                  f"{x['pseudo'] / T_BATCH:.1f}" for x in steps)
                 if r["kind"] == "ssod" else "") + f" | {card}")
    warm = {k: [x["ms"] for x in log["steps"] if x["kind"] == k
                and x["epoch"] != T_BURN and not x["in_flight"]]
            for k in ("burn-in", "ssod")}
    flight = [x["ms"] for x in ssod if x["in_flight"]]
    med = {k: statistics.median(v) for k, v in warm.items() if v}
    ssod_rate = 2 * T_BATCH / med["ssod"] * 1e3
    burn_rate = T_BATCH / med["burn-in"] * 1e3
    print(f"[time] trainer: SSOD step {med['ssod']:.1f} ms in the loop "
          f"(median of {len(warm['ssod'])} steps outside the first SSOD "
          f"epoch, no write in flight), {ssod_rate:.1f} img/s; the same "
          f"step function called bare at {T_BATCH} + {T_BATCH} "
          f"{own['ssod']:.1f} ms ({2 * T_BATCH / own['ssod'] * 1e3:.1f} "
          f"img/s), so the loop adds {med['ssod'] - own['ssod']:+.1f} ms; "
          f"the train phase's bare step at 16 + 16 {bare['ssod']:.1f} "
          f"img/s | {card}")
    print(f"[time] trainer: burn-in step {med['burn-in']:.1f} ms in the loop "
          f"({len(warm['burn-in'])} steps), {burn_rate:.1f} img/s; bare at "
          f"{T_BATCH} {own['burn_in']:.1f} ms "
          f"({T_BATCH / own['burn_in'] * 1e3:.1f} img/s), loop "
          f"{med['burn-in'] - own['burn_in']:+.1f} ms; the train phase's "
          f"bare step at 16 {bare['burn_in']:.1f} img/s | {card}")
    print(f"[time] trainer: one SSOD step's input copy (6 arrays, "
          f"{own['copy_mb']:.0f} MB, the images from the loaders' pinned "
          f"memory, non-blocking): {own['copy_host']:.1f} ms of host "
          f"calls, {own['copy_done']:.1f} ms until on the card | {card}")
    waits = sorted(log["waits"])
    route = route_numbers(log, med["ssod"], peak)
    print(f"[time] trainer: the loop waits on the loaders' next() "
          f"(labelled and unlabelled, {len(waits)} batches): median "
          f"{statistics.median(waits):.2f} ms, p90 "
          f"{waits[int(0.9 * (len(waits) - 1))]:.2f} ms, max "
          f"{waits[-1]:.2f} ms; the first of each epoch included | {card}")
    print(f"[time] trainer: SSOD steps while a checkpoint write is in "
          f"flight: {', '.join(f'{t:.1f}' for t in flight) or 'none'} ms "
          f"(median without {med['ssod']:.1f}) | {card}")
    print(f"[time] trainer: AsyncCheckpointer.save blocks the loop "
          + ", ".join(f"{n} (epoch {e}) {t:.1f} ms"
                      for n, e, t in log["saves"]) + f" | {card}")
    for v in vals:
        wait, host = v["speed"]
        print(f"[time] trainer: epoch {v['epoch']} validator.run "
              f"{v['ms'] / v['batches']:.1f} ms/batch ({v['batches']} x "
              f"{T_BATCH}): device wait {wait * T_BATCH:.1f}, host metrics "
              f"{host * T_BATCH:.1f} ms/batch; candidates/img "
              f"{', '.join(f'{c:.0f}' for c in v['cands'])}, detections/img "
              f"{v['dets']:.1f}; P/R/mAP50/mAP "
              f"{'/'.join(f'{x:.4f}' for x in v['results'])}; launches "
              f"{v['launches']}; detections == plain NMS | {card}")
    print(f"[trainer] peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated; {(peak - base) / 2**30:.2f} GiB above "
          f"the {base / 2**30:.2f} GiB live before the phase); "
          f"train {t_train:.1f} s, resume + 1 epoch {t_resume:.1f} s; "
          f"results.csv {T_EPOCHS} + 1 rows, last/best reload, resumed "
          f"epoch / best_fitness / EMA and semi-EMA updates / weights / "
          f"momentum == saved | {card}")

    # the kernels of this path at its own shapes: K1 at (32, 2048) on the
    # final teacher's weak-view output, the val NMS's kernels on the last
    # validation's first lattice
    teacher = resumed.state.ema.module
    weak_t = next(iter(resumed.raw_loaders[1]))["images_ori"].to(dev)
    m_s = m_s_records(torch, T_BATCH).to(dev)
    ld = pseudo_label_load(torch, teacher_decoded(torch, teacher, weak_t),
                           m_s)
    flat, boxes_xyxy, taus, k2_err, count_err = lattice_checks(
        torch, resumed.val_decoded, "trainer val")
    rows, k1_val, _, k1_val_err = kernel_rows(torch, flat, boxes_xyxy, taus)
    print_kernel_rows("trainer val", rows, card)
    t, (b_ms, b_by) = ld["k1"], ld["bound"]
    print(f"[time] trainer: greedy_nms_keep ({T_BATCH}, 2048) on the final "
          f"teacher ({ld['pl_img']:.1f} pseudo labels/img) kernel "
          f"{t[0]:.4f} ms, plain {ld['k1_plain'][0]:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by}) | {card}")
    src = {"greedy_nms_keep": ("efficientteacher_torch/csrc/nms.cu",
                               "efficientteacher_tpu/ops/nms_pallas.py:138"),
           "threshold_compact": ("efficientteacher_torch/csrc/select.cu",
                                 "efficientteacher_tpu/ops/select_pallas.py:218"),
           "count_ge": ("efficientteacher_torch/csrc/select.cu",
                        "efficientteacher_tpu/ops/select_pallas.py:247")}
    val_launches = {n: sum(v["launches"][n] for v in vals) for n in src}
    entries = [{
        "name": "greedy_nms_keep", "route": "cuda",
        "source": src["greedy_nms_keep"][0],
        "replaces": src["greedy_nms_keep"][1], "launches": k1_steps,
        "max_abs_err": float(ld["k1_err"]), "ms": t[0], "ms_min": t[1],
        "ms_max": t[2], "plain_ms": ld["k1_plain"][0], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None, "path": "trainer: SSOD steps",
        "shape": [T_BATCH, 2048]}]
    errs = {"greedy_nms_keep": k1_val_err, "threshold_compact": k2_err,
            "count_ge": count_err}
    for name, (tk, tp, (b_ms, b_by), lib) in rows.items():
        if not val_launches[name]:
            print(f"[trainer] {name} not launched in the epoch-end "
                  f"validations at this density")
            continue
        entries.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": val_launches[name],
            "max_abs_err": float(errs[name]), "ms": tk[0], "ms_min": tk[1],
            "ms_max": tk[2], "plain_ms": tp[0], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib[0] if lib else None,
            "path": "trainer: epoch-end val",
            "shape": list((k1_val[0] if name == "greedy_nms_keep"
                           else flat).shape[:2])})
    return entries, route


def route_numbers(log, ssod_ms, peak):
    """A trainer run's SSOD step in the loop (ms), the waits of its SSOD
    steps on the two loaders (ms per step: median, p90, max, and the sum
    over all its SSOD steps), its SSOD epochs' img/s and its peak memory
    (GiB), for the [hostaug] comparison of the two routes."""
    ssod = [r for r in log["steps"] if r["kind"] == "ssod"]
    per_step = sorted(a + b for a, b in zip(*[iter(log["ssod_waits"])] * 2))
    epochs = [2 * r["steps"] * T_BATCH / r["ms"] * 1e3
              for r in log["epochs"] if r["kind"] == "ssod"]
    return {"ssod_ms": ssod_ms, "steps": len(ssod),
            "wait_med": statistics.median(per_step),
            "wait_p90": per_step[int(0.9 * (len(per_step) - 1))],
            "wait_max": per_step[-1], "wait_sum": sum(per_step),
            "epoch_img_s": epochs, "peak_gib": peak / 2**30}


# [hostaug]: the host augmentation route (Dataset.device_aug False, every
# shipped YAML). The loader rates run on the JPEGs of the labelled and
# unlabelled splits at T_BATCH@IMG, each engine's epoch held against the
# single-threaded one (a batch draws from random.Random(f"{seed}/{epoch}/
# {batch}") whatever builds it); the trainer run is 1 burn-in + 1
# mean-teacher epoch of T_STEPS steps at T_BATCH + T_BATCH.
HOST_ENGINES = [("thread", 1), ("thread", 8), ("process", 8)]


def pixel_op_digests(torch):
    """The loader core's pixel operations against cv2 5.0.0's digests
    (tests/pixel_op_cases.py, recorded where that cv2 is the oracle); also
    prints which cv2 this machine has, if any (not the oracle here)."""
    from efficientteacher_torch.utils import native_loader as nl

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import pixel_op_cases

    t0 = time.perf_counter()
    bad = pixel_op_cases.check_core(nl)
    dt = time.perf_counter() - t0
    require(not bad, f"pixel ops differ from cv2's digests: {bad}")
    probe = subprocess.run(
        [sys.executable, "-c", "import cv2; print(cv2.__version__)"],
        capture_output=True, text=True, timeout=120)
    here = (f"cv2 {probe.stdout.strip()}" if probe.returncode == 0
            else "no cv2")
    names = [c[0] for c in pixel_op_cases.cases()]
    print(f"[hostaug] loader core pixel ops == cv2 5.0.0's digests on "
          f"{len(names)} cases ({', '.join(names)}) in {dt * 1e3:.1f} ms; "
          f"this machine has {here} (not the oracle)")


def host_loader_rates(torch, make, name, card):
    """img/s of one epoch of `make(workers, mode)` (epoch 0, seed 0) per
    engine of HOST_ENGINES, each epoch's batches held against the first
    engine's (one thread)."""
    rates, ref = {}, None
    for mode, w in HOST_ENGINES:
        loader = make(w, mode)
        t0 = time.perf_counter()
        got = list(loader)
        rates[(mode, w)] = (sum(b["images"].shape[0] for b in got)
                            / (time.perf_counter() - t0))
        if ref is None:
            ref = got
            continue
        for bi, (a, b) in enumerate(zip(got, ref, strict=True)):
            for k in ("images", "images_ori"):
                require(k not in b or torch.equal(a[k], b[k]),
                        f"{name} {mode} x {w}: batch {bi} {k} differs from "
                        f"the single-threaded epoch's")
            require((a["labels"] == b["labels"]).all()
                    and (a["mask"] == b["mask"]).all(),
                    f"{name} {mode} x {w}: batch {bi} labels differ")
    return rates


def hostaug_phase(torch, dev, card, lists, dev_aug):
    """The host augmentation route: the core's pixel ops against cv2's
    digests, the host loaders' img/s per engine and with `cache ram`,
    and SSODTrainer on the main YAML without the device_aug override
    (its step in the loop, the loaders' waits, peak memory) beside the
    trainer phase's device_aug route (`dev_aug`, its route_numbers)."""
    import gc
    import tempfile

    from efficientteacher_torch.data.datasets import (BatchLoader,
                                                      LoadImagesAndLabels)
    from efficientteacher_torch.data.datasets_ssod import (
        LoadImagesAndFakeLabels, SSODBatchLoader)
    from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
    from efficientteacher_torch.ops.select_cuda import (count_ge_cuda,
                                                        threshold_compact_cuda)

    pixel_op_digests(torch)
    cfg = ssod_cfg()
    hyp = {k: cfg.hyp[k] for k in cfg.hyp}
    ssod_hyp = {k: cfg.SSOD.ssod_hyp[k] for k in cfg.SSOD.ssod_hyp}
    jpgs = {}
    for split in ("labelled", "unlabelled"):
        lst = Path(lists[split]).parent / f"only_jpg_{split}.txt"
        lst.write_text("".join(f"{p}\n" for p in
                               Path(lists[split]).read_text().split()
                               if p.endswith("jpg")))
        jpgs[split] = str(lst)

    def labelled(cache=False):
        return LoadImagesAndLabels(jpgs["labelled"], img_size=IMG, hyp=hyp,
                                   augment=True, nc=NC, cache_images=cache)

    def unlabelled():
        return LoadImagesAndFakeLabels(jpgs["unlabelled"], img_size=IMG,
                                       hyp=ssod_hyp, augment=True, nc=NC)

    routes = {
        "labelled (mosaic, affine, HSV, flips)": lambda ds, w, m: BatchLoader(
            ds, T_BATCH, workers=w, mode=m, pin_memory=True),
        "unlabelled (mosaic pair, strong view with HSV and cutout, M_s)":
            lambda ds, w, m: SSODBatchLoader(ds, T_BATCH, workers=w, mode=m,
                                             pin_memory=True)}
    for (name, loader), make_ds in zip(routes.items(),
                                       (labelled, unlabelled)):
        ds = make_ds()
        rates = host_loader_rates(
            torch, lambda w, m, ds=ds, loader=loader: loader(ds, w, m),
            name, card)
        print(f"[hostaug] {name}: {len(ds)} JPEGs at {T_BATCH}@{IMG} into "
              f"pinned memory, img/s by engine x workers: " + ", ".join(
                  f"{m} {w} {r:.1f}" for (m, w), r in rates.items())
              + f"; every engine's epoch == the single-threaded one; the "
              f"loop takes ~276 img/s | {card}")
    cached = labelled(cache=True)
    fill = list(routes)[0]
    t0 = time.perf_counter()
    first = list(routes[fill](cached, 8, "thread"))
    t_fill = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = list(routes[fill](cached, 8, "thread"))
    t_warm = time.perf_counter() - t0
    n = sum(b["images"].shape[0] for b in again)
    require(len(cached._img_cache) == len(cached), "cache ram: not filled")
    require(all(torch.equal(a["images"], b["images"])
                for a, b in zip(first, again)), "cache ram: epochs differ")
    print(f"[hostaug] labelled with cache ram, 8 threads: {n / t_warm:.1f} "
          f"img/s from the cache ({n / t_fill:.1f} img/s on the pass that "
          f"fills it) | {card}")
    del first, again, cached
    gc.collect()

    # the trainer on the main YAML as written (no Dataset.device_aug)
    wrappers = {"greedy_nms_keep": greedy_nms_keep_cuda,
                "threshold_compact": threshold_compact_cuda,
                "count_ge": count_ge_cuda}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cls = smoke_trainer(torch)
        cfg = ssod_cfg("epochs", T_BURN + 1, "hyp.burn_epochs", T_BURN,
                       "project", tmp, "name", "host", *data_overrides(lists))
        t0 = time.perf_counter()
        trainer = cls(cfg, device=dev)
        require(not trainer.device_aug and trainer.dataset.augment
                and trainer.target_loader.ds.augment
                and trainer.nb == T_STEPS, "host route: the loaders do not "
                "augment on the host")
        t_setup = time.perf_counter() - t0
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        trainer.train()
        t_train = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {n: w.launches for n, w in wrappers.items()}
        log = trainer.log
        rows = trainer.results_csv.read_text().splitlines()[1:]
    ssod = [r for r in log["steps"] if r["kind"] == "ssod"]
    for r in log["steps"]:
        require(all(v == v and abs(v) != float("inf")
                    for v in r["losses"].values()),
                f"host route epoch {r['epoch']} {r['kind']}: losses "
                f"{r['losses']}")
    require(len(rows) == T_BURN + 1 and len(ssod) == T_STEPS
            and all(r["k1"] == 1 for r in ssod)
            and launches["greedy_nms_keep"] >= len(ssod) + T_VAL
            and launches["threshold_compact"] >= 1,
            f"host route: {len(rows)} epochs, {len(ssod)} SSOD steps, "
            f"launches {launches}")
    warm = [r["ms"] for r in ssod[2:] if not r["in_flight"]]
    host = route_numbers(log, statistics.median(warm), peak)
    for r in log["epochs"]:
        imgs = r["steps"] * T_BATCH * (2 if r["kind"] == "ssod" else 1)
        print(f"[hostaug] trainer epoch {r['epoch']} {r['kind']}: "
              f"{r['steps']} steps in {r['ms']:.1f} ms, "
              f"{imgs / r['ms'] * 1e3:.1f} img/s; step ms "
              + ", ".join(f"{x['ms']:.1f}" for x in log["steps"]
                          if x["epoch"] == r["epoch"]) + f" | {card}")
    print(f"[hostaug] main YAML as written (host augmentation, AutoAugment "
          f"drawn but not fired: with_gt False), {T_BATCH} + {T_BATCH}: "
          f"SSOD step {host['ssod_ms']:.1f} ms in the loop (median of "
          f"{len(warm)} after 2), loaders' wait per SSOD step median "
          f"{host['wait_med']:.1f} ms, p90 {host['wait_p90']:.1f}, max "
          f"{host['wait_max']:.1f}, {host['wait_sum']:.0f} ms over the "
          f"{host['steps']} steps (the loaders build up to 16 batches "
          f"ahead: an epoch of {T_STEPS} waits once); SSOD epoch "
          f"{', '.join(f'{r:.1f}' for r in host['epoch_img_s'])} img/s; "
          f"peak memory {host['peak_gib']:.2f} GiB "
          f"({(peak - base) / 2**30:.2f} above the live "
          f"{base / 2**30:.2f}); launches {launches}; set-up {t_setup:.1f} "
          f"s, train {t_train:.1f} s | {card}")
    print(f"[hostaug] the trainer phase's device_aug route in this run: "
          f"SSOD step {dev_aug['ssod_ms']:.1f} ms in the loop, wait per SSOD "
          f"step median {dev_aug['wait_med']:.1f} ms, p90 "
          f"{dev_aug['wait_p90']:.1f}, max {dev_aug['wait_max']:.1f}, "
          f"{dev_aug['wait_sum']:.0f} ms over its {dev_aug['steps']} SSOD "
          f"steps; SSOD epochs "
          f"{', '.join(f'{r:.1f}' for r in dev_aug['epoch_img_s'])} img/s "
          f"(the first with the teacher helper and cuDNN's search); peak "
          f"memory {dev_aug['peak_gib']:.2f} GiB | {card}")


def cli_leg(torch, dev, card, lists):
    """The CLIs on the main YAML file itself (read without PyYAML) and the
    smoke dataset: `cli.train` trains one SSOD epoch (the teacher seeded
    at its start) as the YAML is written (the host augmentation);
    `cli.val` scores the best.ckpt
    it wrote, and a copy of it given the serving phase's mid density at
    the eval gate (`mid_val_teacher` on val images: a one-epoch teacher
    detects nothing at conf 0.001, so P/R/mAP would be 0 on both sides),
    each equal to `validator.run` on the same weights and loader. K1 and
    K2 must launch in the second. Both cli.val runs write the COCO JSON
    (--save-json) and score it against a ground-truth file written from
    the val split's label files (--coco-gt); the JSON must hold exactly
    the detections validator.run counted, and the vendor-free re-scorer's
    (mAP50, mAP) is printed beside validator.run's."""
    import gc
    import logging
    import tempfile

    from efficientteacher_torch.cli import compute_dtype
    from efficientteacher_torch.cli import train as cli_train
    from efficientteacher_torch.cli import val as cli_val
    from efficientteacher_torch.data.datasets import create_dataloader
    from efficientteacher_torch.eval import coco, validator
    from efficientteacher_torch.models import build_model, spec_from_cfg
    from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
    from efficientteacher_torch.ops.select_cuda import (count_ge_cuda,
                                                        threshold_compact_cuda)
    from efficientteacher_torch.utils.checkpoint import (
        load_eval_variables, load_module_variables, module_variables,
        save_checkpoint)

    wrappers = {"greedy_nms_keep": greedy_nms_keep_cuda,
                "threshold_compact": threshold_compact_cuda,
                "count_ge": count_ge_cuda}
    class Counted(logging.Handler):
        """validator.run's "Detections: N over M images" records."""

        def __init__(self):
            super().__init__(logging.INFO)
            self.counts = []

        def emit(self, record):
            if record.getMessage().startswith("Detections:"):
                self.counts.append(int(record.args[0]))

    counted = Counted()
    vlog = logging.getLogger(validator.__name__)
    vlog.addHandler(counted)
    vlevel = vlog.level
    vlog.setLevel(logging.INFO)
    gc.collect()
    torch.cuda.empty_cache()
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            overrides = [str(x) for x in (
                "epochs", 1, "hyp.burn_epochs", 0, "project", tmp, "name",
                "cli", *data_overrides(lists))]
            for fn in wrappers.values():
                fn.launches = 0
            t0 = time.perf_counter()
            best = cli_train.main(["--cfg", str(MAIN_YAML), *overrides])
            t_train = time.perf_counter() - t0
            run = Path(tmp) / "cli"
            ckpt = run / "weights" / "best.ckpt"
            rows = (run / "results.csv").read_text().splitlines()
            require(ckpt.is_file() and len(rows) == 2
                    and (run / "weights" / "last.ckpt").is_file(),
                    f"cli.train wrote {sorted(p.name for p in run.rglob('*'))}")
            cfg = ssod_cfg(*overrides)
            loader = create_dataloader(cfg, "val", augment=False,
                                       batch_size=T_BATCH, pin_memory=True)

            def model_of(path):
                model = build_model(spec_from_cfg(cfg), device=dev)
                load_module_variables(model, load_eval_variables(str(path)))
                return model.eval()

            mid = run / "weights" / "mid.ckpt"
            model = model_of(ckpt)
            # calibrated on val images: the density the val run then sees
            calib = next(iter(loader))["images"][:8].to(dev)
            shift = mid_val_teacher(torch, model, calib)
            v = module_variables(model)
            save_checkpoint(mid, params=v["params"],
                            batch_stats=v["batch_stats"],
                            ema_params=v["params"],
                            ema_batch_stats=v["batch_stats"])
            gt = coco.yolo_labels_to_coco_gt(loader.ds.img_files,
                                             str(Path(tmp) / "gt.json"), NC)
            scores = {}
            for name, path in (("best", ckpt), ("mid", mid)):
                for fn in wrappers.values():
                    fn.launches = 0
                pred = Path(tmp) / f"{name}.json"
                counted.counts.clear()
                t0 = time.perf_counter()
                got = cli_val.main(["--cfg", str(MAIN_YAML), "--weights",
                                    str(path), "--batch-size", str(T_BATCH),
                                    "--save-json", str(pred), "--coco-gt",
                                    gt, *overrides])
                t_val = time.perf_counter() - t0
                launches = {n: w.launches for n, w in wrappers.items()}
                want = validator.run(model_of(path), loader, nc=NC,
                                     compute_dtype=compute_dtype(dev))[0]
                rows = json.loads(pred.read_text())
                pair = coco.evaluate_predictions_json(str(pred), gt)
                require(len(counted.counts) == 2
                        and counted.counts[0] == counted.counts[1]
                        == len(rows),
                        f"{name}: the JSON holds {len(rows)} detections, "
                        f"validator.run counted {counted.counts}")
                require(all(isinstance(r["image_id"], int) for r in rows),
                        f"{name}: image ids not the numeric stems")
                scores[name] = (got, want, t_val, launches, len(rows), pair)
    finally:
        vlog.removeHandler(counted)
        vlog.setLevel(vlevel)
        root.setLevel(level)
        for h in root.handlers[:]:
            if h not in handlers:
                root.removeHandler(h)
    for name, (got, want, *_) in scores.items():
        require(tuple(got) == tuple(want),
                f"cli.val on {name} {got} != validator.run {want}")
    require(scores["mid"][3]["greedy_nms_keep"] > 0
            and scores["mid"][3]["threshold_compact"] > 0,
            f"cli.val at the mid density launched {scores['mid'][3]}")
    print(f"[cli] python -m efficientteacher_torch.cli.train --cfg "
          f"{MAIN_YAML.relative_to(MAIN_YAML.parents[3])} epochs 1 "
          f"hyp.burn_epochs 0 (+ the smoke "
          f"dataset): one SSOD epoch of {T_STEPS} steps, results.csv, "
          f"last.ckpt, best.ckpt in {t_train:.1f} s (best fitness "
          f"{best:.4f}) | {card}")
    for name, (got, _, t_val, launches, n_rows, pair) in scores.items():
        what = ("best.ckpt" if name == "best" else
                f"best.ckpt at the mid density (objectness {shift[0]:+.3f}, "
                f"{shift[1]:.0f} candidates/img on its calibration batch)")
        print(f"[cli] cli.val --save-json --coco-gt on {what}: {t_val:.1f} "
              f"s, P/R/mAP50/mAP {'/'.join(f'{x:.4f}' for x in got)} == "
              f"validator.run on the same weights and loader; COCO JSON "
              f"{n_rows} detections == validator.run's count; re-scored "
              f"mAP50/mAP {pair[0]:.4f}/{pair[1]:.4f} beside validator.run's "
              f"{got[2]:.4f}/{got[3]:.4f}; launches "
              f"{', '.join(f'{n} {c}' for n, c in launches.items())} "
              f"| {card}")


# [zoo]: the zoo families from their shipped YAMLs, as written but for the
# data paths: YOLOX-s (SimOTA, ComputeXLoss), YOLOv8-m (C2f, TAL, DFL),
# YOLOv7-L (ELAN, SPPCSPC, IDetect, ComputeLoss), YOLOv7-s-SimOTA (the
# YOLOX head on the YOLOv7 body, ComputeFastXLoss), YOLOv6-s
# (EfficientRep, RepPAN, ComputeTalLoss) and its RepOpt finetune (RealVGG
# blocks, gradient masks from a LinearAdd checkpoint written first), nc 80
# at 640 px, each at its YAML's batch, SGD, the host augmentation route.
# Each trains one epoch on the smoke dataset's labelled split (YOLOX-s
# and YOLOv8-m on its first 128 images: 2 steps), validates on its val
# split in batches of T_BATCH, and cli.val reads the best.ckpt it saved.
# Eval lattices: 8,400 predictions x 80 classes = 672,000 scores per image
# for the anchor-free heads; YOLOv7-L's IDetect has 3 anchors per cell,
# 2,016,000 (YOLOv5l's).
_CFGS = Path(__file__).resolve().parent / "configs/sup/public"
ZOO_YAMLS = {
    "yolox": _CFGS / "yolox_coco.yaml",
    "yolov8": _CFGS / "yolov8m_coco.yaml",
    "yolov7l": _CFGS / "yolov7l_coco.yaml",
    "yolov7s_simota": _CFGS / "yolov7s_coco_simota.yaml",
    "yolov6s": _CFGS / "yolov6s_coco.yaml",
    "yolov6s_repopt": _CFGS / "yolov6s_coco_repopt_finetune.yaml"}
# the labelled images each leg trains on: 2 steps each (128 at the YAMLs'
# batch 64; the batch-128 legs take the whole labelled split)
Z_IMAGES = {"yolox": 128, "yolov8": 128, "yolov7l": 128, "yolov6s": 128}
Z_N = (IMG // 8) ** 2 + (IMG // 16) ** 2 + (IMG // 32) ** 2
# steps timed warm after each leg, on its epoch's last batch
Z_WARM = 3
# the legs whose eval also runs on the `utils/reparam` fused model
Z_FUSED = ("yolov7l", "yolov6s")
# fused against unfused decoded outputs, float32 (no TF32): boxes within
# 1e-3 of the largest box entry, scores within 1e-3
FUSED_TOL = 1e-3
# the saturated lattice's logit spans: objectness near 1, class scores
# spread over (0.018, 0.98) (the top 1% above), every pair over the gate
SAT_LOGITS = {"obj": (4.0, 8.0), "cls": (-4.0, 4.0)}


def zoo_cfg(family, *overrides):
    """The family's YAML (the port's get_cfg() merged with it), then
    `overrides` (dotted key, value pairs)."""
    from efficientteacher_torch.configs import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(ZOO_YAMLS[family]))
    cfg.merge_from_list(list(overrides))
    return cfg


def saturate_head(torch, head, forward, images):
    """Light every (anchor, class) pair of a head with scores that still
    vary with the features: each group of logits whose sigmoid makes part
    of the eval score (the YOLOX class and objectness predictions, the
    YOLOv8 and YOLOv6 class predictions, YOLOv7 IDetect's objectness and
    class channels after its ImplicitM) has its values on `images` mapped
    affinely (the conv's weights scaled, its biases moved) so that their
    minimum lands at the low end of its SAT_LOGITS span and their 99th
    percentile at the high end. Equal scores would leave the element
    engine's bisection no threshold between them, and it would hand the
    selection to torch.topk. The boxes are the model's own."""
    from efficientteacher_torch.models.heads import (YoloV6Detect,
                                                     YoloV7Detect,
                                                     YoloXDetect)

    # (hooked module, conv to rescale, kind, channels or None for all)
    groups = []
    if isinstance(head, YoloXDetect):
        groups = [*((c, c, "cls", None) for c in head.cls_preds),
                  *((c, c, "obj", None) for c in head.obj_preds)]
    elif isinstance(head, YoloV7Detect):
        idx = torch.arange(head.na * head.no).view(head.na, head.no)
        for conv, im in zip(head.m, head.im):
            groups += [(im, conv, "obj", idx[:, 4]),
                       (im, conv, "cls", idx[:, 5:5 + head.nc].flatten())]
    elif isinstance(head, YoloV6Detect):
        groups = [(c, c, "cls", None) for c in head.cls_preds]
    else:
        groups = [(c, c, "cls", None) for c in
                  (getattr(head, f"cv3_{i}")[2]
                   for i in range(len(head.strides)))]
    logits = {}
    hooks = [mod.register_forward_hook(
        lambda m, _, out: logits.__setitem__(m, out.detach().float()))
        for mod in {g[0] for g in groups}]
    try:
        forward(images)
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        for mod, conv, kind, chs in groups:
            out = logits[mod]
            x = (out if chs is None else out[:, chs.to(out.device)]).flatten()
            mn = x.min()
            q99 = x.kthvalue(max(1, int(0.99 * x.numel()))).values
            require(bool(q99 > mn), f"saturate: constant {kind} logits")
            lo, hi = SAT_LOGITS[kind]
            a = (hi - lo) / (q99 - mn)
            # an ImplicitM's per-channel factor comes after the conv
            scale = (mod.implicit.flatten() if mod is not conv
                     else torch.ones_like(conv.bias))
            sel = (slice(None) if chs is None
                   else chs.to(conv.weight.device))
            conv.weight[sel] *= a
            conv.bias[sel] = (conv.bias[sel] * a
                              + (lo - a * mn) / scale[sel])


def zoo_trainer(torch):
    """The supervised Trainer of the phase: its val loader at T_BATCH, each
    step timed between synchronizes, and its epoch-end validation given
    the mid density first (`mid_val_teacher` on 8 val images: a model of a
    few steps detects nothing at conf 0.001) and recorded, each batch's
    detections held against the plain NMS."""
    from efficientteacher_torch.data.datasets import create_dataloader
    from efficientteacher_torch.eval import validator
    from efficientteacher_torch.ops.nms import _pair_scores
    from efficientteacher_torch.train.trainer import Trainer

    class ZooTrainer(Trainer):
        def __init__(self, *args, **kw):
            self.log = {"steps": [], "records": []}
            super().__init__(*args, **kw)

        def build_dataloader(self, cfg):
            super().build_dataloader(cfg)
            self.val_loader = create_dataloader(
                cfg, "val", augment=False, batch_size=T_BATCH,
                pin_memory=True)

        def build_step(self):
            super().build_step()
            step = self.train_step

            def run(state, *args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, parts = step(state, *args)
                torch.cuda.synchronize()
                self.log["steps"].append(
                    ((time.perf_counter() - t0) * 1e3,
                     {k: float(v) for k, v in parts.items()}))
                self.last_batch, self.last_sched = args[:3], args[3]
                return state, parts

            self.train_step = run

        def _validate(self, ema):
            calib = next(iter(self.val_loader))["images"][:8]
            one_class_lit(ema.module.head)
            self.val_shift = mid_val_teacher(torch, ema.module,
                                             calib.to(self.device),
                                             shift=shift_class0_bias)
            records = self.log["records"]
            make = validator.make_infer_fn
            validator.make_infer_fn = \
                lambda *a, **k: RecordingInfer(make(*a, **k), records)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                results = super()._validate(ema)
                self.val_ms = (time.perf_counter() - t0) * 1e3
            finally:
                validator.make_infer_fn = make
            infer = make(ema.module, NC, CONF, IOU, MAX_DET, MAX_NMS, 255.0,
                         self.compute_dtype)
            self.cands = []
            for bi, (decoded, out) in enumerate(records):
                ref = infer.nms(decoded, use_kernels=False)
                require(torch.equal(ref.detections, out.detections)
                        and torch.equal(ref.valid, out.valid),
                        f"val batch {bi}: detections differ from the plain "
                        f"NMS")
                score = _pair_scores(decoded, NC, CONF, False, 0, False,
                                     None)[0]
                self.cands.append(float((score > 0).sum())
                                  / decoded.shape[0])
            return results

    return ZooTrainer


# The zoo's mid lattice: one class lit. When many classes of a cell pass
# the gate, ~3,300 candidates fill a few hundred 128-wide rows of the
# (cell, class) lattice, and the selection's row tier (<= 1,024 live rows)
# takes them without the count; whether it does depends on the few-step
# weights. With the objectness near 1 (+MID_OBJ_LIT), every class but
# class 0 far below the gate (-MID_CLS_OFF) and class 0's biases bisected
# to the target, each candidate is a cell of its own, spread over more
# rows than the row tier takes: the element tier and its count run.
MID_OBJ_LIT = 12.0
MID_CLS_OFF = 20.0


def score_biases(head):
    """(objectness bias views, class bias views (..., nc)) of the convs
    whose sigmoids make a head's eval score: YOLOX's predictions, the
    YOLOv5 / YOLOv7 Detect convs' channels (IDetect's before its
    ImplicitM), the YOLOv6 and YOLOv8 class predictions (no objectness)."""
    from efficientteacher_torch.models.heads import (YoloV5Detect,
                                                     YoloV6Detect,
                                                     YoloXDetect)

    if isinstance(head, YoloXDetect):
        return ([c.bias for c in head.obj_preds],
                [c.bias for c in head.cls_preds])
    if isinstance(head, YoloV5Detect):
        views = [c.bias.view(head.na, head.no) for c in head.m]
        return ([v[:, 4] for v in views],
                [v[:, 5:5 + head.nc] for v in views])
    if isinstance(head, YoloV6Detect):
        return [], [c.bias for c in head.cls_preds]
    return [], [getattr(head, f"cv3_{i}")[2].bias
                for i in range(len(head.strides))]


def one_class_lit(head):
    """Objectness biases +MID_OBJ_LIT, every class bias but class 0's
    -MID_CLS_OFF, in place."""
    import torch

    obj, cls = score_biases(head)
    with torch.no_grad():
        for b in obj:
            b += MID_OBJ_LIT
        for b in cls:
            b[..., 1:] -= MID_CLS_OFF


def shift_class0_bias(head, delta):
    """Class 0's biases + `delta`, in place (`mid_val_teacher`'s shift)."""
    import torch

    with torch.no_grad():
        for b in score_biases(head)[1]:
            b[..., 0] += delta


def write_repscale(torch, tmp):
    """The RepOpt finetune's `Model.RepScale_weight`: a port checkpoint of
    a seeded `LinearAddModel: True` YOLOv6-s (yolov6s_coco.yaml, its
    scales at their init)."""
    from efficientteacher_torch.models import build_model, spec_from_cfg
    from efficientteacher_torch.utils.checkpoint import (module_variables,
                                                         save_checkpoint)

    cfg = zoo_cfg("yolov6s", "Model.LinearAddModel", True)
    model = build_model(spec_from_cfg(cfg), device="cpu",
                        generator=torch.Generator().manual_seed(SEED))
    v = module_variables(model)
    path = Path(tmp) / "repscale_linearadd.ckpt"
    save_checkpoint(path, params=v["params"], batch_stats=v["batch_stats"])
    n = sum(k.endswith(".scale_conv") for k in v["params"])
    print(f"[zoo] yolov6s_repopt: RepScale_weight written from a seeded "
          f"LinearAdd YOLOv6-s ({n} LinearAdd blocks) -> {path.name}")
    return path


def zoo_leg(torch, dev, card, lists, family, tmp):
    """One family's main path in parts, with the kernels' counts set to 0
    just before each and read just after: the Trainer on the YAML for one
    epoch with its epoch-end validation, cli.val on the best.ckpt it
    saved, the eval program on a saturated copy and, for Z_FUSED, the
    same on its `utils/reparam` fused model (the check run of
    validator.run beside cli.val lies outside them); then the kernels
    against their plain versions at the mid and saturated lattices.
    Returns the kernels-line entries of this path."""
    import gc
    import logging

    from efficientteacher_torch.cli import val as cli_val
    from efficientteacher_torch.data.datasets import create_dataloader
    from efficientteacher_torch.eval import validator
    from efficientteacher_torch.models import build_model, spec_from_cfg
    from efficientteacher_torch.ops import select_cuda
    from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
    from efficientteacher_torch.ops.select_cuda import (count_ge_cuda,
                                                        threshold_compact_cuda)
    from efficientteacher_torch.utils.checkpoint import (load_eval_variables,
                                                         load_module_variables)
    from efficientteacher_torch.utils.reparam import deploy_model

    wrappers = {"greedy_nms_keep": greedy_nms_keep_cuda,
                "threshold_compact": threshold_compact_cuda,
                "count_ge": count_ge_cuda}
    gc.collect()
    torch.cuda.empty_cache()
    split = lists.get(f"labelled_{Z_IMAGES.get(family)}", lists["labelled"])
    n_images = Z_IMAGES.get(family, SPLITS["labelled"])
    overrides = [str(x) for x in (
        "epochs", 1, "project", tmp, "name", family,
        "Dataset.train", split, "Dataset.val", lists["val"])]
    if family == "yolov6s_repopt":
        overrides += ["Model.RepScale_weight",
                      str(write_repscale(torch, tmp))]
    cfg = zoo_cfg(family, *overrides)
    t0 = time.perf_counter()
    trainer = zoo_trainer(torch)(cfg, device=dev)
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # cuDNN's heuristics, not its search: timing every algorithm of each
    # family's convolutions cost 5.7-26.1 s per leg (73 s of a 418 s zoo
    # on one H100 host), and the script must stay under its time limit
    torch.backends.cudnn.benchmark = False

    def counted(what, fn):
        """fn() with the kernels' counts and the selection tiers set to 0
        just before; (its result, the counts and tiers just after). Each
        kernel of the path must have launched."""
        for w in wrappers.values():
            w.launches = 0
        select_cuda.tier_counts.clear()
        out = fn()
        torch.cuda.synchronize()
        launches = {n: w.launches for n, w in wrappers.items()}
        require(all(c > 0 for c in launches.values()),
                f"{family}: a kernel of {what} was not launched: {launches}")
        return out, launches, dict(sorted(select_cuda.tier_counts.items()))

    spec = trainer.spec
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"[zoo] {family}: Trainer on {ZOO_YAMLS[family].name} as "
          f"written but the data paths ({spec.backbone}/{spec.neck}/"
          f"{spec.head}, "
          + (f"{spec.vgg_block_type} blocks, " if spec.backbone == "YoloV6"
             else "")
          + f"width {spec.width_multiple}, depth {spec.depth_multiple}, "
          f"{n_params / 1e6:.2f} M parameters, nc {spec.nc}, "
          f"{trainer.img_size} px, bf16 autocast; Loss.type "
          f"{cfg.Loss.type}; batch {trainer.batch_size}, accumulate "
          f"{trainer.accumulate}, {trainer.nb} steps on {n_images} "
          f"images, host augmentation); set-up "
          f"{time.perf_counter() - t0:.1f} s")
    require(trainer.nb == n_images // trainer.batch_size
            and trainer.accumulate == max(round(64 / trainer.batch_size),
                                          1)
            and not trainer.device_aug
            and len(trainer.val_loader) == T_VAL,
            f"{family}: batch {trainer.batch_size}, {trainer.nb} steps, "
            f"accumulate {trainer.accumulate}")

    masked = [m for m in trainer.grad_masks or [] if m is not None]
    if family == "yolov6s_repopt":
        trivial = sum(bool(m.eq(1).all()) for m in masked)
        require(masked and not trivial,
                f"{family}: {len(masked)} masked kernels, {trivial} trivial")
        print(f"[zoo] {family}: RepOpt masks on {len(masked)} RealVGG 3x3 "
              f"kernels, none all ones (centre taps "
              f"{min(float(m[:, :, 1, 1].min()) for m in masked):.3f}.."
              f"{max(float(m[:, :, 1, 1].max()) for m in masked):.3f}, "
              f"corners {min(float(m[:, :, 0, 0].min()) for m in masked):.3f}"
              f"..{max(float(m[:, :, 0, 0].max()) for m in masked):.3f})")
    else:
        require(not masked, f"{family}: gradient masks without RepOpt")

    try:
        t0 = time.perf_counter()
        _, val_launches, val_tiers = counted("the epoch", trainer.train)
        t_train = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        batch = trainer.batch_size
        weights = Path(tmp) / family / "weights"
        require((weights / "best.ckpt").is_file()
                and (weights / "last.ckpt").is_file(),
                f"{family}: no best/last.ckpt")
        loader = create_dataloader(cfg, "val", augment=False,
                                   batch_size=T_BATCH, pin_memory=True)

        def model_of(path):
            model = build_model(spec_from_cfg(cfg), device=dev)
            load_module_variables(model, load_eval_variables(str(path)))
            return model.eval()

        t0 = time.perf_counter()
        got, cli_launches, cli_tiers = counted(
            "cli.val", lambda: cli_val.main([
                "--cfg", str(ZOO_YAMLS[family]), "--weights",
                str(weights / "best.ckpt"), "--batch-size", str(T_BATCH),
                *overrides]))
        t_val = time.perf_counter() - t0
        # the check: validator.run on the same weights (no count is read)
        model = model_of(weights / "best.ckpt")
        want = validator.run(model, loader, nc=NC,
                             compute_dtype=torch.bfloat16)[0]
        require(tuple(got) == tuple(want),
                f"{family}: cli.val {got} != validator.run {want}")
        # the eval program on a saturated copy: every pair lit
        images = next(iter(loader))["images"].to(dev)
        infer = validator.make_infer_fn(model, NC, CONF, IOU, MAX_DET,
                                        MAX_NMS, 255.0, torch.bfloat16)
        mid = infer.forward(images)
        saturate_head(torch, model.head, infer.forward, images)
        recorded = []
        _, sat_launches, sat_tiers = counted(
            "the saturated eval",
            lambda: RecordingInfer(infer, recorded)(images))
        (sat, sat_out), = recorded
        fused_launches = None
        if family in Z_FUSED:
            fused_launches, fused_tiers, fused_times = fused_eval(
                torch, family, model, images, deploy_model, counted, card)
    finally:
        root.setLevel(level)
        for h in root.handlers[:]:
            if h not in handlers:
                root.removeHandler(h)
    steps = list(trainer.log["steps"])
    for ms, parts in steps:
        require(all(v == v and abs(v) != float("inf")
                    for v in parts.values()),
                f"{family}: losses {parts}")
    # warm steps: the epoch's last batch and schedule again, after the
    # leg's evaluations (an epoch of 2 steps has no warm step of its own)
    for _ in range(Z_WARM):
        trainer.train_step(trainer.state, *trainer.last_batch,
                           trainer.last_sched)
    warm = [ms for ms, _ in trainer.log["steps"][len(steps):]]
    step_ms = statistics.median(warm)
    loss_ms, assign_ms, assigner = loss_times(torch, trainer)
    print(f"[zoo] {family}: {len(steps)} steps at {batch}@{IMG}, ms "
          f"(synchronized) {', '.join(f'{ms:.1f}' for ms, _ in steps)} "
          f"(cuDNN's heuristics, no search: the first step "
          f"{steps[0][0] / 1e3:.1f} s); "
          f"{Z_WARM} warm steps on the last batch "
          f"{', '.join(f'{ms:.1f}' for ms in warm)}: median {step_ms:.1f} "
          f"ms, {batch / step_ms * 1e3:.1f} img/s; epoch + validation "
          f"{t_train:.1f} s; losses "
          + "; ".join(", ".join(f"{k} {v:.3f}" for k, v in parts.items())
                      for _, parts in steps[:1] + steps[-1:])
          + f"; peak memory {peak / 2**30:.2f} GiB (max_memory_allocated, "
          f"{base / 2**30:.2f} GiB live before) | {card}")
    print(f"[time] zoo {family}: the loss on the last step's batch, "
          f"forward only: {loss_ms:.2f} ms, of which the assignment "
          f"({assigner}) {assign_ms:.2f} ms ({assign_ms / step_ms:.0%} of "
          f"the step) | {card}")
    print(f"[zoo] {family}: validator.run at the epoch end "
          f"{trainer.val_ms / T_VAL:.1f} ms/batch ({T_VAL} x {T_BATCH}), "
          f"the EMA's class-0 bias shifted {trainer.val_shift[0]:+.3f} "
          f"(one class lit: objectness +{MID_OBJ_LIT:g}, the other classes "
          f"-{MID_CLS_OFF:g}; {trainer.val_shift[1]:.0f} candidates/img on "
          f"its calibration "
          f"batch; {', '.join(f'{c:.0f}' for c in trainer.cands)} per val "
          f"batch); detections == plain NMS; launches {val_launches}, "
          f"selection tiers {val_tiers} | {card}")
    print(f"[zoo] {family}: cli.val on best.ckpt {t_val:.1f} s, P/R/mAP50/mAP "
          f"{'/'.join(f'{x:.4f}' for x in got)} == validator.run; launches "
          f"{cli_launches}, selection tiers {cli_tiers} | {card}")
    print(f"[zoo] {family}: saturated eval (one batch of {T_BATCH}): "
          f"launches {sat_launches}, selection tiers {sat_tiers} | {card}")

    # the kernels at this head's lattices: mid (the saved EMA) and
    # saturated (every pair lit)
    n_pred = Z_N * (len(spec_from_cfg(cfg).anchors[0]) // 2
                    if spec_from_cfg(cfg).head == "YoloV7" else 1)
    require(sat.shape == (T_BATCH, n_pred, 5 + NC), f"{family}: {sat.shape}")
    ref = infer.nms(sat, use_kernels=False)
    require(torch.equal(ref.detections, sat_out.detections)
            and torch.equal(ref.valid, sat_out.valid),
            f"{family}: saturated detections differ from the plain NMS")
    t_fwd = time_ms(torch, lambda: infer.forward(images), reps=10, warmup=3)
    print(f"[time] zoo {family}: forward bf16 b{T_BATCH}@{IMG} "
          f"{t_fwd:.3f} ms/batch | {card}")
    entries = []
    # the mid lattice is the epoch-end validation's and cli.val's; their
    # launches are summed into one entry, and given apart; the saturated
    # entry holds the saturated eval's and the fused eval's
    mid_launches = {n: val_launches[n] + cli_launches[n] for n in wrappers}
    sat_paths = {"saturated eval": sat_launches}
    if fused_launches is not None:
        sat_paths["fused eval"] = fused_launches
    paths = {"mid": ("epoch-end val + cli.val (mid)", mid_launches,
                     {"epoch-end val": val_launches, "cli.val": cli_launches}),
             "saturated": (" + ".join(sat_paths), {
                 n: sum(p[n] for p in sat_paths.values()) for n in wrappers},
                 sat_paths)}
    for regime, decoded in (("mid", mid), ("saturated", sat)):
        flat, boxes_xyxy, taus, k2_err, count_err = lattice_checks(
            torch, decoded, f"zoo {family} {regime}")
        cands = float((flat > 0).sum()) / flat.shape[0]
        require(flat.shape[1] == n_pred * NC,
                f"{family}: lattice {tuple(flat.shape)}")
        if regime == "saturated":
            require(cands == n_pred * NC,
                    f"{family}: saturated holds {cands}")
        rows, k1, tests, k1_err = kernel_rows(torch, flat, boxes_xyxy, taus)
        t_k = time_ms(torch, lambda: infer.nms(decoded))
        t_p = time_ms(torch, lambda: infer.nms(decoded, use_kernels=False))
        print(f"[time] zoo {family} {regime}: {cands:.0f} candidates/img; "
              f"NMS kernels {t_k:.3f} ms, plain {t_p:.3f} ms per batch of "
              f"{T_BATCH}; {tests} IoU tests needed | {card}")
        print_kernel_rows(f"zoo {family} {regime}", rows, card)
        errs = {"greedy_nms_keep": k1_err, "threshold_compact": k2_err,
                "count_ge": count_err}
        path, launches, per_path = paths[regime]
        for name, (tk, tp, (b_ms, b_by), lib) in rows.items():
            entries.append({
                "name": name, "route": "cuda",
                "source": ZOO_SOURCES[name][0],
                "replaces": ZOO_SOURCES[name][1],
                "launches": launches[name], "max_abs_err": float(errs[name]),
                "ms": tk[0], "ms_min": tk[1], "ms_max": tk[2],
                "plain_ms": tp[0], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib[0] if lib else None,
                "path": f"zoo {family}: {path}",
                "launches_per_path": {k: v[name]
                                      for k, v in per_path.items()},
                "shape": list((k1[0] if name == "greedy_nms_keep"
                               else flat).shape[:2])})
    del trainer, model, infer, mid, sat
    gc.collect()
    torch.cuda.empty_cache()
    return entries


def fused_eval(torch, family, model, images, deploy_model, counted, card):
    """The `utils/reparam` deploy model of `model` (every RepVGG block one
    biased 3x3 conv): its decoded outputs in float32 beside the unfused
    model's (boxes within FUSED_TOL of the largest box entry, scores
    within FUSED_TOL), its eval program counted (the kernels must launch)
    with its detections held against the plain NMS, and the forward times
    of both in float32 and bf16. Returns (launches, tiers, times)."""
    from efficientteacher_torch.eval import validator
    from efficientteacher_torch.models.common import RepVGGBlock

    fused = deploy_model(model)
    n_blocks = sum(isinstance(m, RepVGGBlock) for m in model.modules())
    n_fused = sum(hasattr(m, "rbr_reparam") for m in fused.modules())
    require(n_fused == n_blocks > 0,
            f"{family}: {n_fused} of {n_blocks} RepVGG blocks fused")
    make = lambda m, dt: validator.make_infer_fn(  # noqa: E731
        m, NC, CONF, IOU, MAX_DET, MAX_NMS, 255.0, dt)
    plain32, fused32 = make(model, torch.float32), make(fused, torch.float32)
    want, got = plain32.forward(images), fused32.forward(images)
    box_err = float((got[..., :4] - want[..., :4]).abs().max())
    box_max = float(want[..., :4].abs().max())
    score_err = float((got[..., 4:] - want[..., 4:]).abs().max())
    require(box_err <= FUSED_TOL * box_max and score_err <= FUSED_TOL,
            f"{family}: fused model off by {box_err} px (of {box_max}), "
            f"scores by {score_err}")
    recorded = []
    _, launches, tiers = counted(
        "the fused eval", lambda: RecordingInfer(fused32, recorded)(images))
    (decoded, out), = recorded
    ref = fused32.nms(decoded, use_kernels=False)
    require(torch.equal(ref.detections, out.detections)
            and torch.equal(ref.valid, out.valid),
            f"{family}: fused detections differ from the plain NMS")
    times = {}
    for name, m in (("unfused", model), ("fused", fused)):
        for dt in (torch.float32, torch.bfloat16):
            f = make(m, dt)
            times[f"{name} {str(dt)[6:]}"] = time_ms(
                torch, lambda: f.forward(images), reps=10, warmup=3)
    print(f"[zoo] {family}: fused deploy model ({n_fused} RepVGG blocks -> "
          f"one 3x3 conv each): float32 decoded outputs vs unfused: boxes "
          f"{box_err:.2e} px of {box_max:.0f} (tol {FUSED_TOL:g} x), scores "
          f"{score_err:.2e} (tol {FUSED_TOL:g}); its eval launches "
          f"{launches}, tiers {tiers}, detections == plain NMS | {card}")
    print(f"[time] zoo {family}: forward b{T_BATCH}@{IMG} ms/batch "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f" | {card}")
    del fused
    return launches, tiers, times


# the assigner each loss family calls, by Loss.type: (module, name)
ASSIGNERS = {"ComputeLoss": ("yolov5_loss", "assign_all_scales"),
             "ComputeXLoss": ("yolox_loss", "simota_assign"),
             "ComputeFastXLoss": ("yolox_loss", "simota_assign"),
             "ComputeTalLoss": ("tal_loss", "tal_assign")}


def loss_times(torch, trainer, assigner=None):
    """(loss ms, assignment ms, the assigner's name) by CUDA events on the
    trainer's last batch: the detection loss's forward on the model's
    train-mode raw maps, and the same with the assigner's result cached,
    whose difference is the assignment's time. `assigner`: (module in
    `losses`, function) to cache, by default the Loss.type's."""
    import importlib

    from efficientteacher_torch.train.supervised import (forward_train,
                                                         to_input)

    images, labels, mask = trainer.last_batch
    with torch.no_grad():
        raw = forward_train(trainer.state.model,
                            to_input(images, trainer.compute_dtype, 255.0),
                            trainer.compute_dtype)
        loss = lambda: trainer.detection_loss(raw, labels, mask)  # noqa
        full = event_ms(torch, loss, launches=5, repeats=3)[0]
        mod_name, name = assigner or ASSIGNERS[trainer.cfg.Loss.type]
        module = importlib.import_module(
            f"efficientteacher_torch.losses.{mod_name}")
        assign = getattr(module, name)
        cached = []

        def once(*a, **k):
            if not cached:
                cached.append(assign(*a, **k))
            return cached[0]

        setattr(module, name, once)
        try:
            rest = event_ms(torch, loss, launches=5, repeats=3)[0]
        finally:
            setattr(module, name, assign)
    return full, full - rest, name


ZOO_SOURCES = {
    "greedy_nms_keep": ("efficientteacher_torch/csrc/nms.cu",
                        "efficientteacher_tpu/ops/nms_pallas.py:138"),
    "threshold_compact": ("efficientteacher_torch/csrc/select.cu",
                          "efficientteacher_tpu/ops/select_pallas.py:218"),
    "count_ge": ("efficientteacher_torch/csrc/select.cu",
                 "efficientteacher_tpu/ops/select_pallas.py:247")}


def zoo_phase(torch, dev, card, lists):
    """The zoo families (`zoo_leg`); their kernels-line entries."""
    import tempfile

    lists = dict(lists)
    for n in set(Z_IMAGES.values()):
        sub = Path(lists["labelled"]).with_name(f"labelled_{n}.txt")
        lines = Path(lists["labelled"]).read_text().splitlines()[:n]
        sub.write_text("\n".join(lines) + "\n")
        lists[f"labelled_{n}"] = str(sub)
    entries = []
    with tempfile.TemporaryDirectory() as tmp:
        for family in ZOO_YAMLS:
            entries += zoo_leg(torch, dev, card, lists, family, tmp)
    return entries


# [ssod-opts]: the SSOD trainer's remaining options and the last shipped
# YAML. Leg A: the main YAML (device_aug, as the trainer phase) with
# LabelMatch, the SSOD OTA loss and one extra teacher, O_STEPS steps per
# epoch (1 burn-in + 2 SSOD epochs, then one resumed epoch: LabelMatch
# refreshes at the end of each SSOD epoch); leg B: the cityscapes YAML as
# written but the data paths and its depth (1 epoch of CITY_STEPS steps,
# the smoke images with their classes mod 8); leg C: YOLOv7-L with the
# anchor OTA loss and AdamW at its YAML's batch (OTA_STEPS steps + Z_WARM
# warm ones).
O_STEPS = 4
O_EPOCHS, O_BURN = 3, 1
O_PAIRS = 3        # held + fired pairs of the bare, phase-timed SSOD step
O_DROPPED = 10     # classes the extra teacher's name list drops
CITY_YAML = (Path(__file__).resolve().parent
             / "configs/ssod/cityscapes/yolov5l_cityscapes.yaml")
CITY_NC, CITY_STEPS = 8, 4
OTA_STEPS = 2


def city_cfg(*overrides):
    """The cityscapes YAML (the port's get_cfg() merged with it), then
    `overrides` (dotted key, value pairs)."""
    from efficientteacher_torch.configs import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(CITY_YAML))
    cfg.merge_from_list(list(overrides))
    return cfg


def subset_lists(lists, n, tag, classes=None, keypoints=0):
    """The first `n` images of each split as new list files; with
    `classes` or `keypoints`, in a directory of their own whose label
    files take each class mod `classes` and, after each box, `keypoints`
    points drawn inside it (seeded by the file's stem) (the images are
    symlinks)."""
    import numpy as np

    out = {}
    for split, lst in lists.items():
        if split not in SPLITS:
            continue
        lines = Path(lst).read_text().splitlines()[:n.get(split, 0)]
        root = Path(lst).parent
        if classes is not None or keypoints:
            root = DATA_DIR / f"{tag}_{split}"
            (root / "images").mkdir(parents=True, exist_ok=True)
            (root / "labels").mkdir(parents=True, exist_ok=True)
            new = []
            for line in lines:
                src = Path(line)
                dst = root / "images" / src.name
                if not dst.exists():
                    os.symlink(src, dst)
                rows = (src.parent.parent / "labels" / f"{src.stem}.txt"
                        ).read_text().splitlines()
                rng = np.random.default_rng(int(src.stem))
                text = ""
                for r in rows:
                    c, *box = r.split()
                    c = int(c) % classes if classes is not None else int(c)
                    cx, cy, bw, bh = map(float, box)
                    pts = rng.uniform(-0.5, 0.5, (keypoints, 2)) \
                        * (bw, bh) + (cx, cy)
                    text += f"{c} {' '.join(box)}" + "".join(
                        f" {v:.6f}" for v in pts.ravel()) + "\n"
                (root / "labels" / f"{src.stem}.txt").write_text(text)
                new.append(str(dst))
            lines = new
        sub = root / f"{split}_{tag}.txt"
        sub.write_text("\n".join(lines) + "\n")
        out[split] = str(sub)
    return out


class K1Recorder:
    """Wraps a module's `greedy_nms_keep_cuda` name: every call goes to
    the kernel (its launch count moves as before); calls whose K (the
    boxes' second dimension) is in `widths` have their arguments and mask
    kept (a few MB at the SSOD steps' shapes), so each can be held
    against the plain version afterwards."""

    def __init__(self, torch, module, widths):
        self.torch, self.module, self.widths = torch, module, widths
        self.real = module.greedy_nms_keep_cuda
        self.calls = []

    def __enter__(self):
        def rec(boxes, valid, iou, tile=256, stop_at=None):
            keep = self.real(boxes, valid, iou, tile, stop_at)
            if boxes.shape[1] in self.widths:
                self.calls.append((boxes.clone(), valid.clone(), iou, tile,
                                   stop_at, keep.clone()))
            return keep

        self.module.greedy_nms_keep_cuda = rec
        return self

    def __exit__(self, *exc):
        self.module.greedy_nms_keep_cuda = self.real


def k1_entry(torch, call, path, launches, timed=True):
    """K1 on one recorded call: its mask against the plain version (they
    must be equal) and, with `timed`, kernel time (CUDA graph), plain time
    and bound. Returns the kernels-line entry (None untimed)."""
    from efficientteacher_torch.ops.boxes import box_iou
    from efficientteacher_torch.ops.nms_cuda import (greedy_nms_keep,
                                                     greedy_nms_keep_cuda)

    boxes, valid, iou, tile, stop_at, keep = call
    args = (boxes, valid, iou, tile, stop_at)
    ref = greedy_nms_keep(*args)
    err = int((ref != keep).sum()) + int((greedy_nms_keep_cuda(*args)
                                          != ref).sum())
    require(err == 0, f"{path}: K1 at {tuple(keep.shape)} differs from the "
            f"plain version in {err} rows")
    if not timed:
        return None
    tests, swept = nms_iou_tests(torch, box_iou, boxes, valid, ref, tile,
                                 stop_at, iou)
    t = event_ms(torch, lambda: greedy_nms_keep_cuda(*args), graph=True)
    tp = event_ms(torch, lambda: greedy_nms_keep(*args),
                  launches=PLAIN_LAUNCHES)
    b_ms, b_by = bound(keep.numel() * 2 + swept * 16, IOU_OPS * tests)
    return {"name": "greedy_nms_keep", "route": "cuda",
            "source": ZOO_SOURCES["greedy_nms_keep"][0],
            "replaces": ZOO_SOURCES["greedy_nms_keep"][1],
            "launches": launches, "max_abs_err": float(err), "ms": t[0],
            "ms_min": t[1], "ms_max": t[2], "plain_ms": tp[0],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "path": path, "shape": list(keep.shape), "tile": tile,
            "valid_per_img": float(valid.sum(1).float().mean()),
            "kept": int(ref.sum())}


def val_entries(torch, decoded, path, launches, card, nc=NC):
    """K1, K2 and the count on a validation lattice (`kernel_rows`) of a
    model with `nc` classes, as kernels-line entries; a kernel that did
    not launch on the path has none."""
    flat, boxes_xyxy, taus, k2_err, count_err = lattice_checks(
        torch, decoded, path, nc)
    rows, k1, _, k1_err = kernel_rows(torch, flat, boxes_xyxy, taus, nc)
    print_kernel_rows(path, rows, card)
    errs = {"greedy_nms_keep": k1_err, "threshold_compact": k2_err,
            "count_ge": count_err}
    out = []
    for name, (tk, tp, (b_ms, b_by), lib) in rows.items():
        if not launches[name]:
            continue
        out.append({
            "name": name, "route": "cuda", "source": ZOO_SOURCES[name][0],
            "replaces": ZOO_SOURCES[name][1], "launches": launches[name],
            "max_abs_err": float(errs[name]), "ms": tk[0], "ms_min": tk[1],
            "ms_max": tk[2], "plain_ms": tp[0], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib[0] if lib else None,
            "path": path, "shape": list((k1[0] if name == "greedy_nms_keep"
                                         else flat).shape[:2])})
    return out


def write_extra_teacher(torch, cfg, dev, weak, path):
    """A port checkpoint of a seeded YOLOv5l of `cfg` (float32), made a
    teacher that gives pseudo labels on `weak` (`pseudo_label_teacher`)."""
    import types

    from efficientteacher_torch.models import build_model, spec_from_cfg
    from efficientteacher_torch.utils.checkpoint import (module_variables,
                                                         save_checkpoint)

    spec = dataclasses.replace(spec_from_cfg(cfg), train_domain=True)
    model = build_model(spec, device=dev,
                        generator=torch.Generator().manual_seed(SEED + 1))
    pseudo_label_teacher(torch, types.SimpleNamespace(
        ema=types.SimpleNamespace(module=model.eval(), updates=0)), weak)
    v = module_variables(model)
    save_checkpoint(path, params=v["params"], batch_stats=v["batch_stats"],
                    half=False)
    del model


def ssod_step_phases(torch, t, pairs=O_PAIRS):
    """The trainer's SSOD step called bare, `pairs` held + fired pairs on
    one batch, each phase timed by CUDA events (`on_phase`) and each
    SimOTA match (`losses/yolov5_ota_loss.simota_match`) too. Returns
    median ms per phase, of the step, and of its SimOTA matches."""
    from efficientteacher_torch.losses import yolov5_ota_loss as ota

    args = bare_ssod_args(torch, t)
    thr = t._thresholds()
    real = ota.simota_match
    rows = []
    for i in range(2 * pairs):
        marks, spans = [], []

        def on_phase(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        def timed(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = real(*a, **k)
            e.record()
            spans.append((s, e))
            return out

        ota.simota_match = timed
        try:
            torch.cuda.synchronize()
            on_phase("start")
            t.state, _ = t.raw_ssod_step(
                t.state, *args["sup"], args["strong"], args["weak"],
                args["m_s"], *thr, args["sched"], args["semi"],
                on_phase=on_phase)
            torch.cuda.synchronize()
        finally:
            ota.simota_match = real
        row = {name: a[1].elapsed_time(ev)
               for a, (name, ev) in zip(marks, marks[1:])}
        row["step"] = marks[0][1].elapsed_time(marks[-1][1])
        row["simota"] = sum(s.elapsed_time(e) for s, e in spans)
        rows.append(row)
    return {k: statistics.median(r[k] for r in rows[2:]) for k in rows[-1]}


def ssod_opts_leg(torch, dev, card, lists, tmp):
    """Leg A (see the section's comment). Returns kernels-line entries."""
    import random

    import numpy as np

    from efficientteacher_torch.data.datasets_ssod import (
        create_target_dataloader)
    from efficientteacher_torch.ops import nms
    from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
    from efficientteacher_torch.ops.select_cuda import (count_ge_cuda,
                                                        threshold_compact_cuda)
    from efficientteacher_torch.parallel.distributed import to_device
    from efficientteacher_torch.ssod import pseudo_label
    from efficientteacher_torch.utils.checkpoint import load_checkpoint

    wrappers = {"greedy_nms_keep": greedy_nms_keep_cuda,
                "threshold_compact": threshold_compact_cuda,
                "count_ge": count_ge_cuda}
    n = O_STEPS * T_BATCH
    sub = subset_lists(lists, {"labelled": n, "unlabelled": n,
                               "val": SPLITS["val"]}, "opts")
    main = ssod_cfg()
    names = [str(x) for x in main.Dataset.names]
    thr0 = np.float32(main.SSOD.ignore_thres_high)
    rng = random.Random(SEED)
    extra_names = rng.sample(names, len(names))
    for i in rng.sample(range(len(names)), O_DROPPED):
        extra_names[i] = f"not_in_dataset_{i}"
    teacher_path = Path(tmp) / "extra_teacher.ckpt"

    def cfg_of(name, *more):
        return ssod_cfg(
            "epochs", O_EPOCHS, "hyp.burn_epochs", O_BURN, "project", tmp,
            "name", name, "Dataset.device_aug", True, *data_overrides(sub),
            "SSOD.pseudo_label_type", "LabelMatch", "SSOD.use_ota", True,
            "SSOD.extra_teachers", [str(teacher_path)],
            "SSOD.extra_teachers_class_names", [extra_names], *more)

    cls = smoke_trainer(torch)
    # cuDNN's search, as legs A and B have timed since they were added
    # (the zoo before them times on its heuristics)
    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    weak = to_device(next(iter(create_target_dataloader(
        cfg_of("probe"), batch_size=T_BATCH, augment=False)))["images_ori"],
        dev)
    write_extra_teacher(torch, cfg_of("probe"), dev, weak, teacher_path)
    trainer = cls(cfg_of("opts"), device=dev)
    (module, cmap), = trainer.extra_teachers
    require(trainer.use_labelmatch and trainer.label_match is not None
            and int((cmap < 0).sum()) == O_DROPPED and not module.training,
            f"LabelMatch {trainer.use_labelmatch}, class map drops "
            f"{int((cmap < 0).sum())}")
    thr_log = []

    def log_thresholds(tr):
        lm = tr.label_match
        tr.callbacks.register_action(
            "on_fit_epoch_end", callback=lambda m, e: thr_log.append(
                (e, lm.cls_thr_high.copy(), lm.cls_thr_low.copy())))

    log_thresholds(trainer)
    print(f"[ssod-opts] A: SSODTrainer on the main YAML (YOLOv5l, nc {NC}, "
          f"{IMG} px, bf16, batch {T_BATCH} + {T_BATCH}, Dataset.device_aug)"
          f" with SSOD.pseudo_label_type LabelMatch, SSOD.use_ota True and "
          f"one extra teacher (a seeded YOLOv5l's port checkpoint, its class "
          f"names a permutation of Dataset.names with {O_DROPPED} dropped); "
          f"{O_BURN} burn-in + {O_EPOCHS - O_BURN} SSOD epochs of {O_STEPS} "
          f"steps, then one resumed epoch; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    with K1Recorder(torch, pseudo_label, (128, 256, 512)) as merges, \
            K1Recorder(torch, nms, (2048,)) as teachers:
        t0 = time.perf_counter()
        trainer.train()
        weights = trainer.save_dir / "weights"
        cfg2 = cfg_of("resumed", "epochs", O_EPOCHS + 1, "resume", True,
                      "weights", str(weights / "last.ckpt"))
        resumed = cls(cfg2, device=dev)
        saved = load_checkpoint(weights / "last.ckpt")["optimizer"]
        lm, was = resumed.label_match, trainer.label_match
        require(all(np.array_equal(getattr(lm, k), getattr(was, k))
                    for k in ("cls_thr_high", "cls_thr_low",
                              "cls_num_total"))
                and "labelmatch" in saved,
                "resume: LabelMatch's thresholds are not the saved ones")
        log_thresholds(resumed)
        resumed.train()
        t_run = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    log = {k: trainer.log[k] + resumed.log[k] for k in trainer.log}
    ssod = [r for r in log["steps"] if r["kind"] == "ssod"]
    for r in log["steps"]:
        require(all(v == v and abs(v) != float("inf")
                    for v in r["losses"].values()),
                f"ssod-opts epoch {r['epoch']}: losses {r['losses']}")
    require(all(r["k1"] == 3 for r in ssod),
            f"K1 launches per SSOD step {[r['k1'] for r in ssod]} (want 3: "
            f"two teachers' NMS and the merge)")
    require(all(r["pseudo"] > 0 for r in ssod),
            f"pseudo labels per step {[r['pseudo'] for r in ssod]}")
    require(len(thr_log) == O_EPOCHS + 1
            and len(merges.calls) == len(ssod)
            and len(teachers.calls) == 2 * len(ssod),
            f"{len(thr_log)} epoch ends, {len(merges.calls)} merges and "
            f"{len(teachers.calls)} teacher NMS calls recorded for "
            f"{len(ssod)} SSOD steps")
    refreshed = [(e, h, lo) for e, h, lo in thr_log if e >= O_BURN]
    require(all(not np.all(h == thr0) for _, h, _ in refreshed),
            "a LabelMatch refresh left every class at its initial threshold")
    vals = log["vals"]
    require(all(v["launches"]["greedy_nms_keep"] >= v["batches"]
                for v in vals), f"val launches {[v['launches'] for v in vals]}")
    phases = ssod_step_phases(torch, resumed)
    loop = statistics.median(r["ms"] for r in ssod
                             if r["epoch"] != O_BURN and not r["in_flight"])
    print(f"[ssod-opts] A: {len(ssod)} SSOD steps, K1 launches per step "
          f"{sorted({r['k1'] for r in ssod})} (the EMA's and the extra "
          f"teacher's NMS at ({T_BATCH}, 2048), the merge at "
          f"{sorted({tuple(c[0].shape[:2]) for c in merges.calls})}, tile "
          f"{merges.calls[0][3]}); pseudo labels/img "
          + ", ".join(f"{r['pseudo'] / T_BATCH:.1f}" for r in ssod)
          + f"; launches over the run {launches}; train + resume "
          f"{t_run:.1f} s; peak memory {peak / 2**30:.2f} GiB "
          f"({base / 2**30:.2f} GiB live before) | {card}")
    for e, h, lo in thr_log:
        print(f"[ssod-opts] A: LabelMatch thresholds after epoch {e}"
              f"{' (resumed run)' if e == O_EPOCHS else ''}: high "
              f"min/median/max {h.min():.4f}/{np.median(h):.4f}/"
              f"{h.max():.4f}, low {lo.min():.4f}/{np.median(lo):.4f}/"
              f"{lo.max():.4f}, classes refreshed "
              f"{int((h != thr0).sum())} of {NC}")
    extra = phases.get("extra_teachers", 0.0)
    print(f"[time] ssod-opts A: SSOD step {loop:.1f} ms in the loop "
          f"(median, outside the first SSOD epoch), bare "
          f"{phases['step']:.1f} ms ({2 * T_BATCH / phases['step'] * 1e3:.1f}"
          f" img/s); phases (CUDA events) "
          + ", ".join(f"{k} {v:.1f}" for k, v in phases.items()
                      if k not in ("step", "simota"))
          + f" ms: the extra teacher's forward {extra:.1f} ms "
          f"({extra / phases['step']:.0%} of the step), the SimOTA matches "
          f"(reliable + uncertain, 3 scales pooled) {phases['simota']:.1f} "
          f"ms ({phases['simota'] / phases['step']:.0%}) | {card}")
    for v in vals:
        print(f"[ssod-opts] A: epoch {v['epoch']} validation "
              f"{v['ms'] / v['batches']:.1f} ms/batch, P/R/mAP50/mAP "
              f"{'/'.join(f'{x:.4f}' for x in v['results'])}, launches "
              f"{v['launches']}; detections == plain NMS")
    # every recorded launch against the plain version; the last of each
    # kind is also timed
    for call in merges.calls[:-1] + teachers.calls[:-1]:
        k1_entry(torch, call, "ssod-opts A: a recorded K1 call", 0,
                 timed=False)
    entries = [
        k1_entry(torch, merges.calls[-1],
                 "ssod-opts A: the class-agnostic merge", len(ssod)),
        k1_entry(torch, teachers.calls[0],
                 "ssod-opts A: the EMA's and the extra teacher's NMS",
                 2 * len(ssod))]
    for e in entries:
        print(f"[time] ssod-opts A: greedy_nms_keep {tuple(e['shape'])} "
              f"tile {e['tile']} ({e['path'][13:]}; {e['valid_per_img']:.1f}"
              f" valid rows/img, {e['kept']} kept) kernel {e['ms']:.4f} ms, "
              f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.5f} ms "
              f"({e['bound_by']}), == greedy_nms_keep | {card}")
    print(f"[k1] ssod-opts A: all {len(merges.calls)} merges "
          f"{sorted({tuple(c[0].shape) for c in merges.calls})} and "
          f"{len(teachers.calls)} teacher NMS calls "
          f"{sorted({tuple(c[0].shape) for c in teachers.calls})} of the "
          f"SSOD steps bit-equal to greedy_nms_keep")
    val_launches = {k: sum(v["launches"][k] for v in vals) for k in wrappers}
    entries += val_entries(torch, resumed.val_decoded,
                           "ssod-opts A: epoch-end val", val_launches, card)
    del trainer, resumed
    return entries


def cityscapes_leg(torch, dev, card, lists, tmp):
    """Leg B: the cityscapes YAML. Returns kernels-line entries."""
    import gc

    import numpy as np

    from efficientteacher_torch.eval import validator
    from efficientteacher_torch.ops import nms
    from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
    from efficientteacher_torch.ops.select_cuda import (count_ge_cuda,
                                                        threshold_compact_cuda)
    from efficientteacher_torch.parallel.distributed import to_device
    from efficientteacher_torch.train.ssod_trainer import SSODTrainer

    gc.collect()
    torch.cuda.empty_cache()
    wrappers = {"greedy_nms_keep": greedy_nms_keep_cuda,
                "threshold_compact": threshold_compact_cuda,
                "count_ge": count_ge_cuda}
    cfg = city_cfg()
    n = CITY_STEPS * int(cfg.Dataset.batch_size)
    sub = subset_lists(lists, {"labelled": n, "unlabelled": n,
                               "val": SPLITS["val"] // 2}, "city",
                       classes=CITY_NC)
    cfg.merge_from_list(["epochs", 1, "project", tmp, "name", "city",
                         *data_overrides(sub)])
    steps = []

    class CityTrainer(SSODTrainer):
        def build_step(self):
            super().build_step()
            step = self.ssod_step

            def run(state, *args):
                torch.cuda.synchronize()
                k0, t0 = greedy_nms_keep_cuda.launches, time.perf_counter()
                state, out = step(state, *args)
                torch.cuda.synchronize()
                steps.append(((time.perf_counter() - t0) * 1e3,
                              greedy_nms_keep_cuda.launches - k0,
                              int(out.pseudo_count),
                              {k: float(v) for k, v in out.metrics.items()}))
                return state, out

            self.ssod_step = run

    torch.backends.cudnn.benchmark = True     # as in leg A
    t0 = time.perf_counter()
    trainer = CityTrainer(cfg, device=dev)
    check = getattr(trainer, "anchor_check", None)
    require(check is not None and trainer.spec.nc == CITY_NC
            and trainer.img_size == 960 and trainer.batch_size == 16
            and trainer.with_da_loss and trainer.burn_epochs == 0,
            f"cityscapes: anchor check {check}, nc {trainer.spec.nc}, "
            f"{trainer.img_size} px, batch {trainer.batch_size}")
    anchors = np.asarray(trainer.spec.anchors).reshape(3, -1)
    weak = to_device(next(iter(trainer.target_loader))["images_ori"], dev)
    pseudo_label_teacher(torch, trainer.state, weak)
    print(f"[ssod-opts] B: SSODTrainer on {CITY_YAML.name} as written but "
          f"the data paths and epochs 1 (YOLOv5l, nc {CITY_NC}, 960 px, "
          f"batch 16 + 16, burn_epochs 0, with_da_loss, uncertain_aug, host "
          f"augmentation; {trainer.nb} steps on the smoke images, classes "
          f"mod {CITY_NC}); autoanchor: BPR {check['bpr']:.4f}, evolved "
          f"anchors {'adopted' if check['adopted'] else 'not adopted'}"
          + (f" ({', '.join(str([round(float(v), 1) for v in a]) for a in anchors)})"
             if check["adopted"] else "")
          + f"; set-up {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    records = []
    make = validator.make_infer_fn
    validator.make_infer_fn = \
        lambda *a, **k: RecordingInfer(make(*a, **k), records)
    for w in wrappers.values():
        w.launches = 0
    try:
        with K1Recorder(torch, nms, (2048,)) as rec:
            t0 = time.perf_counter()
            trainer.train()
            t_run = time.perf_counter() - t0
    finally:
        validator.make_infer_fn = make
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    require(len(steps) == trainer.nb and all(k == 1 for _, k, _, _ in steps)
            and len(rec.calls) == len(steps) and records,
            f"cityscapes: {len(steps)} steps, K1 per step "
            f"{[k for _, k, _, _ in steps]}, {len(rec.calls)} recorded, "
            f"{len(records)} val batches")
    # the epoch-end val's detections against the plain NMS, batch by batch
    infer = make(trainer.state.semi_ema.module, CITY_NC, CONF, IOU, MAX_DET,
                 MAX_NMS, 255.0, trainer.compute_dtype)
    for bi, (decoded, out) in enumerate(records):
        ref = infer.nms(decoded, use_kernels=False)
        require(torch.equal(ref.detections, out.detections)
                and torch.equal(ref.valid, out.valid),
                f"cityscapes val batch {bi}: detections differ from the "
                f"plain NMS")
    require(all(all(v == v and abs(v) != float("inf") for v in m.values())
                for *_, m in steps), "cityscapes: a loss is not finite")
    ms = [s[0] for s in steps]
    print(f"[time] ssod-opts B: SSOD steps (synchronized) "
          f"{', '.join(f'{x:.1f}' for x in ms)} ms, median of the last "
          f"{len(ms) - 1} {statistics.median(ms[1:]):.1f} ms "
          f"({32 / statistics.median(ms[1:]) * 1e3:.1f} img/s); pseudo "
          f"labels/img {', '.join(f'{p / 16:.1f}' for _, _, p, _ in steps)};"
          f" losses {', '.join('%.3f' % m['total'] for *_, m in steps)}; "
          f"epoch + val {t_run:.1f} s; launches {launches} ({len(records)} "
          f"val batches, detections == plain NMS); peak memory "
          f"{peak / 2**30:.2f} GiB | {card}")
    for call in rec.calls[:-1]:
        k1_entry(torch, call, "ssod-opts B: a recorded K1 call", 0,
                 timed=False)
    entry = k1_entry(torch, rec.calls[-1], "ssod-opts B: cityscapes SSOD "
                     "steps", len(steps))
    print(f"[time] ssod-opts B: greedy_nms_keep {tuple(entry['shape'])} "
          f"kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
          f"bound {entry['bound_ms']:.5f} ms ({entry['bound_by']}); all "
          f"{len(rec.calls)} step launches == greedy_nms_keep | {card}")
    val_launches = dict(launches, greedy_nms_keep=launches["greedy_nms_keep"]
                        - len(steps))
    entries = [entry] + val_entries(
        torch, records[0][0], "ssod-opts B: cityscapes epoch-end val",
        val_launches, card, nc=CITY_NC)
    del trainer
    return entries


def ota_adamw_leg(torch, dev, card, lists, tmp):
    """Leg C: YOLOv7-L with the anchor OTA loss and AdamW. Returns
    kernels-line entries."""
    import gc

    from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
    from efficientteacher_torch.ops.select_cuda import (count_ge_cuda,
                                                        threshold_compact_cuda)

    gc.collect()
    torch.cuda.empty_cache()
    wrappers = {"greedy_nms_keep": greedy_nms_keep_cuda,
                "threshold_compact": threshold_compact_cuda,
                "count_ge": count_ge_cuda}
    cfg = zoo_cfg("yolov7l", "Loss.assigner_type", "SimOTA", "adam", True)
    n = OTA_STEPS * int(cfg.Dataset.batch_size)
    sub = subset_lists(lists, {"labelled": n, "val": SPLITS["val"]}, "ota")
    cfg.merge_from_list(["epochs", 1, "project", tmp, "name", "ota",
                         "Dataset.train", sub["labelled"],
                         "Dataset.val", sub["val"]])
    t0 = time.perf_counter()
    trainer = zoo_trainer(torch)(cfg, device=dev)
    require(trainer.opt_cfg.adam and trainer.state.second_moment is not None
            and trainer.detection_loss.__code__.co_names[0]
            == "compute_ota_loss" and trainer.nb == OTA_STEPS,
            f"YOLOv7-L: adam {trainer.opt_cfg.adam}, {trainer.nb} steps")
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cudnn.benchmark = True
    for w in wrappers.values():
        w.launches = 0
    trainer.train()
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    steps = list(trainer.log["steps"])
    for _ in range(Z_WARM):
        trainer.train_step(trainer.state, *trainer.last_batch,
                           trainer.last_sched)
    warm = [ms for ms, _ in trainer.log["steps"][len(steps):]]
    step_ms = statistics.median(warm)
    loss_ms, ota_ms, _ = loss_times(
        torch, trainer, ("yolov5_ota_loss", "simota_match"))
    require(all(v == v and abs(v) != float("inf")
                for _, p in steps for v in p.values()),
            f"YOLOv7-L OTA: losses {steps}")
    print(f"[ssod-opts] C: Trainer on yolov7l_coco.yaml with "
          f"Loss.assigner_type SimOTA and adam True (AdamW), batch "
          f"{trainer.batch_size}@{IMG}, accumulate {trainer.accumulate}; "
          f"{len(steps)} steps (synchronized) "
          f"{', '.join(f'{ms:.1f}' for ms, _ in steps)} ms; {Z_WARM} warm "
          f"{', '.join(f'{ms:.1f}' for ms in warm)}: median {step_ms:.1f} "
          f"ms, {trainer.batch_size / step_ms * 1e3:.1f} img/s; losses "
          + "; ".join(", ".join(f"{k} {v:.3f}" for k, v in p.items())
                      for _, p in steps)
          + f"; launches {launches}; peak memory {peak / 2**30:.2f} GiB; "
          f"set-up + epoch {time.perf_counter() - t0:.1f} s | {card}")
    print(f"[time] ssod-opts C: the OTA loss on the last batch, forward "
          f"only, {loss_ms:.2f} ms, of which the SimOTA match "
          f"{ota_ms:.2f} ms ({ota_ms / step_ms:.0%} of the step) | {card}")
    entries = val_entries(torch, trainer.log["records"][0][0],
                          "ssod-opts C: YOLOv7-L epoch-end val", launches,
                          card)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return entries


def ssod_opts_phase(torch, dev, card, lists):
    """The [ssod-opts] legs; their kernels-line entries."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        entries = ssod_opts_leg(torch, dev, card, lists, tmp)
        entries += cityscapes_leg(torch, dev, card, lists, tmp)
        entries += ota_adamw_leg(torch, dev, card, lists, tmp)
    return entries


# [ptbridge], [ddp], [kp]: the reference .pt bridge, DDP through
# torch.distributed and the keypoint path, each at full width.
VOC_YAML = (Path(__file__).resolve().parent
            / "configs/ssod/voc/yolov5l_voc_burn.yaml")
TRANSFER_YAML = (Path(__file__).resolve().parent
                 / "configs/ssod/custom/yolov5l_transfer_ssod.yaml")
KP_YAML = _CFGS / "yolov5l_coco.yaml"
PT_STEPS = 4        # the VOC warm start's burn-in steps (the YAML: 300 epochs)
DDP_STEPS = 4       # steps per epoch of each [ddp] run
KP_NP, KP_WARM, KP_TIMED = 5, 3, 2
FP16_MAX = 65504.0


class _Every:
    """Every K: a K1Recorder that keeps all calls."""

    def __contains__(self, k):
        return True


def yaml_cfg(yaml, *overrides):
    from efficientteacher_torch.configs import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(yaml))
    cfg.merge_from_list(list(overrides))
    return cfg


def recorded_cli_val(torch, argv, num_points=0):
    """cli.val with `argv`, every batch's NMS output recorded and held
    against the plain NMS on its decoded tensor afterwards; the kernels'
    launches in the call. Returns (results, launches, first decoded)."""
    from efficientteacher_torch.cli import val as cli_val
    from efficientteacher_torch.eval import validator
    from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
    from efficientteacher_torch.ops.select_cuda import (count_ge_cuda,
                                                        threshold_compact_cuda)

    wrappers = {"greedy_nms_keep": greedy_nms_keep_cuda,
                "threshold_compact": threshold_compact_cuda,
                "count_ge": count_ge_cuda}
    records, made = [], []
    make = validator.make_infer_fn

    def recording(*a, **k):
        made.append(make(*a, **k))
        return RecordingInfer(made[-1], records)

    for w in wrappers.values():
        w.launches = 0
    validator.make_infer_fn = recording
    try:
        got = cli_val.main(argv)
    finally:
        validator.make_infer_fn = make
    launches = {k: w.launches for k, w in wrappers.items()}
    for bi, (decoded, out) in enumerate(records):
        ref = made[0].nms(decoded, use_kernels=False)
        require(torch.equal(ref.detections, out.detections)
                and torch.equal(ref.valid, out.valid),
                f"cli.val {argv[3]} batch {bi}: detections differ from the "
                f"plain NMS")
    return got, launches, records[0][0]


def ptbridge_leg(torch, dev, card, lists, tmp):
    """[ptbridge]: a seeded YOLOv5l (main YAML, nc 80 @640) at the mid
    density, pickled as the reference saves it (fp16 `model` and `ema`
    module trees, its classes under `models.*` only while saving); cli.val
    on it against cli.val on a port checkpoint of the same fp16-rounded
    weights over the 64 val images at batch 32 (the same results and the
    same COCO JSON detections), each batch held against the plain NMS;
    the VOC burn-in YAML warm-started from it (1 burn-in epoch of
    PT_STEPS steps at 32 + 32, the smoke images' classes mod 20); the
    transfer YAML warm-started from an nc 365 `.pt` (built, not trained).
    Returns kernels-line entries."""
    import gc

    from efficientteacher_torch.data.datasets import create_dataloader
    from efficientteacher_torch.models import build_model, spec_from_cfg
    from efficientteacher_torch.utils.checkpoint import (module_variables,
                                                         save_checkpoint)
    from efficientteacher_torch.utils.torch_import import save_reference_pt

    tmp = Path(tmp)
    cfg = ssod_cfg(*data_overrides(lists))
    spec = dataclasses.replace(spec_from_cfg(cfg), train_domain=False)
    model = build_model(spec, device=dev,
                        generator=torch.Generator().manual_seed(SEED + 2))
    loader = create_dataloader(cfg, "val", augment=False, batch_size=T_BATCH,
                               pin_memory=True)
    calib = next(iter(loader))["images"][:8].to(dev)
    shift = mid_val_teacher(torch, model.eval(), calib)
    pt, ckpt = tmp / "eff-yolov5l.pt", tmp / "eff-yolov5l.ckpt"
    t0 = time.perf_counter()
    save_reference_pt(pt, model, model, epoch=-1)
    t_save = time.perf_counter() - t0
    v = module_variables(model)
    save_checkpoint(ckpt, params=v["params"], batch_stats=v["batch_stats"],
                    ema_params=v["params"], ema_batch_stats=v["batch_stats"])
    del model
    overrides = [str(x) for x in ("Dataset.val", lists["val"])]
    out = {}
    for name, path in (("pt", pt), ("ckpt", ckpt)):
        pred = tmp / f"{name}.json"
        t0 = time.perf_counter()
        got, launches, decoded = recorded_cli_val(torch, [
            "--cfg", str(MAIN_YAML), "--weights", str(path), "--batch-size",
            str(T_BATCH), "--save-json", str(pred), *overrides])
        out[name] = (got, launches, decoded, time.perf_counter() - t0,
                     json.loads(pred.read_text()))
    (got, launches, decoded, t_pt, rows), other = out["pt"], out["ckpt"]
    require(tuple(got) == tuple(other[0]) and rows == other[4],
            f"cli.val on the .pt {got} ({len(rows)} detections) != on the "
            f"port checkpoint {other[0]} ({len(other[4])})")
    require(launches["greedy_nms_keep"] > 0
            and launches["threshold_compact"] > 0,
            f"cli.val on the .pt at the mid density launched {launches}")
    print(f"[ptbridge] YOLOv5l (nc {NC}, {IMG} px) at the mid density "
          f"(objectness {shift[0]:+.3f}, {shift[1]:.0f} candidates/img) "
          f"pickled as the reference saves it ({pt.stat().st_size / 1e6:.1f}"
          f" MB fp16 model + ema, {t_save:.1f} s): cli.val --weights "
          f"{pt.name} {t_pt:.1f} s, P/R/mAP50/mAP "
          f"{'/'.join(f'{x:.4f}' for x in got)}, {len(rows)} detections == "
          f"cli.val on a port checkpoint of the same fp16 weights "
          f"({other[3]:.1f} s), each batch == the plain NMS; launches "
          f"{launches} | {card}")
    require(other[1] == launches, f"cli.val launches on the .pt {launches}"
            f" != on the port checkpoint {other[1]}")
    entries = val_entries(torch, decoded, "ptbridge: cli.val on the .pt "
                          "and on the port checkpoint", launches, card)
    for e in entries:
        per = {"cli.val .pt": launches[e["name"]],
               "cli.val port checkpoint": other[1][e["name"]]}
        e.update(launches=sum(per.values()), launches_per_path=per)
    del decoded, out
    gc.collect()
    torch.cuda.empty_cache()

    # the VOC burn-in YAML's warm start, trained
    n = PT_STEPS * T_BATCH
    voc = subset_lists(lists, {"labelled": n, "unlabelled": n,
                               "val": SPLITS["val"]}, "voc", classes=20)
    cls = smoke_trainer(torch)
    t = cls(yaml_cfg(VOC_YAML, "weights", str(pt), "epochs", 1,
                     "hyp.burn_epochs", 1, "Dataset.batch_size", T_BATCH,
                     "noval", True, "project", str(tmp), "name", "voc",
                     *data_overrides(voc)), device=dev)
    counts = t.warm_start_counts
    t.train()
    steps = [r for r in t.log["steps"] if r["kind"] == "burn-in"]
    require(len(steps) == PT_STEPS and all(
        all(x == x and abs(x) != float("inf") for x in r["losses"].values())
        for r in steps), f"VOC burn-in steps {steps}")
    n_head = len([k for k in module_variables(t.model)["params"]
                  if k.startswith("head.m.")])
    n_det = len([k for k in module_variables(t.model)["params"]
                 if k.startswith("det_")])
    (cp, tp), (cs, ts) = counts["params"], counts["batch_stats"]
    require(cs == ts and cp == tp - n_head - n_det,
            f"VOC warm start matched {counts} (head {n_head}, "
            f"discriminators {n_det})")
    ms = statistics.median(r["ms"] for r in steps[1:])
    print(f"[ptbridge] {VOC_YAML.relative_to(VOC_YAML.parents[3])} warm-"
          f"started from it: {cp}/{tp} params, {cs}/{ts} stats (the nc 20 "
          f"head's {n_head} and the discriminators' {n_det} tensors are "
          f"not in the .pt); 1 burn-in epoch of {PT_STEPS} steps at "
          f"{T_BATCH} (the YAML: 96, 300 epochs), step {ms:.1f} ms (median "
          f"after the first), losses "
          + ", ".join(f"{k} {v:.4f}" for k, v in steps[-1]["losses"].items()
                      if k != "loss") + f" | {card}")
    del t
    gc.collect()
    torch.cuda.empty_cache()

    # the transfer YAML: an obj365 (nc 365) .pt into its nc 2 model
    src = build_model(dataclasses.replace(spec, nc=365), device=dev,
                      generator=torch.Generator().manual_seed(SEED + 3))
    pt365 = tmp / "efficient-yolov5l-obj365.pt"
    save_reference_pt(pt365, src, src)
    del src
    sub = subset_lists(lists, {"labelled": T_BATCH, "unlabelled": T_BATCH,
                               "val": T_BATCH}, "transfer", classes=2)
    t = cls(yaml_cfg(TRANSFER_YAML, "weights", str(pt365),
                     "Dataset.batch_size", T_BATCH, "project", str(tmp),
                     "name", "transfer", *data_overrides(sub)), device=dev)
    (cp, tp), (cs, ts) = (t.warm_start_counts["params"],
                          t.warm_start_counts["batch_stats"])
    require(cs == ts and cp == tp - n_head - n_det,
            f"transfer warm start matched {t.warm_start_counts}")
    print(f"[ptbridge] {TRANSFER_YAML.relative_to(TRANSFER_YAML.parents[3])}"
          f" warm-started from an nc 365 .pt: {cp}/{tp} params, {cs}/{ts} "
          f"stats; the head's {n_head} tensors skipped on shape (365 -> 2 "
          f"classes), the discriminators' {n_det} not in the .pt")
    del t
    gc.collect()
    torch.cuda.empty_cache()
    return entries


def ddp_child(out: str, argv) -> int:
    """One [ddp] run (a process of its own): cli.train with `argv`, every
    step synchronised and timed, its losses read, each pseudo-label K1
    launch recorded and held against the plain version, each val batch's
    NMS against the plain NMS; writes `out` (JSON) and `out`.pt (the
    student's final float32 weights, the last recorded K1 call)."""
    import torch

    from efficientteacher_torch.cli import train as cli_train
    from efficientteacher_torch.ops import nms
    from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
    from efficientteacher_torch.ops.select_cuda import (count_ge_cuda,
                                                        threshold_compact_cuda)
    from efficientteacher_torch.parallel import distributed
    from efficientteacher_torch.train.ssod_trainer import SSODTrainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    wrappers = {"greedy_nms_keep": greedy_nms_keep_cuda,
                "threshold_compact": threshold_compact_cuda,
                "count_ge": count_ge_cuda}
    rec = {"steps": [], "vals": 0}
    held = {}

    class Run(smoke_trainer(torch)):
        def build_step(self):
            super().build_step()
            held["trainer"] = self
            rec["group"] = (distributed.group_active() and
                            torch.distributed.get_backend(),
                            distributed.world_size())
            for attr, kind in (("burn_step", "burn-in"),
                               ("ssod_step", "ssod")):
                def run(state, *a, _step=getattr(self, attr), _kind=kind):
                    calls = held["k1"].calls
                    n0 = len(calls)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, o = _step(state, *a)
                    torch.cuda.synchronize()
                    parts = o if _kind == "burn-in" else o.metrics
                    rec["steps"].append({
                        "kind": _kind,
                        "ms": (time.perf_counter() - t0) * 1e3,
                        "k1": len(calls) - n0,
                        "losses": {k: float(v) for k, v in parts.items()}})
                    if len(calls) > n0:
                        held["step_call"] = calls[-1]
                    return state, o
                setattr(self, attr, run)

        def _validate(self, ema):
            rec["vals"] += 1
            return super()._validate(ema)

    real = SSODTrainer
    import efficientteacher_torch.train.ssod_trainer as mod
    mod.SSODTrainer = Run
    for w in wrappers.values():
        w.launches = 0
    try:
        with K1Recorder(torch, nms, _Every()) as k1:
            held["k1"] = k1
            cli_train.main(argv)
    finally:
        mod.SSODTrainer = real
    rec["launches"] = {k: w.launches for k, w in wrappers.items()}
    # the steps' K1 calls held here; the val batches' NMS were held whole
    # (SmokeTrainer._validate), and the group's run holds its validation
    # lattice's K1, K2 and count against their plain versions
    for call in k1.calls:
        if call[0].shape[1] == 2048:
            k1_entry(torch, call, "ddp: a recorded K1 call", 0, timed=False)
    t = held["trainer"]
    rec["val_batches"] = sum(v["batches"] for v in t.log["vals"])
    rec["val_launches"] = {k: sum(v["launches"][k] for v in t.log["vals"])
                           for k in wrappers}
    rec["step_launches"] = {k: n - rec["val_launches"][k]
                            for k, n in rec["launches"].items()}
    if rec["group"][0]:
        rec["val_entries"] = val_entries(
            torch, t.val_decoded, "ddp: cli.train's epoch-end validation",
            rec["val_launches"], os.environ["CHIP_SMOKE_CARD"])
    sd = lambda m: {k: v.detach().float().cpu()  # noqa: E731
                    for k, v in m.state_dict().items()}
    torch.save({"model": sd(t.state.model), "ema": sd(t.state.ema.module),
                "k1": [x.cpu() if torch.is_tensor(x) else x
                       for x in held["step_call"]]}, out + ".pt")
    Path(out).write_text(json.dumps(rec))
    return 0


def ddp_leg(torch, dev, card, lists, tmp):
    """[ddp]: the trainer cell's config (main YAML, 32 + 32,
    Dataset.device_aug True) through cli.train in a process of its own,
    1 burn-in and 1 SSOD epoch of DDP_STEPS steps, 2 val batches at each
    epoch end: once in a world-size-1 NCCL group (torchrun's environment
    given by hand), once without a group. Their losses and final weights
    (student and teacher) must be bit-equal; the step ms of both. Returns
    kernels-line entries: the SSOD steps' K1 and the validations' K1, K2
    and count, each with both runs' launches."""
    import socket

    n = DDP_STEPS * T_BATCH
    sub = subset_lists(lists, {"labelled": n, "unlabelled": n,
                               "val": SPLITS["val"]}, "ddp")
    runs = {}
    for name in ("group", "alone"):
        out = str(Path(tmp) / f"ddp_{name}.json")
        argv = [str(x) for x in (
            "--cfg", MAIN_YAML, "epochs", 2, "hyp.burn_epochs", 1,
            "Dataset.device_aug", True, "project", tmp, "name", name,
            *data_overrides(sub))]
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                            "MASTER_ADDR", "MASTER_PORT")}
        env["CHIP_SMOKE_CARD"] = card
        if name == "group":
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--ddp-child",
             out, *argv], env=env, capture_output=True, text=True,
            timeout=400)
        wall = time.perf_counter() - t0
        require(proc.returncode == 0,
                f"[ddp] {name}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        for line in proc.stdout.splitlines():  # the lattice's checks
            if line.startswith(("[k2]", "[count]", "[time]")):
                print(line)
        rec = json.loads(Path(out).read_text())
        rec["wall"] = wall
        rec["state"] = torch.load(out + ".pt", weights_only=False)
        runs[name] = rec
    g, a = runs["group"], runs["alone"]
    require(g["group"] == ["nccl", 1] and a["group"] == [False, 1],
            f"[ddp] groups {g['group']}, {a['group']}")
    for r in (g, a):
        k1 = [s["k1"] for s in r["steps"]]
        require(len(r["steps"]) == 2 * DDP_STEPS
                and k1 == [0] * DDP_STEPS + [1] * DDP_STEPS
                and r["step_launches"] == {"greedy_nms_keep": DDP_STEPS,
                                           "threshold_compact": 0,
                                           "count_ge": 0}
                and r["val_launches"]["greedy_nms_keep"] == r["val_batches"]
                and r["vals"] == 2, f"[ddp] run: K1 calls per step {k1}, "
                f"launches in the steps {r['step_launches']}, in the "
                f"validations {r['val_launches']}, {r['vals']} validations")
    require(g["val_launches"] == a["val_launches"],
            f"[ddp] validation launches, group {g['val_launches']} != alone "
            f"{a['val_launches']}")
    # the group changes nothing at world size 1: bit-equal, as measured
    # in every run so far (two processes, cuDNN's search off)
    diff_losses = [(i, k) for i, (x, y) in enumerate(zip(g["steps"],
                                                          a["steps"]))
                   for k in y["losses"] if x["losses"][k] != y["losses"][k]]
    diff_w = [f"{m} {k}" for m in ("model", "ema")
              for k, v in a["state"][m].items()
              if not torch.equal(g["state"][m][k], v)]
    require(not diff_losses and not diff_w,
            f"[ddp] group vs no group not bit-equal: losses at (step, part) "
            f"{diff_losses[:5]}, tensors {diff_w[:5]} ({len(diff_w)} in all)")
    med = {name: {kind: statistics.median(
        [s["ms"] for s in r["steps"] if s["kind"] == kind][1:])
        for kind in ("burn-in", "ssod")} for name, r in runs.items()}
    print(f"[ddp] cli.train on the main YAML (YOLOv5l, nc {NC}, {IMG} px, "
          f"bf16, {T_BATCH} + {T_BATCH}, Dataset.device_aug), 1 burn-in + 1 "
          f"SSOD epoch of {DDP_STEPS} steps, 2 val batches per epoch end, "
          f"each in a process of its own: in a world-size-1 NCCL group "
          f"(wall {g['wall']:.1f} s) and without a group ({a['wall']:.1f} "
          f"s); every SSOD step's K1 at ({T_BATCH}, 2048) and every val "
          f"batch's NMS == the plain version in both; launches per run: "
          f"steps {g['step_launches']}, validations {g['val_launches']}")
    for (x, y) in zip(g["steps"], a["steps"]):
        print(f"[ddp] {x['kind']} losses, group | alone: "
              + ", ".join(f"{k} {x['losses'][k]:.5f} | {y['losses'][k]:.5f}"
                          for k in y["losses"] if k not in ("loss", "total")))
    n_t = len(a["state"]["model"]) + len(a["state"]["ema"])
    print(f"[ddp] group vs alone: all {2 * DDP_STEPS} steps' losses and "
          f"the {n_t} tensors of the final student and teacher bit-equal")
    print(f"[time] ddp: step ms (median after each kind's first, "
          f"synchronised) burn-in {med['group']['burn-in']:.1f} in the "
          f"group vs {med['alone']['burn-in']:.1f} alone, SSOD "
          f"{med['group']['ssod']:.1f} vs {med['alone']['ssod']:.1f}: the "
          f"gap is the world-size-1 gradient all-reduce and the losses' "
          f"count all-reduces (the synchronised BatchNorm runs only past "
          f"one rank) | {card}")
    call = g["state"]["k1"]
    call = tuple(x.to(dev) if torch.is_tensor(x) else x for x in call)
    per = {name: r["step_launches"]["greedy_nms_keep"]
           for name, r in runs.items()}
    step = k1_entry(torch, call, "ddp: cli.train's SSOD steps (pseudo-label "
                    "NMS; the group's last call timed)", sum(per.values()))
    step["launches_per_path"] = per
    entries = [step]
    for e in g["val_entries"]:
        per = {name: r["val_launches"][e["name"]]
               for name, r in runs.items()}
        e.update(launches=sum(per.values()), launches_per_path=per)
        entries.append(e)
    require({e["name"] for e in g["val_entries"]}
            == {k for k, v in g["val_launches"].items() if v},
            f"[ddp] validation entries {[e['name'] for e in entries]}")
    return entries


def kp_step_stats(torch, model, labels, mask, nc=NC, npk=KP_NP):
    """After a [kp] step: the largest entry of the model's tensors, the
    largest landmark bias of the head, and the share of the batch's visible
    keypoints that lie outside their own box."""
    sd = model.state_dict()
    big = max(float(t.abs().max()) for t in sd.values()
              if t.is_floating_point())
    lmk = max(float(conv.bias.detach().view(3, -1)[:, 5 + nc:].abs().max())
              for conv in model.head.m)
    lb = labels[mask].float()
    kp = lb[:, 5:5 + 2 * npk].view(-1, npk, 2)
    vis = (kp > 0).all(-1)
    off = (kp - lb[:, None, 1:3]).abs() > lb[:, None, 3:5] / 2
    outside = float((off.any(-1) & vis).sum()) / max(1, int(vis.sum()))
    return big, lmk, outside


def kp_leg(torch, dev, card, lists, tmp):
    """[kp]: configs/sup/public/yolov5l_coco.yaml with Dataset.np 5 (nc 80
    @640, batch 32) on a keypoint copy of the smoke images (5 seeded
    points inside each box): KP_WARM + KP_TIMED steps, each followed by
    the largest tensor entry, the head's largest landmark bias and the
    share of the batch's keypoints outside their box; then cli.val
    --val-kp, each batch's landmark NMS held against the plain NMS, on the
    weights after the last step whose tensors, after the mid-density
    calibration, fit fp16 (the checkpoint is saved fp16, as the trainer
    saves them). Returns kernels-line entries."""
    import gc

    from efficientteacher_torch.models import build_model, spec_from_cfg
    from efficientteacher_torch.ops import nms
    from efficientteacher_torch.utils.checkpoint import (module_variables,
                                                         save_checkpoint)

    n = (KP_WARM + KP_TIMED) * T_BATCH
    sub = subset_lists(lists, {"labelled": n, "val": SPLITS["val"]}, "kp",
                       keypoints=KP_NP)
    overrides = [str(x) for x in (
        "Dataset.np", KP_NP, "Dataset.batch_size", T_BATCH, "epochs", 1,
        "noval", True, "project", tmp, "name", "kp", "Dataset.train",
        sub["labelled"], "Dataset.val", sub["val"])]
    cfg = yaml_cfg(KP_YAML, *overrides)

    class KpTrainer(zoo_trainer(torch)):
        def build_step(self):
            super().build_step()
            step = self.train_step
            self.kp_log = []

            def run(state, *args):
                state, parts = step(state, *args)
                big, lmk, outside = kp_step_stats(torch, state.model,
                                                  args[1], args[2])
                snap = ({k: v.detach().cpu().clone() for k, v in
                         state.model.state_dict().items()}
                        if big < FP16_MAX else None)
                self.kp_log.append((big, lmk, outside,
                                    float(args[3].lr_bias), snap))
                return state, parts

            self.train_step = run

    t = KpTrainer(cfg, device=dev)
    t.train()
    steps, kp_log = t.log["steps"], t.kp_log
    require(len(steps) == len(kp_log) == KP_WARM + KP_TIMED and all(
        "kp" in p and all(x == x and abs(x) != float("inf")
                          for x in p.values()) for _, p in steps),
            f"kp steps {steps}")
    ms = statistics.median(m for m, _ in steps[KP_WARM:])
    del t
    gc.collect()
    torch.cuda.empty_cache()
    # the weights of the last step that still fit fp16 after calibration
    model = build_model(spec_from_cfg(cfg), device=dev)
    calib = None
    for i in reversed(range(len(kp_log))):
        if kp_log[i][4] is None:
            continue
        model.load_state_dict(kp_log[i][4])
        if calib is None:
            from efficientteacher_torch.data.datasets import create_dataloader

            calib = next(iter(create_dataloader(
                cfg, "val", augment=False, batch_size=T_BATCH,
                pin_memory=True)))["images"][:8].to(dev)
        shift = mid_val_teacher(torch, model.eval(), calib)
        v = module_variables(model)
        big = max(float(x.abs().max()) for g in v.values()
                  for x in g.values())
        if big < FP16_MAX:
            break
    else:
        raise SmokeFailure(f"[kp] no step's weights fit fp16 after the "
                           f"calibration: {[x[:4] for x in kp_log]}")
    chosen, stats = i + 1, [x[:4] for x in kp_log]
    mid = Path(tmp) / "kp_mid.ckpt"
    save_checkpoint(mid, params=v["params"], batch_stats=v["batch_stats"],
                    ema_params=v["params"], ema_batch_stats=v["batch_stats"])
    del model, kp_log
    with K1Recorder(torch, nms, _Every()) as k1:
        t0 = time.perf_counter()
        got, launches, _ = recorded_cli_val(torch, [
            "--cfg", str(KP_YAML), "--weights", str(mid), "--batch-size",
            str(T_BATCH), "--val-kp", *overrides])
        t_val = time.perf_counter() - t0
    require(launches["greedy_nms_keep"] == len(k1.calls) > 0
            and all(x == x for x in got),
            f"cli.val --val-kp: launches {launches}, {len(k1.calls)} K1 "
            f"calls recorded, results {got}")
    for call in k1.calls[:-1]:
        k1_entry(torch, call, "kp: a recorded K1 call", 0, timed=False)
    entry = k1_entry(torch, k1.calls[-1], "kp: cli.val --val-kp's landmark "
                     "NMS", launches["greedy_nms_keep"])
    parts = steps[-1][1]
    print(f"[kp] {KP_YAML.relative_to(KP_YAML.parents[3])} with Dataset.np "
          f"{KP_NP} (YOLOv5l, nc {NC}, {IMG} px, bf16, batch {T_BATCH}, host "
          f"augmentation) on a keypoint copy of the smoke images ({KP_NP} "
          f"seeded points inside each box): step {ms:.1f} ms (median of "
          f"{KP_TIMED} after {KP_WARM} warm), "
          f"{T_BATCH / ms * 1e3:.1f} img/s; loss parts "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()
                      if k not in ("loss", "kp")) + f" | {card}")
    for j, ((_, p), (big, lmk, outside, lr)) in enumerate(zip(steps,
                                                              stats)):
        print(f"[kp] step {j + 1} (bias lr {lr:.4f}): landmark term "
              f"{p['kp']:.1f}, largest tensor entry {big:.4g}, largest "
              f"landmark bias {lmk:.4g}, visible keypoints outside their "
              f"box {outside:.1%}")
    print(f"[kp] cli.val --val-kp on the weights after step {chosen} (the "
          f"last whose tensors fit fp16 after the mid-density calibration; "
          f"saved fp16), objectness {shift[0]:+.3f}, {shift[1]:.0f} "
          f"candidates/img on the multi-label lattice: {t_val:.1f} s, OKS "
          f"P/R/mAP50/mAP {'/'.join(f'{x:.4f}' for x in got)}; the "
          f"landmark NMS (obj-gated, single label) at "
          f"{tuple(k1.calls[-1][0].shape[:2])}, each batch == the plain "
          f"NMS; launches {launches} | {card}")
    print(f"[time] kp: greedy_nms_keep {tuple(entry['shape'])} tile "
          f"{entry['tile']} ({entry['valid_per_img']:.1f} valid rows/img, "
          f"{entry['kept']} kept) kernel {entry['ms']:.4f} ms, plain "
          f"{entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.5f} ms "
          f"({entry['bound_by']}) | {card}")
    return [entry]


def slice11_phase(torch, dev, card, lists):
    """The [ptbridge], [ddp] and [kp] legs; their kernels-line entries."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        entries = ptbridge_leg(torch, dev, card, lists, tmp)
        t1 = time.perf_counter()
        entries += ddp_leg(torch, dev, card, lists, tmp)
        t2 = time.perf_counter()
        entries += kp_leg(torch, dev, card, lists, tmp)
        print(f"[time] ptbridge {t1 - t0:.1f} s, ddp {t2 - t1:.1f} s, kp "
              f"{time.perf_counter() - t2:.1f} s | {card}")
    return entries


SERVE_IMAGES = 32       # cli.detect's folder: COCO-sized, three in four JPEG
SERVE_CONF = 0.25       # detect's and AutoShape's gate (JAX detect.py's)
SERVE_TARGET = 300.0    # (anchor, class) pairs per image passing it
BACKEND_BATCH = 8       # DetectBackend's batch of letterboxed images
YOLOV5L_PARAMS = 46_563_709   # count_params of the JAX init, main YAML
YOLOV5L_GFLOPS = 109.1        # ultralytics YOLOv5 README, v6.0 table
# of the largest output: the fused model in bf16 against the unfused bf16
# forward, the traced float32 graph (its fusions round differently)
# against the unfused float32 one; the seeded net amplifies rounding
DEPLOY_TOL = {"deploy": 2e-2, "torchscript": 5e-3}


class _Recorded:
    """Replaces `InferFn` in each of `modules` by a subclass whose calls
    keep (decoded, NMS output, the InferFn), so each NMS can be held
    against the plain NMS on its decoded tensor afterwards."""

    def __init__(self, modules):
        from efficientteacher_torch.eval.validator import InferFn

        self.modules, self.real, self.records = modules, InferFn, []
        records = self.records

        class Recording(InferFn):
            def __call__(self, images_u8):
                decoded = self.forward(images_u8)
                out = self.nms(decoded)
                records.append((decoded, out, self))
                return out

        self.cls = Recording

    def __enter__(self):
        for m in self.modules:
            m.InferFn = self.cls
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.InferFn = self.real


def _same_nms(torch, decoded, out, fn):
    ref = fn.nms(decoded, use_kernels=False)
    return (torch.equal(ref.detections, out.detections)
            and torch.equal(ref.valid, out.valid))


def serve_leg(torch, dev, card, lists, tmp):
    """[serve]: YOLOv5l (main YAML, nc 80, 640 px, bf16) with seeded
    weights calibrated so that ~SERVE_TARGET (anchor, class) pairs per
    image pass conf 0.25, written as a port checkpoint and a reference
    fp16 `.pt`; cli.detect over SERVE_IMAGES images (--save-txt
    --save-crop --save-xml), each image's NMS held against the plain NMS
    on its decoded tensor, K1 once per image; AutoShape on the same paths
    in one call, against detect's detections; cli.export --include params
    deploy torch torchscript onnx; DetectBackend on the .ckpt (bit-equal
    to the in-memory model), the .pt, the .deploy.ckpt and the
    .torchscript on the card; cli.val --plots over the 64 val images at
    the val mid density (without matplotlib: the ImportError it raises,
    then cli.val alone); model_info on the card. Returns kernels-line
    entries."""
    import importlib.util

    import numpy as np

    from efficientteacher_torch.cli import detect as cli_detect
    from efficientteacher_torch.cli import export as cli_export
    from efficientteacher_torch.data.datasets import create_dataloader
    from efficientteacher_torch.data.loaders import LoadImages
    from efficientteacher_torch.eval import validator
    from efficientteacher_torch.eval.multi_backend import DetectBackend
    from efficientteacher_torch.models import (autoshape, build_model,
                                               spec_from_cfg)
    from efficientteacher_torch.ops import nms as nms_module
    from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
    from efficientteacher_torch.ops.select_cuda import (count_ge_cuda,
                                                        threshold_compact_cuda)
    from efficientteacher_torch.utils.checkpoint import (module_variables,
                                                         save_checkpoint)
    from efficientteacher_torch.utils.profile import count_params, model_info
    from efficientteacher_torch.utils.torch_import import save_reference_pt

    tmp = Path(tmp)
    wrappers = {"greedy_nms_keep": greedy_nms_keep_cuda,
                "threshold_compact": threshold_compact_cuda,
                "count_ge": count_ge_cuda}

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def zero():
        for w in wrappers.values():
            w.launches = 0

    cfg = ssod_cfg(*data_overrides(lists))
    spec = dataclasses.replace(spec_from_cfg(cfg), train_domain=False)
    model = build_model(spec, device=dev,
                        generator=torch.Generator().manual_seed(SEED + 5))
    loader = create_dataloader(cfg, "val", augment=False, batch_size=T_BATCH,
                               pin_memory=True)
    calib = next(iter(loader))["images"][:8].to(dev)
    del loader
    base = {k: v.clone() for k, v in model.state_dict().items()}

    def serve_shift(head, delta):
        # at conf 0.25 a class probability must pass the gate as well
        with torch.no_grad():
            for conv in head.m:
                conv.bias.view(head.na, head.no)[:, 4:] += delta

    def save(path):
        """fp16 port checkpoint; the model keeps the fp16-rounded weights,
        so what is in memory is what the file holds."""
        with torch.no_grad():
            for t in model.state_dict().values():
                if t.is_floating_point():
                    t.copy_(t.half().float())
        v = module_variables(model)
        save_checkpoint(path, params=v["params"],
                        batch_stats=v["batch_stats"])

    val_shift = mid_val_teacher(torch, model.eval(), calib)
    save(tmp / "val_mid.ckpt")
    model.load_state_dict(base)
    shift = mid_val_teacher(torch, model, calib, target=SERVE_TARGET,
                            shift=serve_shift, conf=SERVE_CONF)
    ckpt, pt = tmp / "serve.ckpt", tmp / "serve.pt"
    save(ckpt)
    save_reference_pt(pt, model, model, epoch=-1)
    source = DATA_DIR / "serve" / "images"
    write_split(DATA_DIR / "serve", "serve", SERVE_IMAGES, SEED + 7, 900000)
    n_jpeg = len(list(source.glob("*.jpg")))
    print(f"[serve] YOLOv5l (nc {NC}, {IMG} px) at {SERVE_TARGET:.0f} "
          f"pairs/img over conf {SERVE_CONF} (objectness and classes "
          f"{shift[0]:+.3f}: {shift[1]:.0f}/img on the calibration batch), "
          f"fp16 checkpoint and reference .pt; the val copy at "
          f"{val_shift[1]:.0f}/img over conf {CONF}; {SERVE_IMAGES} images "
          f"({n_jpeg} JPEG, {SERVE_IMAGES - n_jpeg} PNG)")

    # -- cli.detect, one image at a time --------------------------------
    infer = validator.InferFn(model, 255.0, torch.bfloat16, dict(
        nc=NC, conf_thres=SERVE_CONF, iou_thres=0.45, max_det=MAX_DET,
        max_nms=2048))
    first = next(iter(LoadImages(str(source), IMG)))
    x1 = torch.from_numpy(first[1]).to(dev)[None]
    infer.forward(x1)   # cuDNN's handles for batch 1
    zero()
    t0 = time.perf_counter()
    with _Recorded([validator]) as rec, \
            K1Recorder(torch, nms_module, _Every()) as k1rec:
        out_dir, dets, speed = cli_detect.main([
            "--cfg", str(MAIN_YAML), "--weights", str(ckpt), "--source",
            str(source), "--save-dir", str(tmp / "detect"), "--save-txt",
            "--save-crop", "--save-xml", "--img-size", str(IMG)])
    t_detect = time.perf_counter() - t0
    launches = counts()
    require(len(rec.records) == len(dets) == SERVE_IMAGES,
            f"cli.detect served {len(dets)} images in {len(rec.records)} "
            f"forwards")
    require(launches == {"greedy_nms_keep": SERVE_IMAGES,
                         "threshold_compact": 0, "count_ge": 0},
            f"cli.detect launches {launches}")
    for i, r in enumerate(rec.records):
        require(_same_nms(torch, *r), f"cli.detect image {i}: NMS != the "
                f"plain NMS")
    detect_decoded = [r[0] for r in rec.records]
    n_det = [len(d) for d in dets.values()]
    for call in k1rec.calls:
        k1_entry(torch, call, "serve: cli.detect", 0, timed=False)
    dense = max(k1rec.calls, key=lambda c: int(c[1].sum()))
    e_detect = k1_entry(torch, dense, "serve: cli.detect, per image",
                        launches["greedy_nms_keep"])
    e_detect["valid_per_img_mean"] = float(np.mean(
        [int(c[1].sum()) for c in k1rec.calls]))
    files = {s: len(list(out_dir.glob(f"*{s}")))
             for s in (".txt", ".xml", ".jpg", ".png")}
    n_crops = len(list((out_dir / "crops").glob("*.jpg")))
    require(files[".txt"] == files[".xml"] == SERVE_IMAGES
            and files[".jpg"] + files[".png"] == SERVE_IMAGES
            and n_crops > 0, f"cli.detect wrote {files}, {n_crops} crops")
    e2e = sum(speed.values())
    t_fwd = time_ms(torch, lambda: infer.forward(x1), reps=10, warmup=2)
    print(f"[serve] cli.detect: {SERVE_IMAGES} images, detections/img "
          f"{np.mean(n_det):.1f} (min {min(n_det)}, max {max(n_det)}), K1 "
          f"valid rows/img {e_detect['valid_per_img_mean']:.1f}; each image's "
          f"NMS == the plain NMS; launches {launches} (K1 once per image); "
          f"wrote {files}, {n_crops} crops; {t_detect:.1f} s with the "
          f"model's load")
    print(f"[time] serve: cli.detect {e2e:.2f} ms/img end to end (read + "
          f"letterbox {speed['read']:.2f}, forward + NMS + copy "
          f"{speed['infer']:.2f}, draw + write {speed['write']:.2f}: host "
          f"share {(speed['read'] + speed['write']) / e2e:.1%}); forward "
          f"bf16 b1@{IMG} {t_fwd:.3f} ms; K1 (1, 2048), "
          f"{int(dense[1].sum())} valid rows: {e_detect['ms']:.4f} ms, "
          f"plain {e_detect['plain_ms']:.4f} ms, bound "
          f"{e_detect['bound_ms']:.6f} ms ({e_detect['bound_by']}, "
          f"{e_detect['bound_ms'] / e_detect['ms']:.2%} of it) | {card}")

    # -- label text against cv2's digests; what drawing one image costs --
    from efficientteacher_torch.utils import draw

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import text_cases

    t0 = time.perf_counter()
    bad = text_cases.check_port(draw)
    t_cases = (time.perf_counter() - t0) * 1e3
    require(not bad, f"label text differs from cv2's digests: {bad}")
    names = list(cfg.Dataset.names)
    canvases = [(np.ascontiguousarray(img0), dets[p])
                for p, _, img0, _ in LoadImages(str(source), IMG)]
    n_labels = sum(len(d) for _, d in canvases)
    t0 = time.perf_counter()
    for img0, rows in canvases:
        for row in rows:
            c = int(row[5])
            draw.box_label(img0, row[:4], f"{names[c]} {row[4]:.2f}",
                           draw.color_of(c))
    t_draw = (time.perf_counter() - t0) * 1e3 / len(canvases)
    print(f"[serve] label text == cv2 5.0.0's digests on "
          f"{len(text_cases.DIGESTS)} cases ({', '.join(text_cases.DIGESTS)})"
          f" in {t_cases:.1f} ms; drawing an image's boxes and labels (Rubik"
          f" 14 px): {t_draw:.3f} ms/img for {n_labels / len(canvases):.1f} "
          f"labels/img, {t_draw / e2e:.1%} of cli.detect's {e2e:.2f} ms/img "
          f"| {card}")

    # -- AutoShape on the same paths, one batch ---------------------------
    paths = list(dets)
    shaper = autoshape.AutoShape(model, list(cfg.Dataset.names), IMG)
    shaper(paths[:2])   # warm-up, not counted
    zero()
    t0 = time.perf_counter()
    with _Recorded([autoshape]) as rec, \
            K1Recorder(torch, nms_module, _Every()) as k1rec:
        res = shaper(paths)
    t_auto = (time.perf_counter() - t0) * 1e3
    a_launches = counts()
    require(a_launches == {"greedy_nms_keep": 1, "threshold_compact": 0,
                           "count_ge": 0}, f"AutoShape launches {a_launches}")
    decoded, out, fn = rec.records[0]
    require(_same_nms(torch, decoded, out, fn), "AutoShape: NMS != the "
            "plain NMS")
    # its input and forward: LoadImages' letterboxes (detect's inputs)
    # through the model at batch 32, bit for bit
    letterboxed = np.stack([rgb for _, rgb, _, _ in
                            LoadImages(str(source), IMG)])
    require(torch.equal(decoded, fn.forward(torch.from_numpy(letterboxed)
                                            .to(dev))),
            "AutoShape's batch differs from LoadImages' letterboxes")
    same = fwd_same = 0
    worst = 0.0
    for i, p in enumerate(paths):
        fwd_same += torch.equal(decoded[i], detect_decoded[i][0])
        worst = max(worst, float((decoded[i] - detect_decoded[i][0])
                                 .abs().max()))
        d = out.detections[i][out.valid[i]].cpu().numpy()
        if len(d):
            d[:, :4] = validator._scale_to_native(d[:, :4], (IMG, IMG),
                                                  res.imgs[i].shape[:2])
        require(np.array_equal(res.xyxy[i], d), f"AutoShape image {i}: "
                f"Detections != its NMS output scaled to the image")
        same += (res.xyxy[i].shape == dets[p].shape
                 and np.array_equal(res.xyxy[i], dets[p]))
    e_auto = k1_entry(torch, k1rec.calls[0], "serve: AutoShape, one batch",
                      a_launches["greedy_nms_keep"])
    print(f"[serve] AutoShape({SERVE_IMAGES} paths): its batch == LoadImages'"
          f" letterboxes, its forward == the model's at batch "
          f"{SERVE_IMAGES}, its NMS == the plain NMS (K1 1 launch at (32, "
          f"2048)), Detections == that output scaled to each image; equal "
          f"to cli.detect's on {same}/{SERVE_IMAGES} images: the batch-"
          f"{SERVE_IMAGES} and batch-1 bf16 forwards are bit-equal on "
          f"{fwd_same}/{SERVE_IMAGES} (largest difference {worst:.4g}: "
          f"cuDNN's algorithm per batch size, amplified by the seeded net)")
    print(f"[time] serve: AutoShape {t_auto:.1f} ms for {SERVE_IMAGES} "
          f"paths ({t_auto / SERVE_IMAGES:.2f} ms/img: read, letterbox, one "
          f"bf16 forward, NMS, scale); K1 (32, 2048) {e_auto['ms']:.4f} ms, "
          f"bound {e_auto['bound_ms']:.6f} ms | {card}")
    del rec, k1rec, decoded, detect_decoded

    # -- cli.export ---------------------------------------------------------
    done = cli_export.main([
        "--cfg", str(MAIN_YAML), "--weights", str(ckpt), "--include",
        "params", "deploy", "torch", "torchscript", "onnx", "--img-size",
        str(IMG)])
    nodes = done["onnx"]["nodes"]
    require("BatchNormalization" not in nodes and nodes["Conv"] >= 100,
            f"ONNX census {nodes}")
    print("[serve] cli.export: " + "; ".join(
        f"{k} {Path(v['path']).name} {Path(v['path']).stat().st_size / 1e6:.1f}"
        f" MB in {v['seconds']:.1f} s" for k, v in done.items())
        + f"; ONNX opset 13, {sum(nodes.values())} nodes {nodes}, no "
        f"BatchNormalization | {card}")

    # -- DetectBackend on the card --------------------------------------
    batch = np.stack([rgb for _, rgb, _, _ in
                      LoadImages(str(source), IMG)][:BACKEND_BATCH])
    xb = torch.from_numpy(batch).to(dev)
    # the in-memory model's unfused forwards: bf16 (the checkpoints' and
    # the deploy model's dtype on the card) and float32 (the traced graph's)
    refs = {torch.bfloat16: infer.forward(xb).float(),
            torch.float32: validator.InferFn(model, 255.0, torch.float32,
                                             {}).forward(xb)}
    bf_vs_f32 = float((refs[torch.bfloat16] - refs[torch.float32]).abs()
                      .max())
    backend_lines, bad = [], []
    for kind, path, dt in (
            ("ckpt", ckpt, torch.bfloat16), ("pt", pt, torch.bfloat16),
            ("deploy", done["deploy"]["path"], torch.bfloat16),
            ("torchscript", done["torchscript"]["path"], torch.float32)):
        backend = DetectBackend(str(path), cfg)
        require(backend.kind == kind and backend.device.type == "cuda",
                f"DetectBackend {path}: {backend.kind} on {backend.device}")
        ref, tol = refs[dt], DEPLOY_TOL.get(kind, 0.0)
        scale = float(ref.abs().max())
        got = torch.from_numpy(backend(batch)).to(dev)
        t = time_ms(torch, lambda: backend(batch), reps=5)
        err = float((got - ref).abs().max())
        if err > tol * scale:
            bad.append(kind)
        backend_lines.append(
            f"{kind} {err:.4g} from the unfused {str(dt)[6:]} forward "
            f"({err / scale:.2e} of its largest output {scale:.1f}; "
            f"allowed {tol:g}), {t:.2f} ms")
        del backend
    print(f"[serve] DetectBackend on the card, uint8 ({BACKEND_BATCH}, {IMG},"
          f" {IMG}, 3) -> decoded, and ms per call (numpy in and out): "
          + "; ".join(backend_lines) + f"; the unfused bf16 and float32 "
          f"forwards themselves differ by {bf_vs_f32:.4g} | {card}")
    require(not bad, f"DetectBackend {bad} outside the tolerance")

    # -- cli.val --plots -----------------------------------------------
    argv = ["--cfg", str(MAIN_YAML), "--weights", str(tmp / "val_mid.ckpt"),
            "--batch-size", str(T_BATCH), "Dataset.val", str(lists["val"])]
    plots = tmp / "plots"
    if importlib.util.find_spec("matplotlib") is not None:
        argv[4:4] = ["--plots", str(plots)]
        path = "serve: cli.val --plots"
    else:
        try:
            recorded_cli_val(torch, argv[:4] + ["--plots", str(plots)]
                             + argv[4:])
            raise SmokeFailure("cli.val --plots ran without matplotlib")
        except ImportError as e:
            refused = str(e)
        require("matplotlib" in refused, f"cli.val --plots raised {refused}")
        print(f"[serve] matplotlib is not installed on this machine: cli.val"
              f" --plots raised ImportError ({refused}), as it must; cli.val "
              f"runs without --plots for the kernels (not a device "
              f"fallback)")
        path = "serve: cli.val (--plots refused, no matplotlib)"
    t0 = time.perf_counter()
    got, v_launches, decoded = recorded_cli_val(torch, argv)
    t_val = time.perf_counter() - t0
    require(all(v_launches.values()), f"{path} launched {v_launches}")
    written = sorted(p.name for p in plots.glob("*.png"))
    if "--plots" in argv and any(got):
        # as JAX's: the curves of a run with true positives
        require(written == ["F1_curve.png", "PR_curve.png", "P_curve.png",
                            "R_curve.png"], f"cli.val --plots wrote {written}")
    print(f"[serve] {path}: {SPLITS['val']} images, P/R/mAP50/mAP "
          f"{'/'.join(f'{x:.4f}' for x in got)}, each batch's NMS == the "
          f"plain NMS, launches {v_launches}, plots {written}; {t_val:.1f} "
          f"s | {card}")
    entries = [e_detect, e_auto] + val_entries(torch, decoded, path,
                                               v_launches, card)

    # -- model_info -----------------------------------------------------
    model.load_state_dict(base)
    t0 = time.perf_counter()
    info = model_info(model, IMG)
    t_info = time.perf_counter() - t0
    require(info["params"] == YOLOV5L_PARAMS,
            f"{info['params']} params, the JAX init has {YOLOV5L_PARAMS}")
    outputs = []
    hooks = [m.register_forward_hook(lambda m, i, o: outputs.append(
        o.numel())) for m in model.modules()
        if isinstance(m, torch.nn.Conv2d)]
    with torch.inference_mode():
        model(torch.zeros(1, 3, IMG, IMG, device=dev))
    for h in hooks:
        h.remove()
    bias = 2 * sum(outputs) / 1e9
    require(round(info["gflops"] + bias, 1) == YOLOV5L_GFLOPS,
            f"{info['gflops']} GFLOPs + {bias} for the biases != "
            f"{YOLOV5L_GFLOPS}")
    print(f"[serve] model_info on the card: {info['params']:,} params (== "
          f"the JAX init's), {info['gflops']:.3f} GFLOPs at {IMG} (2 per "
          f"conv multiply-add, FlopCounterMode); + {bias:.3f} for one bias "
          f"add per conv output = {info['gflops'] + bias:.3f}, the published"
          f" {YOLOV5L_GFLOPS} (thop counts the bias); {t_info:.1f} s")
    return entries


def serve_phase(torch, dev, card, lists):
    """The [serve] leg, then the [video] leg on its checkpoint; their
    kernels-line entries."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        entries = serve_leg(torch, dev, card, lists, tmp)
        print(f"[time] serve {time.perf_counter() - t0:.1f} s | {card}")
        t0 = time.perf_counter()
        entries += video_leg(torch, dev, card, Path(tmp))
        print(f"[time] video {time.perf_counter() - t0:.1f} s | {card}")
    return entries


# -- [video] ------------------------------------------------------------------

VIDEO_DIR = Path(__file__).resolve().parent / "tests" / "video_fixtures"
VIDEO_DETECT = "mp4v_1280x720.mp4"      # cli.detect's clip: 48 frames
VIDEO_H264_DETECT = "h264_high_cabac_1080p.mp4"     # and its H.264 one: 24


def video_leg(torch, dev, card, tmp):
    """[video]: the committed fixtures (tests/video_fixtures/, made by
    scripts/make_video_fixtures.py: mp4v MP4 1280x720, XVID and MJPG AVI,
    a 90-degree display matrix, two AVIs cut inside a frame, 4MV with
    resync markers, MPEG quantisation, the H.264 clips of
    tests/h264_writer.py (1920x1080 High CABAC, Baseline CAVLC in AVI,
    Main CABAC with four references, High CAVLC with scaling lists, full
    range BT.709 in avc3), and five streams the port refuses) decoded by
    `data/video_io.py` and held to cv2 5.0.0's per-frame digests,
    frames/s per clip at 1 thread; then cli.detect with --nosave
    --save-txt on the 1280x720 mp4v clip and on the 1080p H.264 one,
    [serve]'s seeded YOLOv5l checkpoint at 640 in bf16: K1 once per frame,
    each frame's NMS held against the plain NMS on its decoded tensor and
    every K1 call against the plain version; ms/frame and its host share
    (`video: cli.detect` and `video h264: cli.detect` on the kernels
    line)."""
    import hashlib

    from efficientteacher_torch.data import video_io
    from efficientteacher_torch.ops.nms_cuda import greedy_nms_keep_cuda
    from efficientteacher_torch.ops.select_cuda import (count_ge_cuda,
                                                        threshold_compact_cuda)

    table = json.loads((VIDEO_DIR / "digests.json").read_text())
    rates = {}
    for name, entry in table.items():
        path = str(VIDEO_DIR / name)
        if "refused" in entry:
            try:
                list(video_io.frames(path))
                refused = False
            except NotImplementedError as e:
                refused = entry["refused"] in str(e)
            require(refused, f"{name}: not refused naming {entry['refused']}")
            continue
        frames = list(video_io.frames(path))
        got = [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]
        require(got == entry["sha256"], f"{name}: {len(got)} frames, "
                f"{sum(a != b for a, b in zip(got, entry['sha256']))} differ "
                f"from cv2's {len(entry['sha256'])} digests")
        t0 = time.perf_counter()
        n = sum(1 for _ in video_io.frames(path))
        rates[name] = (n / (time.perf_counter() - t0), frames[0].shape)
    n_checked = sum(len(e["sha256"]) for e in table.values()
                    if "refused" not in e)
    print(f"[video] {len(table)} fixtures: every frame == cv2 5.0.0's "
          f"digest ({n_checked} frames), "
          f"{sum('refused' in e for e in table.values())} refused naming "
          f"their ROADMAP item")
    print("[time] video decode, frames/s at 1 thread: " + "; ".join(
        f"{n} ({s[1]}x{s[0]}) {r:.1f}" for n, (r, s) in rates.items())
        + f" | {card}")

    wrappers = {"greedy_nms_keep": greedy_nms_keep_cuda,
                "threshold_compact": threshold_compact_cuda,
                "count_ge": count_ge_cuda}
    return [video_detect(torch, card, tmp, table, wrappers, name, label)
            for name, label in ((VIDEO_DETECT, "video"),
                                (VIDEO_H264_DETECT, "video h264"))]


def video_detect(torch, card, tmp, table, wrappers, name, label):
    """cli.detect --nosave --save-txt on the fixture `name` with [serve]'s
    checkpoint: one forward and one K1 launch per frame, each frame's NMS
    against the plain NMS, every K1 call against the plain version; the
    K1 entry `{label}: cli.detect, per frame` of the densest frame."""
    import numpy as np

    from efficientteacher_torch.cli import detect as cli_detect
    from efficientteacher_torch.eval import validator
    from efficientteacher_torch.ops import nms as nms_module

    for w in wrappers.values():
        w.launches = 0
    clip = VIDEO_DIR / name
    n_frames = table[name]["frames"]
    with _Recorded([validator]) as rec, \
            K1Recorder(torch, nms_module, _Every()) as k1rec:
        out_dir, dets, speed = cli_detect.main([
            "--cfg", str(MAIN_YAML), "--weights", str(tmp / "serve.ckpt"),
            "--source", str(clip), "--save-dir", str(tmp / label.replace(
                " ", "_")), "--nosave", "--save-txt", "--img-size", str(IMG)])
    launches = {k: w.launches for k, w in wrappers.items()}
    require(list(dets) == [f"{clip}#{i}" for i in range(n_frames)]
            and len(rec.records) == n_frames,
            f"{label}: cli.detect served {len(dets)} frames in "
            f"{len(rec.records)} forwards")
    require(launches == {"greedy_nms_keep": n_frames, "threshold_compact": 0,
                         "count_ge": 0}, f"{label}: cli.detect launches "
            f"{launches}")
    for i, r in enumerate(rec.records):
        require(_same_nms(torch, *r), f"{label}: cli.detect frame {i}: NMS "
                f"!= the plain NMS")
    for call in k1rec.calls:
        k1_entry(torch, call, f"{label}: cli.detect", 0, timed=False)
    files = sorted(p.name for p in out_dir.iterdir())
    require(files == [clip.stem + ".txt"], f"{label}: cli.detect wrote "
            f"{files}")
    dense = max(k1rec.calls, key=lambda c: int(c[1].sum()))
    entry = k1_entry(torch, dense, f"{label}: cli.detect, per frame",
                     launches["greedy_nms_keep"])
    entry["valid_per_img_mean"] = float(np.mean(
        [int(c[1].sum()) for c in k1rec.calls]))
    n_det = [len(d) for d in dets.values()]
    e2e = sum(speed.values())
    print(f"[video] {label}: cli.detect {name} --nosave --save-txt: "
          f"{n_frames} frames, detections/frame {np.mean(n_det):.1f} (min "
          f"{min(n_det)}, max {max(n_det)}); each frame's NMS == the plain "
          f"NMS, every K1 call == the plain version; launches {launches} "
          f"(K1 once per frame); wrote {files}")
    print(f"[time] {label}: cli.detect {e2e:.2f} ms/frame end to end "
          f"(decode + letterbox {speed['read']:.2f}, forward + NMS + copy "
          f"{speed['infer']:.2f}, labels {speed['write']:.2f}: host share "
          f"{(speed['read'] + speed['write']) / e2e:.1%}); K1 (1, "
          f"{dense[0].shape[1]}), {int(dense[1].sum())} valid rows: "
          f"{entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, bound "
          f"{entry['bound_ms']:.6f} ms ({entry['bound_by']}) | {card}")
    return entry

# -- [formats] ----------------------------------------------------------------

FORMAT_KINDS = ("bmp", "tif", "png16", "adam7", "jpg411", "jpg440",
                "jpgrgb", "jpgcmyk", "jpgycck")
WEBP_KINDS = ("webp", "webp75", "webp90", "webpalpha", "webpexif")
RATE_KINDS = ("bmp24", "bmprle8", "tiflzw", "tifdeflate", "png16", "adam7",
              "jpg411", "jpg440", "jpgrgb", "jpgcmyk", "png8",
              "jpg420") + WEBP_KINDS
RATE_COPIES = 16        # files per kind in the rate lists (one image each)
FORMAT_DETECT = 8       # cli.detect's sources: 2 of each DETECT_KINDS
DETECT_KINDS = ("bmp", "tif", "png8", "webp90")
# the TIFF kinds of ROADMAP Q1.9c (tests/test_torch_tiff_kinds.py
# SPLIT_KINDS) are the fourth split's; these of them are timed
TIFF_RATE_KINDS = ("tifjpeg", "tifycc22", "tifcmyk", "tiflab",
                   "tiffill2_lzw", "tifg3")
# the JPEG kinds of ROADMAP Q1.9c's JPEG half and F12 (tests/jpeg_writers.py
# SPLIT_KINDS: cut short, a partial progressive file, arithmetic, lossless)
# are the fifth split's, and each is timed


def webp_file(path: Path, kind: str, rgb) -> Path:
    """Write `rgb` as the WebP `kind` at `path` (suffix .webp) with the
    port's writers: lossless VP8L ("webp"), VP8 at the writer's quality 75
    or 90, VP8X + a VP8L-coded ALPH (a ramp; the VP8L writer's stream
    without its 5-byte header) + VP8 at 85, or VP8X + VP8L of the image
    turned a quarter left + an EXIF Orientation 6, which turns it back."""
    import struct

    import numpy as np

    from efficientteacher_torch.data import webp_io
    from efficientteacher_torch.utils import native_loader as nl

    def chunk(tag, body):
        return tag + struct.pack("<I", len(body)) + body + b"\0" * (
            len(body) & 1)

    def vp8x(w, h, flags):
        return chunk(b"VP8X", struct.pack("<I", flags)
                     + (w - 1).to_bytes(3, "little")
                     + (h - 1).to_bytes(3, "little"))

    path = path.with_suffix(".webp")
    h, w = rgb.shape[:2]
    if kind == "webp":
        webp_io.write_webp(str(path), rgb)
        return path
    if kind in ("webp75", "webp90"):
        webp_io.write_webp(str(path), rgb, int(kind[-2:]))
        return path
    if kind == "webpalpha":
        ramp = np.zeros((h, w, 3), np.uint8)
        ramp[..., 1] = np.linspace(0, 255, w).astype(np.uint8)
        body = vp8x(w, h, 0x10) + chunk(b"ALPH", b"\x01"
                                        + nl.webp_encode(ramp)[5:]) \
            + chunk(b"VP8 ", nl.webp_encode(rgb, 85))
    else:   # webpexif
        tiff = b"II" + struct.pack("<HIH", 42, 8, 1) + struct.pack(
            "<HHIHH", 0x112, 3, 1, 6, 0) + b"\0" * 4
        turned = np.ascontiguousarray(np.rot90(rgb, 1))
        body = vp8x(h, w, 0x08) + chunk(b"VP8L", nl.webp_encode(turned)) \
            + chunk(b"EXIF", tiff)
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP"
                     + body)
    return path


def format_file(path: Path, kind: str, rgb) -> Path:
    """Write the RGB image `rgb` as `kind` at `path` (its suffix set by
    the kind) with the port's writers or the tests' own PNG, BMP, TIFF and
    JPEG encoders (numpy only; this machine has neither cv2 nor Pillow).
    The JPEG kinds store YCbCr (4:1:1, 4:4:0), RGB (Adobe transform 0),
    CMYK (transform 0, K 255) or YCCK (transform 2, the YCbCr of the
    inverted image): each decodes to about `rgb`."""
    import numpy as np

    from efficientteacher_torch.data import image_io
    from efficientteacher_torch.utils import native_loader as nl
    from test_torch_image_formats import bmp_bytes, png_bytes, rle_stream, \
        tiff_bytes
    from test_torch_jpeg import encode_baseline

    def ycc(img):
        x = img.astype(np.float64)
        y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
        cb = 128 + (x[..., 2] - y) * 0.564
        cr = 128 + (x[..., 0] - y) * 0.713
        return [np.rint(c).clip(0, 255).astype(np.uint8) for c in (y, cb,
                                                                    cr)]

    if kind.startswith("webp"):
        return webp_file(path, kind, rgb)
    import test_torch_tiff_kinds as tiffk
    if kind in tiffk.KINDS + tiffk.Q19D_KINDS:
        path = path.with_suffix(".tif")
        path.write_bytes(tiffk.write_kind(kind, rgb))
        return path
    h, w = rgb.shape[:2]
    ext = {"bmp": "bmp", "bmp24": "bmp", "bmprle8": "bmp", "tif": "tif",
           "tiflzw": "tif", "tifdeflate": "tiff"}.get(
        kind, "png" if kind.startswith(("png", "adam7")) else "jpg")
    path = path.with_suffix("." + ext)
    if kind in ("bmp", "bmp24", "tif", "tiflzw"):
        image_io.imwrite(str(path), rgb[..., ::-1])
    elif kind == "bmprle8":
        idx = (rgb.astype(int).sum(2) // 12).clip(0, 63)
        pal = np.zeros((256, 3), np.uint8)
        pal[:64] = np.linspace(0, 255, 64)[:, None].astype(np.uint8)
        path.write_bytes(bmp_bytes(rle_stream(idx[::-1], 8, ""), w, h, 8, 40,
                                   1, pal))
    elif kind == "tifdeflate":
        path.write_bytes(tiff_bytes(rgb, compression=8))
    elif kind == "png16":
        deep = rgb.astype(np.uint16) * 257
        path.write_bytes(png_bytes(deep, 16, 2))
    elif kind == "adam7":
        path.write_bytes(png_bytes(rgb, 8, 2, interlace=True))
    elif kind == "png8":
        image_io.write_png(str(path), rgb, level=1)
    elif kind == "jpg420":
        nl.jpeg_write(str(path), rgb, 90)
    elif kind in ("jpg411", "jpg440"):
        factors = ((4, 1) if kind == "jpg411" else (1, 2), (1, 1), (1, 1))
        path.write_bytes(encode_baseline(ycc(rgb), factors, q=8))
    elif kind == "jpgrgb":
        path.write_bytes(encode_baseline([rgb[..., c] for c in range(3)],
                                         ((1, 1),) * 3, ids=[82, 71, 66],
                                         adobe=0, q=8))
    elif kind == "jpgcmyk":
        planes = [rgb[..., c] for c in range(3)] + [np.full((h, w), 255,
                                                            np.uint8)]
        path.write_bytes(encode_baseline(planes, ((2, 2), (1, 1), (1, 1),
                                                  (2, 2)), adobe=0, q=8))
    else:   # jpgycck
        planes = ycc(255 - rgb) + [np.full((h, w), 255, np.uint8)]
        path.write_bytes(encode_baseline(planes, ((2, 1), (1, 1), (1, 1),
                                                  (2, 1)), adobe=2, q=8))
    return path


def formats_leg(torch, dev, card, lists, tmp):
    """[formats]: the fixtures, cli.val on the val split in PNG and in the
    formats, and in WebP beside its own PNG copy, cli.detect on .bmp /
    .tif / .png / .webp sources, decode rates. Returns kernels-line
    entries."""
    import numpy as np

    from efficientteacher_torch.cli import detect as cli_detect
    from efficientteacher_torch.data import image_io
    from efficientteacher_torch.data.datasets import (LoadImagesAndLabels,
                                                      create_dataloader)
    from efficientteacher_torch.models import build_model, spec_from_cfg
    from efficientteacher_torch.utils.checkpoint import (module_variables,
                                                         save_checkpoint)

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import jpeg_writers as jw
    import test_torch_image_formats as tif_fx
    import test_torch_jpeg as jpg_fx
    import test_torch_jpeg_damaged as jd_fx
    import test_torch_tiff_kinds as tiffk_fx
    import test_torch_webp as webp_fx

    tmp = Path(tmp)
    # -- fixtures against cv2's digests ---------------------------------
    t0 = time.perf_counter()
    bad = jpg_fx.check_fixtures(tmp / "jpeg_fixtures") + \
        tif_fx.check_fixtures(tmp / "format_fixtures") + \
        webp_fx.check_fixtures(tmp / "webp_fixtures") + \
        tiffk_fx.check_fixtures(tmp / "tiff_kind_fixtures") + \
        jd_fx.check_fixtures(tmp / "damaged_fixtures")
    counts = {}
    for name in tif_fx.FIXTURES:
        fmt = tif_fx.fixture_format(name)
        counts[fmt] = counts.get(fmt, 0) + 1
    counts["webp"] = len(webp_fx.FIXTURES)
    counts["tiff kinds"] = len(tiffk_fx.FIXTURES)
    counts["jpeg"] = sum(len(d) for _, d in jpg_fx.FIXTURES.values())
    counts["damaged / rare jpeg and tiff"] = sum(
        len(d) for _, d in jd_fx.FIXTURES.values())
    require(not bad, f"decodes differ from cv2's digests: {bad}")
    print(f"[formats] fixtures == cv2.imread's digests, 0 mismatches: "
          + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f" decodes (JPEG: {len(jpg_fx.FIXTURES)} files x 4 scales) in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    # -- the val split in the formats and in WebP, each with a PNG copy --
    t0 = time.perf_counter()
    val = Path(lists["val"]).read_text().split()
    pairs = (("png", "formats"), ("webp_png", "webp"),
             ("tiffkinds_png", "tiffkinds"), ("jpegkinds_png", "jpegkinds"),
             ("q19d_png", "q19d"))
    # the JPEG kinds' files, by the tests' numpy writers in 8 processes:
    # the split's, each arithmetic file's Huffman twin, one of each kind at
    # 640x480 for the rates
    import multiprocessing

    from concurrent.futures import ProcessPoolExecutor

    jk = jw.SPLIT_KINDS
    srcs = [image_io.imread(v) for v in val]
    base = next(im for im in srcs if im.shape[:2] == (480, 640))
    tasks = [(jk[i % len(jk)], im) for i, im in enumerate(srcs)]
    twins = [i for i, (k, _) in enumerate(tasks) if k.startswith("arith")]
    tasks += [("baseline", srcs[i]) for i in twins]
    tasks += [(k, base) for k in jk]
    with ProcessPoolExecutor(
            8, mp_context=multiprocessing.get_context("spawn")) as ex:
        written = list(ex.map(jw.kind_file, *zip(*tasks)))
    jpeg_split = written[:len(val)]
    twin_of = dict(zip(twins, written[len(val):len(val) + len(twins)]))
    jpeg_rates = dict(zip(jk, written[len(val) + len(twins):]))
    splits = {}
    for name in [n for pair in pairs for n in pair]:
        for d in ("images", "labels"):
            (tmp / name / d).mkdir(parents=True, exist_ok=True)
    files = {n: [] for pair in pairs for n in pair}
    kinds_used, kind_of = {}, {}

    def write(i):
        src = val[i]
        rgb = srcs[i]
        stem = Path(src).stem
        label = Path(src).parent.parent / "labels" / f"{stem}.txt"
        out = []
        for (copy_name, name), kinds in zip(pairs, (
                FORMAT_KINDS, WEBP_KINDS, tiffk_fx.SPLIT_KINDS, jk,
                tiffk_fx.Q19D_KINDS)):
            kind = kinds[i % len(kinds)]
            if name == "jpegkinds":
                path = tmp / name / "images" / f"{stem}.jpg"
                path.write_bytes(jpeg_split[i])
            else:
                path = format_file(tmp / name / "images" / stem, kind, rgb)
            copy = tmp / copy_name / "images" / f"{stem}.png"
            image_io.write_png(str(copy), image_io.imread(str(path)),
                               level=1)
            for n in (copy_name, name):
                shutil.copy(label, tmp / n / "labels" / f"{stem}.txt")
            out.append((kind, name, str(path), copy_name, str(copy)))
        return out

    with ThreadPoolExecutor(8) as ex:
        for written in ex.map(write, range(len(val))):
            for kind, name, path, copy_name, copy in written:
                files[name].append(path)
                files[copy_name].append(copy)
                kinds_used[kind] = kinds_used.get(kind, 0) + 1
                kind_of[path] = kind
    for name in files:
        splits[name] = tmp / name / f"{name}.txt"
        splits[name].write_text("".join(f"{p}\n" for p in files[name]))
    t_write = time.perf_counter() - t0
    lossless = [(a, b) for a, b in zip(files["formats"], files["png"])
                if image_io.suffix(a) not in image_io.JPEG_SUFFIXES] + [
        (a, b) for a, b in zip(files["webp"], files["webp_png"])] + [
        (a, b) for a, b in zip(files["tiffkinds"], files["tiffkinds_png"])] \
        + list(zip(files["q19d"], files["q19d_png"]))
    same = sum(np.array_equal(image_io.imread(a), image_io.imread(b))
               for a, b in lossless)
    require(same == len(lossless), f"{len(lossless) - same} files decode "
            f"unlike their PNG copies")
    src_same = sum(np.array_equal(image_io.imread(a), image_io.imread(v))
                   for a, v in zip(files["webp"], val)
                   if kind_of[a] in ("webp", "webpexif"))
    require(src_same == sum(kinds_used.get(k, 0) for k in ("webp",
                                                           "webpexif")),
            "a lossless WebP decodes unlike its source image")
    tiff_same = sum(np.array_equal(image_io.imread(a), image_io.imread(v))
                    for a, v in zip(files["tiffkinds"], val)
                    if kind_of[a] in ("tiffill2_lzw", "tifsigned"))
    require(tiff_same == sum(kinds_used.get(k, 0) for k in (
        "tiffill2_lzw", "tifsigned")),
        "a lossless TIFF kind decodes unlike its source image")
    jpeg_pairs = list(zip(files["jpegkinds"], files["jpegkinds_png"]))
    jpeg_same = sum(np.array_equal(image_io.imread(a), image_io.imread(b))
                    for a, b in jpeg_pairs)
    require(jpeg_same == len(jpeg_pairs),
            f"{len(jpeg_pairs) - jpeg_same} JPEG-kind files decode unlike "
            f"their PNG copies")
    ll_same = sum(np.array_equal(image_io.imread(a), srcs[i])
                  for i, a in enumerate(files["jpegkinds"])
                  if kind_of[a] == "lossless")
    require(ll_same == kinds_used.get("lossless", 0),
            "a lossless JPEG decodes unlike its source image")
    twin_same = 0
    for i, data in twin_of.items():
        twin = tmp / f"twin_{i}.jpg"
        twin.write_bytes(data)
        twin_same += np.array_equal(image_io.imread(str(twin)),
                                    image_io.imread(files["jpegkinds"][i]))
    require(twin_same == len(twin_of), "an arithmetic JPEG decodes unlike "
            "the same coefficients Huffman-coded")
    print(f"[formats] val split ({len(val)} images at {NATIVE_WH}) written "
          f"as PNG and as {kinds_used} in {t_write:.1f} s; the "
          f"{len(lossless)} lossless, WebP, TIFF-kind and Q1.9d files "
          f"decode as their PNG copies, the {src_same} VP8L ones (EXIF-turned too) "
          f"and the {tiff_same} FillOrder 2 / signed TIFFs as their "
          f"sources; the {jpeg_same} JPEG-kind files as their PNG copies, "
          f"the {ll_same} lossless ones as their sources, the {twin_same} "
          f"arithmetic ones as their Huffman twins")

    # -- YOLOv5l at the mid density, cli.val on both --------------------
    cfg = ssod_cfg(*data_overrides(lists))
    spec = dataclasses.replace(spec_from_cfg(cfg), train_domain=False)
    model = build_model(spec, device=dev,
                        generator=torch.Generator().manual_seed(SEED + 14))
    loader = create_dataloader(cfg, "val", augment=False, batch_size=T_BATCH,
                               pin_memory=True)
    calib = next(iter(loader))["images"][:8].to(dev)
    del loader
    shift = mid_val_teacher(torch, model.eval(), calib)
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.copy_(t.half().float())
    v = module_variables(model)
    ckpt = tmp / "formats_mid.ckpt"
    save_checkpoint(ckpt, params=v["params"], batch_stats=v["batch_stats"])
    results, entries = {}, []
    label = {"formats": "formats", "webp": "webp", "tiffkinds": "tiff",
             "jpegkinds": "jpeg kinds", "q19d": "q1.9d tiff"}
    for name in ("png", "formats", "webp_png", "webp", "tiffkinds_png",
                 "tiffkinds", "jpegkinds_png", "jpegkinds", "q19d_png",
                 "q19d"):
        argv = ["--cfg", str(MAIN_YAML), "--weights", str(ckpt),
                "--batch-size", str(T_BATCH), "Dataset.val",
                str(splits[name])]
        t0 = time.perf_counter()
        got, launches, decoded = recorded_cli_val(torch, argv)
        t_val = time.perf_counter() - t0
        require(all(launches.values()), f"cli.val on the {name} split "
                f"launched {launches}")
        results[name] = got
        print(f"[formats] cli.val on the {name} split: P/R/mAP50/mAP "
              f"{'/'.join(f'{x:.6f}' for x in got)}, each batch's NMS == the "
              f"plain NMS, launches {launches}; {t_val:.1f} s | {card}")
        if name in label:
            entries += val_entries(torch, decoded, f"{label[name]}: cli.val",
                                   launches, card)
    require(results["png"] == results["formats"]
            and results["webp_png"] == results["webp"]
            and results["tiffkinds_png"] == results["tiffkinds"]
            and results["jpegkinds_png"] == results["jpegkinds"]
            and results["q19d_png"] == results["q19d"],
            f"cli.val differs between a split and its PNG copy: {results}")
    print(f"[formats] cli.val: the formats split's results == the PNG "
          f"split's, the WebP split's, the TIFF kinds', the JPEG kinds' "
          f"and the Q1.9d TIFF kinds' == their PNG copies' "
          f"({shift[1]:.0f} candidates/img on the "
          f"calibration batch)")

    # -- cli.detect over .bmp / .tif / .png / .webp sources ------------
    src_dir = {k: tmp / f"detect_{k}" for k in ("mixed", "png")}
    for d in src_dir.values():
        d.mkdir()
    for i in range(FORMAT_DETECT):
        rgb = image_io.imread(val[i])
        kind = DETECT_KINDS[i % len(DETECT_KINDS)]
        path = format_file(src_dir["mixed"] / f"{i}", kind, rgb)
        image_io.write_png(str(src_dir["png"] / f"{i}.png"),
                           image_io.imread(str(path)))
    canvases, real = [], image_io.imwrite

    def record(path, img):
        canvases.append((Path(path), np.array(img)))
        real(path, img)

    outs = {}
    image_io.imwrite = record
    try:
        for k, d in src_dir.items():
            outs[k] = cli_detect.main([
                "--cfg", str(MAIN_YAML), "--weights", str(ckpt), "--source",
                str(d), "--save-dir", str(tmp / f"out_{k}"), "--save-txt",
                "--conf-thres", "0.001", "--img-size", str(IMG)])
    finally:
        image_io.imwrite = real
    out_dir = outs["mixed"][0]
    written = [(p, c) for p, c in canvases if p.parent == out_dir]
    suffixes = sorted(p.suffix for p, _ in written)
    require(suffixes == sorted(Path(p).suffix for p in outs["mixed"][1]),
            f"cli.detect wrote {suffixes}")
    for p, c in written:
        require(np.array_equal(image_io.imread(str(p)), c[..., ::-1]),
                f"{p.name} reads back unlike its canvas")
    txt = [sorted(outs[k][0].glob("*.txt")) for k in ("mixed", "png")]
    require(len(txt[0]) == FORMAT_DETECT and [t.read_text() for t in txt[0]]
            == [t.read_text() for t in txt[1]],
            "cli.detect's label files differ from the PNG copies'")
    n_det = sum(len(d) for d in outs["mixed"][1].values())
    print(f"[formats] cli.detect --save-txt over {FORMAT_DETECT} sources "
          f"({', '.join(sorted(set(suffixes)))}): {n_det} detections; each "
          f"canvas written under its source's suffix and read back equal; "
          f"label files == the PNG copies'")

    # -- decode rates per kind at 640x480 -------------------------------
    rates = {}
    for kind in RATE_KINDS + TIFF_RATE_KINDS + tuple(f"jpg_{k}" for k in jk):
        d = tmp / f"rate_{kind}"
        d.mkdir()
        if kind.startswith("jpg_") and kind[4:] in jpeg_rates:
            first = d / "0.jpg"
            first.write_bytes(jpeg_rates[kind[4:]])
        else:
            first = format_file(d / "0", kind, base)
        data = first.read_bytes()
        paths = [first] + [first.with_name(f"{i}{first.suffix}")
                           for i in range(1, RATE_COPIES)]
        for p in paths[1:]:
            p.write_bytes(data)
        lst = d / "list.txt"
        lst.write_text("".join(f"{p}\n" for p in paths))
        ds = LoadImagesAndLabels(str(lst), img_size=IMG, nc=NC)
        ref = ds.load_image(0)[0]
        rates[kind] = {"bytes": len(data)}
        for threads in DATA_WORKERS:
            with ThreadPoolExecutor(threads) as ex:
                list(ex.map(ds.load_image, range(min(threads, len(ds)))))
                t0 = time.perf_counter()
                imgs = list(ex.map(lambda i: ds.load_image(i)[0],
                                   range(len(ds))))
                rates[kind][threads] = len(ds) / (time.perf_counter() - t0)
            require(all(np.array_equal(im, ref) for im in imgs),
                    f"{kind}: decodes differ")
    print(f"[formats] decode img/s through LoadImagesAndLabels.load_image "
          f"at 640x480 ({RATE_COPIES} files each), 1 / 8 threads: "
          + "; ".join(f"{k} {r[1]:.1f} / {r[8]:.1f} ({r['bytes'] / 1e3:.0f}"
                      f" kB)" for k, r in rates.items())
          + f"; host cores {os.cpu_count()} | {card}")
    return entries


def formats_phase(torch, dev, card, lists):
    """The [formats] leg; its kernels-line entries."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=DATA_DIR) as tmp:
        t0 = time.perf_counter()
        entries = formats_leg(torch, dev, card, lists, tmp)
        print(f"[time] formats {time.perf_counter() - t0:.1f} s | {card}")
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2

    from efficientteacher_torch.ops import _build, select_cuda
    from efficientteacher_torch.ops.nms_cuda import (greedy_nms_keep,
                                                     greedy_nms_keep_cuda)
    from efficientteacher_torch.ops.select_cuda import (
        check_exact_topk, count_ge_cuda, exact_topk_elems, exact_topk_rows,
        threshold_compact_cuda)
    from efficientteacher_torch.utils.eval_regimes import make_density_fn

    t_start = time.perf_counter()
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
          f"tie-class compactions after bisection: "
          f"{sum(t.get('elems:ties', 0) for t in tiers.values())}")
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
    flats = {}
    k2_err = count_err = 0
    for name, decoded in lattices.items():
        flat, boxes_xyxy, taus, e2, ec = lattice_checks(torch, decoded, name)
        flats[name] = (flat, boxes_xyxy, taus)
        k2_err, count_err = max(k2_err, e2), max(count_err, ec)
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
        flat = flats[name][0]
        rows[name], k1, tests, err = kernel_rows(torch, *flats[name])
        k1_err = max(k1_err, err)
        t_eager = event_ms(torch, lambda: greedy_nms_keep_cuda(*k1))
        t_engine = event_ms(torch, lambda: exact_topk_rows(flat, MAX_NMS))
        print(f"[time] {name}: NMS kernels {t_k:.3f} ms, plain {t_p:.3f} ms"
              f" | selection engine {t_engine[0]:.3f} ms, torch.topk "
              f"{rows[name]['threshold_compact'][3][0]:.3f} ms | "
              f"greedy_nms_keep (32, {k1[0].shape[1]}) called eagerly "
              f"{t_eager[0]:.4f} ms/call; {tests} IoU tests needed | {card}")
        print_kernel_rows(name, rows[name], card)

    # what ordering equal scores costs (lowest flat index first,
    # assigners/topk.py): the selection's last top-k at the rows tier's
    # buffer width, the element tier's and the whole lattice, on the mid
    # lattice's scores, beside torch.topk (which orders no ties)
    from efficientteacher_torch.assigners.topk import topk_lower_index_first
    from efficientteacher_torch.ops.select_cuda import _SLACK
    widths = (256 * 128, -(-(MAX_NMS + _SLACK) // 128) * 128,
              flats["mid"][0].shape[1])
    ties = []
    for width in widths:
        x = flats["mid"][0][:, :width].contiguous()
        ties.append((width, event_ms(
            torch, lambda: topk_lower_index_first(x, MAX_NMS), launches=10,
            repeats=3)[0], event_ms(
            torch, lambda: torch.topk(x, MAX_NMS, 1), launches=10,
            repeats=3)[0]))
    print("[time] tie order: top-k of 30000 with equal scores lowest index "
          "first vs torch.topk, ms: "
          + "; ".join(f"({B}, {w}) {a:.4f} vs {b:.4f}" for w, a, b in ties)
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

    # 7. the training step's path
    phase_s = {"slice": time.perf_counter() - t_start}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    entry, bare = timed("train", train_phase, torch, dev, card)
    kernels.append(entry)
    # 8. the data path: a dataset on disk, the loaders' engines, the
    # device augmentation, the trainer from disk, the CLIs
    try:
        lists = timed("write", write_dataset, torch)
        timed("data", data_phase, torch, lists, card)
        timed("aug", aug_phase, torch, dev, lists, card)
        entries, dev_aug = timed("trainer", trainer_phase, torch, dev, card,
                                 bare, lists)
        kernels += entries
        timed("hostaug", hostaug_phase, torch, dev, card, lists, dev_aug)
        timed("cli", cli_leg, torch, dev, card, lists)
        kernels += timed("zoo", zoo_phase, torch, dev, card, lists)
        kernels += timed("ssod-opts", ssod_opts_phase, torch, dev, card,
                         lists)
        kernels += timed("slice11", slice11_phase, torch, dev, card, lists)
        kernels += timed("serve", serve_phase, torch, dev, card, lists)
        kernels += timed("formats", formats_phase, torch, dev, card, lists)
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    print("[time] phases (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_s.items()) + f" | {card}")
    print(f"[time] chip_smoke.py total {time.perf_counter() - t_start:.1f} "
          f"s (the kernels' build included) | {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--ddp-child"]:  # one [ddp] run
            sys.exit(ddp_child(sys.argv[2], sys.argv[3:]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip without a CUDA device (as on the CPU test host)
and run on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

This file imports no jax (the GPU machine has none)."""

import numpy as np
import pytest
import torch

from efficientteacher_torch.ops.nms_cuda import (greedy_nms_keep,
                                                 greedy_nms_keep_cuda)
from efficientteacher_torch.ops.select_cuda import (
    _count_ge, check_exact_topk, count_ge_cuda, exact_topk_elems,
    exact_topk_rows, threshold_compact, threshold_compact_cuda)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fields(rng, k, n_valid):
    """Overlapping xyxy boxes in score order; prefix and holed masks."""
    xy = rng.uniform(0, 300, (2, k, 2))
    wh = rng.uniform(10, 90, (2, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.zeros((2, k), bool)
    valid[:, :n_valid] = True
    valid[1, rng.choice(n_valid, n_valid // 3, replace=False)] = False
    return torch.from_numpy(boxes), torch.from_numpy(valid)


def _check_nms(boxes, valid, tile, stop_at, thr=0.6):
    """The kernel against the plain version; returns the mask."""
    ref = greedy_nms_keep(boxes, valid, thr, tile, stop_at)
    before = greedy_nms_keep_cuda.launches
    got = greedy_nms_keep_cuda(boxes, valid, thr, tile, stop_at)
    assert greedy_nms_keep_cuda.launches == before + 1
    assert torch.equal(got, ref), (tile, stop_at)
    return ref


@pytest.mark.parametrize("k,n_valid", [(2048, 700), (30208, 3000),
                                       (2048, 0), (30208, 30208)])
def test_nms_kernel_matches_plain(card, k, n_valid):
    boxes, valid = _fields(np.random.default_rng(k), k, n_valid)
    boxes, valid = boxes.to(card), valid.to(card)
    for tile in (128, 256):
        for stop_at in (None, 300):
            _check_nms(boxes, valid, tile, stop_at)


def test_nms_kernel_dense_field_spills_the_kept_list(card):
    """stop_at None on a dense, class-offset K = 30208 field: thousands of
    kept rows, beyond the 1536 the kernel holds in shared memory."""
    rng = np.random.default_rng(5)
    k = 30208
    xy = rng.uniform(0, 600, (2, k, 2))
    wh = rng.uniform(10, 200, (2, k, 2))
    cls = rng.integers(0, 80, (2, k, 1)) * 7680.0
    boxes = torch.from_numpy(
        (np.concatenate([xy, xy + wh], -1) + cls).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(2, k)) > 0.2)
    keep = _check_nms(boxes.to(card), valid.to(card), 256, None)
    assert int(keep.sum(1).min()) > 1536


def _near_threshold_pairs():
    """Pairs of equal-width boxes, pair p on its own strip y in [2p, 2p+1]:
    a = [0, W], b = [x, x + W] with W - x = n and W + x = d integers, so
    inter = n and union = d exactly, and IoU = fl(n / d) with n / d within
    a few ulps of 0.6 (n = round(0.6 d) + e, e in -3..3). Returns boxes
    (1, K, 4) and the float32 IoU of each pair."""
    rows, ious = [], []
    for p in range(512):
        d = 2_000_000 + 6 * p + p % 5
        n = round(0.6 * d) + p % 7 - 3
        wd, x = (n + d) / 2, (d - n) / 2          # halves: exact in float32
        rows += [[0.0, 2 * p, wd, 2 * p + 1], [x, 2 * p, x + wd, 2 * p + 1]]
        ious.append(np.float32(n) / np.float32(d))
    k = -(-len(rows) // 256) * 256
    boxes = np.zeros((1, k, 4), np.float32)
    boxes[0, :len(rows)] = rows
    return torch.from_numpy(boxes), np.array(ious, np.float32)


def test_nms_kernel_near_threshold_pairs(card):
    boxes, ious = _near_threshold_pairs()
    thr = np.float32(0.6)
    assert np.abs(ious - thr).max() < 64 * np.spacing(thr)
    assert (ious > thr).any() and (ious <= thr).any()
    valid = torch.zeros(boxes.shape[:2], dtype=torch.bool)
    valid[0, :2 * len(ious)] = True
    keep = _check_nms(boxes.to(card), valid.to(card), 256, None)
    np.testing.assert_array_equal(keep[0, 1:2 * len(ious):2].cpu().numpy(),
                                  ious <= thr)


def test_nms_kernel_rejects_bad_input(card):
    boxes = torch.zeros(1, 256, 4, device=card)
    valid = torch.zeros(1, 256, dtype=torch.bool, device=card)
    with pytest.raises(TypeError):
        greedy_nms_keep_cuda(boxes.double(), valid, 0.5)
    with pytest.raises(ValueError):
        greedy_nms_keep_cuda(boxes, valid, 0.5, tile=512)
    with pytest.raises(ValueError):
        greedy_nms_keep_cuda(boxes, valid.cpu(), 0.5)


@pytest.mark.parametrize("n", [300001, 300000])
def test_compact_kernel_matches_plain(card, n):
    """N not a multiple of the 8192-element chunk, with (300000) and
    without (300001) 16-byte rows; zero survivors, some, and all."""
    rng = np.random.default_rng(2)
    sc = np.full((4, n), -1.0, np.float32)
    for i, npos in enumerate((0, 7000, 250000)):
        pos = rng.choice(sc.shape[1], npos, replace=False)
        sc[i, pos] = rng.uniform(1e-4, 1.0, npos)
    sc[3] = rng.uniform(1e-4, 1.0, n)
    scores = torch.from_numpy(sc).to(card)
    lo = torch.tensor([0.0, 0.3, 0.0, 0.0], device=card)
    hi = torch.full((4,), float("inf"), device=card)
    for cap in (1, 4096, 62848, n + 5):
        before = threshold_compact_cuda.launches
        ks, ki = threshold_compact_cuda(scores, lo, hi, cap)
        assert threshold_compact_cuda.launches == before + 1
        ps, pi = threshold_compact(scores, lo, hi, cap)
        assert torch.equal(ks, ps) and torch.equal(ki, pi)
    for engine in (exact_topk_rows, exact_topk_elems):
        ts, ti = engine(scores, 30000)
        check_exact_topk(scores, 30000, ts, ti)


def test_tie_tier_on_the_card_equals_plain(card):
    """The eval lattice (B, 2,016,000) where a tie class straddles [k, cap]
    in two images and a third takes a plain tau: the element engine's tie
    tier through the kernels equals its plain version index for index."""
    from efficientteacher_torch.ops import select_cuda
    rng = np.random.default_rng(5)
    n, k = 2016000, 30000
    sc = np.full((3, n), -1.0, np.float32)
    sc[0, ::3] = np.float32(0.0123)                 # 672000 equal scores
    sc[0, rng.choice(n, 9000, replace=False)] = rng.uniform(0.5, 1.0, 9000)
    sc[1, 1::4] = np.float32(0.75)                  # the top score ties
    sc[2, ::5] = rng.uniform(1e-4, 1.0, sc[2, ::5].size)
    scores = torch.from_numpy(sc).to(card)
    select_cuda.tier_counts.clear()
    before = threshold_compact_cuda.launches
    ts, ti = exact_topk_elems(scores, k)
    assert dict(select_cuda.tier_counts) == {"elems:ties": 1}
    assert threshold_compact_cuda.launches == before + 2
    ps, pi = exact_topk_elems(scores, k, use_kernel=False)
    assert torch.equal(ts, ps) and torch.equal(ti, pi)
    check_exact_topk(scores, k, ts, ti)


@pytest.mark.parametrize("n", [300001, 300000])
def test_count_ge_kernel_matches_plain(card, n):
    """T = 1..8, thresholds on tie classes and on the -1 padding."""
    rng = np.random.default_rng(n)
    sc = np.full((3, n), -1.0, np.float32)
    sc[1, ::3] = rng.uniform(1e-4, 1.0, sc[1, ::3].size)
    sc[2] = rng.uniform(1e-4, 1.0, n)
    sc[1, :1000] = sc[2, :1000] = 0.5
    scores = torch.from_numpy(sc).to(card)
    for t in range(1, 9):
        taus = np.sort(rng.uniform(0, 1, (3, t)).astype(np.float32), 1)
        taus[:, 0] = 0.5 if t % 2 else -1.0
        taus = torch.from_numpy(taus).to(card)
        before = count_ge_cuda.launches
        got = count_ge_cuda(scores, taus)
        assert count_ge_cuda.launches == before + 1
        assert torch.equal(got, _count_ge(scores, taus))
    with pytest.raises(ValueError):
        count_ge_cuda(scores, torch.zeros(3, 9, device=card))


def _decoded_field(rng, b, n, nc, img):
    """Decoded teacher predictions (b, n, 5 + nc) with spread scores."""
    pred = np.zeros((b, n, 5 + nc), np.float32)
    pred[..., 0:2] = rng.uniform(0, img, (b, n, 2))
    pred[..., 2:4] = rng.uniform(4, 120, (b, n, 2))
    pred[..., 4] = rng.uniform(0, 1, (b, n)) ** 3
    pred[..., 5:] = rng.uniform(0, 1, (b, n, nc)) ** 4
    return torch.from_numpy(pred)


def test_pseudo_labels_through_k1_match_plain(card):
    """The SSOD path's NMS at its main-path shape: 16 images of 25,200
    YOLOv5l rows at 640 px, max_nms 2048 -> K1 at (16, 2048), conf 0.1,
    IoU 0.65, 100 labels; identity and scale + flip warps."""
    from efficientteacher_torch.ssod.pseudo_label import create_pseudo_labels

    rng = np.random.default_rng(16)
    decoded = _decoded_field(rng, 16, 25200, 80, 640).to(card)
    m_s = torch.zeros(16, 13)
    m_s[:, 1:10] = torch.eye(3).flatten()
    m_s[:, 10] = 1.0
    m_s[8:, 1:10] = torch.tensor([[0.5, 0, 160], [0, 0.5, 160],
                                  [0, 0, 1.0]]).flatten()
    m_s[8:, 10], m_s[8:, 12] = 0.5, 1.0
    kw = dict(img_size=640, nc=80, conf_thres=0.1, iou_thres=0.65,
              max_pl=100)
    before = greedy_nms_keep_cuda.launches
    got = create_pseudo_labels(decoded, m_s.to(card), **kw)
    assert greedy_nms_keep_cuda.launches == before + 1
    ref = create_pseudo_labels(decoded, m_s.to(card), use_kernels=False,
                               **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got.mask.sum(1).min()) > 0


@pytest.mark.parametrize("k", [128, 256, 512])
def test_nms_kernel_at_the_merge_shapes(card, k):
    """K1 at the multi-teacher merge's shapes: (B, k) with
    k = max(128, next_pow2(D_total)) and tile min(256, k), no stop_at
    (`ssod/pseudo_label.class_agnostic_merge`): crowded fields, the valid
    rows a prefix as the merge's score sort leaves them."""
    rng = np.random.default_rng(k)
    for n_valid in (k // 2 + 7, k, 0):
        boxes, valid = _fields(rng, k, n_valid)
        valid[1] = valid[0]
        _check_nms(boxes.to(card), valid.to(card), min(256, k), None)


def test_multi_teacher_pseudo_labels_through_k1_match_plain(card):
    """`create_pseudo_labels_multi` at the main path's shapes: two
    teachers of 16 x 25,200 YOLOv5l rows (the extra one's classes
    permuted, some dropped), max_pl 100: K1 at (16, 2048) twice, then the
    merge's K1 at (16, 256); every output equal to the plain versions'."""
    from efficientteacher_torch.ssod.pseudo_label import (
        create_pseudo_labels_multi)

    rng = np.random.default_rng(17)
    main = _decoded_field(rng, 16, 25200, 80, 640).to(card)
    extra = _decoded_field(rng, 16, 25200, 80, 640).to(card)
    cmap = torch.from_numpy(rng.permutation(80)).to(card)
    cmap[::7] = -1
    m_s = torch.zeros(16, 13)
    m_s[:, 1:10] = torch.eye(3).flatten()
    m_s[:, 10] = 1.0
    kw = dict(img_size=640, nc=80, conf_thres=0.1, iou_thres=0.65,
              max_pl=100)
    before = greedy_nms_keep_cuda.launches
    got = create_pseudo_labels_multi([main, extra], [None, cmap],
                                     m_s.to(card), **kw)
    assert greedy_nms_keep_cuda.launches == before + 3
    ref = create_pseudo_labels_multi([main, extra], [None, cmap],
                                     m_s.to(card), use_kernels=False, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got.mask.sum(1).min()) > 0


def test_ssod_step_on_the_card(card):
    """One burn-in and two SSOD steps (held, fired) of a width-0.25 SSOD
    model, 2 + 2 images at 256 px (4032 rows: K1 at (2, 2048)), bf16
    autocast: finite losses, one K1 launch per SSOD step, parameters
    moved by the fired step only."""
    from efficientteacher_torch.losses.ssod_loss import SSODLossConfig
    from efficientteacher_torch.losses.yolov5_loss import YoloV5LossConfig
    from efficientteacher_torch.models import ModelSpec, build_model
    from efficientteacher_torch.train.optim import OptimizerConfig
    from efficientteacher_torch.train.ssod_step import (
        create_ssod_train_state, make_burn_in_train_step,
        make_ssod_train_step, seed_teacher_from_ema)
    from efficientteacher_torch.train.supervised import Schedule

    spec = ModelSpec(width_multiple=0.25, depth_multiple=0.33, img_size=256,
                     train_domain=True)
    model = build_model(spec, device=card,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # a teacher that gives pseudo labels
        for conv in model.head.m:
            conv.bias.view(3, 85)[:, 4] += 4.0
            conv.bias.view(3, 85)[:, 5:] += 5.0
    anchors = (torch.tensor(spec.anchors).view(3, 3, 2)
               / torch.tensor(spec.strides).view(3, 1, 1)).to(card)
    oc = OptimizerConfig(lr0=0.01, lrf=1.0)
    state = create_ssod_train_state(model, oc)
    g = torch.Generator().manual_seed(1)
    img = lambda: torch.randint(0, 256, (2, 256, 256, 3), generator=g,  # noqa
                                dtype=torch.uint8).to(card)
    sup, strong, weak = img(), img(), img()
    labels = torch.tensor([[[3, 0.5, 0.5, 0.2, 0.3], [7, 0.3, 0.6, 0.1,
                                                      0.1]]] * 2).to(card)
    mask = torch.ones(2, 2, dtype=torch.bool, device=card)
    m_s = torch.zeros(2, 13)
    m_s[:, 1:10] = torch.eye(3).flatten()
    m_s[:, 10] = 1.0
    sched = Schedule.make(0.01, 0.01, 0.937, 2)
    sup_cfg = YoloV5LossConfig(nc=80, obj_w=0.7, cls_w=0.3)
    burn = make_burn_in_train_step(sup_cfg, anchors, oc)
    state, parts = burn(state, sup, labels, mask, weak,
                        Schedule.make(0.01, 0.01, 0.937, 1))
    assert all(torch.isfinite(v) for v in parts.values())
    seed_teacher_from_ema(state)
    step = make_ssod_train_step(
        sup_cfg, SSODLossConfig(nc=80, obj_w=0.7, cls_w=0.3,
                                uncertain_aug=True,
                                pseudo_label_with_obj=True), anchors, oc,
        spec, nms_conf_thres=0.1, nms_iou_thres=0.65, max_pl=100,
        multi_label=False, teacher_loss_weight=3.0, da_loss_weight=0.01,
        with_da_loss=False)
    thr = (torch.full((80,), 0.6, device=card),
           torch.full((80,), 0.1, device=card))
    for fired in (False, True):
        before = [p.detach().clone() for p in state.params]
        launches = greedy_nms_keep_cuda.launches
        state, out = step(state, sup, labels, mask, strong, weak,
                          m_s.to(card), *thr, sched, 0.999)
        assert greedy_nms_keep_cuda.launches == launches + 1
        assert all(torch.isfinite(v) for v in out.metrics.values())
        assert int(out.pseudo_count) > 0
        same = [torch.equal(a, b) for a, b in zip(before, state.params)]
        assert (not any(same)) if fired else all(same)


def test_ssod_trainer_on_the_card(card, tmp_path):
    """Two epochs of a width-0.25 SSODTrainer (1 burn-in, 1 mean-teacher)
    on the card by default, 4 + 4 images at 256 px, bf16, with epoch-end
    validation at nc 80: finite losses, K1 in every SSOD step and every
    val batch, a results.csv row per epoch, and a last.ckpt that a
    resumed trainer restores."""
    import types

    from efficientteacher_torch.configs import get_cfg
    from efficientteacher_torch.train.ssod_trainer import SSODTrainer
    from efficientteacher_torch.utils.checkpoint import load_checkpoint

    rng = np.random.default_rng(0)
    img, b = 256, 4

    def batch():
        labels = np.zeros((b, 4, 5), np.float32)
        labels[:, :2, 0] = rng.integers(0, 80, (b, 2))
        labels[:, :2, 1:3] = rng.uniform(0.3, 0.7, (b, 2, 2))
        labels[:, :2, 3:5] = rng.uniform(0.1, 0.3, (b, 2, 2))
        mask = np.zeros((b, 4), bool)
        mask[:, :2] = True
        return {"images": rng.integers(0, 256, (b, img, img, 3), np.uint8),
                "labels": labels, "mask": mask, "shapes": [None] * b}

    m_s = np.zeros((b, 13), np.float32)
    m_s[:, 1:10] = np.eye(3).ravel()
    m_s[:, 10] = 1.0
    train = [batch(), batch()]
    target = [{"images": batch()["images"], "images_ori": batch()["images"],
               "M_s": m_s} for _ in range(2)]
    ds = types.SimpleNamespace(mosaic=True)
    steps = []

    class Trainer(SSODTrainer):
        def build_dataloader(self, cfg):
            self.train_loader, self.target_loader = train, target
            self.val_loader, self.dataset, self.nb = [batch()], ds, 2

        def build_step(self):
            super().build_step()
            step = self.ssod_step

            def counted(*args):
                k0 = greedy_nms_keep_cuda.launches
                state, out = step(*args)
                steps.append((greedy_nms_keep_cuda.launches - k0,
                              {k: float(v) for k, v in out.metrics.items()}))
                return state, out

            self.ssod_step = counted

    cfg = get_cfg()
    cfg.merge_from_list([
        "Model.Backbone.name", "YoloV5", "Model.Neck.name", "YoloV5",
        "Model.Head.name", "YoloV5", "Model.Backbone.activation", "SiLU",
        "Model.Neck.activation", "SiLU",
        "Model.Neck.in_channels", [256, 512, 1024],
        "Model.Neck.out_channels", [256, 512, 1024],
        "Model.width_multiple", 0.25, "Model.depth_multiple", 0.33,
        "Loss.type", "ComputeLoss", "SSOD.train_domain", True,
        "Dataset.img_size", img, "Dataset.batch_size", b, "epochs", 2,
        "hyp.burn_epochs", 1, "SSOD.fixed_accumulate", True,
        "project", str(tmp_path), "name", "card"])
    trainer = Trainer(cfg)
    assert trainer.device.type == "cuda"
    with torch.no_grad():  # a teacher that gives pseudo labels
        for m in (trainer.state.model, trainer.state.ema.module):
            for conv in m.head.m:
                conv.bias.view(3, 85)[:, 4] += 4.0
                conv.bias.view(3, 85)[:, 5:] += 5.0
    k0 = greedy_nms_keep_cuda.launches
    trainer.train()
    assert [k for k, _ in steps] == [1, 1]
    assert all(np.isfinite(v) for _, m in steps for v in m.values())
    # two SSOD steps + one val batch per epoch
    assert greedy_nms_keep_cuda.launches - k0 == 4
    rows = trainer.results_csv.read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["0", "1"]
    last = trainer.save_dir / "weights" / "last.ckpt"
    assert load_checkpoint(last)["meta"]["epoch"] == 1
    cfg.resume, cfg.weights, cfg.name = True, str(last), "resumed"
    resumed = Trainer(cfg)
    assert resumed.start_epoch == 2 and resumed.teacher_seeded
    for ema in ("ema", "semi_ema"):
        assert getattr(resumed.state, ema).updates == \
            getattr(trainer.state, ema).updates
    for (k, p), q in zip(resumed.state.model.named_parameters(),
                         trainer.state.model.parameters()):
        assert torch.equal(p, q.half().float()), k


def test_loader_core_builds_and_reads_on_the_card_machine(card, tmp_path):
    """The host loader core builds with the machine's compiler and links
    no libjpeg; PNG reads back exactly; the core's JPEG decoder gives
    cv2's digests on the fixtures of test_torch_jpeg.py (the machine has
    no libjpeg to compare against), the PNG / BMP / TIFF readers give them
    on the fixtures of test_torch_image_formats.py, the WebP decoders on
    those of test_torch_webp.py, the TIFF kinds of ROADMAP Q1.9c (fax,
    JPEG-in-TIFF, CMYK, CIELab, YCbCr) on those of
    test_torch_tiff_kinds.py, the damaged and rare JPEGs and damaged TIFF
    strips on those of test_torch_jpeg_damaged.py, and the core's writers
    round-trip (the lossless WebP one exactly)."""
    import subprocess

    from efficientteacher_torch.data import image_io
    from efficientteacher_torch.ops._build import host_library
    from efficientteacher_torch.utils import native_loader as nl
    from test_torch_image_formats import \
        check_fixtures as check_format_fixtures
    from test_torch_jpeg import check_fixtures
    from test_torch_jpeg_damaged import \
        check_fixtures as check_damaged_fixtures
    from test_torch_tiff_kinds import check_fixtures as check_tiff_fixtures
    from test_torch_webp import check_fixtures as check_webp_fixtures

    built = host_library()
    assert built.path.exists()
    ldd = subprocess.run(["ldd", str(built.path)], capture_output=True,
                         text=True).stdout
    assert "jpeg" not in ldd, ldd
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), np.uint8)
    image_io.write_png(str(tmp_path / "a.png"), img)
    assert np.array_equal(image_io.imread(str(tmp_path / "a.png")), img)
    assert np.array_equal(nl.resize(img, 53, 37), img)
    canvas = np.zeros((64, 64, 3), np.uint8)
    nl.resize_letterbox(img, canvas, 13, 5, 53, 37)
    assert np.array_equal(canvas[13:50, 5:58], img)
    assert (canvas[:13] == 114).all() and (canvas[50:] == 114).all()
    assert check_fixtures(tmp_path / "fixtures") == []
    assert check_format_fixtures(tmp_path / "format_fixtures") == []
    assert check_webp_fixtures(tmp_path / "webp_fixtures") == []
    assert check_tiff_fixtures(tmp_path / "tiff_fixtures") == []
    assert check_damaged_fixtures(tmp_path / "damaged_fixtures") == []
    image_io.imwrite(str(tmp_path / "a.webp"), img)
    assert np.array_equal(image_io.imread(str(tmp_path / "a.webp")),
                          img[..., ::-1])
    smooth = np.repeat(np.repeat(img[::8, ::8], 8, 0), 8, 1)[:37, :53]
    jpg = str(tmp_path / "a.jpg")
    nl.jpeg_write(jpg, np.ascontiguousarray(smooth), 95)
    assert image_io.image_size(jpg) == (53, 37)
    got = image_io.imread(jpg).astype(int)
    assert np.abs(got - smooth).mean() < 12


def test_pixel_ops_give_cv2s_digests_on_the_card_machine(card):
    """The host augmentation's pixel operations, built with that machine's
    compiler, give cv2 5.0.0's digests (tests/pixel_op_cases.py): its own
    cv2, if any, is not the oracle."""
    import pixel_op_cases

    from efficientteacher_torch.utils import native_loader as nl

    assert pixel_op_cases.check_core(nl) == []


@pytest.mark.parametrize("rotating", [False, True])
def test_augmentation_on_the_card_equals_the_cpu(card, rotating):
    """device_augment_batch and device_ssod_views on the card and on the
    CPU with the same draws (drawn on the card): images within 1 LSB,
    boxes within 1e-4, masks exact, M_s within 1e-5."""
    from efficientteacher_torch.ops import augment_device as A

    rng = np.random.default_rng(1)
    b, s, m = 8, 160, 12
    images = torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), np.uint8))
    labels = np.zeros((b, m, 5), np.float32)
    labels[..., 0] = rng.integers(0, 80, (b, m))
    labels[..., 1:3] = rng.uniform(0.2, 0.8, (b, m, 2))
    labels[..., 3:] = rng.uniform(0.05, 0.3, (b, m, 2))
    labels = torch.from_numpy(labels)
    mask = torch.from_numpy(rng.uniform(size=(b, m)) < 0.7)
    hyp = {"mosaic": 1.0, "scale": 0.9, "translate": 0.1, "hsv_h": 0.015,
           "hsv_s": 0.7, "hsv_v": 0.4, "fliplr": 0.5, "cutout": 0.5,
           "degrees": 10.0 if rotating else 0.0,
           "shear": 2.0 if rotating else 0.0}

    def on(d, dev):
        return {k: on(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in d.items()}

    g = torch.Generator(device=card).manual_seed(A.step_seed(2, 5, 0))
    for draw, fn in ((A.draw_augment, A.augment_batch),
                     (A.draw_ssod, A.ssod_views)):
        draws = draw(g, b, s, hyp, card)
        got = fn(images.to(card), labels.to(card), mask.to(card), hyp, draws,
                 max_out=2 * m)
        want = fn(images, labels, mask, hyp, on(draws, "cpu"), max_out=2 * m)
        for x, y in zip(got, want):
            x = x.cpu()
            if x.dtype == torch.uint8:
                assert (x.int() - y.int()).abs().max() <= 1
            elif x.dtype == torch.bool:
                assert torch.equal(x, y)
            else:
                assert torch.allclose(x, y, rtol=1e-5, atol=1e-4)


def _anchor_free_lattice(rng, b, nc=80, lit=None):
    """A decoded anchor-free field at 640 px: 8,400 predictions per image,
    (b, 8400, 5 + nc) [xywh, obj, cls]; `lit` pairs per image above the
    0.001 gate (None: every one)."""
    n = 8400
    pred = np.zeros((b, n, 5 + nc), np.float32)
    pred[..., 0:2] = rng.uniform(0, 640, (b, n, 2))
    pred[..., 2:4] = rng.uniform(4, 200, (b, n, 2))
    pred[..., 4] = 1.0  # the TAL heads' constant objectness
    cls = rng.uniform(0.002, 1.0, (b, n * nc)).astype(np.float32)
    if lit is not None:
        for i in range(b):
            off = rng.choice(n * nc, n * nc - lit, replace=False)
            cls[i, off] = rng.uniform(0, 0.0009, off.size)
    pred[..., 5:] = cls.reshape(b, n, nc)
    return torch.from_numpy(pred)


@pytest.mark.parametrize("lit", [3300, None])
def test_selection_kernels_at_the_anchor_free_lattice(card, lit):
    """K2 (element and row buffers) and count_ge at the YOLOX-s / YOLOv8-m
    eval lattice, N = 8,400 x 80 = 672,000 scores per image, mid and
    saturated; then the whole eval NMS with the kernels equals the plain
    one."""
    from efficientteacher_torch.ops.nms import _pair_scores, batched_nms

    decoded = _anchor_free_lattice(np.random.default_rng(8), 4, lit=lit)
    decoded = decoded.to(card)
    flat = _pair_scores(decoded, 80, 0.001, False, 0, False, None)[0]
    assert flat.shape == (4, 672000)
    assert int((flat > 0).sum(1).min()) == (lit or 672000)
    lo, hi = torch.zeros(4, device=card), torch.full((4,), float("inf"),
                                                     device=card)
    for cap in (30080, 672000):
        before = threshold_compact_cuda.launches
        ks, ki = threshold_compact_cuda(flat, lo, hi, cap)
        assert threshold_compact_cuda.launches == before + 1
        ps, pi = threshold_compact(flat, lo, hi, cap)
        assert torch.equal(ks, ps) and torch.equal(ki, pi)
    taus = torch.sort(torch.rand(4, 8, device=card), 1).values.contiguous()
    before = count_ge_cuda.launches
    assert torch.equal(count_ge_cuda(flat, taus), _count_ge(flat, taus))
    assert count_ge_cuda.launches == before + 1
    for engine in (exact_topk_rows, exact_topk_elems):
        ts, ti = engine(flat, 30000)
        check_exact_topk(flat, 30000, ts, ti)
    kw = dict(nc=80, conf_thres=0.001, iou_thres=0.6, max_nms=30000,
              max_det=300, multi_label=True)
    got = batched_nms(decoded, **kw)
    ref = batched_nms(decoded, use_kernels=False, **kw)
    assert torch.equal(got.detections, ref.detections)
    assert torch.equal(got.valid, ref.valid)


@pytest.mark.parametrize("family", ["yolox", "yolov8", "yolov6s"])
def test_anchor_free_train_step_on_the_card(card, family):
    """One supervised step of each anchor-free family from its shipped
    YAML (width 0.25, 256 px, 4 images) on the card against the same step
    on the CPU, both float32 (TF32 off) from one seeded init: the same
    loss parts (rtol 1e-3: cuDNN's convolutions round otherwise), then a
    bf16 autocast step on the card with finite losses."""
    from pathlib import Path

    from efficientteacher_torch.configs import get_cfg
    from efficientteacher_torch.losses.tal_loss import (TALLossConfig,
                                                        compute_tal_loss)
    from efficientteacher_torch.losses.yolox_loss import (YoloXLossConfig,
                                                          compute_yolox_loss)
    from efficientteacher_torch.models import build_model, spec_from_cfg
    from efficientteacher_torch.train.optim import OptimizerConfig
    from efficientteacher_torch.train.supervised import (
        Schedule, make_supervised_train_step)
    from efficientteacher_torch.train.train_state import create_train_state

    yaml = {"yolox": "yolox_coco.yaml", "yolov8": "yolov8m_coco.yaml",
            "yolov6s": "yolov6s_coco.yaml"}
    cfg = get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parents[1]
                            / "configs/sup/public" / yaml[family]))
    cfg.merge_from_list(["Model.width_multiple", 0.25,
                         "Model.depth_multiple", 0.33,
                         "Dataset.img_size", 256])
    if family == "yolox":
        lc = YoloXLossConfig.from_cfg(cfg, use_l1=True)
        loss = lambda r, lab, m: compute_yolox_loss(r, lab, m, 256, lc)  # noqa
    else:
        lc = TALLossConfig.from_cfg(cfg)
        loss = lambda r, lab, m: compute_tal_loss(r, lab, m, 256, lc)  # noqa
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.integers(0, 256, (4, 256, 256, 3),
                                           dtype=np.uint8))
    labels = torch.zeros(4, 8, 5)
    labels[:, :5, 0] = torch.from_numpy(rng.integers(0, 80, (4, 5)))
    labels[:, :5, 1:3] = torch.from_numpy(rng.uniform(0.2, 0.8, (4, 5, 2)))
    labels[:, :5, 3:5] = torch.from_numpy(rng.uniform(0.05, 0.4, (4, 5, 2)))
    mask = torch.zeros(4, 8, dtype=torch.bool)
    mask[:, :5] = True
    oc = OptimizerConfig(lr0=0.01, lrf=1.0)
    sched = Schedule.make(0.01, 0.01, 0.937, 1)
    parts = {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev, dtype in (("cpu", torch.float32), (card, torch.float32),
                           (card, torch.bfloat16)):
            model = build_model(spec_from_cfg(cfg), device=dev,
                                generator=torch.Generator().manual_seed(0))
            state = create_train_state(model, oc, with_ema=True)
            step = make_supervised_train_step(
                opt_cfg=oc, compute_dtype=dtype, detection_loss=loss)
            _, out = step(state, images.to(dev), labels.to(dev),
                          mask.to(dev), sched)
            parts[(str(dev), dtype)] = {k: float(v) for k, v in out.items()}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    cpu, f32, bf16 = parts.values()
    assert set(cpu) == set(f32) == set(bf16)
    for k in cpu:
        assert f32[k] == pytest.approx(cpu[k], rel=1e-3), k
        assert np.isfinite(bf16[k]), k


@pytest.mark.parametrize("yaml", ["yolov6s_coco.yaml", "yolov7l_coco.yaml"])
def test_fused_deploy_model_on_the_card(card, yaml):
    """The RepVGG-fused deploy model (`utils/reparam.deploy_model`) of a
    YOLOv6-s / YOLOv7-L (width 0.25, 256 px, its BN statistics calibrated
    on the test images, `utils/eval_regimes.calibrate_bn`) fused on the
    card: its float32 decoded outputs (TF32 off) equal the unfused
    model's and the CPU's fused model's within 5e-4 of the largest entry
    (a box side is a DFL expectation times the stride), and its eval NMS
    with the kernels equals the plain one."""
    from pathlib import Path

    from efficientteacher_torch.configs import get_cfg
    from efficientteacher_torch.eval.validator import make_infer_fn
    from efficientteacher_torch.models import build_model, spec_from_cfg
    from efficientteacher_torch.utils.eval_regimes import calibrate_bn
    from efficientteacher_torch.utils.reparam import deploy_model

    cfg = get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parents[1]
                            / "configs/sup/public" / yaml))
    cfg.merge_from_list(["Model.width_multiple", 0.25,
                         "Model.depth_multiple", 0.33,
                         "Dataset.img_size", 256])
    model = build_model(spec_from_cfg(cfg), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (4, 256, 256, 3), dtype=np.uint8))
    calibrate_bn(model, images, torch.float32)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = {}
        for name, m in (("cpu fused", deploy_model(model.eval())),
                        ("card", model.to(card).eval())):
            dev = next(m.parameters()).device
            infer = make_infer_fn(m, 80, 0.001, 0.6, 300, 30000, 255.0,
                                  torch.float32)
            outs[name] = infer.forward(images.to(dev)).cpu()
        fused = deploy_model(model)
        infer = make_infer_fn(fused, 80, 0.001, 0.6, 300, 30000, 255.0,
                              torch.float32)
        decoded = infer.forward(images.to(card))
        got = infer.nms(decoded)
        ref = infer.nms(decoded, use_kernels=False)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    assert not any("rbr_dense" in k for k in fused.state_dict())
    scale = float(outs["card"].abs().max())
    for name, want in outs.items():
        np.testing.assert_allclose(decoded.cpu().numpy(), want.numpy(),
                                   rtol=0, atol=5e-4 * scale, err_msg=name)
    assert torch.equal(got.detections, ref.detections)
    assert torch.equal(got.valid, ref.valid)


def test_landmark_nms_through_k1_matches_plain(card):
    """The keypoint validation's NMS (`validator.make_infer_fn` with
    num_points 5: obj-gated, single label, 10 keypoint columns riding
    along) on 32 images of 25,200 YOLOv5l rows: one K1 launch, the output
    equal to the plain version's, keypoints included."""
    from efficientteacher_torch.eval.validator import make_infer_fn

    rng = np.random.default_rng(19)
    decoded = _decoded_field(rng, 32, 25200, 80, 640)
    kps = torch.from_numpy(rng.uniform(0, 640, (32, 25200, 10)).astype(
        np.float32))
    decoded = torch.cat([decoded, kps], -1).to(card)
    infer = make_infer_fn(torch.nn.Identity(), 80, 0.001, 0.6, 300, 30000,
                          255.0, num_points=5)
    before = greedy_nms_keep_cuda.launches
    got = infer.nms(decoded)
    assert greedy_nms_keep_cuda.launches == before + 1
    ref = infer.nms(decoded, use_kernels=False)
    assert got.detections.shape[-1] == 6 + 10
    assert torch.equal(got.detections, ref.detections)
    assert torch.equal(got.valid, ref.valid)
    assert int(got.valid.sum(1).min()) > 0


def test_pt_weights_serve_through_the_kernels(card, tmp_path):
    """A reference-style fp16 `.pt` of a width-0.25 YOLOv5 (nc 80, 640
    px) loaded into a model on the card: every tensor matched, the eval
    program at a mid density (objectness raised) launches K1 and K2, and
    its output equals the plain NMS's on the same decoded tensor."""
    from efficientteacher_torch.eval.validator import make_infer_fn
    from efficientteacher_torch.models import ModelSpec, build_model
    from efficientteacher_torch.utils.torch_import import (load_weights_into,
                                                           save_reference_pt)

    spec = ModelSpec(width_multiple=0.25, depth_multiple=0.33, img_size=640)
    src = build_model(spec, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for conv in src.head.m:
            conv.bias.view(3, 85)[:, 4] += 1.0
    save_reference_pt(tmp_path / "w.pt", src, src)
    model = build_model(spec, device=card).eval()
    counts = load_weights_into(model, tmp_path / "w.pt", strict=True)
    assert all(c == t for c, t in counts.values())
    infer = make_infer_fn(model, 80, 0.001, 0.6, 300, 30000, 255.0)
    images = torch.randint(0, 256, (8, 640, 640, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(4))
    decoded = infer.forward(images.to(card))
    k1, k2 = greedy_nms_keep_cuda.launches, threshold_compact_cuda.launches
    got = infer.nms(decoded)
    assert greedy_nms_keep_cuda.launches == k1 + 1
    assert threshold_compact_cuda.launches > k2
    ref = infer.nms(decoded, use_kernels=False)
    assert torch.equal(got.detections, ref.detections)
    assert torch.equal(got.valid, ref.valid)


def test_ssod_step_in_a_world_one_nccl_group(card):
    """The SSOD step (width 0.25, 2 + 2 images at 256 px, K1 at (2, 2048))
    inside a world-size-1 NCCL group, as `cli.train` under torchrun runs
    it: the gradient and the losses' counts go through all-reduces; one
    K1 launch per step, and the weights and losses are bit-equal to the
    same steps run after the group is gone (a world of one changes no
    number)."""
    import copy
    import socket

    import torch.distributed as dist

    from efficientteacher_torch.losses.ssod_loss import SSODLossConfig
    from efficientteacher_torch.losses.yolov5_loss import YoloV5LossConfig
    from efficientteacher_torch.models import ModelSpec, build_model
    from efficientteacher_torch.parallel.distributed import group_active
    from efficientteacher_torch.train.optim import OptimizerConfig
    from efficientteacher_torch.train.ssod_step import (
        create_ssod_train_state, make_ssod_train_step, seed_teacher_from_ema)
    from efficientteacher_torch.train.supervised import Schedule

    spec = ModelSpec(width_multiple=0.25, depth_multiple=0.33, img_size=256,
                     train_domain=True)
    model = build_model(spec, device=card,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for conv in model.head.m:
            conv.bias.view(3, 85)[:, 4] += 4.0
            conv.bias.view(3, 85)[:, 5:] += 5.0
    anchors = (torch.tensor(spec.anchors).view(3, 3, 2)
               / torch.tensor(spec.strides).view(3, 1, 1)).to(card)
    oc = OptimizerConfig(lr0=0.01, lrf=1.0)
    g = torch.Generator().manual_seed(1)
    img = lambda: torch.randint(0, 256, (2, 256, 256, 3), generator=g,  # noqa
                                dtype=torch.uint8).to(card)
    sup, strong, weak = img(), img(), img()
    labels = torch.tensor([[[3, 0.5, 0.5, 0.2, 0.3]]] * 2).to(card)
    mask = torch.ones(2, 1, dtype=torch.bool, device=card)
    m_s = torch.zeros(2, 13)
    m_s[:, 1:10] = torch.eye(3).flatten()
    m_s[:, 10] = 1.0
    sup_cfg = YoloV5LossConfig(nc=80, obj_w=0.7, cls_w=0.3)
    step = make_ssod_train_step(
        sup_cfg, SSODLossConfig(nc=80, obj_w=0.7, cls_w=0.3), anchors, oc,
        spec, nms_conf_thres=0.1, nms_iou_thres=0.65, max_pl=100,
        multi_label=False, teacher_loss_weight=3.0, da_loss_weight=0.01,
        with_da_loss=False)
    thr = (torch.full((80,), 0.6, device=card),
           torch.full((80,), 0.1, device=card))

    def run(state):
        losses = []
        for _ in range(2):
            launches = greedy_nms_keep_cuda.launches
            state, out = step(state, sup, labels, mask, strong, weak,
                              m_s.to(card), *thr,
                              Schedule.make(0.01, 0.01, 0.937, 1), 0.999)
            assert greedy_nms_keep_cuda.launches == launches + 1
            losses.append(float(out.metrics["total"]))
        return state, losses

    state = seed_teacher_from_ema(create_ssod_train_state(model, oc))
    alone = copy.deepcopy(state)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        assert group_active()
        state, in_group = run(state)
    finally:
        dist.destroy_process_group()
    alone, without = run(alone)
    assert in_group == without
    for a, b in zip(state.params, alone.params):
        assert torch.equal(a, b)


SUP_YAML = "configs/sup/public/yolov5l_coco.yaml"
SERVE_OVERRIDES = ["Model.width_multiple", "0.25", "Model.depth_multiple",
                   "0.33", "Dataset.img_size", "256"]


def _serve_setup(tmp_path, n=4):
    """A width-0.25 YOLOv5 (the supervised YAML, nc 80, 256 px) whose
    objectness and first classes detect, as a port checkpoint, and `n`
    images (JPEG and PNG) in a folder."""
    from efficientteacher_torch.configs import get_cfg
    from efficientteacher_torch.data import image_io
    from efficientteacher_torch.models import build_model, spec_from_cfg
    from efficientteacher_torch.utils import native_loader as nl
    from efficientteacher_torch.utils.checkpoint import (module_variables,
                                                         save_checkpoint)

    cfg = get_cfg()
    cfg.merge_from_file(SUP_YAML)
    cfg.merge_from_list(SERVE_OVERRIDES)
    model = build_model(spec_from_cfg(cfg), device="cpu",
                        generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for conv in model.head.m:
            conv.bias.view(3, 85)[:, 4] += 8.0
            conv.bias.view(3, 85)[:, 5:9] += 6.0
    v = module_variables(model)
    save_checkpoint(tmp_path / "w.ckpt", params=v["params"],
                    batch_stats=v["batch_stats"])
    rng = np.random.default_rng(6)
    (tmp_path / "imgs").mkdir()
    for i in range(n):
        img = rng.integers(0, 256, (200 + 20 * i, 300, 3), dtype=np.uint8)
        if i % 2:
            image_io.write_png(str(tmp_path / "imgs" / f"{i}.png"), img)
        else:
            nl.jpeg_write(str(tmp_path / "imgs" / f"{i}.jpg"), img, 90)
    return cfg, tmp_path / "w.ckpt", tmp_path / "imgs"


def test_detect_on_the_card_equals_the_plain_path(card, tmp_path):
    """cli.detect on the card: one K1 launch per image, and each image's
    detections equal the same model's bf16 forward followed by the plain
    NMS, scaled to the image, exactly."""
    from efficientteacher_torch.cli import detect
    from efficientteacher_torch.data.loaders import LoadImages
    from efficientteacher_torch.eval.validator import InferFn, _scale_to_native
    from efficientteacher_torch.models.autoshape import attempt_load

    cfg, ckpt, imgs = _serve_setup(tmp_path)
    before = greedy_nms_keep_cuda.launches
    _, dets, _ = detect.main(["--cfg", SUP_YAML, "--weights", str(ckpt),
                              "--source", str(imgs), "--save-dir",
                              str(tmp_path / "out"), "--img-size", "256",
                              "--save-txt", *SERVE_OVERRIDES])
    assert greedy_nms_keep_cuda.launches == before + len(dets) == before + 4
    model = attempt_load(str(ckpt), cfg, device=card)
    infer = InferFn(model, 255.0, torch.bfloat16, dict(
        nc=80, conf_thres=0.25, iou_thres=0.45, max_det=300, max_nms=2048))
    n = 0
    for path, rgb, img0, _ in LoadImages(str(imgs), 256):
        decoded = infer.forward(torch.from_numpy(rgb).to(card)[None])
        out = infer.nms(decoded, use_kernels=False)
        want = out.detections[0][out.valid[0]].cpu().numpy()
        want[:, :4] = _scale_to_native(want[:, :4], (256, 256),
                                       img0.shape[:2])
        np.testing.assert_array_equal(dets[path], want)
        n += len(want)
    assert n > 0


def test_detect_backend_deploy_and_torchscript_on_the_card(card, tmp_path):
    """cli.export on the card, then DetectBackend's `.deploy.ckpt` and
    `.torchscript` run there: the fused model in bf16 within 2e-2 of the
    largest output of the unfused bf16 forward, the traced float32 graph
    within 1e-3 of the unfused float32 forward's (a seeded network's bf16
    and float32 forwards part far more than either fusion moves them)."""
    from efficientteacher_torch.cli import export
    from efficientteacher_torch.eval.multi_backend import DetectBackend
    from efficientteacher_torch.eval.validator import InferFn
    from efficientteacher_torch.models.autoshape import attempt_load

    cfg, ckpt, _ = _serve_setup(tmp_path)
    done = export.main(["--cfg", SUP_YAML, "--weights", str(ckpt),
                        "--include", "deploy", "torchscript", "--img-size",
                        "256", "--batch", "2", *SERVE_OVERRIDES])
    cfg.freeze()
    images = np.random.default_rng(7).integers(0, 256, (2, 256, 256, 3),
                                               dtype=np.uint8)
    x = torch.from_numpy(images).to(card)
    model = attempt_load(str(ckpt), cfg, device=card)
    refs = {"deploy": (InferFn(model, 255.0, torch.bfloat16, {}), 2e-2),
            "torchscript": (InferFn(model, 255.0, torch.float32, {}), 1e-3)}
    for kind, (infer, tol) in refs.items():
        ref = infer.forward(x).float()
        backend = DetectBackend(str(done[kind]["path"]), cfg)
        assert backend.kind == kind and backend.device.type == "cuda"
        got = torch.from_numpy(backend(images)).to(card)
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


def test_detect_without_a_card_raises_unless_device_cpu(card, tmp_path,
                                                        monkeypatch):
    from efficientteacher_torch.cli import detect

    _, ckpt, imgs = _serve_setup(tmp_path, n=1)
    argv = ["--cfg", SUP_YAML, "--weights", str(ckpt), "--source",
            str(imgs), "--save-dir", str(tmp_path / "out"), "--img-size",
            "256", *SERVE_OVERRIDES]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        detect.main(argv)
    _, dets, _ = detect.main(argv + ["device", "cpu"])
    assert len(dets) == 1


def test_video_fixtures_give_cv2s_digests_on_the_card_machine(card):
    """The port's video reader, built with that machine's compiler, gives
    cv2 5.0.0's per-frame digests on tests/video_fixtures/ (the machine
    has no cv2); the fixtures it refuses raise naming their ROADMAP
    item."""
    import hashlib
    import json
    from pathlib import Path

    from efficientteacher_torch.data import video_io

    root = Path(__file__).resolve().parent / "video_fixtures"
    table = json.loads((root / "digests.json").read_text())
    for name, entry in table.items():
        if "refused" in entry:
            with pytest.raises(NotImplementedError, match=entry["refused"]):
                list(video_io.frames(str(root / name)))
            continue
        got = [hashlib.sha256(f.tobytes()).hexdigest()
               for f in video_io.frames(str(root / name))]
        assert got == entry["sha256"], name


def test_detect_on_a_clip_on_the_card(card, tmp_path):
    """cli.detect on a clip on the card: one K1 launch per frame, every
    frame's detections equal the bf16 forward followed by the plain NMS,
    and --nosave writes only the clip's label file."""
    from pathlib import Path

    from efficientteacher_torch.cli import detect
    from efficientteacher_torch.data.loaders import LoadImages
    from efficientteacher_torch.eval.validator import InferFn, _scale_to_native
    from efficientteacher_torch.models.autoshape import attempt_load

    cfg, ckpt, _ = _serve_setup(tmp_path, n=1)
    clip = Path(__file__).resolve().parent / "video_fixtures" / \
        "xvid_320x240.avi"
    before = greedy_nms_keep_cuda.launches
    out_dir, dets, _ = detect.main([
        "--cfg", SUP_YAML, "--weights", str(ckpt), "--source", str(clip),
        "--save-dir", str(tmp_path / "out"), "--img-size", "256",
        "--nosave", "--save-txt", *SERVE_OVERRIDES])
    assert greedy_nms_keep_cuda.launches == before + len(dets) == before + 30
    assert sorted(p.name for p in out_dir.iterdir()) == ["xvid_320x240.txt"]
    model = attempt_load(str(ckpt), cfg, device=card)
    infer = InferFn(model, 255.0, torch.bfloat16, dict(
        nc=80, conf_thres=0.25, iou_thres=0.45, max_det=300, max_nms=2048))
    for path, rgb, img0, _ in LoadImages(str(clip), 256):
        decoded = infer.forward(torch.from_numpy(rgb).to(card)[None])
        out = infer.nms(decoded, use_kernels=False)
        want = out.detections[0][out.valid[0]].cpu().numpy()
        want[:, :4] = _scale_to_native(want[:, :4], (256, 256),
                                       img0.shape[:2])
        np.testing.assert_array_equal(dets[path], want)

"""The port's trainers on their own (the JAX parity run is
test_torch_trainer.py): 2 epochs + resume + 1 epoch against 3 epochs of
the supervised trainer and of the SSOD trainer (1 burn-in epoch, so the
resume is past seeding), a graceful stop as tests/test_graceful_stop.py,
the options the port refuses, and the card it needs unless asked for the
CPU. Width 0.125 / depth 0.34, nc 1, 64 px, float32, in-memory batches.

Resume tolerance: the checkpoint stores fp16 weights, so the resumed
tensors are the saved ones rounded to fp16 (held exactly), and after the
last epoch each tensor is within 2e-3 of its largest entry of the
uninterrupted run's (measured ~5e-4); the last epoch's losses rtol 2e-3.
The SSOD run holds its EMA and semi-EMA to the same limits, and its
update counts, optimizer steps and pseudo labels per step exactly."""

import signal
import types

import numpy as np
import pytest
import torch

from efficientteacher_torch.configs import get_cfg
from efficientteacher_torch.train.ssod_trainer import SSODTrainer
from efficientteacher_torch.train.trainer import Trainer
from efficientteacher_torch.utils.checkpoint import load_checkpoint
from efficientteacher_torch.utils.shutdown import GracefulStop

from torch_port_helpers import one_torch_thread  # noqa: F401

TINY = ["Model.Backbone.name", "YoloV5", "Model.Neck.name", "YoloV5",
        "Model.Head.name", "YoloV5", "Model.Backbone.activation", "SiLU",
        "Model.Neck.activation", "SiLU",
        "Model.Neck.in_channels", [256, 512, 1024],
        "Model.Neck.out_channels", [256, 512, 1024],
        "Model.width_multiple", 0.125, "Model.depth_multiple", 0.34,
        "Loss.type", "ComputeLoss", "Dataset.nc", 1,
        "Dataset.img_size", 64, "Dataset.max_targets", 16]


class Replay(list):
    """In-memory batches with the BatchLoader surface (`len`, `.ds`)."""

    def __init__(self, batches, ds=None):
        super().__init__(batches)
        self.ds = ds


def _sup_batches(n, b, img, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = np.zeros((b, 4, 5), np.float32)
        mask = np.zeros((b, 4), bool)
        for i in range(b):
            k = int(rng.integers(1, 4))
            labels[i, :k, 1:3] = rng.uniform(0.3, 0.7, (k, 2))
            labels[i, :k, 3:5] = rng.uniform(0.15, 0.4, (k, 2))
            mask[i, :k] = True
        out.append({"images": rng.integers(0, 256, (b, img, img, 3),
                                           dtype=np.uint8),
                    "labels": labels, "mask": mask, "shapes": [None] * b})
    return out


class PortSup(Trainer):
    """The supervised trainer on in-memory batches: 2 steps of 32 images
    (accumulate 2: one fired step per epoch) and one val batch."""

    def build_dataloader(self, cfg):
        ds = types.SimpleNamespace(mosaic=True)
        self.train_loader = Replay(_sup_batches(2, 32, 64, 0), ds)
        self.val_loader = Replay(_sup_batches(1, 8, 64, 1))
        self.dataset, self.nb = ds, 2


def _sup_cfg(project, name, **kw):
    cfg = get_cfg()
    cfg.merge_from_list(TINY + ["Dataset.batch_size", 32, "epochs", 3,
                                "project", str(project), "name", name])
    for k, v in kw.items():
        cfg[k] = v
    return cfg


def test_resume_equals_an_uninterrupted_run(tmp_path):
    whole = PortSup(_sup_cfg(tmp_path, "whole"), compute_dtype=torch.float32,
                    device="cpu")
    whole.train()
    first = PortSup(_sup_cfg(tmp_path, "first"), compute_dtype=torch.float32,
                    device="cpu")
    first.epochs = 2  # stop after 2 of the 3 epochs of the schedule
    first.train()
    last = first.save_dir / "weights" / "last.ckpt"
    resumed = PortSup(_sup_cfg(tmp_path, "resumed", resume=True,
                               weights=str(last)),
                      compute_dtype=torch.float32, device="cpu")
    saved = load_checkpoint(last)
    assert resumed.start_epoch == 2 and saved["meta"]["epoch"] == 1
    assert resumed.best_fitness == first.best_fitness
    st = resumed.state
    assert st.ema.updates == first.state.ema.updates == 2
    assert st.opt_step == first.state.opt_step == 2
    for k, v in st.model.named_parameters():
        assert torch.equal(v, saved["model"]["params"][k].float()), k
    for k, v in st.ema.module.named_parameters():
        assert torch.equal(v, saved["ema"]["params"][k].float()), k
    for (k, _), v in zip(st.model.named_parameters(), st.momentum_buf):
        assert torch.equal(v, first.state.momentum_buf[
            [n for n, _ in first.state.model.named_parameters()].index(k)])
    resumed.train()
    assert resumed.state.ema.updates == whole.state.ema.updates == 3
    assert resumed.state.opt_step == whole.state.opt_step == 3
    for what in ("model", "ema"):
        a = (resumed.state.model if what == "model"
             else resumed.state.ema.module).state_dict()
        b = (whole.state.model if what == "model"
             else whole.state.ema.module).state_dict()
        for k, v in b.items():
            if k.endswith("num_batches_tracked"):
                continue
            atol = 2e-3 * max(1.0, float(v.abs().max()))
            torch.testing.assert_close(a[k], v, rtol=0, atol=atol,
                                       msg=f"{what} {k}")
    rows = [np.loadtxt(t.results_csv, delimiter=",", skiprows=1, ndmin=2)
            for t in (whole, resumed)]
    np.testing.assert_array_equal(rows[1][:, 0], [2])
    np.testing.assert_allclose(rows[1][-1, 1:4], rows[0][-1, 1:4], rtol=2e-3)


def _target_batches(n, b, img, seed):
    """Unlabelled batches: one noise image as both views, identity M_s."""
    rng = np.random.default_rng(seed)
    m_s = np.zeros((b, 13), np.float32)
    m_s[:, 0] = np.arange(b)
    m_s[:, 1:10] = np.eye(3).ravel()
    m_s[:, 10] = 1.0
    out = []
    for _ in range(n):
        im = rng.integers(0, 256, (b, img, img, 3), dtype=np.uint8)
        out.append({"images": im, "images_ori": im.copy(), "M_s": m_s})
    return out


class PortSSOD(SSODTrainer):
    """The SSOD trainer on in-memory batches (2 labelled + 2 unlabelled
    steps of 4 images, accumulate 1, one val batch), on a network whose
    EMA gives pseudo labels (test_torch_trainer.py's conv x1.6,
    objectness +4, classes +2.5); each step's pseudo-label count kept."""

    def build_dataloader(self, cfg):
        ds = types.SimpleNamespace(mosaic=True)
        self.train_loader = Replay(_sup_batches(2, 4, 64, 0), ds)
        self.target_loader = Replay(_target_batches(2, 4, 64, 2))
        self.val_loader = Replay(_sup_batches(1, 4, 64, 1))
        self.dataset, self.nb = ds, 2

    def build_model(self, cfg):
        super().build_model(cfg)
        with torch.no_grad():
            for k, v in self.model.state_dict().items():
                if k.endswith("conv.weight"):
                    v.mul_(1.6)
                if k.startswith("head.m.") and k.endswith("bias"):
                    v.view(-1, 6)[:, 4] += 4.0
                    v.view(-1, 6)[:, 5:] += 2.5

    def build_step(self):
        super().build_step()
        step, self.pseudo = self.ssod_step, []

        def run(state, *args):
            state, out = step(state, *args)
            self.pseudo.append(int(out.pseudo_count))
            return state, out

        self.ssod_step = run


def _ssod_cfg(project, name, **kw):
    cfg = _sup_cfg(project, name, **kw)
    cfg.merge_from_list(["Dataset.batch_size", 4, "SSOD.train_domain", True,
                         "SSOD.nms_conf_thres", 0.1,
                         "SSOD.max_pseudo_labels", 16,
                         "SSOD.fixed_accumulate", True, "hyp.burn_epochs", 1,
                         "hyp.warmup_epochs", 0])
    return cfg


def test_ssod_resume_equals_an_uninterrupted_run(tmp_path):
    whole = PortSSOD(_ssod_cfg(tmp_path, "whole"),
                     compute_dtype=torch.float32, device="cpu")
    whole.train()
    first = PortSSOD(_ssod_cfg(tmp_path, "first"),
                     compute_dtype=torch.float32, device="cpu")
    first.epochs = 2  # burn-in, then one mean-teacher epoch
    first.train()
    last = first.save_dir / "weights" / "last.ckpt"
    saved = load_checkpoint(last)
    assert set(saved) == {"model", "ema", "student_ema", "optimizer", "meta"}
    assert saved["meta"]["has_optimizer"]
    assert "optimizer" not in load_checkpoint(
        first.save_dir / "weights" / "best.ckpt")
    resumed = PortSSOD(_ssod_cfg(tmp_path, "resumed", resume=True,
                                 weights=str(last)),
                       compute_dtype=torch.float32, device="cpu")
    st, was = resumed.state, first.state
    assert resumed.start_epoch == 2 and resumed.teacher_seeded
    assert st.ema.updates == was.ema.updates == 4
    assert st.semi_ema.updates == was.semi_ema.updates \
        == saved["meta"]["ema_updates"] == 2
    assert st.opt_step == was.opt_step == 4
    for what, module in (("model", st.model), ("ema", st.semi_ema.module),
                         ("student_ema", st.ema.module)):
        for k, v in module.named_parameters():
            assert torch.equal(v, saved[what]["params"][k].float()), (what, k)
    for a, b in zip(st.momentum_buf, was.momentum_buf):
        assert torch.equal(a, b)
    # each EMA is the one the first run left, to fp16 rounding (4.9e-4 of
    # the largest entry; the EMA and the semi-EMA are 3e-2 apart here)
    for a, b in ((st.ema, was.ema), (st.semi_ema, was.semi_ema)):
        for x, y in zip(a.params, b.params):
            torch.testing.assert_close(
                x, y, rtol=0, atol=1e-3 * max(1.0, float(y.abs().max())))
    resumed.train()
    assert resumed.state.ema.updates == whole.state.ema.updates == 6
    assert resumed.state.semi_ema.updates == whole.state.semi_ema.updates \
        == 4
    assert resumed.state.opt_step == whole.state.opt_step == 6
    assert resumed.pseudo == whole.pseudo[-2:] and min(resumed.pseudo) > 0
    for what in ("model", "ema", "semi_ema"):
        a, b = ((t.state.model if what == "model"
                 else getattr(t.state, what).module).state_dict()
                for t in (resumed, whole))
        for k, v in b.items():
            if k.endswith("num_batches_tracked"):
                continue
            atol = 2e-3 * max(1.0, float(v.abs().max()))
            torch.testing.assert_close(a[k], v, rtol=0, atol=atol,
                                       msg=f"{what} {k}")
    rows = [np.loadtxt(t.results_csv, delimiter=",", skiprows=1, ndmin=2)
            for t in (whole, resumed)]
    np.testing.assert_array_equal(rows[1][:, 0], [2])
    np.testing.assert_allclose(rows[1][-1, 1:4], rows[0][-1, 1:4], rtol=2e-3)


def test_graceful_stop_saves_a_resumable_checkpoint(tmp_path):
    trainer = PortSup(_sup_cfg(tmp_path, "stop", epochs=50),
                      compute_dtype=torch.float32, device="cpu")
    trainer.callbacks.register_action(
        "on_train_batch_end", "stop",
        lambda *a, **k: setattr(trainer.stop, "requested", True))
    trainer.train()
    assert trainer.state.step == 1  # one step ran
    path = trainer.save_dir / "weights" / "last.ckpt"
    ckpt = load_checkpoint(path)
    assert ckpt["meta"]["epoch"] == -1  # resume re-runs epoch 0
    assert "optimizer" in ckpt
    assert not (trainer.save_dir / "weights" / "best.ckpt").exists()
    again = PortSup(_sup_cfg(tmp_path, "again", epochs=50, resume=True,
                             weights=str(path)),
                    compute_dtype=torch.float32, device="cpu")
    assert again.start_epoch == 0


def test_graceful_stop_handler_sets_flag_and_uninstall_restores():
    stop = GracefulStop()
    prev = signal.getsignal(signal.SIGTERM)
    stop.install(signals=(signal.SIGTERM,))
    try:
        signal.raise_signal(signal.SIGTERM)
        assert stop.requested
    finally:
        stop.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev


@pytest.mark.parametrize("override,cls", [
    # the SSOD OTA loss, autoanchor, the YOLOv7 OTA loss, LabelMatch, AdamW,
    # the reference .pt (tests/test_torch_pt_bridge.py) and the keypoint
    # loss (tests/test_torch_keypoints.py) are ported now; what is still
    # refused: the SSOD losses of an anchor-free head (ROADMAP Q1.12)
    ({"Model.Head.name": "YoloX", "Loss.type": "ComputeXLoss"}, SSODTrainer),
])
def test_refuses_what_is_not_ported(tmp_path, override, cls):
    cfg = get_cfg()
    cfg.merge_from_list(TINY + ["project", str(tmp_path)])
    for k, v in override.items():
        cfg.merge_from_list([k, v])
    # in-memory loaders: the refusal comes after the loaders
    cls = {Trainer: PortSup, SSODTrainer: PortSSOD}[cls]
    with pytest.raises(NotImplementedError):
        cls(cfg, compute_dtype=torch.float32, device="cpu").train()


def test_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_cfg()
    cfg.merge_from_list(TINY + ["project", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Trainer(cfg)
    assert not any(tmp_path.iterdir())  # nothing was made

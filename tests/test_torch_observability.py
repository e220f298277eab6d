"""The port's loggers, plots and wandb artifacts (`utils/loggers.py`, `utils/plots.py`, `utils/wandb_artifacts.py`) against
the JAX package's, mirroring tests/test_observability.py and
tests/test_wandb_artifacts.py: the same inputs through both.

- results.csv: the rows are JAX's, character for character;
- TensorBoard (`torch.utils.tensorboard` here, tf.summary in JAX): the
  scalars read back with TensorBoard's own event reader, equal to what was
  logged (float32 in the event file);
- every plot writes the file JAX's writes, under the same name;
- wandb, against the stub module of tests/test_wandb_artifacts.py: the
  artifacts, their files, metadata and aliases are JAX's;
- gating: without torch.utils.tensorboard the loggers skip TensorBoard;
  without matplotlib a plot raises ImportError naming it.
"""

import sys
import types
from pathlib import Path

import cv2
import numpy as np
import pytest

from efficientteacher_tpu.utils import loggers as jax_loggers
from efficientteacher_tpu.utils import plots as jax_plots
from efficientteacher_tpu.utils import wandb_artifacts as jax_wa
from efficientteacher_torch.utils import loggers, plots, wandb_artifacts
from efficientteacher_torch.utils.callbacks import Callbacks

METRICS = [({"train/box_loss": 0.5, "metrics/mAP_0.5": 0.3,
             "metrics/precision": 0.125, "x/lr0": 0.01}, 0),
           ({"train/box_loss": 0.4, "metrics/mAP_0.5": 0.4,
             "metrics/precision": 0.25, "x/lr0": 0.0099}, 1)]


def test_results_csv_equals_jax(tmp_path):
    for name, mod in (("port", loggers), ("jax", jax_loggers)):
        (tmp_path / name).mkdir()
        lg = mod.Loggers(tmp_path / name, include=("csv",))
        cb = Callbacks()
        lg.register(cb)
        for m, epoch in METRICS:
            cb.run("on_fit_epoch_end", m, epoch)
        cb.run("on_train_end")
    got = (tmp_path / "port" / "results.csv").read_text()
    assert got == (tmp_path / "jax" / "results.csv").read_text()
    assert got.splitlines()[0].startswith("epoch,train/box_loss")
    assert len(got.splitlines()) == 3


def test_tensorboard_scalars_read_back(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    lg = loggers.Loggers(tmp_path, include=("tb",))
    assert lg.tb is not None
    for m, epoch in METRICS:
        lg.on_fit_epoch_end(m, epoch)
    lg.on_train_batch_end({"loss": 1.5}, step=7)
    lg.on_train_end()
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    for k in METRICS[0][0]:
        got = [(e.step, e.value) for e in acc.Scalars(k)]
        assert got == [(epoch, float(np.float32(m[k])))
                       for m, epoch in METRICS]
    assert [(e.step, e.value) for e in acc.Scalars("batch/loss")] == \
        [(7, 1.5)]


def test_loggers_skip_tensorboard_without_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    lg = loggers.Loggers(tmp_path, include=("csv", "tb"))
    assert lg.tb is None
    lg.on_fit_epoch_end(*METRICS[0])
    assert (tmp_path / "results.csv").exists()


def _plot_inputs():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (4, 64, 64, 3), np.uint8)
    lab = np.zeros((4, 3, 6), np.float32)
    lab[:, 0] = [1, 0.5, 0.5, 0.4, 0.4, 0.9]
    mask = np.zeros((4, 3), bool)
    mask[:, 0] = True
    pl = np.zeros((2, 4, 8), np.float32)
    plm = np.zeros((2, 4), bool)
    pl[0, 0] = [1, 0.5, 0.5, 0.3, 0.3, 0.9, 0.95, 0.9]
    plm[0, 0] = True
    gt = np.zeros((2, 4, 5), np.float32)
    gtm = np.zeros((2, 4), bool)
    gt[0, 0] = [1, 0.52, 0.48, 0.3, 0.3]
    gtm[0, 0] = True
    feats = [rng.random((1, 8 // 2 ** i, 8 // 2 ** i, 16)) for i in range(2)]
    px = np.linspace(0, 1, 1000)
    py = [np.linspace(1, 0, 1000), np.linspace(0.8, 0.1, 1000)]
    ap = np.array([[0.5] * 10, [0.25] * 10])
    cm = np.zeros((4, 4))
    cm[0, 0], cm[1, 2], cm[3, 1] = 10, 3, 2
    return images, lab, mask, pl, plm, gt, gtm, feats, px, py, ap, cm


def _all_plots(mod, d: Path):
    images, lab, mask, pl, plm, gt, gtm, feats, px, py, ap, cm = \
        _plot_inputs()
    mod.plot_labels([lab[0, :1, :5], lab[1, :1, :5]], nc=2, save_dir=d)
    mod.plot_images(images, lab, mask, d / "batch.png", with_scores=True)
    mod.plot_pr_curve(px, py, ap, d / "PR_curve.png", names=["a", "b"])
    mod.plot_mc_curve(px, np.stack(py), d / "F1_curve.png", names=["a", "b"],
                      ylabel="F1")
    mod.plot_confusion_matrix(cm, d / "cm.png", names=["a", "b", "c"])
    mod.plot_pseudo_vs_gt(images[:2], pl, plm, gt, gtm, d / "pg.png")
    (d / "results.csv").write_text("epoch,a,b\n0,1.0,2.0\n1,0.5,1.5\n")
    mod.plot_results(d / "results.csv")
    mod.feature_visualization(feats, d / "fv.png", max_maps=8)


def test_every_plot_writes_jax_files(tmp_path):
    _all_plots(plots, tmp_path / "port")
    _all_plots(jax_plots, tmp_path / "jax")
    got = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert got == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert got == sorted(["labels.png", "batch.png", "PR_curve.png",
                          "F1_curve.png", "cm.png", "pg.png", "results.csv",
                          "results.png", "fv_p3.png", "fv_p4.png"])
    for name in got:
        if name.endswith(".png"):
            img = cv2.imread(str(tmp_path / "port" / name))
            assert img is not None and img.std() > 0, name


def test_plots_without_matplotlib_raise(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plots.plot_results(tmp_path / "results.csv")


# -- wandb, against tests/test_wandb_artifacts.py's stub ---------------------

class _StubArtifact:
    def __init__(self, name, type=None, metadata=None):
        self.name = name
        self.type = type
        self.metadata = metadata or {}
        self.files = {}
        self.tables = {}
        self._download_dir = None

    def add_file(self, path, name=None):
        self.files[name or Path(path).name] = str(path)

    def add(self, obj, name):
        self.tables[name] = obj

    def download(self):
        return self._download_dir


class _StubTable:
    def __init__(self, columns):
        self.columns = columns
        self.rows = []

    def add_data(self, *row):
        self.rows.append(row)


class _StubImage:
    def __init__(self, path):
        self.path = path


class _StubRun:
    def __init__(self):
        self.id = "run123"
        self.logged = []
        self.used = {}

    def log_artifact(self, art, aliases=None):
        self.logged.append((art, aliases or []))

    def use_artifact(self, name):
        return self.used[name]


@pytest.fixture()
def stub_wandb(monkeypatch):
    mod = types.ModuleType("wandb")
    mod.Artifact = _StubArtifact
    mod.Table = _StubTable
    mod.Image = _StubImage
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


def _logged(run):
    return [(a.name, a.type, a.metadata, sorted(a.files), aliases,
             {k: (t.columns, [r[0] for r in t.rows] + [r[2] for r in t.rows])
              for k, t in a.tables.items()})
            for a, aliases in run.logged]


def test_artifact_path_helpers_equal_jax():
    for p in ("wandb-artifact://me/proj/run_1_model:best",
              "runs/train/exp/weights/best.ckpt", "wandb-artifact://a/b/c",
              "last.ckpt"):
        for fn in ("is_artifact_path", "check_wandb_resume"):
            assert getattr(wandb_artifacts, fn)(p) == getattr(jax_wa, fn)(p)
        if wandb_artifacts.is_artifact_path(p):
            assert wandb_artifacts.remove_prefix(p) == jax_wa.remove_prefix(p)


def test_artifacts_equal_jax(stub_wandb, tmp_path):
    from efficientteacher_torch.data.image_io import imwrite

    img_dir, lab_dir = tmp_path / "images", tmp_path / "labels"
    img_dir.mkdir()
    lab_dir.mkdir()
    paths = []
    for i in range(3):
        p = img_dir / f"i{i}.jpg"
        imwrite(str(p), np.full((32, 32, 3), 80, np.uint8))
        (lab_dir / f"i{i}.txt").write_text("0 0.5 0.5 0.2 0.2\n")
        paths.append(str(p))
    lst = tmp_path / "train.txt"
    lst.write_text("\n".join(paths))
    ckpt = tmp_path / "weights" / "best.ckpt"
    ckpt.parent.mkdir()
    ckpt.write_bytes(b"x" * 16)
    dl = tmp_path / "dl"
    dl.mkdir()
    (dl / "last.ckpt").write_bytes(b"y")
    runs = {}
    for name, mod, lmod in (("port", wandb_artifacts, loggers),
                            ("jax", jax_wa, jax_loggers)):
        run = _StubRun()
        art = _StubArtifact("run_run123_model", metadata={"epoch": 9})
        art._download_dir = str(dl)
        run.used["me/proj/run_run123_model:latest"] = art
        wa = mod.WandbArtifacts(run)
        assert wa.log_model(ckpt, epoch=4, fitness=0.7, best=True)
        assert not wa.log_model(tmp_path / "nope.ckpt", 0, 0.0, wait_s=0.05)
        path, meta = wa.download_model_artifact(
            "wandb-artifact://me/proj/run_run123_model")
        assert path.name == "last.ckpt" and meta == {"epoch": 9}
        assert wa.log_dataset_artifact(lst, name="synth", names=["a"])
        lg = lmod.Loggers(tmp_path / name, include=("csv",))
        lg.wandb_artifacts = wa
        lg.on_model_save(ckpt, epoch=2, fitness=0.5, name="best.ckpt")
        runs[name] = _logged(run)
    assert runs["port"] == runs["jax"]
    assert runs["port"][0][4] == ["latest", "epoch 5", "best"]

"""The port's supervised `Trainer` on the anchor-free families' YAMLs
(`configs/sup/public/yolox_coco.yaml`, `yolov8m_coco.yaml`) against the
JAX package's: each YAML shrunk to the SiLU test network (width 0.125,
depth 0.34, nc 1, 128 px), batch 4, warmup over the first 2 iterations,
each trainer with its own host-augmented loaders (JAX's process engine,
the port's threads) over one seeded dataset on disk. YOLOX trains 2
epochs with `hyp.no_aug_epochs 1`, so its second epoch is the no-aug
tail that closes mosaic and turns on the L1 term; YOLOv8 trains 1 epoch.

Unlike tests/test_torch_trainer_sup.py's YOLOv5s run, each port step
starts from the JAX trainer's state before the same step (carried by
`train_state_from_jax`): SimOTA and TAL assign from the predictions, so
two runs that drift by float32 rounding (flax's one-pass train-mode
variance, ROADMAP Queue 3 "Justified") reassign anchors within a few
steps and part ways (measured: a 5e-4 loss difference at the second step,
10% of the accumulated gradient by the fourth). From one state, one step
is well posed.

Held exactly: the images and labels each step receives, the schedule,
the counters, the loss parts' names (L1 only in the tail) and the
results.csv epochs. Held to a tolerance: each step's losses rtol 1e-3
(1.3e-4 measured),
the state after each step 2e-3 of each tensor's largest entry (the
gradient-made buffers 2e-2: 4e-3 measured after one step), the
validation results and fitness atol 1e-4.

Also: JAX's ValueError on an anchor-free loss with an anchor head, the
refusals that remain (YOLOv6 / YOLOv7 YAMLs, the YOLOv7 OTA loss, the SSOD
trainer on an anchor-free head: ROADMAP Q1.10), and `cli.train` /
`cli.val` with `device cpu` on each YAML shrunk, cli.val equal to
`validator.run` on best.ckpt and on a copy whose scores are raised so it
detects."""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.configs import get_cfg as jax_get_cfg
from efficientteacher_tpu.train.train_state import (
    create_train_state as jax_create_train_state)
from efficientteacher_tpu.utils import loggers as jax_loggers
from efficientteacher_torch.cli import train as cli_train
from efficientteacher_torch.cli import val as cli_val
from efficientteacher_torch.configs import get_cfg
from efficientteacher_torch.data.datasets import create_dataloader
from efficientteacher_torch.eval import validator
from efficientteacher_torch.models import build_model, spec_from_cfg
from efficientteacher_torch.train.from_jax import train_state_from_jax
from efficientteacher_torch.train.ssod_trainer import SSODTrainer
from efficientteacher_torch.train.trainer import Trainer
from efficientteacher_torch.utils.checkpoint import (load_eval_variables,
                                                     load_module_variables,
                                                     module_variables,
                                                     save_checkpoint)
from efficientteacher_torch.utils.eval_regimes import shift_score_bias
from test_torch_datasets import write_dataset
from test_torch_trainer_resume import TINY, PortSup
from test_torch_trainer_sup import SIZES, JaxSup
from torch_port_helpers import assert_states, to_jax_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
YAMLS = {"yolox": REPO / "configs/sup/public/yolox_coco.yaml",
         "yolov8": REPO / "configs/sup/public/yolov8m_coco.yaml"}
EPOCHS = {"yolox": 2, "yolov8": 1}
SHRINK = ["Model.width_multiple", 0.125, "Model.depth_multiple", 0.34,
          "Dataset.nc", 1, "Dataset.img_size", 128, "Dataset.max_targets",
          16]


def _overrides(family, lst, project):
    return SHRINK + [
        "Dataset.train", lst, "Dataset.val", lst, "Dataset.batch_size", 4,
        "Dataset.loader", "process", "Dataset.workers", 2,
        "hyp.warmup_epochs", 1, "hyp.scale", 0.5, "hyp.no_aug_epochs", 1,
        "epochs", EPOCHS[family], "project", str(project)]


class Recording:
    """A trainer that logs each iteration's schedule and each step's loss
    parts, images, labels and its state before and after (as numpy trees
    for JAX, copies for the port), also across `build_step` (the YOLOX
    tail rebuilds the step). With `forced` (JAX's states before each
    step), each step starts from the JAX state instead of its own."""

    forced = None

    def __init__(self, *args, **kw):
        self.log = {"sched": [], "steps": [], "images": [], "labels": [],
                    "before": [], "after": []}
        super().__init__(*args, **kw)
        schedule = self._schedule

        def sched(ni):
            s = schedule(ni)
            self.log["sched"].append(
                (ni, *map(np.float32, (s.lr_bias, s.lr_rest, s.momentum)),
                 int(s.accumulate)))
            return s

        self._schedule = sched

    def snapshot(self, state):
        return jax.tree_util.tree_map(np.asarray, state)

    def build_step(self):
        super().build_step()
        step = self.train_step

        def run(state, images, labels, mask, sched_):
            if self.forced is not None:
                state = train_state_from_jax(
                    self.forced[len(self.log["steps"])], self.model)
            self.log["before"].append(self.snapshot(state))
            self.log["images"].append(np.asarray(images).copy())
            self.log["labels"].append(np.asarray(labels)[np.asarray(mask)])
            state, parts = step(state, images, labels, mask, sched_)
            self.log["steps"].append(
                (self.epoch, {k: float(v) for k, v in parts.items()}))
            self.log["after"].append(self.snapshot(state))
            return state, parts

        self.train_step = run


class JaxZoo(Recording, JaxSup):
    pass


class PortZoo(Recording, Trainer):
    def snapshot(self, state):
        return None if self.forced is None else copy.deepcopy(state)


@pytest.fixture(scope="module", params=["yolox", "yolov8"])
def zoo_runs(request, tmp_path_factory):
    family = request.param
    tmp = tmp_path_factory.mktemp(family)
    lst = write_dataset(tmp / "data", SIZES, seed=22, nc=1, name="train",
                        blur=False)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(str(YAMLS[family]))
    jcfg.merge_from_list(_overrides(family, lst, tmp / "jax"))
    jcfg.freeze()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loggers, "Loggers", None)
        jt = JaxZoo(jcfg, compute_dtype=jnp.float32)
    pcfg = get_cfg()
    pcfg.merge_from_file(str(YAMLS[family]))
    pcfg.merge_from_list(_overrides(family, lst, tmp / "port")
                         + ["Dataset.loader", "thread"])
    pcfg.freeze()
    pt = PortZoo(pcfg, compute_dtype=torch.float32, device="cpu")
    variables = to_jax_variables(
        pt.model.state_dict(), {"params": jt.state.params,
                                "batch_stats": jt.state.batch_stats})
    jt.mesh = None
    jt.state = jax_create_train_state(variables["params"],
                                      variables["batch_stats"], jt.opt_cfg,
                                      with_ema=True)
    jt.train()
    pt.forced = jt.log["before"]
    pt.train()
    return family, jt, pt


def test_zoo_batches_schedule_and_counters_exact(zoo_runs):
    family, jt, pt = zoo_runs
    j, p = jt.log, pt.log
    assert pt.train_loader.ds.augment and jt.train_loader.ds.augment
    assert len(p["images"]) == len(j["images"]) == 2 * EPOCHS[family]
    for a, b in zip(p["images"], j["images"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(p["labels"], j["labels"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert p["sched"] == j["sched"]
    assert pt.state.ema.updates == int(jt.state.ema.updates)
    assert pt.state.opt_step == int(jt.state.opt.step)


def test_zoo_state_after_each_step_within_tolerance(zoo_runs):
    family, jt, pt = zoo_runs
    for got, want in zip(pt.log["after"], jt.log["after"], strict=True):
        assert_states(got, train_state_from_jax(
            want, copy.deepcopy(pt.model)), tol=2e-3, grad_tol=2e-2)


def test_zoo_losses_and_results_within_tolerance(zoo_runs):
    family, jt, pt = zoo_runs
    names = {"yolox": {"iou", "obj", "cls", "loss"},
             "yolov8": {"box", "cls", "dfl", "loss"}}[family]
    for (ep, got), (jep, want) in zip(pt.log["steps"], jt.log["steps"],
                                      strict=True):
        assert ep == jep
        # YOLOX's no-aug tail (the last epoch) adds the L1 term
        tail = family == "yolox" and ep == EPOCHS[family] - 1
        assert set(got) == set(want) == names | ({"l1"} if tail else set())
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                       atol=1e-7, err_msg=k)
    rows = {}
    for name, t in (("jax", jt), ("port", pt)):
        lines = t.results_csv.read_text().splitlines()
        rows[name] = np.array([[float(x) for x in line.split(",")]
                               for line in lines[1:]])
    np.testing.assert_array_equal(rows["port"][:, 0],
                                  np.arange(EPOCHS[family]))
    np.testing.assert_array_equal(rows["port"][:, 0], rows["jax"][:, 0])
    np.testing.assert_allclose(rows["port"][:, 1:4], rows["jax"][:, 1:4],
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(rows["port"][:, 4:], rows["jax"][:, 4:],
                               rtol=0, atol=1e-4)
    if family == "yolox":
        assert not pt.dataset.mosaic and pt.yolox_cfg.use_l1


def _tiny(override):
    cfg = get_cfg()
    cfg.merge_from_list(TINY)
    for k, v in override.items():
        cfg.merge_from_list([k, v])
    return cfg


@pytest.mark.parametrize("loss", ["ComputeXLoss", "ComputeFastXLoss",
                                  "ComputeTalLoss"])
def test_anchor_free_loss_with_an_anchor_head_raises_value_error(
        tmp_path, loss):
    cfg = _tiny({"Loss.type": loss, "project": str(tmp_path)})
    with pytest.raises(ValueError, match="anchor-free but head 'YoloV5'"):
        PortSup(cfg, compute_dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("yaml_name,cls", [
    ("yolov6s_coco.yaml", Trainer),
    ("yolov6s_coco_repopt_finetune.yaml", Trainer),
    ("yolov7l_coco.yaml", Trainer),
    ("yolov7s_coco_simota.yaml", Trainer),
    ("yolox_coco.yaml", SSODTrainer),
])
def test_unported_families_raise_naming_the_roadmap(tmp_path, yaml_name, cls):
    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / "configs/sup/public" / yaml_name))
    cfg.merge_from_list(["project", str(tmp_path), "Dataset.img_size", 64,
                         "Model.width_multiple", 0.125, "noautoanchor",
                         True])
    with pytest.raises(NotImplementedError, match="ROADMAP Q1.10"):
        type("T", (cls,), {"build_dataloader": PortSup.build_dataloader})(
            cfg, compute_dtype=torch.float32, device="cpu")


def test_yolov7_ota_loss_still_raises(tmp_path):
    cfg = _tiny({"Loss.type": "ComputeLoss", "Loss.assigner_type": "SimOTA",
                 "project": str(tmp_path)})
    with pytest.raises(NotImplementedError, match="ROADMAP Q1.10"):
        PortSup(cfg, compute_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module", params=["yolox", "yolov8"])
def cli_run(request, tmp_path_factory):
    family = request.param
    root = tmp_path_factory.mktemp(f"cli_{family}")
    lst = write_dataset(root / "d", SIZES[:4], seed=5, nc=1, name="train")
    overrides = [str(x) for x in SHRINK + [
        "device", "cpu", "project", root / "runs", "name", family,
        "epochs", 1, "Dataset.train", lst, "Dataset.val", lst,
        "Dataset.batch_size", 2, "Dataset.workers", 2]]
    cli_train.main(["--cfg", str(YAMLS[family]), *overrides])
    weights = root / "runs" / family / "weights"
    model = _model(family, overrides, weights / "best.ckpt")
    shift_score_bias(model.head, 8.0)
    if family == "yolov8":
        # the init's equal bins put every box side 8 strides out; one bin
        # raised makes boxes of two strides, the labels' sizes
        with torch.no_grad():
            for i in range(3):
                getattr(model.head, f"cv2_{i}")[2].bias.view(4, 17)[:, 1] \
                    += 10.0
    v = module_variables(model)
    save_checkpoint(weights / "shifted.ckpt", params=v["params"],
                    batch_stats=v["batch_stats"], ema_params=v["params"],
                    ema_batch_stats=v["batch_stats"])
    return family, overrides, weights


def _model(family, overrides, weights):
    cfg = get_cfg()
    cfg.merge_from_file(str(YAMLS[family]))
    cfg.merge_from_list(overrides)
    model = build_model(spec_from_cfg(cfg), device="cpu")
    load_module_variables(model, load_eval_variables(str(weights)))
    return model.eval()


@pytest.mark.parametrize("ckpt", ["best.ckpt", "shifted.ckpt"])
def test_cli_train_and_val_on_the_yaml(cli_run, ckpt):
    family, overrides, weights = cli_run
    rows = (weights.parent / "results.csv").read_text().splitlines()
    assert len(rows) == 2 and (weights / "last.ckpt").is_file()
    got = cli_val.main(["--cfg", str(YAMLS[family]), "--weights",
                        str(weights / ckpt), "--batch-size", "2",
                        *overrides])
    cfg = get_cfg()
    cfg.merge_from_file(str(YAMLS[family]))
    cfg.merge_from_list(overrides)
    loader = create_dataloader(cfg, "val", augment=False, batch_size=2)
    model = _model(family, overrides, weights / ckpt)
    want = validator.run(model, loader, nc=1,
                         compute_dtype=torch.float32)[0]
    assert got == want and all(np.isfinite(got))
    if ckpt == "shifted.ckpt":
        assert got[1] > 0  # detections that match the labels

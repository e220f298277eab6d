"""The port's trainers (`efficientteacher_torch/train/trainer.py`,
`ssod_trainer.py`) against the JAX package's.

The SSOD run: the synthetic set of tests/test_e2e_ssod.py (8 labelled
images, 8 unlabelled), width 0.125 / depth 0.34, nc 1, 128 px, batch 4,
1 burn-in epoch + 2 mean-teacher epochs with epoch-end validation, warmup
over the first 3 iterations. The batches are recorded once from the JAX
trainer's own loaders (with seeded noise on the images: `_add_noise`) and
replayed to both trainers every epoch, and both
start from one state (the port's seeded init carried to JAX, and back by
`train_state_from_jax`). The network is the SiLU model of
tests/test_torch_ssod.py (conv kernels x1.6, objectness biases
+4, class biases +2.5: a teacher that gives pseudo labels and does not
collapse in eval mode), in float32.

Held exactly: the per-iteration schedule (lr_bias, lr_rest, momentum,
accumulate), which step ran at each iteration (so the seeding iteration),
the EMA and semi-EMA update counts, the per-epoch semi-EMA decay, the
results.csv epochs, the checkpoints' meta (but for the port's optimizer
state in the SSOD last.ckpt) and pseudo labels per step.
Held to a tolerance: the logged losses, rtol 1e-3 (measured 2.2e-4); the
validation results, atol 1e-4 (measured 1e-6); the final state,
parameters, statistics and EMAs 2e-3 and momentum 2e-2 of each tensor's
largest entry (measured 1.1e-3 and 1.3e-2). The limit is flax's
train-mode batch variance (E[x^2] - E[x]^2, test_torch_ssod.py),
compounded over 6 steps.
The port-only trainer tests (resume, graceful stop, refused options) are
in test_torch_trainer_resume.py."""

import copy
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from efficientteacher_tpu.configs import get_cfg as jax_get_cfg
from efficientteacher_tpu.models import build_model as jax_build_model
from efficientteacher_tpu.models.spec import spec_from_cfg as jax_spec_from_cfg
from efficientteacher_tpu.train.ssod_step import (
    create_ssod_train_state as jax_create_ssod_state)
from efficientteacher_tpu.train.ssod_trainer import (
    SSODTrainer as JaxSSODTrainer)
from efficientteacher_tpu.utils import loggers as jax_loggers
from efficientteacher_torch.configs import get_cfg
from efficientteacher_torch.train.from_jax import train_state_from_jax
from efficientteacher_torch.train.ssod_trainer import SSODTrainer
from efficientteacher_torch.utils.checkpoint import load_checkpoint

from test_e2e_ssod import ssod_data  # noqa: F401  (the synthetic set)
from torch_port_helpers import assert_states, to_jax_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

TINY = ["Model.Backbone.name", "YoloV5", "Model.Neck.name", "YoloV5",
        "Model.Head.name", "YoloV5", "Model.Backbone.activation", "SiLU",
        "Model.Neck.activation", "SiLU",
        "Model.Neck.in_channels", [256, 512, 1024],
        "Model.Neck.out_channels", [256, 512, 1024],
        "Model.width_multiple", 0.125, "Model.depth_multiple", 0.34,
        "Loss.type", "ComputeLoss", "Dataset.nc", 1,
        "Dataset.img_size", 128, "Dataset.max_targets", 16,
        "Dataset.workers", 1]


class JaxSSOD(JaxSSODTrainer):
    def build_model(self, cfg):
        """The JAX SSOD trainer's build_model with zeros of the variables'
        shapes for weights (`jax.eval_shape`: flax's eager init compiles
        every initializer apart, ~40 s here). The test sets the weights."""
        self.spec = jax_spec_from_cfg(cfg)
        self.model = jax_build_model(self.spec, ssod=True,
                                     dtype=self.compute_dtype)
        x0 = jnp.zeros((1, self.img_size, self.img_size, 3),
                       self.compute_dtype)
        shapes = jax.eval_shape(lambda key: self.model.init(
            key, x0, train=False), jax.random.PRNGKey(0))
        v = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                   shapes)
        self._init_params, self._init_bs = v["params"], v["batch_stats"]
        self.grad_masks = None
        s = np.asarray(self.spec.strides, np.float32)[:, None, None]
        self.anchors_grid = (np.asarray(self.spec.anchors, np.float32)
                             .reshape(self.spec.nl, -1, 2) / s)


class Replay(list):
    """Recorded batches with the BatchLoader surface (`len`, `.ds`)."""

    def __init__(self, batches, ds=None):
        super().__init__(batches)
        self.ds = ds


def _ssod_overrides(root, project):
    return TINY + [
        "SSOD.train_domain", True, "SSOD.nms_conf_thres", 0.1,
        "SSOD.max_pseudo_labels", 16, "SSOD.teacher_loss_weight", 0.5,
        "SSOD.epoch_adaptor", True, "SSOD.fixed_accumulate", True,
        "hyp.burn_epochs", 1,
        "hyp.warmup_epochs", 1, "hyp.mosaic", 0.5,
        "Dataset.train", str(root / "train.txt"),
        "Dataset.val", str(root / "train.txt"),
        "Dataset.target", str(root / "target.txt"),
        "Dataset.batch_size", 4, "epochs", 3, "project", str(project)]


def _add_noise(batches, seed=0):
    """Seeded noise of +-60 on every recorded image, in place. The set's
    flat gray images make flax's train-mode variance E[x^2] - E[x]^2 lose
    its digits in the deep layers (gradients 55% apart after one step);
    with the noise they agree to 3e-4 of each tensor's largest entry."""
    rng = np.random.default_rng(seed)
    for loader in batches.values():
        for b in loader:
            for k in ("images", "images_ori"):
                if k in b:
                    noise = rng.integers(-60, 61, b[k].shape)
                    b[k] = np.clip(b[k] + noise, 0, 255).astype(np.uint8)


def _teacher_weights(model):
    """The non-collapsing SiLU network of test_torch_ssod.py, in place."""
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("conv.weight"):
                v.mul_(1.6)
            if k.startswith("head.m.") and k.endswith("bias"):
                v.view(-1, 6)[:, 4] += 4.0
                v.view(-1, 6)[:, 5:] += 2.5


def _record(trainer, log):
    """Log each iteration's schedule and step, and each epoch's semi-EMA
    decay, of `trainer`."""
    schedule = trainer._schedule

    def sched(ni):
        s = schedule(ni)
        # float32, as the JAX Schedule holds them
        log["sched"].append((ni, *map(np.float32, (s.lr_bias, s.lr_rest,
                                                   s.momentum)),
                             int(s.accumulate)))
        return s

    trainer._schedule = sched
    for kind in ("burn_step", "ssod_step"):
        step = getattr(trainer, kind)

        def run(state, *args, _step=step, _kind=kind):
            state, out = _step(state, *args)
            metrics = out if _kind == "burn_step" else out.metrics
            row = {k: float(v) for k, v in metrics.items()}
            if _kind == "ssod_step":
                row["pseudo"] = int(out.pseudo_count)
            log["steps"].append((_kind, row))
            return state, out

        setattr(trainer, kind, run)
    trainer.callbacks.register_action(
        "on_train_epoch_start",
        callback=lambda: log["decay"].append(trainer._semi_decay()))


@pytest.fixture(scope="module")
def ssod_runs(ssod_data, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("trainers")
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(_ssod_overrides(ssod_data, tmp / "jax"))
    jcfg.freeze()
    with pytest.MonkeyPatch.context() as mp:
        # the JAX trainer's optional TensorBoard logger is not under test
        # (its import pulls in TensorFlow: ~10 s)
        mp.setattr(jax_loggers, "Loggers", None)
        jt = JaxSSOD(jcfg, compute_dtype=jnp.float32)
    batches = {k: Replay(list(getattr(jt, k)), getattr(jt, k).ds)
               for k in ("train_loader", "target_loader", "val_loader")}
    _add_noise(batches)
    ds = batches["train_loader"].ds

    class PortSSOD(SSODTrainer):
        def build_dataloader(self, cfg):
            for k, v in batches.items():
                setattr(self, k, v)
            self.dataset, self.nb = ds, len(batches["train_loader"])

    pcfg = get_cfg()
    pcfg.merge_from_list(_ssod_overrides(ssod_data, tmp / "port"))
    pcfg.freeze()
    pt = PortSSOD(pcfg, compute_dtype=torch.float32, device="cpu")

    # one state on both sides (one device): the port's seeded init, made a
    # teacher, carried to JAX and back
    model = pt.model
    _teacher_weights(model)
    variables = to_jax_variables(
        model.state_dict(), {"params": jt.state.params,
                             "batch_stats": jt.state.batch_stats})
    jt.mesh = None
    jt.state = jax_create_ssod_state(variables["params"],
                                     variables["batch_stats"], jt.opt_cfg)
    pt.state = train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jt.state), model)
    for k, v in batches.items():
        setattr(jt, k, v)
    logs = {}
    for name, t in (("jax", jt), ("port", pt)):
        logs[name] = {"sched": [], "steps": [], "decay": []}
        _record(t, logs[name])
        t.train()
    return jt, pt, logs


def test_ssod_schedule_dispatch_and_counters_exact(ssod_runs):
    jt, pt, logs = ssod_runs
    j, p = logs["jax"], logs["port"]
    assert p["sched"] == j["sched"]
    assert [s[-1] for s in p["sched"]] == [1, 6, 11, 16, 1, 1]
    assert [k for k, _ in p["steps"]] == [k for k, _ in j["steps"]] == \
        ["burn_step"] * 2 + ["ssod_step"] * 4
    assert p["decay"] == j["decay"]
    assert jt.teacher_seeded and pt.teacher_seeded
    assert pt.state.ema.updates == int(jt.state.ema.updates) == 3
    assert pt.state.semi_ema.updates == int(jt.state.semi_ema.updates) == 2
    assert pt.state.opt_step == int(jt.state.opt.step)
    assert [r["pseudo"] for k, r in p["steps"] if k == "ssod_step"] == \
        [r["pseudo"] for k, r in j["steps"] if k == "ssod_step"]
    assert min(r["pseudo"] for k, r in p["steps"] if k == "ssod_step") > 0
    want = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jt.state),
                                copy.deepcopy(pt.model))
    assert_states(pt.state, want, tol=2e-3, grad_tol=2e-2)


def test_ssod_losses_and_results_within_tolerance(ssod_runs):
    jt, pt, logs = ssod_runs
    for (_, got), (_, want) in zip(logs["port"]["steps"],
                                   logs["jax"]["steps"]):
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-7,
                                       err_msg=k)
    rows = {}
    for name, t in (("jax", jt), ("port", pt)):
        lines = t.results_csv.read_text().splitlines()
        rows[name] = np.array([[float(x) for x in line.split(",")]
                               for line in lines[1:]])
        assert lines[0] == "epoch,train/box_loss,train/obj_loss," \
            "train/cls_loss,metrics/precision,metrics/recall," \
            "metrics/mAP_0.5,metrics/mAP_0.5:0.95,val/fitness,lr"
    np.testing.assert_array_equal(rows["port"][:, 0], [0, 1, 2])
    np.testing.assert_array_equal(rows["port"][:, 0], rows["jax"][:, 0])
    np.testing.assert_allclose(rows["port"][:, 1:4], rows["jax"][:, 1:4],
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(rows["port"][:, 4:], rows["jax"][:, 4:],
                               rtol=0, atol=1e-4)
    assert rows["port"][:, 6].max() > 0  # a teacher that detects


def test_ssod_checkpoint_meta_equal(ssod_runs):
    jt, pt, _ = ssod_runs
    for name in ("last.ckpt", "best.ckpt"):
        metas = [json.loads((t.save_dir / "weights" / f"{name}.json")
                            .read_text()) for t in (jt, pt)]
        cfgs = [yaml.safe_load(m.pop("cfg")) for m in metas]
        for c in cfgs:
            c.pop("project")
        assert cfgs[0] == cfgs[1]
        jm, pm = metas
        assert pm.pop("best_fitness") == pytest.approx(
            jm.pop("best_fitness"), abs=1e-4)
        # the port's SSOD last.ckpt keeps the optimizer state for its
        # resume, which the JAX SSOD trainer does not have
        assert pm.pop("has_optimizer") == (name == "last.ckpt")
        assert not jm.pop("has_optimizer")
        assert pm == jm and pm["epoch"] in (0, 1, 2) and pm["has_ema"]
    ckpt = load_checkpoint(pt.save_dir / "weights" / "last.ckpt")
    assert ckpt["meta"]["epoch"] == 2
    assert ckpt["student_ema"]["updates"] == pt.state.ema.updates
    teacher = {k: v.half() for k, v in
               pt.state.semi_ema.module.named_parameters()}
    for k, v in ckpt["ema"]["params"].items():
        assert torch.equal(v, teacher[k]), k


@pytest.mark.parametrize("device_aug,autoaugment,with_gt,warns", [
    pytest.param(True, 0.5, True, True, id="True-0.5-True"),
    pytest.param(True, 0.0, True, False, id="True-0.0-False"),
    pytest.param(False, 0.5, True, False, id="False-0.5-False"),
    pytest.param(True, 0.5, False, False, id="True-0.5-nolabels-False")])
def test_ssod_set_env_warns_that_autoaugment_is_dropped(
        tmp_path, caplog, device_aug, autoaugment, with_gt, warns):
    """Under Dataset.device_aug the strong view has no AutoAugment (as in
    JAX); set_env says so once, naming the ROADMAP item, where the host
    route would apply it: only to a target with labels (ssod_hyp.with_gt
    here, or SSOD.debug). Without them neither route applies it (the main
    YAML), and nothing is said."""
    from efficientteacher_torch.configs import get_cfg as port_get_cfg
    from efficientteacher_torch.train.ssod_trainer import SSODTrainer

    cfg = port_get_cfg()
    cfg.project, cfg.name = str(tmp_path), "env"
    cfg.noautoanchor = True
    cfg.Dataset.device_aug = device_aug
    cfg.SSOD.ssod_hyp.autoaugment = autoaugment
    cfg.SSOD.ssod_hyp.with_gt = with_gt
    trainer = SSODTrainer.__new__(SSODTrainer)
    trainer.device = torch.device("cpu")
    with caplog.at_level(logging.WARNING,
                         logger="efficientteacher_torch.train.ssod_trainer"):
        trainer.set_env(cfg)
    trainer.checkpointer.wait()
    found = [r for r in caplog.records if "autoaugment" in r.getMessage()]
    assert len(found) == (1 if warns else 0)
    if warns:
        assert "ROADMAP F2" in found[0].getMessage()

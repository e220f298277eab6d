"""The port's supervised `Trainer` (`efficientteacher_torch/train/
trainer.py`) against the JAX package's, on `configs/sup/public/
yolov5s_coco.yaml` shrunk to the SiLU test network of
tests/test_torch_trainer.py (width 0.125, depth 0.34, nc 1, 128 px),
batch 4, 2 epochs of 2 steps with epoch-end validation, warmup over the
first 2 iterations.

Each trainer builds its own loaders over one seeded dataset on disk and
augments on the host as the YAML says (mosaic, affine, HSV, flips):
the JAX one with `Dataset.loader process` (its per-batch draws), the
port's with its thread engine. The images each step receives are held
byte-equal; both start from one state (the port's seeded init carried to
JAX, and back by `train_state_from_jax`). The images are unblurred noise
and the affine scale range is 0.5: flat images make flax's train-mode
variance (E[x^2] - E[x]^2) lose its digits (tests/test_torch_ssod.py).

Held exactly: the per-iteration schedule (lr_bias, lr_rest, momentum,
accumulate), the step count, the EMA update and optimizer step counters,
the results.csv epochs and the checkpoints' meta. Held to a tolerance:
the logged losses rtol 1e-3, the validation results and fitness atol
1e-4, the final state 2e-3 of each tensor's largest entry (momentum
2e-2), as for the SSOD trainer."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from efficientteacher_tpu.configs import get_cfg as jax_get_cfg
from efficientteacher_tpu.models import build_model as jax_build_model
from efficientteacher_tpu.models.spec import spec_from_cfg as jax_spec_from_cfg
from efficientteacher_tpu.train.train_state import (
    create_train_state as jax_create_train_state)
from efficientteacher_tpu.train.trainer import Trainer as JaxTrainer
from efficientteacher_tpu.utils import loggers as jax_loggers
from efficientteacher_torch.configs import get_cfg
from efficientteacher_torch.train.from_jax import train_state_from_jax
from efficientteacher_torch.train.trainer import Trainer
from test_torch_datasets import write_dataset
from test_torch_host_augment import SUP_YAML
from test_torch_trainer import TINY
from torch_port_helpers import assert_states, to_jax_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

SIZES = [(128, 128, "png"), (96, 128, "jpg"), (128, 100, "png"),
         (120, 128, "jpg"), (128, 90, "png"), (128, 128, "jpg"),
         (100, 128, "png"), (128, 110, "jpg")]


class JaxSup(JaxTrainer):
    def build_model(self, cfg):
        """The JAX trainer's build_model with zeros of the variables'
        shapes for weights (as tests/test_torch_trainer.py's JaxSSOD: flax's
        eager init compiles every initializer apart). The test sets the
        weights."""
        self.spec = jax_spec_from_cfg(cfg)
        self.model = jax_build_model(self.spec, ssod=False,
                                     dtype=self.compute_dtype)
        x0 = jnp.zeros((1, self.img_size, self.img_size, 3),
                       self.compute_dtype)
        shapes = jax.eval_shape(lambda key: self.model.init(
            key, x0, train=False), jax.random.PRNGKey(0))
        v = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                   shapes)
        self._init_params, self._init_bs = v["params"], v["batch_stats"]
        self.grad_masks = None
        st = np.asarray(self.spec.strides, np.float32)[:, None, None]
        self.anchors_grid = (np.asarray(self.spec.anchors, np.float32)
                             .reshape(self.spec.nl, -1, 2) / st)


def _overrides(lst, project):
    return TINY + [
        "Dataset.train", lst, "Dataset.val", lst, "Dataset.batch_size", 4,
        "Dataset.loader", "process", "Dataset.workers", 2,
        "hyp.warmup_epochs", 1, "hyp.scale", 0.5, "epochs", 2,
        "project", str(project)]


def _record(trainer, log):
    """Log each iteration's schedule, and each step's losses and images."""
    schedule = trainer._schedule

    def sched(ni):
        s = schedule(ni)
        log["sched"].append((ni, *map(np.float32, (s.lr_bias, s.lr_rest,
                                                   s.momentum)),
                             int(s.accumulate)))
        return s

    trainer._schedule = sched
    step = trainer.train_step

    def run(state, images, labels, mask, sched_):
        log["images"].append(np.asarray(images).copy())
        log["labels"].append(np.asarray(labels)[np.asarray(mask)])
        state, parts = step(state, images, labels, mask, sched_)
        log["steps"].append({k: float(v) for k, v in parts.items()})
        return state, parts

    trainer.train_step = run


@pytest.fixture(scope="module")
def sup_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sup")
    lst = write_dataset(tmp / "data", SIZES, seed=21, nc=1, name="train",
                        blur=False)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(str(SUP_YAML))
    jcfg.merge_from_list(_overrides(lst, tmp / "jax"))
    jcfg.freeze()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loggers, "Loggers", None)
        jt = JaxSup(jcfg, compute_dtype=jnp.float32)
    pcfg = get_cfg()
    pcfg.merge_from_file(str(SUP_YAML))
    pcfg.merge_from_list(_overrides(lst, tmp / "port") +
                         ["Dataset.loader", "thread"])
    pcfg.freeze()
    pt = Trainer(pcfg, compute_dtype=torch.float32, device="cpu")
    variables = to_jax_variables(
        pt.model.state_dict(), {"params": jt.state.params,
                                "batch_stats": jt.state.batch_stats})
    jt.mesh = None
    jt.state = jax_create_train_state(variables["params"],
                                      variables["batch_stats"], jt.opt_cfg,
                                      with_ema=True)
    pt.state = train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jt.state), pt.model)
    logs = {}
    for name, t in (("jax", jt), ("port", pt)):
        logs[name] = {"sched": [], "steps": [], "images": [], "labels": []}
        _record(t, logs[name])
        t.train()
    return jt, pt, logs


def test_sup_batches_schedule_and_counters_exact(sup_runs):
    jt, pt, logs = sup_runs
    j, p = logs["jax"], logs["port"]
    assert pt.train_loader.ds.augment and jt.train_loader.ds.augment
    assert len(p["images"]) == len(j["images"]) == 4
    for a, b in zip(p["images"], j["images"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(p["labels"], j["labels"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert p["sched"] == j["sched"]
    assert pt.state.ema.updates == int(jt.state.ema.updates)
    assert pt.state.opt_step == int(jt.state.opt.step)
    want = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jt.state),
                                copy.deepcopy(pt.model))
    assert_states(pt.state, want, tol=2e-3, grad_tol=2e-2)


def test_sup_losses_and_results_within_tolerance(sup_runs):
    jt, pt, logs = sup_runs
    for got, want in zip(logs["port"]["steps"], logs["jax"]["steps"],
                         strict=True):
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-7,
                                       err_msg=k)
    rows = {}
    for name, t in (("jax", jt), ("port", pt)):
        lines = t.results_csv.read_text().splitlines()
        rows[name] = np.array([[float(x) for x in line.split(",")]
                               for line in lines[1:]])
    np.testing.assert_array_equal(rows["port"][:, 0], [0, 1])
    np.testing.assert_array_equal(rows["port"][:, 0], rows["jax"][:, 0])
    np.testing.assert_allclose(rows["port"][:, 1:4], rows["jax"][:, 1:4],
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(rows["port"][:, 4:], rows["jax"][:, 4:],
                               rtol=0, atol=1e-4)


def test_sup_checkpoint_meta_equal(sup_runs):
    jt, pt, _ = sup_runs
    for name in ("last.ckpt", "best.ckpt"):
        metas = [json.loads((t.save_dir / "weights" / f"{name}.json")
                            .read_text()) for t in (jt, pt)]
        cfgs = [yaml.safe_load(m.pop("cfg")) for m in metas]
        for c in cfgs:
            c.pop("project")
            c["Dataset"].pop("loader")
        assert cfgs[0] == cfgs[1]
        jm, pm = metas
        assert pm.pop("best_fitness") == pytest.approx(
            jm.pop("best_fitness"), abs=1e-4)
        assert pm == jm and pm["epoch"] in (0, 1) and pm["has_ema"]

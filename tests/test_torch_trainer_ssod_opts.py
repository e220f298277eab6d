"""The port's SSOD trainer with its remaining options (LabelMatch, the SSOD
OTA loss, an extra teacher) against the JAX package's, and the port's
resume across a LabelMatch refresh.

The run is tests/test_torch_trainer.py's (the synthetic set of
tests/test_e2e_ssod.py, width 0.125 / depth 0.34, nc 1, 128 px, batch 4,
1 burn-in epoch + 2 mean-teacher epochs, recorded batches with seeded
noise replayed to both, one start state, the non-collapsing SiLU
network, float32) with `SSOD.pseudo_label_type: LabelMatch`,
`SSOD.use_ota: True` and one extra teacher: a seeded SSOD model of the
same architecture with the teacher weights of test_torch_trainer.py,
written as a JAX checkpoint and a port checkpoint of the same numbers,
its class names mapped into `Dataset.names`. LabelMatch refreshes at the
end of both mean-teacher epochs (`dynamic_thres_epoch` 0), so the second
epoch's steps take the first refresh's thresholds.

Held exactly: the schedule, the step dispatch, the counters and each
step's pseudo-label count. Held to a tolerance: the thresholds after each
refresh 1e-5 (the scores they are read from are the teachers' float32
outputs), the logged losses rtol 1e-3 and the validation atol 1e-4, as
in tests/test_torch_trainer.py.

The resume (port only; the JAX SSOD trainer does not resume): on the
in-memory batches of tests/test_torch_trainer_resume.py, 3 epochs
against 2, `last.ckpt` and a resumed third, with the three options on:
the thresholds, class totals and uncollected scores come back exactly,
and the third epoch refreshes to the uninterrupted run's thresholds
within 1e-5."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.configs import get_cfg as jax_get_cfg
from efficientteacher_tpu.train.ssod_step import (
    create_ssod_train_state as jax_create_ssod_state)
from efficientteacher_tpu.utils import loggers as jax_loggers
from efficientteacher_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from efficientteacher_tpu.utils.torch_import import state_dict_to_flax
from efficientteacher_torch.configs import get_cfg
from efficientteacher_torch.models import build_model, spec_from_cfg
from efficientteacher_torch.train.from_jax import train_state_from_jax
from efficientteacher_torch.train.ssod_trainer import SSODTrainer
from efficientteacher_torch.utils.checkpoint import (load_checkpoint,
                                                     module_variables,
                                                     save_checkpoint)

from test_e2e_ssod import ssod_data  # noqa: F401  (the synthetic set)
from test_torch_trainer import (JaxSSOD, Replay, _add_noise, _record,
                                _ssod_overrides, _teacher_weights)
from test_torch_trainer_resume import PortSSOD, _ssod_cfg
from torch_port_helpers import to_jax_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

OPTS = ["SSOD.pseudo_label_type", "LabelMatch", "SSOD.use_ota", True,
        "SSOD.ignore_thres_high", 0.5, "SSOD.ignore_thres_low", 0.2,
        "SSOD.resample_low_percent", 0.5, "Dataset.names", ["box"]]


def write_extra_teacher(cfg, root, seed=5):
    """A seeded SSOD model of `cfg`'s architecture with the teacher
    weights, as a port checkpoint and a JAX checkpoint (float32).
    Returns (port path, JAX path)."""
    spec = dataclasses.replace(spec_from_cfg(cfg), train_domain=True)
    model = build_model(spec, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    _teacher_weights(model)
    v = module_variables(model)
    ppath, jpath = root / "extra.ckpt", root / "extra_jax.ckpt"
    save_checkpoint(ppath, params=v["params"], batch_stats=v["batch_stats"],
                    half=False)
    sd = {k: t.numpy() for k, t in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    jv = state_dict_to_flax(sd)
    jax_save_checkpoint(jpath, params=jv["params"],
                        batch_stats=jv["batch_stats"], half=False)
    return ppath, jpath


def _thresholds(trainer, log):
    trainer.callbacks.register_action(
        "on_fit_epoch_end", callback=lambda metrics, epoch: log.append(
            (epoch, trainer.label_match.cls_thr_high.copy(),
             trainer.label_match.cls_thr_low.copy())))


@pytest.fixture(scope="module")
def opts_runs(ssod_data, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("ssod_opts")
    base = get_cfg()
    base.merge_from_list(_ssod_overrides(ssod_data, tmp))
    ppath, jpath = write_extra_teacher(base, tmp)

    def overrides(project, path):
        return _ssod_overrides(ssod_data, project) + OPTS + [
            "SSOD.extra_teachers", [str(path)],
            "SSOD.extra_teachers_class_names", [["box"]]]

    jcfg = jax_get_cfg()
    jcfg.merge_from_list(overrides(tmp / "jax", jpath))
    jcfg.freeze()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loggers, "Loggers", None)
        jt = JaxSSOD(jcfg, compute_dtype=jnp.float32)
    batches = {k: Replay(list(getattr(jt, k)), getattr(jt, k).ds)
               for k in ("train_loader", "target_loader", "val_loader")}
    _add_noise(batches)
    ds = batches["train_loader"].ds

    class PortOpts(SSODTrainer):
        def build_dataloader(self, cfg):
            for k, v in batches.items():
                setattr(self, k, v)
            self.dataset, self.nb = ds, len(batches["train_loader"])

    pcfg = get_cfg()
    pcfg.merge_from_list(overrides(tmp / "port", ppath))
    pcfg.freeze()
    pt = PortOpts(pcfg, compute_dtype=torch.float32, device="cpu")
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
        logs[name] = {"sched": [], "steps": [], "decay": [], "thr": []}
        _record(t, logs[name])
        _thresholds(t, logs[name]["thr"])
        t.train()
    return jt, pt, logs


def test_ssod_opts_dispatch_and_counters_exact(opts_runs):
    jt, pt, logs = opts_runs
    j, p = logs["jax"], logs["port"]
    assert pt.use_labelmatch and jt.use_labelmatch
    (module, cmap), = pt.extra_teachers
    assert not module.training and cmap.tolist() == [0]
    assert p["sched"] == j["sched"]
    assert [k for k, _ in p["steps"]] == [k for k, _ in j["steps"]] == \
        ["burn_step"] * 2 + ["ssod_step"] * 4
    assert pt.state.opt_step == int(jt.state.opt.step)
    assert pt.state.semi_ema.updates == int(jt.state.semi_ema.updates)
    counts = [r["pseudo"] for k, r in p["steps"] if k == "ssod_step"]
    assert counts == [r["pseudo"] for k, r in j["steps"] if k == "ssod_step"]
    assert min(counts) > 0


def test_ssod_opts_thresholds_and_losses_match_jax(opts_runs):
    jt, pt, logs = opts_runs
    jthr, pthr = logs["jax"]["thr"], logs["port"]["thr"]
    assert [e for e, _, _ in pthr] == [e for e, _, _ in jthr] == [0, 1, 2]
    for (e, ph, pl), (_, jh, jl) in zip(pthr, jthr):
        np.testing.assert_allclose(ph, jh, rtol=0, atol=1e-5, err_msg=e)
        np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-5, err_msg=e)
    # both refreshes moved the thresholds off their initial values
    assert pthr[1][1][0] != np.float32(0.5) and pthr[1][2][0] != \
        np.float32(0.2)
    np.testing.assert_array_equal(pt.label_match.cls_num_total,
                                  jt.label_match.cls_num_total)
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
    np.testing.assert_allclose(rows["port"][:, 4:], rows["jax"][:, 4:],
                               rtol=0, atol=1e-4)


class PortOptsResume(PortSSOD):
    """PortSSOD with LabelMatch's dataset statistics, LabelMatch, the
    SSOD OTA loss and an extra teacher; thresholds logged per epoch."""

    def build_dataloader(self, cfg):
        super().build_dataloader(cfg)
        self.dataset = types.SimpleNamespace(
            mosaic=True, label_num_per_image=1.0, cls_ratio_gt=np.ones(1))
        self.train_loader.ds = self.dataset
        self.target_loader.ds = range(8)  # LabelMatch reads its length
        self.thr = []
        _thresholds(self, self.thr)


def test_labelmatch_resume_across_a_refresh_equals_an_uninterrupted_run(
        tmp_path):
    cfg0 = _ssod_cfg(tmp_path, "probe")
    ppath, _ = write_extra_teacher(cfg0, tmp_path)
    extra = ["SSOD.extra_teachers", [str(ppath)],
             "SSOD.extra_teachers_class_names", [["box"]]]

    def cfg(name, **kw):
        c = _ssod_cfg(tmp_path, name, **kw)
        c.merge_from_list(OPTS + extra)
        return c

    whole = PortOptsResume(cfg("whole"), compute_dtype=torch.float32,
                           device="cpu")
    whole.train()
    first = PortOptsResume(cfg("first"), compute_dtype=torch.float32,
                           device="cpu")
    first.epochs = 2  # burn-in, then one mean-teacher epoch and a refresh
    first.train()
    last = first.save_dir / "weights" / "last.ckpt"
    saved = load_checkpoint(last)["optimizer"]["labelmatch"]
    resumed = PortOptsResume(cfg("resumed", resume=True, weights=str(last)),
                             compute_dtype=torch.float32, device="cpu")
    lm, was = resumed.label_match, first.label_match
    for k in ("cls_thr_high", "cls_thr_low", "cls_num_total"):
        np.testing.assert_array_equal(getattr(lm, k), getattr(was, k))
        np.testing.assert_array_equal(saved[k].numpy(), getattr(was, k))
    assert lm.cls_num_total.sum() > 0
    np.testing.assert_array_equal(whole.thr[1][1], first.thr[1][1])
    resumed.train()
    np.testing.assert_array_equal(lm.cls_num_total,
                                  whole.label_match.cls_num_total)
    np.testing.assert_allclose(resumed.thr[-1][1], whole.thr[-1][1],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(resumed.thr[-1][2], whole.thr[-1][2],
                               rtol=0, atol=1e-5)
    assert resumed.pseudo == whole.pseudo[-2:] and min(resumed.pseudo) > 0

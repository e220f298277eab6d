"""The port's checkpoints (`efficientteacher_torch/utils/checkpoint.py`):
the four cases of tests/test_async_checkpoint.py (round trip, a snapshot
isolated from later in-place updates, successive saves in order, a failed
write surfacing at wait()), the layout and meta sidecar of the JAX
package's, fp16 storage, and warm starts whose intersect counts equal the
JAX trainer's on the same pair of configurations."""

import json
import logging

import numpy as np
import pytest
import torch

from efficientteacher_torch.utils.checkpoint import (
    AsyncCheckpointer, intersect_trees, load_checkpoint, load_eval_variables,
    load_module_variables, module_variables, save_checkpoint,
    strip_optimizer)

from torch_port_helpers import one_torch_thread  # noqa: F401


def _tree(seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {"conv.weight": torch.randn(8, 4, 3, 3, generator=g) * scale,
            "bn.weight": torch.randn(8, generator=g)}


def _stats():
    return {"bn.running_mean": torch.zeros(8), "bn.running_var": torch.ones(8)}


def test_round_trip(tmp_path):
    ck = AsyncCheckpointer()
    params = _tree(0)
    path = tmp_path / "w" / "last.ckpt"
    ck.save(path, params=params, batch_stats=_stats(), epoch=3,
            best_fitness=0.5, half=False)
    ck.wait()
    out = load_checkpoint(path)
    for k, v in params.items():
        assert torch.equal(out["model"]["params"][k], v)
    assert out["meta"]["epoch"] == 3


def test_snapshot_isolated_from_later_mutation(tmp_path):
    """The values written are the values at save() time, though the
    caller's tensors change in place right after (the trainers' next step
    updates the live parameters while the writer thread runs)."""
    ck = AsyncCheckpointer()
    params = _tree(1)
    expect = {k: v.clone() for k, v in params.items()}
    path = tmp_path / "last.ckpt"
    ck.save(path, params=params, batch_stats={}, half=False)
    params["conv.weight"].mul_(0.0)
    ck.wait()
    out = load_checkpoint(path)
    assert torch.equal(out["model"]["params"]["conv.weight"],
                       expect["conv.weight"])


def test_successive_saves_serialize(tmp_path):
    ck = AsyncCheckpointer()
    path = tmp_path / "last.ckpt"
    ck.save(path, params=_tree(2, scale=1.0), batch_stats={}, half=False)
    second = _tree(2, scale=2.0)
    ck.save(path, params=second, batch_stats={}, half=False)  # joins first
    ck.wait()
    assert not ck.in_flight()
    out = load_checkpoint(path)
    assert torch.equal(out["model"]["params"]["conv.weight"],
                       second["conv.weight"])


def test_failure_surfaces_at_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("file, not dir")
    ck = AsyncCheckpointer()
    ck.save(blocker / "weights" / "last.ckpt",
            params=_tree(3), batch_stats={}, half=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        ck.wait()
    # and the checkpointer is reusable afterwards
    ok = tmp_path / "ok.ckpt"
    ck.save(ok, params=_tree(4), batch_stats={}, half=False)
    ck.wait()
    assert ok.exists()


def test_layout_meta_and_fp16(tmp_path):
    """The JAX layout: model / ema entries of params + batch_stats, stored
    fp16; momentum float32 under `optimizer`; the JSON sidecar's keys."""
    path = tmp_path / "last.ckpt"
    momentum = {"conv.weight": torch.randn(8, 4, 3, 3)}
    save_checkpoint(path, params=_tree(5), batch_stats=_stats(),
                    ema_params=_tree(6), ema_batch_stats=_stats(),
                    ema_updates=17, opt_state={"momentum_buf": momentum,
                                               "step": 4},
                    epoch=2, best_fitness=0.25, cfg_yaml="epochs: 3\n")
    out = load_checkpoint(path)
    assert set(out) == {"model", "ema", "optimizer", "meta"}
    assert out["model"]["params"]["conv.weight"].dtype == torch.float16
    assert out["ema"]["batch_stats"]["bn.running_var"].dtype == torch.float16
    assert torch.equal(out["ema"]["params"]["bn.weight"],
                       _tree(6)["bn.weight"].half())
    assert out["optimizer"]["momentum_buf"]["conv.weight"].dtype == \
        torch.float32 and out["optimizer"]["step"] == 4
    meta = json.loads(path.with_suffix(".ckpt.json").read_text())
    assert meta == {"epoch": 2, "best_fitness": 0.25, "ema_updates": 17,
                    "has_ema": True, "has_optimizer": True,
                    "cfg": "epochs: 3\n"}
    ev = load_eval_variables(path)
    assert ev["params"]["bn.weight"].dtype == torch.float32
    assert torch.equal(ev["params"]["bn.weight"],
                       _tree(6)["bn.weight"].half().float())
    strip_optimizer(path)
    stripped = load_checkpoint(path)
    assert set(stripped) == {"model", "meta"}
    assert stripped["meta"]["epoch"] == -1
    assert torch.equal(stripped["model"]["params"]["bn.weight"],
                       ev["params"]["bn.weight"].half())


def test_module_variables_round_trip():
    from efficientteacher_torch.models import ModelSpec, build_model

    spec = ModelSpec(width_multiple=0.125, depth_multiple=0.34, nc=1,
                     img_size=64)
    a = build_model(spec, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    b = build_model(spec, device="cpu",
                    generator=torch.Generator().manual_seed(1))
    va = module_variables(a)
    assert va["params"].keys() == dict(a.named_parameters()).keys()
    assert all(k.endswith(("running_mean", "running_var"))
               for k in va["batch_stats"])
    load_module_variables(b, va)
    for k, v in a.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(b.state_dict()[k], v), k
    with pytest.raises(KeyError):
        load_module_variables(b, {"params": {}, "batch_stats": {}})


def test_intersect_trees_counts():
    src = {"a": torch.ones(2, 3), "b": torch.ones(4), "c": torch.ones(1)}
    dst = {"a": torch.zeros(2, 3, dtype=torch.float64), "b": torch.zeros(5),
           "d": torch.zeros(2)}
    merged, copied, total = intersect_trees(src, dst)
    assert (copied, total) == (1, 3)
    assert merged["a"].dtype == torch.float64 and merged["a"].sum() == 6
    assert merged["b"] is dst["b"] and merged["d"] is dst["d"]


def test_warm_start_intersect_counts_match_jax(tmp_path, caplog):
    """A checkpoint of an nc-3 model warm-starts an nc-1 model: the head's
    output convolutions differ in shape. The port trainer's and the JAX
    trainer's `_warm_start` log equal "warm start: a/b params, c/d stats"
    counts. (The JAX side's trees are zeros of the variables' shapes, by
    `jax.eval_shape`: the counts depend on the shapes alone, and flax's
    eager init would compile every initializer apart.)"""
    import jax
    import jax.numpy as jnp

    from efficientteacher_tpu.configs import get_cfg as jax_get_cfg
    from efficientteacher_tpu.models import build_model as jax_build_model
    from efficientteacher_tpu.train.trainer import Trainer as JaxTrainer
    from efficientteacher_tpu.utils.checkpoint import (
        save_checkpoint as jax_save_checkpoint)
    from efficientteacher_torch.configs import get_cfg
    from efficientteacher_torch.models import build_model, spec_from_cfg
    from efficientteacher_torch.train.trainer import Trainer as PortTrainer

    def configure(cfg, nc):
        cfg.merge_from_list([
            "Model.Backbone.name", "YoloV5", "Model.Neck.name", "YoloV5",
            "Model.Head.name", "YoloV5",
            "Model.Neck.in_channels", [256, 512, 1024],
            "Model.Neck.out_channels", [256, 512, 1024],
            "Model.width_multiple", 0.125, "Model.depth_multiple", 0.34,
            "Loss.type", "ComputeLoss", "Dataset.nc", nc,
            "Dataset.img_size", 64, "noval", True,
            "project", str(tmp_path / "runs")])
        return cfg

    def jax_zeros(nc):
        jm = jax_build_model(configure(jax_get_cfg(), nc), ssod=False)
        shapes = jax.eval_shape(lambda k: jm.init(
            k, jnp.zeros((1, 64, 64, 3)), train=False), jax.random.PRNGKey(0))
        return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                      shapes)

    src = jax_zeros(3)
    jax_save_checkpoint(tmp_path / "src_jax.ckpt", params=src["params"],
                        batch_stats=src["batch_stats"])
    pv = module_variables(build_model(spec_from_cfg(configure(get_cfg(), 3)),
                                      device="cpu"))
    save_checkpoint(tmp_path / "src_port.ckpt", params=pv["params"],
                    batch_stats=pv["batch_stats"])

    class NoData:
        def build_dataloader(self, cfg):
            self.train_loader = self.val_loader = None
            self.dataset, self.nb = None, 1

    def warm_start_args():
        (rec,) = [r for r in caplog.records
                  if r.getMessage().startswith("warm start")]
        caplog.clear()
        return rec.args[:4]

    with caplog.at_level(logging.INFO):
        dst = jax_zeros(1)
        JaxTrainer._warm_start(None, str(tmp_path / "src_jax.ckpt"),
                               dst["params"], dst["batch_stats"])
        jax_counts = warm_start_args()
        cfg = configure(get_cfg(), 1)
        cfg.weights = str(tmp_path / "src_port.ckpt")
        type("T", (NoData, PortTrainer), {})(cfg, compute_dtype=torch.float32,
                                            device="cpu")
        port_counts = warm_start_args()
    assert port_counts == jax_counts
    c1, t1, c2, t2 = port_counts
    assert t1 - c1 == 3 * 2 and c2 == t2 > 0  # 3 head convs: weight + bias

"""AdamW in the PyTorch port (`efficientteacher_torch/train/train_state.py`,
`adam: True`) against the JAX package's (`train/optim.py:144-182` through
`train_state.apply_gradients_accumulating`), and its resume.

Seven micro-steps of the same random gradients and BatchNorm statistics go
through both optimizers from one SSOD state (the width-0.25 YOLOv5 of
tests/test_torch_train.py, its discriminators included), at accumulate
1, 2 and 3, with the warmup's per-step lr and momentum and the semi-EMA
on: every tensor of the states after each micro-step, both moments
included, is held within 1e-6 of its largest entry (float32; the bias
corrections' powers round in the last bit, measured <= 2e-7). The resume:
a supervised run of 3 epochs against 2 epochs, `last.ckpt` and a resumed
third: the moments read back from the checkpoint exactly, the final
weights within test_torch_trainer_resume.py's tolerance plus one step's
move (the checkpoint's weights are fp16, and AdamW's normalised step can
turn a last-digit gradient change into a different step)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientteacher_tpu.train import optim as jax_optim
from efficientteacher_tpu.train import train_state as jax_ts
from efficientteacher_tpu.train.ssod_step import (
    create_ssod_train_state as jax_create_ssod_state)
from efficientteacher_torch.train import optim
from efficientteacher_torch.train.from_jax import train_state_from_jax
from efficientteacher_torch.train.train_state import (
    apply_gradients_accumulating, bn_stats, create_train_state)
from efficientteacher_torch.utils.checkpoint import load_checkpoint
from efficientteacher_torch.utils.jax_import import params_from_jax

from test_torch_trainer_resume import PortSup, _sup_cfg
from torch_port_helpers import (assert_states, jax_and_port_models,
                                yolov5_cfg)
from torch_port_helpers import one_torch_thread  # noqa: F401

OC = dict(lr0=0.01, weight_decay=5e-4, epochs=10, momentum=0.937,
          adam=True)


@pytest.fixture(scope="module")
def small():
    cfg = yolov5_cfg()
    cfg.SSOD.train_domain = True
    return jax_and_port_models(cfg)


def _moments_close(got, want, tol):
    for a, b in ((got.momentum_buf, want.momentum_buf),
                 (got.second_moment, want.second_moment)):
        for x, y in zip(a, b):
            y = y.numpy()
            np.testing.assert_allclose(
                x.numpy(), y, rtol=0,
                atol=tol * max(float(np.abs(y).max()), 1e-30))


@pytest.mark.parametrize("accumulate", [1, 2, 3])
def test_adamw_matches_jax(small, accumulate):
    _, variables, port = small
    rng = np.random.default_rng(20 + accumulate)
    jstate = jax_create_ssod_state(variables["params"],
                                   variables["batch_stats"],
                                   jax_optim.OptimizerConfig(**OC))
    model = copy.deepcopy(port)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 model)
    assert state.second_moment is not None
    stats = bn_stats(model)
    jstep = jax.jit(jax_ts.apply_gradients_accumulating,
                    static_argnames=("oc",))
    for it in range(7):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(0, 0.01, p.shape).astype(np.float32),
            variables["params"])
        new_bs = jax.tree_util.tree_map(
            lambda s: (s + rng.uniform(0, 0.1, s.shape)).astype(np.float32),
            variables["batch_stats"])
        # warmup-like ramps: AdamW reads the configured momentum, not these
        kw = dict(lr_bias=0.05 - 0.005 * it, lr_rest=0.002 * (it + 1),
                  momentum=0.8 + 0.01 * it, accumulate=accumulate,
                  ema_decay=0.9999)
        jstate = jstep(
            jstate, grads, oc=jax_optim.OptimizerConfig(**OC),
            new_batch_stats=jax.tree_util.tree_map(jnp.asarray, new_bs),
            semi_decay=jnp.float32(0.996),
            **{k: jnp.float32(v) if k != "accumulate" else jnp.int32(v)
               for k, v in kw.items()})
        ref = train_state_from_jax(
            jax.tree_util.tree_map(np.asarray, jstate), copy.deepcopy(port))
        with torch.no_grad():
            torch._foreach_copy_(stats, bn_stats(ref.model))
        apply_gradients_accumulating(state, params_from_jax(model, grads),
                                     optim.OptimizerConfig(**OC),
                                     semi_decay=0.996, **kw)
        assert_states(state, ref, tol=1e-6)
        _moments_close(state, ref, 1e-6)
    assert state.opt_step == 7 // accumulate
    assert state.ema.updates == state.semi_ema.updates == 7 // accumulate


def test_adamw_decays_only_the_weight_group(small):
    """With zero gradients a fired step moves only the `weight` group's
    parameters, by the factor 1 - lr * wd."""
    _, _, port = small
    model = copy.deepcopy(port)
    oc = optim.OptimizerConfig(**OC)
    state = create_train_state(model, oc, with_ema=False)
    before = [p.detach().clone() for p in state.params]
    apply_gradients_accumulating(
        state, [torch.zeros_like(p) for p in state.params], oc,
        lr_bias=0.1, lr_rest=0.01, momentum=0.9, accumulate=1,
        ema_decay=0.9999)
    for g, b, p in zip(state.groups, before, state.params):
        want = b * (1.0 - 0.01 * 5e-4) if g == "weight" else b
        torch.testing.assert_close(p.detach(), want, rtol=0, atol=0)


def test_adamw_resume_equals_an_uninterrupted_run(tmp_path):
    whole = PortSup(_sup_cfg(tmp_path, "whole", adam=True),
                    compute_dtype=torch.float32, device="cpu")
    whole.train()
    first = PortSup(_sup_cfg(tmp_path, "first", adam=True),
                    compute_dtype=torch.float32, device="cpu")
    first.epochs = 2
    first.train()
    last = first.save_dir / "weights" / "last.ckpt"
    saved = load_checkpoint(last)["optimizer"]
    names = [n for n, _ in first.state.model.named_parameters()]
    for n, v in zip(names, first.state.second_moment):
        assert torch.equal(saved["second_moment"][n], v), n
    resumed = PortSup(_sup_cfg(tmp_path, "resumed", adam=True, resume=True,
                               weights=str(last)),
                      compute_dtype=torch.float32, device="cpu")
    assert resumed.start_epoch == 2
    for a, b in zip(resumed.state.second_moment, first.state.second_moment):
        assert torch.equal(a, b)
    resumed.train()
    a, b = resumed.state, whole.state
    assert (a.opt_step, a.ema.updates) == (b.opt_step, b.ema.updates) == (3, 3)
    # the checkpoint holds fp16 weights, so the third step's gradients
    # differ in their last digits, and AdamW's normalised step can turn
    # that into a different step where v is tiny: each tensor is held to
    # test_torch_trainer_resume.py's 2e-3 of its largest entry plus the
    # largest move the third step made to it in the uninterrupted run
    # (the run of 2 epochs is that run's first two)
    for x, y, y2 in zip(a.params, b.params, first.state.params):
        move = float((y - y2).abs().max())
        torch.testing.assert_close(
            x, y, rtol=0, atol=2e-3 * max(1.0, float(y.abs().max())) + move)

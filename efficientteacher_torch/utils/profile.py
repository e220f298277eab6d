"""Model profiling: parameter and FLOP counts, op micro-benchmarks
(counterpart of `efficientteacher_tpu/utils/profile.py`; reference
utils/torch_utils.py:94-145 `profile`, :222-244 `model_info`).

FLOPs come from `torch.utils.flop_counter.FlopCounterMode` over one eval
forward: 2 per multiply-accumulate of the convolutions and matrix
products, nothing for the elementwise ops (the reference's thop count adds
one per output element of each convolution for its bias). JAX reads XLA's
cost analysis, which counts by XLA's own rules; the gap is measured in
`tests/test_torch_profile.py`.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict

import numpy as np
import torch
from torch import nn


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


@torch.inference_mode()
def model_flops(model: nn.Module, img_size: int = 640, ch: int = 3,
                batch: int = 1) -> float:
    """FLOPs of one eval forward (decode included) of a (batch, ch,
    img_size, img_size) input on the model's device and dtype."""
    from torch.utils.flop_counter import FlopCounterMode

    p = next(model.parameters())
    x = torch.zeros((batch, ch, img_size, img_size), dtype=p.dtype,
                    device=p.device)
    was_training = model.training
    model.eval()
    try:
        with FlopCounterMode(display=False) as counter:
            model(x)
    finally:
        model.train(was_training)
    return float(counter.get_total_flops())


def model_info(model: nn.Module, img_size: int = 640,
               verbose: bool = False) -> Dict[str, Any]:
    """Summary dict (reference model_info, torch_utils.py:222-244)."""
    n_params = count_params(model)
    info = {
        "params": n_params,
        "params_m": n_params / 1e6,
        "gflops": model_flops(model, img_size) / 1e9,
        "img_size": img_size,
    }
    if verbose:
        for name, p in model.named_parameters():
            print(f"{name:80s} {tuple(p.shape)}")
    return info


def profile_fn(fn: Callable, *args, iters: int = 10,
               warmup: int = 2) -> Dict[str, float]:
    """Micro-benchmark `fn(*args)`, each call ended by a device sync
    (reference torch_utils.profile, :94-145)."""
    for _ in range(warmup):
        _sync(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args))
        ts.append(time.perf_counter() - t0)
    return {
        "mean_ms": float(np.mean(ts) * 1e3),
        "min_ms": float(np.min(ts) * 1e3),
        "std_ms": float(np.std(ts) * 1e3),
    }


def _sync(out) -> None:
    """Wait for the CUDA work behind `out` (a tensor or a nest of them)."""
    leaves = out if isinstance(out, (list, tuple)) else [out]
    for t in leaves:
        if isinstance(t, (list, tuple)):
            _sync(t)
        elif torch.is_tensor(t) and t.is_cuda:
            torch.cuda.synchronize(t.device)


def time_sync() -> float:
    """Host wall clock after the CUDA work queued so far (reference
    torch_utils.time_sync)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter()

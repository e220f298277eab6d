"""Checkpoint save/load (counterpart of
`efficientteacher_tpu/utils/checkpoint.py`).

The JAX package writes msgpack state dicts; the port writes a torch file
(`torch.save`) of the same layout, plus the same JSON sidecar
(`<path>.json`: epoch, best_fitness, ema_updates, has_ema, has_optimizer,
cfg):

    {"model": {"params": {name: tensor}, "batch_stats": {name: tensor}},
     "ema": {...same...},                      # when there is an EMA
     "optimizer": {"momentum_buf": {name: float32 tensor}, "step": int},
     "student_ema": {...same..., "updates": int}}  # SSOD last.ckpt only

Names are the module's own (`named_parameters`, and the BatchNorm running
statistics as `batch_stats`), so the trees are the modules' state dicts
split as the JAX variables are. Model and EMA tensors are stored fp16 by
default (the reference's .half() save, trainer.py:475-481); the optimizer's
momentum stays float32 and, as in the reference's last.pt, rides only in
the checkpoint the trainers resume from. The SSOD trainer's `ema` is the
teacher; past seeding its `last.ckpt` also holds the student's EMA (the
pseudo-label teacher), which its resume needs. Loading prefers the `ema`
entry like the reference's attempt_load (models/backbone/experimental.py:97);
`strip_optimizer` keeps only eval state (reference utils/general.py:1201).
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from torch import nn


def _map_tensors(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _is_bn(m: nn.Module) -> bool:
    return isinstance(m, nn.modules.batchnorm._BatchNorm) \
        and m.track_running_stats


def module_variables(module: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"params": named parameters, "batch_stats": BatchNorm running means
    and variances} of `module`: its tensors themselves, not copies."""
    stats = {}
    for prefix, m in module.named_modules():
        if _is_bn(m):
            for b in ("running_mean", "running_var"):
                stats[f"{prefix}.{b}" if prefix else b] = getattr(m, b)
    return {"params": dict(module.named_parameters()), "batch_stats": stats}


@torch.no_grad()
def load_module_variables(module: nn.Module, variables) -> None:
    """Copy a checkpoint entry into `module` in place, each tensor cast to
    the module's dtype. Every name must match both ways (the JAX resume's
    tree cast fails on a mismatch too)."""
    own = module_variables(module)
    for group in ("params", "batch_stats"):
        mine, theirs = own[group], variables[group]
        if set(mine) != set(theirs):
            diff = sorted(set(mine) ^ set(theirs))[:5]
            raise KeyError(f"checkpoint {group} do not match the module: "
                           f"{diff}")
        for name, t in mine.items():
            t.copy_(theirs[name])


def save_checkpoint(
    path: str | Path,
    *,
    params,
    batch_stats,
    ema_params=None,
    ema_batch_stats=None,
    ema_updates: int = 0,
    opt_state=None,
    epoch: int = -1,
    best_fitness: float = 0.0,
    cfg_yaml: Optional[str] = None,
    half: bool = True,
    extra: Optional[Dict[str, Any]] = None,
):
    """Write a checkpoint from name -> tensor trees (on any device). With
    half=True model/ema tensors are stored fp16 (mirroring the reference's
    .half() save, trainer.py:475-481). `extra`: further entries by name,
    {"params", "batch_stats", ...} trees stored as the model's."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def to_cpu(t):
        return t.detach().cpu()

    def cast(tree):
        return _map_tensors(
            lambda t: to_cpu(t).half() if half and t.is_floating_point()
            else to_cpu(t), tree)

    payload: Dict[str, Any] = {
        "model": {"params": cast(params), "batch_stats": cast(batch_stats)},
    }
    if ema_params is not None:
        payload["ema"] = {
            "params": cast(ema_params),
            "batch_stats": cast(ema_batch_stats),
        }
    for name, tree in (extra or {}).items():
        payload[name] = cast(tree)
    if opt_state is not None:
        payload["optimizer"] = _map_tensors(to_cpu, opt_state)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    meta = {
        "epoch": int(epoch),
        "best_fitness": float(best_fitness),
        "ema_updates": int(ema_updates),
        "has_ema": ema_params is not None,
        "has_optimizer": opt_state is not None,
    }
    if cfg_yaml is not None:
        meta["cfg"] = cfg_yaml
    path.with_suffix(path.suffix + ".json").write_text(json.dumps(meta))


class AsyncCheckpointer:
    """Non-blocking checkpoint writes for the training loop.

    `save()` snapshots every tensor with a copy on its own device (on the
    card an asynchronous device copy on the current stream, so the
    snapshot is immune to the next step updating the live state in place)
    and returns; the device->host copy, fp16 casts, serialization and the
    file write all run on a background thread, the copies on a stream of
    their own that waits for the snapshot. One save is in flight at a
    time: a new `save()` first joins the previous one, and `wait()` joins
    and re-raises any background failure.

    Replaces the reference's in-loop torch.save (trainer/trainer.py:474-491),
    which serializes the full state dict on the training thread every epoch.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def save(self, path: str | Path, **kwargs) -> None:
        self.wait()
        devices = set()

        def snap(t):
            if t.is_cuda:
                devices.add(t.device)
            return t.detach().clone()

        snapshot = _map_tensors(snap, kwargs)
        ready = None
        if devices:
            (device,) = devices  # one card
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))

        def run():
            try:
                if ready is None:
                    save_checkpoint(path, **snapshot)
                    return
                stream = torch.cuda.Stream(device=device)
                stream.wait_event(ready)
                with torch.cuda.stream(stream):
                    save_checkpoint(path, **snapshot)
            except BaseException as e:  # surfaced by the next wait()/save()
                self._exc = e

        self._thread = threading.Thread(
            target=run, name="ckpt-writer", daemon=True)
        self._thread.start()

    def in_flight(self) -> bool:
        """Whether a background save is still running."""
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._exc is not None:
            e, self._exc = self._exc, None
            raise RuntimeError("async checkpoint save failed") from e


def load_checkpoint(path: str | Path) -> Dict[str, Any]:
    """Read a checkpoint (tensors on the CPU) + meta."""
    path = Path(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    meta_path = path.with_suffix(path.suffix + ".json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    payload["meta"] = meta
    return payload


def load_eval_variables(path: str | Path, prefer_ema: bool = True,
                        dtype=torch.float32) -> Dict[str, Any]:
    """{"params", "batch_stats"} in `dtype`, preferring the EMA entry
    (reference attempt_load semantics, experimental.py:97); load them into
    a model with `load_module_variables`."""
    ckpt = load_checkpoint(path)
    src = ckpt.get("ema") if (prefer_ema and "ema" in ckpt) else ckpt["model"]
    return _map_tensors(lambda t: t.to(dtype),
                        {"params": src["params"],
                         "batch_stats": src["batch_stats"]})


def intersect_trees(src, dst):
    """Shape-matched partial copy for warm starts (reference intersect_dicts,
    trainer.py:132-144). Returns (merged_tree, n_copied, n_total); copied
    tensors take `dst`'s dtype and device."""
    copied = 0
    total = 0

    def merge(s, d):
        nonlocal copied, total
        if isinstance(d, dict):
            return {k: merge(s.get(k) if isinstance(s, dict) else None, v)
                    for k, v in d.items()}
        total += 1
        if s is not None and tuple(s.shape) == tuple(d.shape):
            copied += 1
            return s.to(dtype=d.dtype, device=d.device)
        return d

    merged = merge(src or {}, dst)
    return merged, copied, total


def strip_optimizer(path: str | Path):
    """Drop optimizer state; promote EMA to model (reference
    utils/general.py:1201-1216)."""
    ckpt = load_checkpoint(path)
    meta = ckpt.pop("meta", {})
    model = ckpt.get("ema") or ckpt["model"]
    save_checkpoint(
        Path(path),
        params=model["params"],
        batch_stats=model["batch_stats"],
        epoch=-1,
        best_fitness=meta.get("best_fitness", 0.0),
        half=True,
    )

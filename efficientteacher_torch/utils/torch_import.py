"""Reference `.pt` checkpoints: read them into the port, write them back
(counterpart of `efficientteacher_tpu/utils/torch_import.py` and of the
converters `scripts/convert_pt_to_efficient.py` /
`convert_efficient_to_pt.py`, which need the JAX package).

The reference saves pickled fp16 `nn.Module` trees, `ema` preferred on
load (reference trainer/trainer.py:475-481, attempt_load at
models/backbone/experimental.py:90-128). Reading one:

  1. unpickle without the reference's code: a meta-path finder serves
     stub modules for its packages (`models`, `utils`, `torchvision`,
     `configs`, `trainer`, `deploy`) while `torch.load` runs, and is
     removed after; a module pickles through its `__dict__`, so the
     stubs keep `_parameters` / `_buffers` / `_modules`;
  2. take `ema`, else `model`, else the file itself; walk the tree into a
     flat name -> tensor dict (or take the entry as it is when it already
     is a state_dict), cast to float32;
  3. rename onto the port's modules. The port keeps torch layouts and the
     reference's names, so tensors cross as they are (a ConvTranspose2d
     weight included: the JAX importer's fault F5 cannot arise). Only
     these names differ:
       - RepVGG's branches: YOLOv7's RepConv holds conv and BN in a
         Sequential (`rbr_dense.0` / `rbr_dense.1`), YOLOv6's
         RepVGGBlock names them (`rbr_dense.conv` / `rbr_dense.bn`); the
         port has `rbr_dense_conv` / `rbr_dense_bn` (and `rbr_1x1_*`);
       - the LinearAdd ScaleLayers store `<scale>.weight`; the port holds
         the vector as the parameter `<scale>` itself;
       - dropped: the Detect `anchors` / `anchor_grid` buffers (the spec
         gives them; the port's own is `anchors_px`),
         `num_batches_tracked` (not in the port's checkpoint trees),
         `stride`, and the DFL `proj` / `proj_conv` constants (the
         port's heads compute the projection).
     YOLOv7's `implicit` tokens are (1, C, 1, 1) on both sides.

Loads are shape-matched partial loads (`intersect_trees`, the reference's
intersect_dicts) that report what matched.
"""

from __future__ import annotations

import importlib.abc
import importlib.machinery
import logging
import sys
import types
from pathlib import Path
from typing import Dict, Tuple

import torch
from torch import nn

from .checkpoint import (intersect_trees, load_checkpoint,
                         load_eval_variables, load_module_variables,
                         module_variables, save_checkpoint)

LOGGER = logging.getLogger(__name__)

_STUB_PREFIXES = ("models", "utils", "torchvision", "configs", "trainer",
                  "deploy")


class _Stub:
    """Stands in for any class of the reference inside the pickle."""

    def __init__(self, *a, **k):
        pass


class _StubModule(types.ModuleType):
    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        cls = type(name, (_Stub,), {"__module__": self.__name__})
        setattr(self, name, cls)
        return cls


class _StubLoader(importlib.abc.Loader):
    def create_module(self, spec):
        return _StubModule(spec.name)

    def exec_module(self, module):
        pass


class _StubFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".")[0] not in _STUB_PREFIXES:
            return None
        return importlib.machinery.ModuleSpec(fullname, _StubLoader(),
                                              is_package=True)


def _stubbed_load(path):
    """`torch.load` of a pickled file with the reference's packages
    stubbed; the stubs leave `sys.modules` afterwards."""
    before = set(sys.modules)
    finder = _StubFinder()
    sys.meta_path.insert(0, finder)
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    finally:
        sys.meta_path.remove(finder)
        for name in set(sys.modules) - before:
            if isinstance(sys.modules[name], _StubModule):
                del sys.modules[name]


def _walk(obj, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flat state_dict of an unpickled (possibly stubbed) module tree."""
    out: Dict[str, torch.Tensor] = {}
    d = getattr(obj, "__dict__", None) or {}
    for group in ("_parameters", "_buffers"):
        for name, t in (d.get(group) or {}).items():
            if t is not None:
                out[prefix + name] = t
    for name, child in (d.get("_modules") or {}).items():
        if child is not None:
            out.update(_walk(child, f"{prefix}{name}."))
    return out


def load_reference_state_dict(path, prefer_ema: bool = True
                              ) -> Dict[str, torch.Tensor]:
    """A reference `.pt` -> {reference name: float32 tensor}: its `ema`
    (with `prefer_ema`), else `model`, else the file's own object; a
    module tree or a state_dict."""
    ckpt = _stubbed_load(path)
    entry = ckpt
    if isinstance(ckpt, dict):
        if prefer_ema and ckpt.get("ema") is not None:
            entry = ckpt["ema"]
        elif ckpt.get("model") is not None:
            entry = ckpt["model"]
    if isinstance(entry, dict) and all(torch.is_tensor(v)
                                       for v in entry.values()):
        sd = entry
    else:
        sd = _walk(entry)
    return {k: v.detach().float() for k, v in sd.items()
            if v.is_floating_point()}


# the reference's RepVGG branch cells -> the port's attribute names
_BRANCH_CELLS = {"0": "conv", "1": "bn", "conv": "conv", "bn": "bn"}
_BRANCHES = ("rbr_dense", "rbr_1x1")
# LinearAddBlock's ScaleLayer modules (reference common.py:1650-1678)
_SCALE_LAYERS = ("scale_conv", "scale_1x1", "scale_identity")
_DROPPED_LEAVES = ("anchors", "anchor_grid", "anchors_px",
                   "num_batches_tracked", "stride", "proj")


def port_name(key: str):
    """A reference state_dict name -> the port's, or None for a tensor the
    port does not hold."""
    parts = key.split(".")
    if parts[-1] in _DROPPED_LEAVES or "proj_conv" in parts[:-1]:
        return None
    out = []
    for p in parts:
        if out and out[-1] in _BRANCHES and p in _BRANCH_CELLS:
            out[-1] = f"{out[-1]}_{_BRANCH_CELLS[p]}"
        else:
            out.append(p)
    if len(out) > 1 and out[-1] == "weight" and out[-2] in _SCALE_LAYERS:
        out.pop()
    return ".".join(out)


def reference_name(name: str) -> str:
    """The port's name -> the reference's (YOLOv7's Sequential form for
    the RepVGG branches, as the JAX exporter writes them)."""
    out = []
    for p in name.split("."):
        head, _, cell = p.rpartition("_")
        if head in _BRANCHES and cell in ("conv", "bn"):
            out += [head, "0" if cell == "conv" else "1"]
        else:
            out.append(p)
    if out[-1] in _SCALE_LAYERS:
        out.append("weight")
    return ".".join(out)


def load_torch_weights(path, prefer_ema: bool = True):
    """A reference `.pt` -> {"params": {name: tensor}, "batch_stats":
    {name: tensor}} under the port's names, float32 on the CPU (the
    layout of a port checkpoint entry)."""
    params, stats = {}, {}
    for key, t in load_reference_state_dict(path, prefer_ema).items():
        name = port_name(key)
        if name is None:
            continue
        leaf = name.rsplit(".", 1)[-1]
        (stats if leaf in ("running_mean", "running_var")
         else params)[name] = t
    return {"params": params, "batch_stats": stats}


def match_variables(src, model: nn.Module) -> Tuple[dict, Dict[str, tuple]]:
    """Shape-matched partial copy of `src` ({"params", "batch_stats"}) onto
    `model`'s own tensors: (the merged variables, {group: (matched,
    total)})."""
    own = module_variables(model)
    merged, counts = {}, {}
    for g in ("params", "batch_stats"):
        merged[g], c, t = intersect_trees(src.get(g, {}), own[g])
        counts[g] = (c, t)
    return merged, counts


def read_variables(weights) -> dict:
    """{"params", "batch_stats"} float32 on the CPU from a reference `.pt`
    or a port checkpoint, the `ema` entry preferred in either."""
    return (load_torch_weights(weights) if str(weights).endswith(".pt")
            else load_eval_variables(weights))


def load_weights_into(model: nn.Module, weights, strict: bool = False
                      ) -> Dict[str, tuple]:
    """A reference `.pt` or a port checkpoint (`read_variables`) into
    `model`, in place, shape-matched; returns {group: (matched, total)}.
    With `strict`, every tensor of the model must match."""
    src = read_variables(weights)
    merged, counts = match_variables(src, model)
    if strict and any(c != t for c, t in counts.values()):
        missing = [k for g in ("params", "batch_stats")
                   for k, v in module_variables(model)[g].items()
                   if k not in src.get(g, {})
                   or tuple(src[g][k].shape) != tuple(v.shape)]
        raise ValueError(f"{weights}: {counts} tensors matched; missing or "
                         f"reshaped: {missing[:5]}")
    load_module_variables(model, merged)
    return counts


def convert_pt_to_checkpoint(pt, cfg, out, prefer_ema: bool = True
                             ) -> Dict[str, tuple]:
    """A reference `.pt` -> a port checkpoint of the model `cfg` builds (the
    counterpart of scripts/convert_pt_to_efficient.py): the matched
    tensors, the model's own init elsewhere, saved fp16 with the config;
    returns the match report {group: (matched, total)}."""
    from ..models import build_model, spec_from_cfg

    model = build_model(spec_from_cfg(cfg), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    merged, counts = match_variables(load_torch_weights(pt, prefer_ema),
                                     model)
    c, t = counts["params"]
    if c < 0.95 * t:
        LOGGER.warning("%s: %d/%d params matched, check the config", pt, c, t)
    save_checkpoint(out, params=merged["params"],
                    batch_stats=merged["batch_stats"], cfg_yaml=cfg.dump())
    return counts


def export_checkpoint_to_pt(ckpt, out) -> int:
    """A port checkpoint -> a reference-style `.pt` ({"model": state_dict
    under the reference's names, "ema": None, "epoch"}; the counterpart of
    scripts/convert_efficient_to_pt.py), its `ema` entry preferred; the
    tensors keep the checkpoint's dtype. Returns the tensor count."""
    payload = load_checkpoint(ckpt)
    entry = payload.get("ema") or payload["model"]
    sd = {reference_name(k): v for g in ("params", "batch_stats")
          for k, v in entry[g].items()}
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": sd, "ema": None,
                "epoch": payload["meta"].get("epoch", -1)}, out)
    return len(sd)


# the reference's module path that `save_reference_pt` pickles classes under
PT_MODULE = "models.common"


def save_reference_pt(path, model: nn.Module, ema: nn.Module = None,
                      **extra) -> None:
    """Pickle `model` (and `ema`) fp16 as the reference saves them, each
    of the port's module classes registered under `PT_MODULE` only while
    saving, so that loading the file needs the stubs as a reference `.pt`
    does."""
    import copy

    mod = types.ModuleType(PT_MODULE)
    top = PT_MODULE.split(".")[0]
    # whatever held these names before (another loader's stubs) returns
    # after the save
    saved = {n: sys.modules.get(n) for n in (top, PT_MODULE)}
    stand_ins: Dict[type, type] = {}

    def stand_in(obj) -> None:
        cls = type(obj)
        if cls not in stand_ins:
            name = cls.__name__
            while hasattr(mod, name):  # a name two port modules share
                name += "_"
            stand_ins[cls] = type(name, (cls,), {
                "__module__": PT_MODULE, "__qualname__": name})
            setattr(mod, name, stand_ins[cls])
        object.__setattr__(obj, "__class__", stand_ins[cls])

    def ours(obj) -> bool:
        return type(obj).__module__.startswith("efficientteacher_torch")

    def recast(m: nn.Module) -> nn.Module:
        m = copy.deepcopy(m).half().cpu()
        for sub in m.modules():
            # the modules and what they hold of the port's own (the spec)
            for v in [sub, *vars(sub).values()]:
                if ours(v) and type(v) not in stand_ins.values():
                    stand_in(v)
        return m

    payload = {"model": recast(model),
               "ema": recast(ema) if ema is not None else None, **extra}
    for n in saved:
        sys.modules[n] = mod if n == PT_MODULE else types.ModuleType(n)
    try:
        torch.save(payload, path)
    finally:
        for n, m in saved.items():
            if m is None:
                del sys.modules[n]
            else:
                sys.modules[n] = m

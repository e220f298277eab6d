"""Hierarchical, freezable configuration nodes (a copy of
`efficientteacher_tpu/configs/cfg_node.py`, which imports yaml at module
level; the card's machine has no yaml).

A nested attribute dict with YAML merge, dotted-path overrides and a freeze
bit:

    cfg = get_cfg()                    # deep-copied default tree
    cfg.merge_from_file("x.yaml")      # overlay a YAML file
    cfg.merge_from_list(["a.b", 1])    # dotted overrides (the CLIs pass
                                       # strings: "epochs", "12")
    cfg.freeze()                       # make immutable

YAML is read by `yaml_lite`, which gives what `yaml.safe_load` gives on
the subset the shipped configs use. As in the JAX package, a string
override of a non-string key is parsed as YAML (`"0.5"` -> 0.5, `"[1, 2]"`
-> [1, 2]; text that is no YAML stays a string). `dump` writes JSON, a
subset of YAML that `yaml.safe_load` reads back to the same tree as long
as every float's repr has a dot (true of every config shipped in
`configs/`).
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, List

from . import yaml_lite

_VALID_SCALARS = (int, float, bool, str, type(None))


class CfgNode(dict):
    """An attribute-accessible dict with recursive merge + freeze."""

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"CfgNode is frozen; cannot set {name!r}")
        self[name] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"CfgNode is frozen; cannot set {key!r}")
        super().__setitem__(key, value)

    # -- freeze --------------------------------------------------------------
    def freeze(self) -> "CfgNode":
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, "_frozen")

    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    # -- merging --------------------------------------------------------------
    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge(other, self, [])

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            loaded = yaml_lite.safe_load(f.read()) or {}
        _merge(CfgNode(loaded), self, [])

    def merge_from_list(self, opts: List[Any]) -> None:
        if len(opts) % 2 != 0:
            raise ValueError(f"override list must be key/value pairs, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"unknown config key: {key}")
            node[leaf] = _coerce(value, node[leaf], key)

    # -- io -------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()
        }

    def dump(self) -> str:
        return json.dumps(self.to_dict(), indent=2) + "\n"

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return self.dump()


def _merge(src: CfgNode, dst: CfgNode, path: List[str]) -> None:
    for key, value in src.items():
        full = ".".join(path + [key])
        if key not in dst:
            # Tolerate unknown keys from user YAMLs (the reference's yacs is
            # strict, but its config zoo contains a few stale keys; we accept
            # and carry them so those YAMLs load unmodified).
            dst[key] = value.clone() if isinstance(value, CfgNode) else value
            continue
        if isinstance(value, CfgNode) and isinstance(dst[key], CfgNode):
            _merge(value, dst[key], path + [key])
        else:
            dst[key] = _coerce(value, dst[key], full)


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Coerce a replacement value to the type of the existing default."""
    if isinstance(value, CfgNode) or isinstance(old, CfgNode):
        if isinstance(value, dict) and isinstance(old, dict):
            return value
        raise TypeError(f"cannot replace node/leaf at {key}")
    if old is None or value is None:
        return value
    if isinstance(value, str) and not isinstance(old, str):
        value = _parse_literal(value)
    if isinstance(old, bool) and isinstance(value, int) and not isinstance(value, bool):
        return bool(value)
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, int) and isinstance(value, float) and value.is_integer():
        return int(value)
    if type(value) is type(old) or isinstance(value, _VALID_SCALARS):
        return value
    raise TypeError(f"type mismatch at {key}: {type(value)} vs {type(old)}")


def _parse_literal(s: str) -> Any:
    """`s` read as YAML, or `s` itself when it is no YAML the reader
    covers (the JAX version returns it on a YAMLError)."""
    try:
        return yaml_lite.safe_load(s)
    except ValueError:
        return s

"""Command-line entry points of the port: `python -m
efficientteacher_torch.cli.train`, `.cli.val`, `.cli.detect` and
`.cli.export` (the counterparts of the root `train.py`, `val.py`,
`detect.py` and `export.py`)."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """The config's `device` ("" or a card index: the CUDA card; "cpu")."""
    name = str(name or "").strip()
    if not name:
        return torch.device("cuda")
    if name.isdigit():
        return torch.device(f"cuda:{name}")
    return torch.device(name)


def compute_dtype(device: torch.device) -> torch.dtype:
    """bf16 autocast on the card (the trainers' default); float32 on the
    CPU, where bf16 autocast only slows the small runs the CPU serves."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32

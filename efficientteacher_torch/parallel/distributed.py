"""Process-group helpers (counterpart of
`efficientteacher_tpu/parallel/distributed.py`).

One card, one process: the rank is 0 unless `torch.distributed` has been
initialised by the caller. DDP (the reference's multi-GPU path,
train.py:52-59) is not ported yet (ROADMAP, "Next, in order" item
2.4). Besides the rank: the loaders' share of a batch and of an epoch's
sample order (`per_process_batch`, `process_slice`), and the host <->
device copies of the trainers and the validator: `to_device` (through
pinned memory) and `to_host`.
"""

from __future__ import annotations

import numpy as np
import torch


def is_main_process() -> bool:
    """Rank 0 (the reference's RANK in (-1, 0) guards)."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _world() -> tuple:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_slice(items: list) -> list:
    """This process's strided share of an (identically ordered) sample
    list: all of it in a single process."""
    rank, world = _world()
    return items if world == 1 else items[rank::world]


def per_process_batch(global_batch: int) -> int:
    """This process's share of the global batch."""
    _, world = _world()
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{world} processes")
    return global_batch // world


def to_device(x, device: torch.device) -> torch.Tensor:
    """A host array or CPU tensor on `device`. On the card the copy runs
    asynchronously to the host from pinned memory: a tensor the loaders
    allocated pinned is copied as it is (the caching host allocator keeps
    its block until the copy is done), anything else is first copied into
    a pinned block."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    return t.to(device)


def to_host(x) -> np.ndarray:
    """A tensor (on any device) or array -> a host numpy array. A CUDA
    tensor's copy waits for the work that produces it."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)

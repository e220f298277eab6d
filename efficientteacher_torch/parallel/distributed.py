"""Process-group helpers (counterpart of
`efficientteacher_tpu/parallel/distributed.py`).

One card, one process: the rank is 0 unless `torch.distributed` has been
initialised by the caller. DDP (the reference's multi-GPU path,
train.py:52-59) is not ported yet (ROADMAP, Queue 1 item 6). Besides the
rank, the host <-> device copies of the trainers and the validator:
`to_device` (through pinned memory) and `to_host`.
"""

from __future__ import annotations

import numpy as np
import torch


def is_main_process() -> bool:
    """Rank 0 (the reference's RANK in (-1, 0) guards)."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`. On the card it goes through pinned
    memory, and the copy runs asynchronously to the host (the caching host
    allocator keeps the pinned block until the copy is done)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_host(x) -> np.ndarray:
    """A tensor (on any device) or array -> a host numpy array. A CUDA
    tensor's copy waits for the work that produces it."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)

"""Process groups for DDP (counterpart of
`efficientteacher_tpu/parallel/distributed.py`; the reference's
multi-GPU path, train.py:52-59).

`maybe_initialize` joins the group that torchrun describes in the
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):
nccl with the rank on `cuda:LOCAL_RANK`, gloo on the CPU; without that
environment it does nothing and the run is one process. The step is the
global batch's, as JAX's step on its global array is
(`efficientteacher_tpu/parallel/mesh.py:1-11`): each rank holds
`per_process_batch` of the batch, its strided share of the epoch's sample
order (`process_slice`), and

  - `global_sum` makes the losses' normalisers (counts of positives) the
    whole batch's, and `world_size` their means and the loss scale;
  - the accumulated gradients are summed over the ranks once per
    optimizer step (`train/train_state.py`), whenever a group exists;
  - the BatchNorm statistics of a train-mode forward are the whole
    batch's when the group has more than one rank
    (`models/common.BatchNorm2d`);
  - rank 0 alone writes files, logs and validates (`is_main_process`),
    and `broadcast_object` hands its results to the others, which wait.

Also the host <-> device copies of the trainers and the validator:
`to_device` (through pinned memory) and `to_host`.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

LOGGER = logging.getLogger(__name__)


def group_active() -> bool:
    """Whether a process group exists (of any size, 1 included)."""
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def _world() -> tuple:
    if group_active():
        dist = torch.distributed
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def maybe_initialize(device: torch.device) -> torch.device:
    """Join torchrun's process group when its environment is set, and
    return the device this rank trains on: `cuda:LOCAL_RANK` for a card
    rank (nccl), the given device otherwise (gloo on the CPU). Without
    RANK and WORLD_SIZE in the environment, or with a group already
    joined, the device is returned as it is."""
    env = os.environ
    if group_active() or "RANK" not in env or "WORLD_SIZE" not in env:
        return device
    dist = torch.distributed
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    if device.type == "cuda":
        device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    LOGGER.info("process group: rank %d of %d, %s on %s", rank, world,
                backend, device)
    return device


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if group_active():
        torch.distributed.destroy_process_group()


def world_size() -> int:
    return _world()[1]


def is_main_process() -> bool:
    """Rank 0 (the reference's RANK in (-1, 0) guards)."""
    return _world()[0] == 0


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks (a new tensor, outside autograd); `t`
    itself without a group."""
    if not group_active():
        return t
    t = t.detach().clone()
    torch.distributed.all_reduce(t)
    return t


def all_reduce_(t: torch.Tensor) -> None:
    """Sum `t` over the ranks in place, when a group exists."""
    if group_active():
        torch.distributed.all_reduce(t)


def broadcast_object(obj):
    """Rank 0's `obj` on every rank (a collective: every rank calls it);
    `obj` itself without a group."""
    if not group_active():
        return obj
    box = [obj]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


def gather_objects(obj) -> list:
    """Every rank's `obj`, in rank order, on every rank."""
    if not group_active():
        return [obj]
    out = [None] * world_size()
    torch.distributed.all_gather_object(out, obj)
    return out


def process_slice(items):
    """This process's strided share of an (identically ordered) sample
    list: all of it in a single process. The tail past a multiple of the
    world size is dropped, so every rank gets as many items; the k-th
    batches of the ranks together are then the k-th global batch."""
    rank, world = _world()
    if world == 1:
        return items
    return items[rank:len(items) // world * world:world]


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

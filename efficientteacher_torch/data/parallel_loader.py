"""Batch engines of the loaders (counterpart of
`efficientteacher_tpu/data/parallel_loader.py`).

Both deliver batches in task order, so a loader's epoch is a function of
its seed and epoch alone. Each batch's image array is a new uint8 CPU
tensor, allocated pinned when `pin_memory` (PyTorch's caching host
allocator hands out and recycles the blocks, and keeps a block that an
asynchronous copy to the card still reads until the copy is done), so the
trainer's copy to the card reads the batch where the loader wrote it.

  - threads (`iter_batches_threads`): `workers` threads build batches into
    their image tensors; the core's calls (decode, resize, letterbox)
    release the interpreter lock, so threads decode in parallel.
  - processes (`iter_batches_processes`): forked workers build batches into
    shared-memory slots; the parent copies each slot into the batch's
    image tensor at yield time and recycles the slot. The children touch
    numpy, zlib and the core only, never torch, so forking a process that
    has the card open is safe for them.

`BatchLoader`'s 'auto' takes threads: each task carries its batch's seed
(`data/datasets.py`), so a batch's draws do not depend on which worker
builds it or when, and threads skip the processes' slot copy.
"""

from __future__ import annotations

import itertools
import multiprocessing
import os
import queue as _queue
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch

_FORK_OK = hasattr(os, "fork")


def _image_tensor(shape, pin_memory: bool) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.uint8, pin_memory=pin_memory)


def iter_batches_threads(
    build_batch: Callable[[object, np.ndarray], Dict],
    tasks: List,
    image_shape: Callable[[object], tuple],
    workers: int,
    prefetch: int = 4,
    pin_memory: bool = False,
) -> Iterator[Dict]:
    """Yield build_batch(task, images) for every task, with "images" the
    tensor it wrote, built by `workers` threads over a window of
    max(prefetch, workers) tasks in flight; batch i is yielded i-th."""
    if not tasks:
        return

    def run(task):
        images = _image_tensor(image_shape(task), pin_memory)
        batch = build_batch(task, images.numpy())
        batch["images"] = images
        return batch

    workers = max(1, min(workers, len(tasks)))
    window = max(prefetch, workers)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futs = deque()
        it = iter(tasks)
        for t in itertools.islice(it, window):
            futs.append(ex.submit(run, t))
        try:
            while futs:
                f = futs.popleft()
                nxt = next(it, None)
                if nxt is not None:  # keep the window full before blocking
                    futs.append(ex.submit(run, nxt))
                yield f.result()
        finally:
            for f in futs:
                f.cancel()


def iter_batches_processes(
    build_batch: Callable[[object, np.ndarray], Dict],
    tasks: List,
    image_shape: Callable[[object], tuple],
    workers: int,
    prefetch: int = 4,
    pin_memory: bool = False,
    poll_timeout: float = 30.0,
) -> Iterator[Dict]:
    """Yield build_batch(task, images) for every task (all of one image
    shape), built by forked worker processes into a ring of
    max(2 * workers, prefetch) shared-memory slots."""
    if not tasks:
        return
    shape = image_shape(tasks[0])
    workers = max(1, min(workers, len(tasks)))
    n_slots = max(2 * workers, prefetch)
    ctx = multiprocessing.get_context("fork")
    nbytes = int(np.prod(shape))
    slots = [np.frombuffer(ctx.RawArray("B", nbytes), np.uint8)
             .reshape(shape) for _ in range(n_slots)]
    task_q, done_q, free_q = ctx.Queue(), ctx.Queue(), ctx.Queue()
    for sid in range(n_slots):
        free_q.put(sid)
    for seq, t in enumerate(tasks):
        task_q.put((seq, t))
    for _ in range(workers):
        task_q.put(None)

    def worker():
        while True:
            # the slot before the task: every task-holder owns a slot, so
            # the batch the in-order cursor waits for can always complete
            sid = free_q.get()
            task = task_q.get()
            if task is None:
                free_q.put(sid)
                break
            seq, t = task
            try:
                meta = build_batch(t, slots[sid])
            except Exception:
                import traceback

                free_q.put(sid)
                done_q.put(("error", traceback.format_exc()))
                break
            done_q.put((sid, seq, meta))
        done_q.put(None)

    procs = [ctx.Process(target=worker, daemon=True) for _ in range(workers)]
    for p in procs:
        p.start()
    try:
        finished = 0
        remaining = len(tasks)
        pending: Dict[int, tuple] = {}
        next_seq = 0
        while remaining > 0:
            try:
                msg = done_q.get(timeout=poll_timeout)
            except _queue.Empty:
                # a worker that dies hard posts neither a result nor its
                # exit sentinel: without this check the parent would wait
                # forever on its batch
                dead = sum(1 for p in procs if not p.is_alive())
                if dead > finished:
                    raise RuntimeError(
                        f"{dead - finished} loader worker process(es) died "
                        f"without reporting; {remaining} batches missing, "
                        f"exit codes {[p.exitcode for p in procs]} (use "
                        "Dataset.loader 'thread')")
                continue
            if msg is None:
                finished += 1
                if finished >= workers and remaining > 0:
                    raise RuntimeError(f"loader workers exited early "
                                       f"({remaining} batches missing)")
                continue
            if msg[0] == "error":
                raise RuntimeError(f"loader worker failed:\n{msg[1]}")
            sid, seq, meta = msg
            pending[seq] = (sid, meta)
            while next_seq in pending:
                psid, batch = pending.pop(next_seq)
                images = _image_tensor(shape, pin_memory)
                images.numpy()[...] = slots[psid]
                free_q.put(psid)
                batch["images"] = images
                remaining -= 1
                next_seq += 1
                yield batch
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5)

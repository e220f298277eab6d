"""Callback hook bus (a copy of `efficientteacher_tpu/utils/callbacks.py`;
parity: reference utils/callbacks.py:7-77)."""

from __future__ import annotations

from typing import Callable, Dict, List

HOOKS = [
    "on_pretrain_routine_start",
    "on_pretrain_routine_end",
    "on_train_start",
    "on_train_epoch_start",
    "on_train_batch_start",
    "on_train_batch_end",
    "on_train_epoch_end",
    "on_val_start",
    "on_val_image_end",
    "on_val_end",
    "on_fit_epoch_end",
    "on_model_save",
    "on_train_end",
    "teardown",
]


class Callbacks:
    def __init__(self):
        self._callbacks: Dict[str, List[dict]] = {h: [] for h in HOOKS}

    def register_action(self, hook: str, name: str = "", callback: Callable = None):
        assert hook in self._callbacks, f"unknown hook {hook!r}"
        assert callable(callback)
        self._callbacks[hook].append({"name": name, "callback": callback})

    def get_registered_actions(self, hook=None):
        return self._callbacks[hook] if hook else self._callbacks

    def run(self, hook: str, *args, **kwargs):
        assert hook in self._callbacks, f"unknown hook {hook!r}"
        for logger in self._callbacks[hook]:
            logger["callback"](*args, **kwargs)

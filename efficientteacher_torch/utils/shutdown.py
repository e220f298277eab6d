"""Preemption-graceful shutdown for training loops (a copy of
`efficientteacher_tpu/utils/shutdown.py`).

Preemptible machines get SIGTERM and are reclaimed shortly after. The
reference's only resilience is restarting from last.pt (`resume: True`,
reference trainer/trainer.py:159-186; SURVEY §5.3 records it has no
failure handling to match) — this goes one better: on SIGTERM/SIGINT the trainers finish the in-flight step, write
last.ckpt, and return cleanly, so `resume` loses at most the current
epoch's steps instead of the whole epoch-in-progress plus whatever a
hard kill corrupts.

Usage: trainers call `install()` at train start and poll `requested`
at step boundaries; `uninstall()` restores the previous handlers.
"""

from __future__ import annotations

import logging
import signal
import threading

LOGGER = logging.getLogger(__name__)


class GracefulStop:
    """Flag flipped by SIGTERM/SIGINT; poll `requested` at safe points.

    The second signal of the same kind re-raises the default behavior
    (a genuinely stuck loop stays killable with a repeated Ctrl-C).
    Installing from a non-main thread is a no-op (signal.signal raises
    there) — `requested` then simply stays False.
    """

    def __init__(self):
        self.requested = False
        self._prev = {}
        self._lock = threading.Lock()

    def _handler(self, signum, frame):
        if self.requested:  # second signal: defer to the previous handler
            prev = self._prev.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            if callable(prev):
                prev(signum, frame)
            else:
                signal.raise_signal(signum)
            return
        self.requested = True
        LOGGER.warning(
            "received signal %d — finishing the current step, saving "
            "last.ckpt, then exiting (repeat to force)", signum)

    def install(self, signals=(signal.SIGTERM, signal.SIGINT)) -> None:
        with self._lock:
            for sig in signals:
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:  # not the main thread
                    LOGGER.debug("GracefulStop: cannot install %s off the "
                                 "main thread", sig)

    def uninstall(self) -> None:
        with self._lock:
            for sig, prev in self._prev.items():
                try:
                    signal.signal(sig, prev)
                except ValueError:
                    pass
            self._prev.clear()

"""Ambient end-to-end request deadlines (absolute ``time.time()`` epoch
seconds), copied from ``ray_tpu/core/deadlines.py``: the serving engine
reads the ambient deadline of the calling task (:func:`current`) and the
budget left on one (:func:`remaining`).

A ContextVar, not a thread-local: async callers run many requests
interleaved on one event-loop thread, and each asyncio Task gets its own
context copy.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional

_deadline_var: contextvars.ContextVar[Optional[float]] = \
    contextvars.ContextVar("ray_tpu_torch_deadline", default=None)


def current() -> Optional[float]:
    """The ambient absolute deadline (epoch s) of this thread/task,
    or None."""
    return _deadline_var.get()


def set_current(deadline: Optional[float]) -> Optional[float]:
    """Install ``deadline`` in the current context; returns the
    previous value so callers can restore it."""
    prev = _deadline_var.get()
    _deadline_var.set(deadline)
    return prev


class scope:
    """``with deadlines.scope(dl): ...`` — install ``dl`` and restore
    the previous deadline on exit."""

    __slots__ = ("_deadline", "_prev")

    def __init__(self, deadline: Optional[float]):
        self._deadline = deadline

    def __enter__(self):
        self._prev = set_current(self._deadline)
        return self._deadline

    def __exit__(self, *exc):
        set_current(self._prev)


def remaining(deadline: Optional[float]) -> Optional[float]:
    """Seconds of budget left (may be <= 0), or None for no deadline."""
    if deadline is None:
        return None
    return deadline - time.time()


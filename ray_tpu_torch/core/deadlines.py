"""End-to-end request deadlines (the overload-robust request plane).

Following "The Tail at Scale" (Dean & Barroso, CACM 2013): under
saturation a system must degrade by *shedding* work that can no longer
meet its deadline, not by letting queues and latency grow without
bound.  The primitive here is an ABSOLUTE deadline (``time.time()``
epoch seconds — monotonic clocks don't compare across processes)
minted once at the ingress/driver root op and carried next to the
trace id on every hop:

- ``TaskSpec.deadline`` — set from ``.options(deadline_s=...)`` or
  inherited from the ambient scope at submission
  (:func:`for_submission`, mirroring ``tracing.for_submission``).
- the RPC envelope's 5th field (``cluster/rpc.py``) — the server
  re-installs it around the handler (:func:`scope_from`), so task
  submissions on the receiving node inherit the caller's budget.
- ``TaskContext.deadline`` — executing user code can read its own
  remaining budget, and anything it submits or ``get``s inherits it.

Every dequeue point (scheduler dispatch, actor mailbox, batch flush)
sheds already-expired work with a typed ``DeadlineExceededError``
instead of executing it; the shed is counted in
``ray_tpu_requests_expired_shed``.

Clock-skew caveat: cross-host deadlines assume loosely-synchronized
wall clocks (NTP-level skew is noise against second-scale serving
deadlines).
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional

# A ContextVar, NOT threading.local: async actors run many requests
# interleaved on ONE event-loop thread, and a thread-local installed
# around awaits would leak one request's deadline into another's
# resumed coroutine (poisoning its get()/submissions).  Each asyncio
# Task gets its own context copy at creation, so per-task writes stay
# per-task; on plain threads a ContextVar behaves like a thread-local.
_deadline_var: contextvars.ContextVar[Optional[float]] = \
    contextvars.ContextVar("ray_tpu_deadline", default=None)


def current() -> Optional[float]:
    """The ambient absolute deadline (epoch s) of this thread/task,
    or None."""
    return _deadline_var.get()


def set_current(deadline: Optional[float]) -> Optional[float]:
    """Install ``deadline`` in the current context; returns the
    previous value so callers can restore it (always restore — server
    handler and executor threads are reused across requests)."""
    prev = _deadline_var.get()
    _deadline_var.set(deadline)
    return prev


class scope:
    """``with deadlines.scope(dl): ...`` — install ``dl`` (which may be
    None, clearing any stale ambient deadline) and restore on exit."""

    __slots__ = ("_deadline", "_prev")

    def __init__(self, deadline: Optional[float]):
        self._deadline = deadline

    def __enter__(self):
        self._prev = set_current(self._deadline)
        return self._deadline

    def __exit__(self, *exc):
        set_current(self._prev)


def scope_from(deadline: Optional[float]) -> "scope":
    """Alias used at RPC-handler re-installation sites (parallel to
    ``tracing.scope_from``)."""
    return scope(deadline)


def for_submission(deadline_s: Optional[float]) -> Optional[float]:
    """The absolute deadline for a spec being minted NOW: an explicit
    ``deadline_s`` option wins (relative to now); else inherit the
    ambient deadline (a parent task's / RPC caller's budget)."""
    if deadline_s is not None:
        return time.time() + float(deadline_s)
    return current()


def remaining(deadline: Optional[float]) -> Optional[float]:
    """Seconds of budget left (may be <= 0), or None for no deadline."""
    if deadline is None:
        return None
    return deadline - time.time()


def expired(deadline: Optional[float]) -> bool:
    return deadline is not None and time.time() >= deadline

"""Cross-process trace propagation.

Reference analogue: the OpenTelemetry hooks threaded through Ray's
task submission paths (tracing_utils.py decorators around submit /
actor-call) plus the (trace ctx → task spec → worker) plumbing.  Here
the trace context is two ids:

- ``trace_id`` — minted once per driver-side ROOT operation (a bare
  ``.remote()`` from the driver, a compiled-DAG ``execute``, a serve
  request, a train step) and inherited by everything transitively
  submitted under it.
- ``span_id`` — one per recorded span (task execution, driver-side
  scope); a child records its parent's span id as ``parent_span_id``.

Propagation path: submission reads :func:`current` (thread-local) into
the TaskSpec's ``trace_id``/``parent_span_id``; cross-process hops
carry the pair in the RPC envelope (``cluster/rpc.py``) and in task
bundles, and the receiving server re-installs it around the handler so
specs minted there inherit; execution installs (trace_id, own span_id)
for the task's duration so nested submissions chain correctly.  Spans
land in ``observability.timeline`` tagged with all three ids, so the
merged cluster timeline can stitch one distributed pass together.

``disable()`` turns the whole plane into no-ops (``current`` → None,
ids → None, spans untagged) — the ``obs_overhead_pct`` bench phase
measures its cost this way.
"""

from __future__ import annotations

import itertools
import os
import random
import contextvars
import threading
import time
from typing import Any, Dict, Optional, Tuple

# A ContextVar, NOT threading.local: async actors interleave many
# requests on one event-loop thread, and each request runs as its
# own asyncio task — the trace scope must follow the task, or a
# request resuming after an await logs/submits under whichever
# trace last dispatched (same reasoning as core/deadlines.py).
# On plain threads a ContextVar behaves like a thread-local.
_ctx_var: "contextvars.ContextVar[Optional[TraceCtx]]" = \
    contextvars.ContextVar("ray_tpu_trace", default=None)
# RAY_TPU_TRACING=0 disables the plane process-wide (worker
# subprocesses inherit it through the environment — how the bench
# measures a whole cluster untraced).
_enabled = os.environ.get("RAY_TPU_TRACING", "1").lower() not in (
    "0", "false", "off")

# Fast id minting: ids are needed per task submission, and
# os.urandom/uuid4 costs hundreds of µs on some kernels — far too
# much for a hot path.  A process-unique prefix (pid + one random
# draw at import) plus an atomic counter is unique across the cluster
# and costs ~100ns.
_id_prefix = f"{os.getpid() & 0xFFFFFF:06x}{random.getrandbits(24):06x}"
_id_counter = itertools.count(1)  # next() is atomic in CPython

# A trace context is (trace_id, span_id) — span_id is the would-be
# parent of anything submitted while the context is current.
TraceCtx = Tuple[str, Optional[str]]


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn tracing into no-ops (bench: measures the plane's cost)."""
    global _enabled
    _enabled = False


def new_trace_id() -> Optional[str]:
    if not _enabled:
        return None
    return f"{_id_prefix}{next(_id_counter):08x}"


def new_span_id() -> Optional[str]:
    if not _enabled:
        return None
    return f"{_id_prefix}{next(_id_counter):08x}"


def current() -> Optional[TraceCtx]:
    """The thread's active (trace_id, parent_span_id), or None."""
    if not _enabled:
        return None
    return _ctx_var.get()


def set_current(ctx: Optional[TraceCtx]) -> Optional[TraceCtx]:
    """Install ``ctx`` on this thread; returns the previous context so
    callers can restore it (always restore — server handler threads
    are reused)."""
    prev = _ctx_var.get()
    _ctx_var.set(ctx)
    return prev


def for_submission() -> Tuple[Optional[str], Optional[str]]:
    """(trace_id, parent_span_id) for a task spec being minted NOW:
    inherit the active context, else this submission IS a root
    operation and gets a fresh trace id."""
    if not _enabled:
        return None, None
    ctx = _ctx_var.get()
    if ctx is not None:
        return ctx[0], ctx[1]
    return new_trace_id(), None


class span:
    """Context manager for a DRIVER-SIDE span (DAG execute, serve
    request, train step): mints a trace id if none is active, makes
    this span the parent of everything submitted inside, and records
    it to the timeline on exit::

        with tracing.span("dag.execute"):
            ...  # submissions inherit the trace
    """

    __slots__ = ("name", "args", "trace_id", "span_id",
                 "parent_span_id", "_prev", "_t0")

    def __init__(self, name: str, args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.args = args

    def __enter__(self) -> "span":
        if not _enabled:
            self.trace_id = self.span_id = self.parent_span_id = None
            self._prev = None
            return self
        prev = _ctx_var.get()
        if prev is not None:
            self.trace_id, self.parent_span_id = prev
        else:
            self.trace_id, self.parent_span_id = new_trace_id(), None
        self.span_id = new_span_id()
        self._prev = set_current((self.trace_id, self.span_id))
        self._t0 = time.time()
        return self

    def __exit__(self, *exc) -> None:
        if self.trace_id is None:
            return
        # Restore UNCONDITIONALLY once a context was installed —
        # tracing.disable() landing mid-span must not leak this span's
        # ctx onto the thread forever; only the recording is gated.
        set_current(self._prev)
        if not _enabled:
            return
        from .timeline import process_pid, record_span

        args = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_span_id:
            args["parent_span_id"] = self.parent_span_id
        if self.args:
            args.update(self.args)
        record_span(self.name, self._t0, time.time(),
                    pid=process_pid(),
                    tid=threading.current_thread().name, args=args)


class scope_from:
    """Re-install a context received over the wire (RPC envelope /
    task bundle) around a block — the server-side half of
    propagation.  A None ctx is a no-op (leaves the thread as-is)."""

    __slots__ = ("_ctx", "_prev", "_installed")

    def __init__(self, ctx):
        self._ctx = tuple(ctx) if ctx else None

    def __enter__(self):
        self._installed = _enabled and self._ctx is not None
        if self._installed:
            self._prev = set_current(self._ctx)
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            set_current(self._prev)

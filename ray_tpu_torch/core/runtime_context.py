"""Per-thread execution context (who am I, which task am I running).

Reference semantics: python/ray/runtime_context.py:15 — introspection of
current job/task/actor/node plus ``was_current_actor_reconstructed`` etc.
"""

from __future__ import annotations

import contextvars
from typing import Any, Dict, Optional

from .ids import ActorID, JobID, NodeID, TaskID, WorkerID

# Per-asyncio-task, not merely per-thread (see core/deadlines.py):
# an async actor interleaves requests on one loop thread, and the
# executing task's identity must follow each request across awaits
# — log records and nested submissions stamp from here.
_ctx_var: "contextvars.ContextVar[Optional[TaskContext]]" = \
    contextvars.ContextVar("ray_tpu_task_ctx", default=None)


class TaskContext:
    __slots__ = ("task_id", "task_name", "actor_id", "attempt_number",
                 "parent_task_id", "trace_id", "span_id", "deadline")

    def __init__(self, task_id: TaskID, task_name: str = "",
                 actor_id: Optional[ActorID] = None, attempt_number: int = 0,
                 parent_task_id: Optional[TaskID] = None,
                 trace_id: Optional[str] = None,
                 span_id: Optional[str] = None,
                 deadline: Optional[float] = None):
        self.task_id = task_id
        self.task_name = task_name
        self.actor_id = actor_id
        self.attempt_number = attempt_number
        self.parent_task_id = parent_task_id
        # Distributed tracing (observability/tracing.py): the trace
        # this execution belongs to and the span it records.
        self.trace_id = trace_id
        self.span_id = span_id
        # Absolute end-to-end deadline (core/deadlines.py): user code
        # can read its remaining budget; batch flush drops entries
        # whose deadline passed while they coalesced.
        self.deadline = deadline


def set_task_context(ctx: Optional[TaskContext]):
    _ctx_var.set(ctx)


def current_task_context() -> Optional[TaskContext]:
    return _ctx_var.get()


class RuntimeContext:
    def __init__(self, runtime):
        self._runtime = runtime

    def get_job_id(self) -> str:
        return self._runtime.job_id.hex()

    def get_node_id(self) -> str:
        return self._runtime.node_id.hex()

    def get_worker_id(self) -> str:
        return self._runtime.worker_id.hex()

    def get_task_id(self) -> Optional[str]:
        ctx = current_task_context()
        return ctx.task_id.hex() if ctx else None

    def get_task_name(self) -> Optional[str]:
        ctx = current_task_context()
        return ctx.task_name if ctx else None

    def get_actor_id(self) -> Optional[str]:
        ctx = current_task_context()
        if ctx and ctx.actor_id is not None:
            return ctx.actor_id.hex()
        return None

    def get_actor_name(self) -> Optional[str]:
        aid = self.get_actor_id()
        if aid is None:
            return None
        return self._runtime.actor_manager.actor_name(ActorID.from_hex(aid))

    def get_attempt_number(self) -> int:
        ctx = current_task_context()
        return ctx.attempt_number if ctx else 0

    def get_trace_id(self) -> Optional[str]:
        """The distributed trace id of the current task (or the active
        driver-side tracing scope), for log correlation."""
        ctx = current_task_context()
        if ctx is not None and ctx.trace_id is not None:
            return ctx.trace_id
        from ..observability import tracing

        cur = tracing.current()
        return cur[0] if cur else None

    def get_deadline(self):
        """The current task's absolute end-to-end deadline (epoch s),
        or None when the request carries no deadline.  The ambient
        contextvar is consulted FIRST: it is per-asyncio-task, so it
        stays correct when an async actor interleaves many requests on
        one loop thread — the thread-local TaskContext is overwritten
        at every task switch and is only the sync-path fallback."""
        from . import deadlines

        ambient = deadlines.current()
        if ambient is not None:
            return ambient
        ctx = current_task_context()
        if ctx is not None and ctx.deadline is not None:
            return ctx.deadline
        return None

    def remaining_deadline_s(self):
        """Seconds of budget left (may be negative), or None."""
        from . import deadlines

        return deadlines.remaining(self.get_deadline())

    def current_actor(self):
        aid = self.get_actor_id()
        if aid is None:
            raise RuntimeError("not running inside an actor")
        return self._runtime.actor_manager.get_handle(ActorID.from_hex(aid))

    @property
    def namespace(self) -> str:
        return self._runtime.namespace

    def get_runtime_env(self) -> Dict[str, Any]:
        return dict(self._runtime.runtime_env or {})

    def get_assigned_resources(self) -> Dict[str, float]:
        ctx = current_task_context()
        if ctx is None:
            return {}
        return self._runtime.scheduler.assigned_resources(ctx.task_id)

    def was_current_actor_reconstructed(self) -> bool:
        aid = self.get_actor_id()
        if aid is None:
            return False
        return self._runtime.actor_manager.num_restarts(
            ActorID.from_hex(aid)) > 0

"""Typed errors of the port's serving engine.

Copied from ``ray_tpu/exceptions.py`` (the port imports nothing of
``ray_tpu``): the engine rejects a full queue with
``BackPressureError`` and sheds late work with
``DeadlineExceededError``, with the same fields and messages.
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base for all framework errors."""


def _format_context(context) -> str:
    """``" [k=v k2=v2]"`` suffix for error messages, or ""."""
    if not context:
        return ""
    parts = []
    for k, v in dict(context).items():
        if isinstance(v, bytes):
            v = v.hex()[:16]
        parts.append(f"{k}={v}")
    return " [" + " ".join(parts) + "]" if parts else ""


class BackPressureError(RayTpuError):
    """Request rejected by admission control: a bounded queue is full.
    Deliberately a REJECTION, not a failure — the work was never
    started, so the caller may safely retry after ``retry_after_s``."""

    def __init__(self, reason: str = "request rejected: queue full",
                 retry_after_s: float | None = None, context=None):
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.context = dict(context or {})
        ctx = dict(self.context)
        if retry_after_s is not None:
            ctx.setdefault("retry_after_s", round(retry_after_s, 3))
        super().__init__(reason + _format_context(ctx))

    def __reduce__(self):
        return (type(self), (self.reason, self.retry_after_s,
                             self.context))


class DeadlineExceededError(RayTpuError, TimeoutError):
    """The request's end-to-end deadline expired; ``context`` names the
    shed point (``where``)."""

    def __init__(self, reason: str = "deadline exceeded",
                 deadline: float | None = None, context=None):
        self.reason = reason
        self.deadline = deadline
        self.context = dict(context or {})
        super().__init__(reason + _format_context(self.context))

    def __reduce__(self):
        return (type(self), (self.reason, self.deadline, self.context))

"""User-facing error types.

Reference semantics: python/ray/exceptions.py — errors are themselves
objects: a failed task's return object *contains* the error, so it
propagates through dependency chains (TaskError wrapping) and surfaces at
``get`` time.
"""

from __future__ import annotations

import pickle
import traceback


class RayTpuError(Exception):
    """Base for all framework errors."""


def _format_context(context) -> str:
    """``" [k=v k2=v2]"`` suffix for FT error messages, or "".

    A ``last_logs`` key (the death report's final log excerpt) renders
    as an indented block after the suffix instead of inline — five log
    lines crammed into the bracket would bury the cause fields
    (``signal=``, ``oom=``, ``postmortem=``) they accompany."""
    if not context:
        return ""
    ctx = dict(context)
    last_logs = ctx.pop("last_logs", None)
    parts = []
    for k, v in ctx.items():
        if isinstance(v, bytes):
            v = v.hex()[:16]
        parts.append(f"{k}={v}")
    out = " [" + " ".join(parts) + "]" if parts else ""
    if last_logs:
        out += "\n  last logs from the dead process:"
        for line in list(last_logs)[-5:]:
            out += f"\n    {str(line)[:300]}"
    return out


def _picklable_cause(cause: BaseException) -> BaseException:
    """Return ``cause`` if it survives a pickle round-trip, else a
    stringified stand-in.  Errors cross the RPC boundary inside task
    results; an unpicklable user exception must degrade gracefully
    rather than kill the connection's reader."""
    try:
        pickle.loads(pickle.dumps(cause))
        return cause
    except Exception:
        return RayTpuError(f"{type(cause).__name__}: {cause}")


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at ``get`` of its outputs.

    Mirrors RayTaskError (python/ray/exceptions.py) including cause
    chaining: if a task fails because an *argument* holds a TaskError,
    the original error is propagated unwrapped.

    Custom ``__init__`` signatures break the default ``Exception``
    reduce (it replays ``cls(*args)`` with ``args`` = the message), so
    every exception here with extra fields defines ``__reduce__``.
    """

    def __init__(self, function_name: str, cause: BaseException,
                 tb_str: str | None = None):
        self.function_name = function_name
        self.tb_str = tb_str or "".join(
            traceback.format_exception(type(cause), cause, cause.__traceback__)
        )
        self.cause = cause
        super().__init__(f"task {function_name} failed: {cause!r}")

    def __reduce__(self):
        # Sanitize lazily: local (non-cluster) consumers keep the real
        # cause object; only the wire copy degrades to a stand-in.
        return (type(self),
                (self.function_name, _picklable_cause(self.cause),
                 self.tb_str))

    def __str__(self):
        return (f"{type(self.cause).__name__} in task {self.function_name}\n"
                f"{self.tb_str}")


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    """The actor is dead (creation failed, killed, or out of restarts).

    Carries structured context so the message is actionable at the
    driver: ``node_id`` (where it was hosted) and a free-form
    ``context`` dict the failure site fills in (pass/step index,
    originating channel edge, chaos detail, ...)."""

    def __init__(self, actor_id=None, reason: str = "actor died",
                 node_id=None, context=None):
        self.actor_id = actor_id
        self.reason = reason
        self.node_id = node_id
        self.context = dict(context or {})
        ctx = dict(self.context)
        if actor_id is not None:
            hexfn = getattr(actor_id, "hex", None)
            ctx.setdefault("actor_id",
                           hexfn()[:16] if callable(hexfn) else actor_id)
        if node_id is not None:
            ctx.setdefault("node_id", str(node_id)[:16])
        super().__init__(reason + _format_context(ctx))

    def __reduce__(self):
        return (type(self), (self.actor_id, self.reason, self.node_id,
                             self.context))


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (restarting)."""


class ObjectLostError(RayTpuError):
    """Object value unrecoverable (all copies lost, lineage exhausted).

    ``context`` mirrors ActorDiedError: holder node, originating edge,
    pass index — whatever the failure site knows."""

    def __init__(self, object_ref=None, reason: str = "object lost",
                 context=None):
        self.object_ref = object_ref
        self.reason = reason
        self.context = dict(context or {})
        super().__init__(reason + _format_context(self.context))

    def __reduce__(self):
        return (type(self), (self.object_ref, self.reason, self.context))


class ChannelError(RayTpuError):
    """A channel-data-plane edge failed: the producer feeding the ring
    raised (its error frame rides here as ``__cause__``), the ring was
    severed/closed mid-pass, or the read deadline expired.  ``context``
    names the edge (ring path, producer actor, frame/pass index) so the
    driver-side message is actionable.  Propagates UNWRAPPED through
    task results (like the other FT errors) so callers can catch it
    typed."""

    def __init__(self, reason: str = "channel error", context=None):
        self.reason = reason
        self.context = dict(context or {})
        super().__init__(reason + _format_context(self.context))

    def __reduce__(self):
        return (type(self), (self.reason, self.context))


class ShuffleError(RayTpuError):
    """A push-based exchange (data/exchange.py) failed as a whole: a
    map task died mid-shuffle, pushed fragments never landed at their
    reducers within the deadline, or a reducer actor was lost.  The
    exchange tears its reducers/rings down BEFORE raising, so a failed
    shuffle never leaves hung reader threads behind.  ``context`` names
    the exchange (op, shuffle id, expected/received fragment counts)."""

    def __init__(self, reason: str = "shuffle failed", context=None):
        self.reason = reason
        self.context = dict(context or {})
        super().__init__(reason + _format_context(self.context))

    def __reduce__(self):
        return (type(self), (self.reason, self.context))


class ZipLengthMismatchError(RayTpuError, ValueError):
    """``Dataset.zip`` requires equal row counts; raised driver-side
    from the metadata round, before any block moves."""

    def __init__(self, left_rows: int, right_rows: int):
        self.left_rows = int(left_rows)
        self.right_rows = int(right_rows)
        super().__init__(
            f"Dataset.zip requires equal row counts: left has "
            f"{self.left_rows} rows, right has {self.right_rows}")

    def __reduce__(self):
        return (type(self), (self.left_rows, self.right_rows))


class UnionSchemaError(RayTpuError, TypeError):
    """``Dataset.union`` requires every source to share one column
    set; raised from the schema probe before blocks interleave."""

    def __init__(self, left_schema, right_schema):
        self.left_schema = sorted(left_schema)
        self.right_schema = sorted(right_schema)
        super().__init__(
            f"Dataset.union sources disagree on columns: "
            f"{self.left_schema} vs {self.right_schema}")

    def __reduce__(self):
        return (type(self), (self.left_schema, self.right_schema))


class ObjectFreedError(ObjectLostError):
    """Object was explicitly freed by the application."""


class OwnerDiedError(ObjectLostError):
    """The object's owner process died; value and lineage are gone."""


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__("task was cancelled")

    def __reduce__(self):
        return (type(self), (self.task_id,))


class PendingCallsLimitExceededError(RayTpuError):
    """Actor's max_pending_calls exceeded — the bounded-mailbox
    admission signal.  Serve's router treats it as *route elsewhere*
    (the replica is saturated, not broken); bare actor callers see it
    raised at submission."""


class BackPressureError(RayTpuError):
    """Request rejected by admission control: a bounded queue (replica
    mailbox, ``@serve.batch`` queue, router with every replica
    saturated) is full.  Deliberately a REJECTION, not a failure — the
    work was never started, so the caller may safely retry after
    ``retry_after_s`` (the HTTP proxy maps this to 503 + Retry-After,
    the gRPC proxy to UNAVAILABLE)."""

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
    """The request's end-to-end deadline expired.  Raised both when
    already-expired work is SHED before execution (scheduler dispatch,
    actor mailbox dequeue, batch flush — user code never ran) and when
    a caller's ``get``/``result`` budget runs out while the work is
    still in flight.  ``context`` names the shed point (``where``) and
    how late the work was (``late_by_s``)."""

    def __init__(self, reason: str = "deadline exceeded",
                 deadline: float | None = None, context=None):
        self.reason = reason
        self.deadline = deadline
        self.context = dict(context or {})
        super().__init__(reason + _format_context(self.context))

    def __reduce__(self):
        return (type(self), (self.reason, self.deadline, self.context))


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get`` exceeded its timeout."""


class RuntimeEnvSetupError(RayTpuError):
    """Preparing a worker's runtime environment failed."""


class NodeDiedError(RayTpuError):
    pass


class StaleEpochError(RayTpuError):
    """A mutating control-plane RPC carried a fenced lease epoch.

    The head minted the caller a ``(lease_id, epoch)`` pair at node
    registration; declaring the node dead fences that epoch, and a
    later re-registration mints a strictly newer one.  A write arriving
    with a superseded epoch is a ZOMBIE — a node that was declared dead
    and never re-attached (partition heal, paused VM, delayed packet) —
    and is rejected typed instead of silently overwriting live state
    (the classic lease-fencing pattern; reference: GCS node-death
    fencing via raylet restarts + the fencing-token literature).

    The fix on the caller's side is always the same: re-register (the
    heartbeat loop does this automatically on its next beat) and replay
    intent against the CURRENT cluster state, which may have moved on.
    """

    def __init__(self, reason: str = "stale lease epoch", *,
                 node_id: str = "", sent_epoch=None,
                 current_epoch=None, context=None):
        self.reason = reason
        self.node_id = node_id
        self.sent_epoch = sent_epoch
        self.current_epoch = current_epoch
        self.context = dict(context or {})
        ctx = dict(self.context)
        if node_id:
            ctx.setdefault("node_id", node_id[:12])
        if sent_epoch is not None:
            ctx.setdefault("sent_epoch", sent_epoch)
        if current_epoch is not None:
            ctx.setdefault("current_epoch", current_epoch)
        super().__init__(reason + _format_context(ctx))

    def __reduce__(self):
        return (_rebuild_stale_epoch,
                (self.reason, self.node_id, self.sent_epoch,
                 self.current_epoch, self.context))


def _rebuild_stale_epoch(reason, node_id, sent, cur, context):
    return StaleEpochError(reason, node_id=node_id, sent_epoch=sent,
                           current_epoch=cur, context=context)


class NotPrimaryError(StaleEpochError):
    """A mutating control-plane RPC reached a head that is not the
    current primary — a standby still tailing the journal, or a
    DEPOSED primary fenced by a newer head generation after failover.

    Subclasses :class:`StaleEpochError` because the contract is the
    same lease-fencing contract one level up: head *generations* are
    fencing tokens minted at promotion, exactly as node epochs are
    minted at registration.  A write acked by a deposed primary would
    be a zombie write at cluster scope, so it is rejected typed before
    it can land.

    ``generation`` is the rejecting head's generation;
    ``primary_hint`` (may be "") is the address that head believes is
    the current primary — clients use it to re-resolve their head set
    (``ClusterClient.mut_call`` fails over and retries).
    """

    def __init__(self, reason: str = "head is not primary", *,
                 generation: int = 0, primary_hint: str = "",
                 context=None):
        self.generation = int(generation)
        self.primary_hint = primary_hint
        ctx = dict(context or {})
        ctx.setdefault("head_gen", self.generation)
        if primary_hint:
            ctx.setdefault("primary_hint", primary_hint)
        super().__init__(reason, context=ctx)

    def __reduce__(self):
        return (_rebuild_not_primary,
                (self.reason, self.generation, self.primary_hint,
                 self.context))


def _rebuild_not_primary(reason, generation, primary_hint, context):
    return NotPrimaryError(reason, generation=generation,
                           primary_hint=primary_hint, context=context)


class OutOfMemoryError(RayTpuError):
    """Worker killed by the memory monitor (reference: OOM killer, N22)."""


class WorkerCrashedError(RayTpuError):
    """An isolated worker subprocess died mid-task (segfault, os._exit,
    external kill).  A system failure: retried within max_retries
    (reference: worker process death → task retry)."""

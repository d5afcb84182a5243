"""Dynamic request batching.

Reference: serve/batching.py:80,597 — ``@serve.batch`` queues single
calls inside the replica and invokes the wrapped function with a list
once ``max_batch_size`` is reached or ``batch_wait_timeout_s`` expires.
Runs on the replica's asyncio loop (async actors), so waiting requests
don't block the event loop.

Overload robustness: the pending queue is BOUNDED
(``max_queue_size``, default 8× ``max_batch_size``) — a stalled
downstream rejects new entries with a typed ``BackPressureError``
instead of growing without bound — and every entry remembers its
request deadline (``TaskContext.deadline``): a flush drops entries
whose deadline passed while they coalesced, failing just those waiters
with ``DeadlineExceededError`` before the wrapped function runs.
"""

from __future__ import annotations

import asyncio
import functools
import time
from typing import Any, Callable, List, Optional


def _entry_deadline() -> Optional[float]:
    """The calling request's absolute deadline, if it carries one.
    The ambient contextvar comes first: it is per-asyncio-task, so it
    stays correct when an async replica interleaves many requests on
    one loop thread (the thread-local TaskContext is the sync-path
    fallback)."""
    from ..core import deadlines as _deadlines
    from ..core import runtime_context as rc

    ambient = _deadlines.current()
    if ambient is not None:
        return ambient
    ctx = rc.current_task_context()
    if ctx is not None and ctx.deadline is not None:
        return ctx.deadline
    return None


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 timeout_s: float, max_queue_size: Optional[int] = None):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_s
        # Bounded mailbox: entries beyond this reject instead of queue.
        self.max_queue_size = (8 * max_batch_size
                               if max_queue_size is None
                               else int(max_queue_size))
        self._pending: List[tuple] = []  # (arg, future, deadline)
        self._flush_task: Optional[asyncio.Task] = None
        # Per-queue gauge identity: multiple @serve.batch functions in
        # one process must not overwrite each other's depth series.
        self._gauge_tags = {
            "queue": f"serve_batch:{getattr(fn, '__qualname__', 'fn')}"}

    def _overload(self):
        from ..observability.metrics import overload_counters

        return overload_counters()

    async def submit(self, instance, arg):
        if 0 < self.max_queue_size <= len(self._pending):
            from ..exceptions import BackPressureError

            self._overload()["backpressure"].inc(
                tags={"where": "serve_batch"})
            raise BackPressureError(
                f"@serve.batch queue full "
                f"({len(self._pending)}/{self.max_queue_size})",
                retry_after_s=self.timeout_s,
                context={"where": "serve_batch"})
        loop = asyncio.get_event_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((arg, fut, _entry_deadline()))
        self._overload()["queue_depth"].set(
            len(self._pending), tags=self._gauge_tags)
        if len(self._pending) >= self.max_batch_size:
            await self._flush(instance)
        elif self._flush_task is None or self._flush_task.done():
            self._flush_task = loop.create_task(
                self._flush_after_timeout(instance))
        return await fut

    async def _flush_after_timeout(self, instance):
        try:
            await asyncio.sleep(self.timeout_s)
        except asyncio.CancelledError:
            return
        await self._flush(instance)

    async def _flush(self, instance):
        # A size-triggered flush must cancel the pending timer, or the
        # stale timer fires early into the NEXT batch's coalescing
        # window and collapses batch sizes under steady load.
        task = self._flush_task
        self._flush_task = None
        if task is not None and task is not asyncio.current_task() \
                and not task.done():
            task.cancel()
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        self._overload()["queue_depth"].set(0, tags=self._gauge_tags)
        # Deadline shed at the flush point: entries that expired while
        # coalescing fail typed, WITHOUT riding into the wrapped fn —
        # running them would only add latency for the live entries.
        now = time.time()
        live = []
        for a, f, dl in batch:
            if dl is not None and now >= dl:
                self._overload()["expired_shed"].inc(
                    tags={"where": "batch_flush"})
                if not f.done():
                    from ..exceptions import DeadlineExceededError

                    f.set_exception(DeadlineExceededError(
                        "batch entry shed at flush: deadline exceeded",
                        deadline=dl,
                        context={"where": "batch_flush",
                                 "late_by_s": round(now - dl, 4)}))
            else:
                live.append((a, f))
        if not live:
            return
        args = [a for a, _f in live]
        futs = [f for _a, f in live]
        try:
            if instance is not None:
                results = await self.fn(instance, args)
            else:
                results = await self.fn(args)
            if len(results) != len(args):
                raise RuntimeError(
                    f"@serve.batch function returned {len(results)} "
                    f"results for a batch of {len(args)}")
            for f, r in zip(futs, results):
                if not f.done():
                    f.set_result(r)
        except BaseException as e:  # noqa: BLE001 — fail each waiter
            for f in futs:
                if not f.done():
                    f.set_exception(e)


def batch(_func: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01,
          max_queue_size: Optional[int] = None):
    """``@serve.batch`` — the wrapped coroutine receives a LIST of the
    single-call arguments and must return a list of equal length.
    ``max_queue_size`` (default 8× ``max_batch_size``; <= 0 disables)
    bounds the coalescing queue: beyond it, submissions reject with
    ``BackPressureError`` instead of queueing without bound."""

    def deco(fn: Callable):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError("@serve.batch requires an async function")
        queues: dict = {}  # instance id -> _BatchQueue

        @functools.wraps(fn)
        async def wrapper(*args):
            if len(args) == 2:          # bound method: (self, arg)
                instance, arg = args
                key = id(instance)
            elif len(args) == 1:        # free function: (arg,)
                instance, arg = None, args[0]
                key = 0
            else:
                raise TypeError(
                    "@serve.batch methods take exactly one argument")
            q = queues.get(key)
            if q is None:
                q = queues[key] = _BatchQueue(
                    fn, max_batch_size, batch_wait_timeout_s,
                    max_queue_size)
            return await q.submit(instance, arg)

        wrapper._is_serve_batch = True
        return wrapper

    if _func is not None:
        return deco(_func)
    return deco

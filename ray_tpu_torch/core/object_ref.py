"""ObjectRef: a distributed future addressing one immutable object.

Reference semantics: ObjectRef in python/ray/includes/object_ref.pxi +
ownership in src/ray/core_worker/reference_count.h:64.  A ref is created
eagerly at submission time (ObjectID = TaskID + index, lineage encoded),
before the value exists; ``get`` blocks until the value is sealed in the
owner's store.  Refs participate in distributed GC: the runtime is told
when Python drops the last local reference.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Optional

from .ids import ObjectID

# Deferred release queue: ``__del__`` runs inside the garbage collector
# at ARBITRARY points — including while the collecting thread holds the
# object-store lock (a dict insert in ``put`` can trigger GC) — so the
# release path (store free, plasma free, borrower-release RPCs!) must
# never run inline there.  __del__ only appends to this deque
# (GIL-atomic, lock-free); a reaper thread drains it.
_pending_releases: "collections.deque" = collections.deque()


def _release_loop():
    while True:
        try:
            rt, oid = _pending_releases.popleft()
        except IndexError:
            # Plain polling on purpose: an Event/Condition set from
            # __del__ could re-enter its own (non-reentrant) lock if GC
            # fires inside a notify — the very deadlock this thread
            # exists to avoid.  50 ms idle latency is invisible to the
            # GC-driven release path.
            time.sleep(0.05)
            continue
        if rt.is_shutdown:
            continue
        try:
            rt.reference_counter.remove_local_reference(oid)
        except Exception:
            pass


_reaper = threading.Thread(target=_release_loop, daemon=True,
                           name="raytpu-ref-reaper")
_reaper.start()


class ObjectRef:
    __slots__ = ("_id", "_owner", "_call_site", "_runtime", "__weakref__")

    def __init__(self, object_id: ObjectID, runtime=None, owner: str = "",
                 call_site: str = "", add_local_ref: bool = True):
        self._id = object_id
        self._owner = owner
        self._call_site = call_site
        self._runtime = runtime
        if runtime is not None and add_local_ref:
            runtime.reference_counter.add_local_reference(object_id)

    def object_id(self) -> ObjectID:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def binary(self) -> bytes:
        return self._id.binary()

    def task_id(self):
        return self._id.task_id()

    def owner_address(self) -> str:
        return self._owner

    def call_site(self) -> str:
        return self._call_site

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and self._id == other._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __del__(self):
        rt = self._runtime
        if rt is not None and not rt.is_shutdown:
            _pending_releases.append((rt, self._id))

    # Futures protocol -------------------------------------------------------
    def future(self) -> "threading.Event":
        return self._runtime.object_store.completion_event(self._id)

    def _on_completed(self, callback: Callable[[Any], None]):
        """Invoke callback with the sealed RayObject (value or error)."""
        self._runtime.object_store.add_done_callback(self._id, callback)

    def __await__(self):
        # Asyncio interop: ray.get in a thread to avoid blocking the loop.
        import asyncio

        loop = asyncio.get_event_loop()
        fut = loop.create_future()

        def _done(obj):
            def _set():
                if fut.cancelled():
                    return
                err = obj.error
                if err is not None:
                    fut.set_exception(err)
                else:
                    fut.set_result(obj.value)

            loop.call_soon_threadsafe(_set)

        self._on_completed(_done)
        return fut.__await__()

    def __reduce__(self):
        # Serializing a ref ships the id + owner address; the receiving
        # runtime re-registers it and can fetch the value from the owner
        # (borrower protocol, simplified: no distributed ref counts yet).
        owner = self._owner
        if not owner and self._runtime is not None:
            owner = getattr(self._runtime, "address", "") or ""
        return (_deserialize_ref, (self._id, owner, self._call_site))


def _deserialize_ref(object_id, owner, call_site):
    from .runtime import try_get_runtime

    rt = try_get_runtime()
    return ObjectRef(object_id, rt, owner, call_site)


class ObjectRefGenerator:
    """Streaming-generator handle (reference: _raylet.pyx:284 — tasks with
    ``num_returns="streaming"``).  Iterating yields ObjectRefs as the
    executor reports them; supports both sync and async iteration."""

    def __init__(self, generator_id: ObjectID, runtime):
        self._generator_id = generator_id
        self._runtime = runtime
        self._index = 0
        self._lock = threading.Lock()

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        return self.next_ref()

    def next_ref(self, timeout: Optional[float] = None) -> ObjectRef:
        """``__next__`` with an optional bound on the item wait.  On
        timeout raises ``GetTimeoutError`` and puts the index back, so
        a later call retries the same item (single-consumer iteration
        assumed, as with any generator)."""
        with self._lock:
            idx = self._index
            self._index += 1
        try:
            item_id = self._runtime.streaming_manager.wait_item(
                self._generator_id, idx, timeout)
        except TimeoutError:
            with self._lock:
                self._index -= 1
            from ..exceptions import GetTimeoutError

            raise GetTimeoutError(
                f"streaming item {idx} not reported within {timeout}s")
        if item_id is None:
            raise StopIteration
        return ObjectRef(item_id, self._runtime)

    def __aiter__(self):
        return self

    async def __anext__(self) -> ObjectRef:
        import asyncio

        loop = asyncio.get_event_loop()
        try:
            return await loop.run_in_executor(None, self.__next__)
        except StopIteration:
            raise StopAsyncIteration

    def completed(self) -> bool:
        return self._runtime.streaming_manager.is_finished(self._generator_id)

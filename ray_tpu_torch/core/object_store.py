"""In-memory object store: the owner's view of object values.

Reference semantics: the core-worker in-process memory store
(src/ray/core_worker/store_provider/memory_store/memory_store.h:43) —
small/inlined results live here; big values live in the node's shared
store (ray_tpu_torch.core.plasma, cluster mode).  Objects are immutable once
sealed; sealing fires completion callbacks (get waiters, dependency
resolution, streaming consumers).

Values may hold ``torch.Tensor``s, CUDA ones included.  They stay on
their device (no host transfer) but are cloned there at seal and at
every read, because a tensor is mutable (cluster/serialization.py);
cross-process transfer goes through the serialization layer, which
copies to the host only at the boundary.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .ids import ObjectID
from ..exceptions import GetTimeoutError, ObjectFreedError

_UNSET = object()


class RayObject:
    """A sealed object: exactly one of sealed-value / error / remote
    location is meaningful.

    Values are sealed through the serialization boundary at put time
    (cluster/serialization.py): each ``value`` access deserializes a
    fresh copy of the container structure, so a consumer mutating a
    ``get`` result can never alias the producer's copy or another
    consumer's (reference plasma semantics).  numpy leaves are shared
    as frozen read-only copies; tensor leaves are cloned on their
    device at every access.

    A *location record* (``location=(node_id, address)``) is the owner's
    view of a primary copy pinned on the executing node (reference:
    plasma-resident big task returns + ownership-based object directory,
    ownership_based_object_directory.h).  ``get`` materializes it via a
    chunked pull; losing the holder triggers lineage reconstruction.
    """

    __slots__ = ("sealed", "error", "size_bytes", "location")

    def __init__(self, value: Any = _UNSET, error: Optional[BaseException] = None,
                 size_bytes: Optional[int] = None, sealed=None,
                 location: Optional[tuple] = None):
        if sealed is not None:
            self.sealed = sealed
        elif value is not _UNSET:
            from ..cluster.serialization import serialize

            self.sealed = serialize(value)
        else:
            self.sealed = None
        self.error = error
        self.location = location
        if size_bytes is None:
            size_bytes = self.sealed.size_bytes if self.sealed else 0
        self.size_bytes = size_bytes

    @property
    def value(self) -> Any:
        if self.sealed is None:
            if self.location is not None:
                raise RuntimeError(
                    "located object was not materialized before value "
                    "access (runtime.get pulls it first)")
            return None
        from ..cluster.serialization import deserialize

        return deserialize(self.sealed)

    def is_error(self) -> bool:
        return self.error is not None

    def is_located_only(self) -> bool:
        return (self.sealed is None and self.error is None
                and self.location is not None)


class MemoryStore:
    """Thread-safe object table with completion events + callbacks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objects: Dict[ObjectID, RayObject] = {}
        self._events: Dict[ObjectID, threading.Event] = {}
        self._callbacks: Dict[ObjectID, List[Callable[[RayObject], None]]] = {}
        self._total_bytes = 0

    # -- write side ----------------------------------------------------------
    def put(self, object_id: ObjectID, obj: RayObject) -> None:
        with self._lock:
            if object_id in self._objects:
                # Objects are immutable: double-seal keeps the first value.
                # (Happens on speculative retries racing a slow original.)
                return
            self._objects[object_id] = obj
            self._total_bytes += obj.size_bytes
            event = self._events.pop(object_id, None)
            callbacks = self._callbacks.pop(object_id, [])
        if event is not None:
            event.set()
        for cb in callbacks:
            cb(obj)

    def free(self, object_id: ObjectID) -> None:
        with self._lock:
            obj = self._objects.pop(object_id, None)
            if obj is not None:
                self._total_bytes -= obj.size_bytes
            self._events.pop(object_id, None)
            self._callbacks.pop(object_id, None)

    def replace_with_error(self, object_id: ObjectID, error: BaseException):
        """Used by GC/eviction to leave a tombstone."""
        with self._lock:
            old = self._objects.pop(object_id, None)
            if old is not None:
                self._total_bytes -= old.size_bytes
            self._objects[object_id] = RayObject(error=error)

    def materialize(self, object_id: ObjectID, sealed) -> None:
        """Attach the pulled value to a location record in place (the
        entry keeps its location so later borrowers can still be
        redirected).  No-op if the entry is gone or already sealed."""
        with self._lock:
            obj = self._objects.get(object_id)
            if obj is None or obj.sealed is not None or obj.is_error():
                return
            obj.sealed = sealed
            self._total_bytes += sealed.size_bytes - obj.size_bytes
            obj.size_bytes = sealed.size_bytes

    def invalidate_for_recovery(self, object_id: ObjectID) -> None:
        """Drop a stale location record so a reconstruction re-seal can
        land.  Unlike ``free``, registered waiter events and callbacks
        stay: the recovery ``put`` fires them."""
        with self._lock:
            obj = self._objects.pop(object_id, None)
            if obj is not None:
                self._total_bytes -= obj.size_bytes

    # -- read side -----------------------------------------------------------
    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._objects

    def get_if_exists(self, object_id: ObjectID) -> Optional[RayObject]:
        with self._lock:
            return self._objects.get(object_id)

    def completion_event(self, object_id: ObjectID) -> threading.Event:
        with self._lock:
            obj = self._objects.get(object_id)
            if obj is not None:
                ev = threading.Event()
                ev.set()
                return ev
            ev = self._events.get(object_id)
            if ev is None:
                ev = threading.Event()
                self._events[object_id] = ev
            return ev

    def add_done_callback(self, object_id: ObjectID,
                          callback: Callable[[RayObject], None]):
        with self._lock:
            obj = self._objects.get(object_id)
            if obj is None:
                self._callbacks.setdefault(object_id, []).append(callback)
                return
        callback(obj)

    def wait_and_get(self, object_id: ObjectID,
                     timeout: Optional[float] = None) -> RayObject:
        ev = self.completion_event(object_id)
        if not ev.wait(timeout):
            raise GetTimeoutError(
                f"get() timed out after {timeout}s waiting for {object_id!r}"
            )
        with self._lock:
            obj = self._objects.get(object_id)
        if obj is None:
            # Freed between event set and read.
            raise ObjectFreedError(reason=f"{object_id!r} was freed")
        return obj

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "num_objects": len(self._objects),
                "total_bytes": self._total_bytes,
                "num_waiters": len(self._events),
            }


def wait_refs(store: MemoryStore, object_ids, num_returns: int,
              timeout: Optional[float]):
    """Core of ``ray.wait``: first-completed ordering, stable within ready.

    Reference: CoreWorker::Wait (core_worker.cc:1901) — returns
    (ready, not_ready) preserving input order among the ready set.
    """
    deadline = None if timeout is None else time.monotonic() + timeout
    ready: List = []
    pending = list(object_ids)
    done = threading.Event()
    lock = threading.Lock()

    def make_cb(oid):
        def cb(_obj):
            with lock:
                if oid not in ready:
                    ready.append(oid)
                if len(ready) >= num_returns:
                    done.set()

        return cb

    for oid in pending:
        store.add_done_callback(oid, make_cb(oid))

    if deadline is None:
        done.wait()
    else:
        done.wait(max(0.0, deadline - time.monotonic()))

    with lock:
        ready_set = set(ready[:num_returns])
    ready_ordered = [o for o in object_ids if o in ready_set]
    not_ready = [o for o in object_ids if o not in ready_set]
    return ready_ordered, not_ready

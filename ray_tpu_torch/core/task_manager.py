"""Owner-side task bookkeeping: pending table, retries, lineage.

Reference semantics: src/ray/core_worker/task_manager.h:212 — the owner
keeps every submitted task's spec until its returns are sealed; on
failure it resubmits up to ``max_retries``; specs of *finished* tasks are
retained ("lineage pinning", task_manager.h:219-240) while any of their
return objects are still in scope, so a lost object can be recomputed by
re-running its creating task (object_recovery_manager.h:41).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Set

from .ids import ObjectID, TaskID
from .object_store import RayObject
from .task_spec import TaskSpec, STREAMING
from ..exceptions import TaskCancelledError, TaskError


class TaskManager:
    def __init__(self, runtime):
        self._runtime = runtime
        self._lock = threading.Lock()
        self._pending: Dict[TaskID, TaskSpec] = {}
        self._lineage: Dict[TaskID, TaskSpec] = {}
        self._lineage_refcount: Dict[TaskID, int] = {}
        # Return oids with a registered out-of-scope listener: a spec
        # can finish more than once (lineage reconstruction re-runs it)
        # but each return must decrement the lineage refcount once.
        self._listening: Set[ObjectID] = set()
        self._num_retries: int = 0
        self._num_reconstructions: int = 0

    # -- lifecycle -----------------------------------------------------------
    def register_pending(self, spec: TaskSpec):
        with self._lock:
            self._pending[spec.task_id] = spec
        for oid in spec.return_ids:
            self._runtime.reference_counter.add_owned_object(oid)

    def complete_success(self, spec: TaskSpec, result):
        """Seal return objects from the task's result value."""
        store = self._runtime.object_store
        n = spec.num_returns
        if n == STREAMING:
            # Items were already sealed by the executor as they were
            # yielded; nothing left to do but drop from pending.
            pass
        elif n == 1:
            store.put(spec.return_ids[0],
                      RayObject(value=result))
        elif n == 0:
            pass
        else:
            values = list(result)
            if len(values) != n:
                err = TaskError(
                    spec.repr_name(),
                    ValueError(f"expected {n} return values, got "
                               f"{len(values)}"))
                self.complete_error(spec, err, allow_retry=False)
                return
            for oid, v in zip(spec.return_ids, values):
                store.put(oid, RayObject(value=v))
        self._finish(spec)

    def complete_remote(self, spec: TaskSpec, entries):
        """Seal return objects from a remote executor's reply.  Each
        entry is ``("inline", wire_bytes)`` — small results ride the
        reply, sealed here without re-serializing — or
        ``("stored", node_id, address, size)`` — the primary copy stays
        pinned on the executing node and the owner seals a location
        record (reference: small returns inline in the PushTask reply
        vs plasma-resident big returns, task_manager.cc seal paths +
        ownership-based directory)."""
        from ..cluster.serialization import from_wire

        store = self._runtime.object_store
        for oid, entry in zip(spec.return_ids, entries):
            if entry[0] == "inline":
                store.put(oid, RayObject(sealed=from_wire(entry[1])))
            else:
                _kind, node_id, address, size = entry
                store.put(oid, RayObject(location=(node_id, address),
                                         size_bytes=size))
                self._runtime.register_object_location(
                    oid, node_id, address)
        self._finish(spec)

    def complete_error(self, spec: TaskSpec, error: BaseException,
                       allow_retry: bool = True):
        if (allow_retry and not isinstance(error, TaskCancelledError)
                and spec.should_retry(error)):
            with self._lock:
                self._num_retries += 1
            spec.attempt_number += 1
            self._runtime.resubmit_task(spec)
            return
        store = self._runtime.object_store
        if spec.num_returns == STREAMING:
            # Error terminates the stream; readers see it via the
            # sentinel error item.
            err_id = ObjectID.for_return(spec.task_id, 2**20)
            store.put(err_id, RayObject(error=error))
            self._runtime.streaming_manager.report_item(
                spec.return_ids[0], err_id)
            self._runtime.streaming_manager.finish(spec.return_ids[0])
        for oid in spec.return_ids:
            store.put(oid, RayObject(error=error))
        self._finish(spec)

    def _finish(self, spec: TaskSpec):
        # Task is done for good (no further retries): drop the
        # submitted-task references on its arguments.
        self._runtime._release_arg_refs(spec)
        with self._lock:
            self._pending.pop(spec.task_id, None)
            live_returns = 0
            for oid in spec.return_ids:
                if self._runtime.reference_counter.has_reference(oid):
                    live_returns += 1
            if live_returns and spec.function is not None:
                self._lineage[spec.task_id] = spec
                self._lineage_refcount[spec.task_id] = live_returns
        # Release lineage when the last return goes out of scope.  A
        # reconstruction re-finish must not stack a second listener on
        # the same oid (it would double-decrement the refcount).
        for oid in spec.return_ids:
            with self._lock:
                if oid in self._listening:
                    continue
                self._listening.add(oid)
            self._runtime.reference_counter.on_out_of_scope(
                oid, self._on_return_out_of_scope)

    def abandon(self, spec: TaskSpec):
        """Back out a task that was registered but never submitted (the
        caller keeps the exception; no error objects are sealed and the
        never-handed-out return refs are forgotten entirely)."""
        self._runtime._release_arg_refs(spec)
        with self._lock:
            self._pending.pop(spec.task_id, None)
        for oid in spec.return_ids:
            self._runtime.reference_counter.forget_if_unreferenced(oid)

    def _on_return_out_of_scope(self, object_id: ObjectID):
        task_id = object_id.task_id()
        with self._lock:
            self._listening.discard(object_id)
            if task_id in self._lineage_refcount:
                self._lineage_refcount[task_id] -= 1
                if self._lineage_refcount[task_id] <= 0:
                    del self._lineage_refcount[task_id]
                    self._lineage.pop(task_id, None)

    # -- introspection / recovery -------------------------------------------
    def is_pending(self, task_id: TaskID) -> bool:
        with self._lock:
            return task_id in self._pending

    def get_pending_spec(self, task_id: TaskID) -> Optional[TaskSpec]:
        with self._lock:
            return self._pending.get(task_id)

    def lineage_spec(self, object_id: ObjectID) -> Optional[TaskSpec]:
        """Spec of the task that created this object, if pinned."""
        with self._lock:
            return self._lineage.get(object_id.task_id())

    def take_lineage_for_recovery(self, task_id: TaskID
                                  ) -> Optional[TaskSpec]:
        """Pop a finished task's pinned spec to re-execute it (object
        recovery, object_recovery_manager.h:41).  The spec re-enters
        the pending table via ``reregister_for_recovery`` and re-pins
        itself on the next finish."""
        with self._lock:
            spec = self._lineage.pop(task_id, None)
            if spec is not None:
                self._lineage_refcount.pop(task_id, None)
            return spec

    def reregister_for_recovery(self, spec: TaskSpec) -> None:
        """Put a recovered spec back in flight: pending-table entry,
        owned return refs, and submitted-task refs on its args (the
        mirror of what ``_finish`` released)."""
        with self._lock:
            self._pending[spec.task_id] = spec
            self._num_reconstructions += 1
        rc = self._runtime.reference_counter
        for oid in spec.return_ids:
            rc.add_owned_object(oid)
        from .object_ref import ObjectRef

        arg_ids = [a.object_id() for a in spec.args
                   if isinstance(a, ObjectRef)]
        arg_ids += [v.object_id() for v in spec.kwargs.values()
                    if isinstance(v, ObjectRef)]
        rc.add_submitted_task_references(arg_ids)

    def num_pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def num_lineage_entries(self) -> int:
        with self._lock:
            return len(self._lineage)

    def num_retries(self) -> int:
        with self._lock:
            return self._num_retries

    def num_reconstructions(self) -> int:
        with self._lock:
            return self._num_reconstructions


def _sizeof(value) -> int:
    try:
        import sys

        if hasattr(value, "nbytes"):
            return int(value.nbytes)
        return sys.getsizeof(value)
    except Exception:
        return 0

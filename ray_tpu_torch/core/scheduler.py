"""Local task scheduling: dependency resolution + resource-gated dispatch.

Reference semantics: the raylet's two-stage scheduler
(src/ray/raylet/scheduling/cluster_task_manager.h:42 picks a node;
local_task_manager.h dispatches locally once args are local and resources
are acquired, pulling workers from a pool).  In the in-process runtime
there is one node, so this collapses to: wait for ObjectRef args
(DependencyManager, dependency_manager.h:49) → acquire resources →
run on a worker thread.  Cluster mode swaps the dispatch backend for
worker processes (ray_tpu_torch.core.node).
"""

from __future__ import annotations

import ctypes
import threading
from collections import deque
from enum import Enum
from typing import Callable, Dict, List, Optional, Set

from .ids import ObjectID, TaskID
from .object_ref import ObjectRef
from .resources import ResourceSet
from .task_spec import TaskSpec
from ..exceptions import TaskCancelledError


class TaskState(Enum):
    WAITING_DEPS = "WAITING_DEPS"
    QUEUED = "QUEUED"
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    CANCELLED = "CANCELLED"


class _Entry:
    __slots__ = ("spec", "state", "pending_deps", "thread", "demand",
                 "cancelled")

    def __init__(self, spec: TaskSpec, demand: Dict[str, float]):
        self.spec = spec
        self.state = TaskState.WAITING_DEPS
        self.pending_deps = 0
        self.thread: Optional[threading.Thread] = None
        self.demand = demand
        self.cancelled = False


def collect_dependencies(spec: TaskSpec) -> List[ObjectRef]:
    """Top-level ObjectRef args only — nested refs are not awaited
    (matches reference: only direct arguments are resolved)."""
    deps = [a for a in spec.args if isinstance(a, ObjectRef)]
    deps += [v for v in spec.kwargs.values() if isinstance(v, ObjectRef)]
    return deps


class LocalScheduler:
    def __init__(self, resources: ResourceSet,
                 execute_fn: Callable[[TaskSpec], None],
                 on_cancelled: Callable[[TaskSpec], None],
                 object_store):
        self._resources = resources
        self._execute_fn = execute_fn
        self._on_cancelled = on_cancelled
        self._object_store = object_store
        self._lock = threading.Lock()
        self._entries: Dict[TaskID, _Entry] = {}
        self._ready: deque = deque()
        self._cond = threading.Condition(self._lock)
        self._shutdown = False
        self._children: Dict[TaskID, Set[TaskID]] = {}
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="raytpu-dispatch", daemon=True)
        self._dispatcher.start()

    # -- submission ----------------------------------------------------------
    def backlog(self) -> int:
        """Tasks queued but not yet running (resources not acquired) —
        the cluster dispatcher consults this: available-resource checks
        alone don't see a submission burst still sitting in the queue."""
        with self._lock:
            return len(self._ready)

    def submit(self, spec: TaskSpec):
        entry = _Entry(spec, dict(spec.resources))
        if not self._resources.can_ever_fit(entry.demand):
            raise ValueError(
                f"task {spec.repr_name()} demands {entry.demand}, which can "
                f"never be satisfied by node resources {self._resources.total}"
            )
        deps = collect_dependencies(spec)
        with self._lock:
            self._entries[spec.task_id] = entry
            if spec.parent_task_id is not None:
                self._children.setdefault(
                    spec.parent_task_id, set()).add(spec.task_id)
            entry.pending_deps = len(deps)
            if entry.pending_deps == 0:
                entry.state = TaskState.QUEUED
                self._ready.append(spec.task_id)  # raylint: disable=unbounded-mailbox -- resource-gated backlog, not demand-driven: admission happens upstream (cluster spill + deadline shed at dispatch drains expired entries)
                self._cond.notify_all()
        for dep in deps:
            self._object_store.add_done_callback(
                dep.object_id(), self._make_dep_callback(spec.task_id))

    def _make_dep_callback(self, task_id: TaskID):
        def cb(_obj):
            with self._lock:
                entry = self._entries.get(task_id)
                if entry is None or entry.state != TaskState.WAITING_DEPS:
                    return
                entry.pending_deps -= 1
                if entry.pending_deps <= 0:
                    entry.state = TaskState.QUEUED
                    self._ready.append(task_id)
                    self._cond.notify_all()

        return cb

    # -- dispatch ------------------------------------------------------------
    def _dispatch_loop(self):
        while True:
            with self._lock:
                self._cond.wait_for(
                    lambda: self._shutdown or len(self._ready) > 0)
                if self._shutdown:
                    return
                task_id = self._pop_fitting()
                if task_id is None:
                    # Nothing fits right now — wait for a resource release
                    # (release notifies via ResourceSet; poll on a timer).
                    self._cond.wait(0.01)
                    continue
                entry = self._entries[task_id]
                entry.state = TaskState.RUNNING
            thread = threading.Thread(
                target=self._run_entry, args=(entry,),
                name=f"raytpu-worker-{entry.spec.repr_name()[:32]}",
                daemon=True)
            entry.thread = thread
            thread.start()

    def _pop_fitting(self) -> Optional[TaskID]:
        """First queued task whose demand fits available resources."""
        for i, task_id in enumerate(self._ready):
            entry = self._entries.get(task_id)
            if entry is None or entry.state != TaskState.QUEUED:
                continue
            if self._resources.try_acquire(entry.demand):
                del self._ready[i]
                return task_id
        return None

    def _run_entry(self, entry: _Entry):
        try:
            if entry.cancelled:
                self._on_cancelled(entry.spec)
            else:
                self._execute_fn(entry.spec)
        finally:
            self._resources.release(entry.demand)
            with self._lock:
                entry.state = TaskState.FINISHED
                # A retry may have re-registered the same task_id with a
                # fresh entry — only remove if the table still points at us.
                if self._entries.get(entry.spec.task_id) is entry:
                    del self._entries[entry.spec.task_id]
                    self._children.pop(entry.spec.task_id, None)
                self._cond.notify_all()

    # -- cancellation --------------------------------------------------------
    def cancel(self, task_id: TaskID, force: bool = False,
               recursive: bool = False) -> bool:
        """Returns True if the task was found (pending or running)."""
        targets = [task_id]
        if recursive:
            with self._lock:
                stack = [task_id]
                while stack:
                    t = stack.pop()
                    kids = self._children.get(t, set())
                    targets.extend(kids)
                    stack.extend(kids)
        found = False
        for t in targets:
            found = self._cancel_one(t, force) or found
        return found

    def _cancel_one(self, task_id: TaskID, force: bool) -> bool:
        with self._lock:
            entry = self._entries.get(task_id)
            if entry is None:
                return False
            entry.cancelled = True
            if entry.state in (TaskState.WAITING_DEPS, TaskState.QUEUED):
                entry.state = TaskState.CANCELLED
                try:
                    self._ready.remove(task_id)
                except ValueError:
                    pass
                self._entries.pop(task_id, None)
                spec = entry.spec
                to_seal = spec
            else:
                to_seal = None
                thread = entry.thread
        if to_seal is not None:
            self._on_cancelled(to_seal)
            return True
        # Running: interrupt the worker thread (best-effort async raise —
        # the in-process analogue of the executor-interrupt RPC,
        # core_worker.h:955 CancelTask).
        if thread is not None and thread.is_alive():
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(thread.ident),
                ctypes.py_object(TaskCancelledError))
        return True

    def assigned_resources(self, task_id: TaskID) -> Dict[str, float]:
        with self._lock:
            entry = self._entries.get(task_id)
            return dict(entry.demand) if entry else {}

    def num_pending(self) -> int:
        with self._lock:
            return len(self._entries)

    def shutdown(self):
        with self._lock:
            self._shutdown = True
            self._cond.notify_all()
        self._dispatcher.join(timeout=2.0)

"""Distributed reference counting for object GC.

Reference semantics: src/ray/core_worker/reference_count.h:64 — every
object has an owner; the owner tracks (a) local Python references,
(b) submitted-task references (the object is an argument of a pending
task), (c) borrowers.  When all counts reach zero the value is freed;
if lineage pinning is on, the creating task's spec is retained until the
object itself goes out of scope so lost objects can be reconstructed.

This implementation is process-local (single-controller runtime); the
borrower half of the protocol becomes relevant in cluster mode where it
rides the pubsub channel (WaitForRefRemoved analogue).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Set

from .ids import ObjectID, TaskID


class _Ref:
    # Lineage pinning itself lives in TaskManager._lineage_refcount;
    # this table only counts references.
    __slots__ = ("local_refs", "submitted_task_refs", "borrowers")

    def __init__(self):
        self.local_refs = 0
        self.submitted_task_refs = 0
        # Remote nodes (by object-service address) holding fetched
        # copies (reference borrower protocol, reference_count.h:64).
        # A COUNT per address, not a set: releases are async and
        # unordered, so release-then-refetch must net to one hold
        # regardless of arrival order (set semantics has an ABA race
        # where a stale release cancels a fresh borrow).
        self.borrowers: Dict[str, int] = {}

    def total(self) -> int:
        return (self.local_refs + self.submitted_task_refs
                + sum(self.borrowers.values()))


class ReferenceCounter:
    def __init__(self, on_object_out_of_scope: Callable[[ObjectID], None]):
        self._lock = threading.RLock()
        self._refs: Dict[ObjectID, _Ref] = {}
        self._on_out_of_scope = on_object_out_of_scope
        self._out_of_scope_listeners: Dict[ObjectID, list] = {}

    def add_owned_object(self, object_id: ObjectID):
        with self._lock:
            self._refs.setdefault(object_id, _Ref())

    def add_local_reference(self, object_id: ObjectID):
        with self._lock:
            ref = self._refs.setdefault(object_id, _Ref())
            ref.local_refs += 1

    def remove_local_reference(self, object_id: ObjectID):
        self._decrement(object_id, "local_refs")

    def add_submitted_task_references(self, object_ids):
        with self._lock:
            for oid in object_ids:
                ref = self._refs.setdefault(oid, _Ref())
                ref.submitted_task_refs += 1

    def remove_submitted_task_references(self, object_ids):
        for oid in object_ids:
            self._decrement(oid, "submitted_task_refs")

    def add_borrower(self, object_id: ObjectID, borrower: str):
        """An owner-side hold for a remote node that fetched a copy;
        the value stays alive until every borrower releases."""
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return False  # already out of scope: borrow refused
            ref.borrowers[borrower] = ref.borrowers.get(borrower, 0) + 1
            return True

    def remove_borrower(self, object_id: ObjectID, borrower: str):
        to_free: Optional[ObjectID] = None
        listeners = []
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            n = ref.borrowers.get(borrower, 0) - 1
            if n > 0:
                ref.borrowers[borrower] = n
            else:
                ref.borrowers.pop(borrower, None)
            if ref.total() == 0:
                del self._refs[object_id]
                to_free = object_id
                listeners = self._out_of_scope_listeners.pop(object_id, [])
        self._fire(to_free, listeners)

    def remove_borrower_node(self, borrower: str):
        """Drop every hold a (dead) borrower node had — without this,
        objects it fetched stay pinned at their owners forever."""
        to_free = []
        with self._lock:
            for oid, ref in list(self._refs.items()):
                if (ref.borrowers.pop(borrower, None) is not None
                        and ref.total() == 0):
                    del self._refs[oid]
                    to_free.append(
                        (oid,
                         self._out_of_scope_listeners.pop(oid, [])))
        for oid, listeners in to_free:
            self._fire(oid, listeners)

    def _decrement(self, object_id: ObjectID, field: str):
        to_free: Optional[ObjectID] = None
        listeners = []
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            setattr(ref, field, max(0, getattr(ref, field) - 1))
            if ref.total() == 0:
                del self._refs[object_id]
                to_free = object_id
                listeners = self._out_of_scope_listeners.pop(object_id, [])
        self._fire(to_free, listeners)

    def _fire(self, to_free: Optional[ObjectID], listeners):
        if to_free is not None:
            self._on_out_of_scope(to_free)
            for cb in listeners:
                cb(to_free)

    def forget_if_unreferenced(self, object_id: ObjectID):
        """Drop a zero-count owned entry without firing the
        out-of-scope hook (used to back out never-submitted tasks whose
        return refs were never handed to anyone)."""
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is not None and ref.total() == 0:
                del self._refs[object_id]
                self._out_of_scope_listeners.pop(object_id, None)

    def has_reference(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._refs

    def local_ref_count(self, object_id: ObjectID) -> int:
        with self._lock:
            ref = self._refs.get(object_id)
            return 0 if ref is None else ref.local_refs

    def on_out_of_scope(self, object_id: ObjectID, callback):
        """Register a callback fired when the object leaves scope
        (lineage release hook — task_manager.h:240 analogue)."""
        with self._lock:
            if object_id in self._refs:
                self._out_of_scope_listeners.setdefault(object_id, []).append(
                    callback)
                return
        callback(object_id)

    def num_tracked(self) -> int:
        with self._lock:
            return len(self._refs)

"""Streaming-generator bookkeeping.

Reference semantics: SURVEY.md A.9 — tasks with ``num_returns="streaming"``
return an ObjectRefGenerator; each yielded item is reported out-of-band to
the owner (task_manager.h:301 HandleReportGeneratorItemReturns), tolerant
of out-of-order arrival; consumers block until the next index is reported
or the stream is finished.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .ids import ObjectID


class _Stream:
    def __init__(self):
        self.items: List[ObjectID] = []
        self.finished = False
        self.error_index: Optional[int] = None


class StreamingGeneratorManager:
    def __init__(self):
        self._streams: Dict[ObjectID, _Stream] = {}
        self._cond = threading.Condition()

    def create_stream(self, generator_id: ObjectID):
        with self._cond:
            self._streams[generator_id] = _Stream()

    def report_item(self, generator_id: ObjectID, item_id: ObjectID):
        with self._cond:
            stream = self._streams[generator_id]
            stream.items.append(item_id)
            self._cond.notify_all()

    def finish(self, generator_id: ObjectID):
        with self._cond:
            stream = self._streams.get(generator_id)
            if stream is not None:
                stream.finished = True
            self._cond.notify_all()

    def wait_item(self, generator_id: ObjectID, index: int,
                  timeout: Optional[float] = None) -> Optional[ObjectID]:
        """Block until item ``index`` exists; None = stream ended first."""
        with self._cond:
            stream = self._streams.get(generator_id)
            if stream is None:
                return None
            ok = self._cond.wait_for(
                lambda: len(stream.items) > index or stream.finished, timeout)
            if not ok:
                raise TimeoutError("streaming generator item wait timed out")
            if len(stream.items) > index:
                return stream.items[index]
            return None

    def num_items(self, generator_id: ObjectID) -> int:
        """Items reported so far (gates retry of a remote stream: a
        partially-consumed stream must not re-run)."""
        with self._cond:
            stream = self._streams.get(generator_id)
            return 0 if stream is None else len(stream.items)

    def is_finished(self, generator_id: ObjectID) -> bool:
        """True once the executor has reported the end of the stream."""
        with self._cond:
            stream = self._streams.get(generator_id)
            return stream is None or stream.finished

    def drop_stream(self, generator_id: ObjectID):
        with self._cond:
            self._streams.pop(generator_id, None)

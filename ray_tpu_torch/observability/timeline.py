"""Chrome-trace timeline export (reference: ray.timeline →
_private/state.py:948; events from the per-worker TaskEventBuffer,
task_event_buffer.h:220).

The in-process runtime records task begin/end events into a bounded
DROP-OLDEST ring buffer (a full buffer evicts the oldest event and
counts it in ``dropped_events`` / the ``ray_tpu_timeline_dropped_events``
metric — new events are never silently discarded); export emits Chrome
trace-event JSON loadable in chrome://tracing / Perfetto.

Cluster mode ships this buffer to the head: ``drain_since`` hands the
event shipper (observability/events.py) everything recorded past its
cursor, so each event crosses the wire once.  Cross-process producer→
consumer edges are stitched with flow events (``record_flow`` — ph
"s"/"f" pairs sharing an id), which Perfetto renders as arrows between
the writer's and the reader's lanes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

_lock = threading.Lock()
_events: Deque[Dict] = deque()
_MAX_EVENTS = int(os.environ.get("RAY_TPU_TIMELINE_MAX_EVENTS",
                                 "100000"))
_dropped = 0     # events evicted (drop-oldest) since last clear()
_total = 0       # events ever recorded since last clear() (drain cursor base)


def set_capacity(n: int) -> None:
    """Resize the ring buffer (tests); evicts oldest as needed."""
    global _MAX_EVENTS
    with _lock:
        _MAX_EVENTS = max(1, int(n))
        _evict_locked()


def _evict_locked() -> None:
    global _dropped
    n = len(_events) - _MAX_EVENTS
    if n > 0:
        for _ in range(n):
            _events.popleft()
        _dropped += n
        _count_dropped(n)


def _count_dropped(n: int) -> None:
    """Mirror drops into the metrics registry so ``metrics_summary()``
    exposes them (caller holds _lock; the metric has its own lock)."""
    try:
        from . import metrics as _metrics

        _metrics.dropped_events_counter().inc(n)
    except Exception:
        pass


def _append(event: Dict) -> None:
    global _total
    with _lock:
        _events.append(event)
        _total += 1
        _evict_locked()


def process_pid() -> str:
    """The Chrome-trace ``pid`` lane for this process: the runtime's
    node id when one exists (every node process gets its own lane in
    the merged cluster timeline), else "driver"."""
    try:
        from ..core.runtime import try_get_runtime

        rt = try_get_runtime()
        if rt is not None:
            pid = getattr(rt, "_timeline_pid", None)
            if pid is None:
                pid = f"node:{rt.node_id.hex()[:8]}"
                rt._timeline_pid = pid
            return pid
    except Exception:
        pass
    return "driver"


def record_event(name: str, phase: str, *, pid: str = "driver",
                 tid: str = "main", ts: Optional[float] = None,
                 args: Optional[Dict] = None):
    event = {
        "name": name,
        "ph": phase,  # "B" begin / "E" end / "X" complete / "i" instant
        "pid": pid,
        "tid": tid,
        "ts": (ts if ts is not None else time.time()) * 1e6,
    }
    if phase == "i":
        event["s"] = "p"  # instant scope: process
    if args:
        event["args"] = args
    _append(event)


def record_span(name: str, start: float, end: float, *, pid: str = "driver",
                tid: str = "main", args: Optional[Dict] = None):
    event = {
        "name": name, "ph": "X", "pid": pid, "tid": tid,
        "ts": start * 1e6, "dur": (end - start) * 1e6,
    }
    if args:
        event["args"] = args
    _append(event)


def record_flow(name: str, flow_id: int, side: str, *,
                pid: str = "driver", tid: str = "main",
                ts: Optional[float] = None,
                args: Optional[Dict] = None):
    """One half of a cross-process flow arrow: ``side`` is "s" (start,
    at the producer) or "f" (finish, at the consumer); both halves must
    share ``flow_id`` and the "flow" category.  Producers pass ``ts``
    captured BEFORE publishing the frame — renderers match flow halves
    by id but draw by timestamp, so a start stamped after the consumer
    already read the frame loses the arrow."""
    event = {
        "name": name, "ph": side, "cat": "flow", "id": int(flow_id),
        "pid": pid, "tid": tid,
        "ts": (ts if ts is not None else time.time()) * 1e6,
    }
    if side == "f":
        event["bp"] = "e"  # bind to the enclosing slice
    if args:
        event["args"] = args
    _append(event)


def dropped_events() -> int:
    """Events evicted by the drop-oldest ring buffer since clear()."""
    with _lock:
        return _dropped


def drain_since(cursor: int) -> Tuple[List[Dict], int]:
    """Events recorded at absolute index ≥ ``cursor`` that are still in
    the buffer, plus the new cursor.  Events evicted before the caller
    drained them are simply gone (they are counted in
    ``dropped_events``); the cursor advances past them."""
    from itertools import islice

    with _lock:
        oldest = _total - len(_events)  # absolute index of _events[0]
        start = max(cursor, oldest)
        if start >= _total:
            return [], _total
        # islice materializes only the undrained tail — a flush must
        # not copy the whole (up to capacity-sized) ring under the
        # lock every interval.
        return list(islice(_events, start - oldest, None)), _total


def export_timeline(filename: Optional[str] = None):
    with _lock:
        data = list(_events)
    if filename is None:
        return data
    with open(filename, "w") as f:
        json.dump(data, f)
    return filename


def clear():
    global _dropped, _total
    with _lock:
        _events.clear()
        _dropped = 0
        _total = 0

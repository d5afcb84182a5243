"""On-demand cluster profiling: a pure-Python sampling profiler plus a
wall-clock stuck detector.

Reference analogue: the dashboard reporter's
``profile_manager.py`` (py-spy subprocess attach serving
``/worker/cpu_profile``) — rebuilt dependency-free on
``sys._current_frames()``: a sampler thread snapshots every thread's
stack at a fixed interval, aggregates collapsed stacks (flamegraph
text: ``frame;frame;frame count``), and can render the samples as a
Chrome-trace span reconstruction mergeable with the cluster timeline
(same ``pid`` lane as the process's other events).

Exposed as:
- ``profile_process(duration_s, ...)`` — profile THIS process;
- the node RPC ``profile`` (``cluster/client.py``) — profile any node;
- ``ray_tpu profile --node/--actor`` + dashboard ``/api/profile``.

The **stuck detector** closes the loop with the deadline plane:
dispatch points that run under a request budget (actor mailbox
dispatch, channel reads) arm a :func:`stuck_guard`; a watchdog thread
snapshots every thread's stack the moment a guarded operation runs
``RAY_TPU_STUCK_FACTOR``× past its budget — the post-mortem for "the
deadline machinery itself is wedged" arrives with the stacks attached,
as a timeline instant event, a WARNING log record, and a queryable
snapshot (``stuck_snapshots()``).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

_MAX_SAMPLES = 100000


# --------------------------------------------------------------- sampler
def _thread_names() -> Dict[int, str]:
    return {t.ident: t.name for t in threading.enumerate()
            if t.ident is not None}


def _frames_of(frame, limit: int = 64) -> Tuple[str, ...]:
    """Stack root→leaf as printable frames (module:function)."""
    out: List[str] = []
    f = frame
    while f is not None and len(out) < limit:
        code = f.f_code
        mod = os.path.splitext(os.path.basename(code.co_filename))[0]
        out.append(f"{mod}.{code.co_name}")
        f = f.f_back
    out.reverse()
    return tuple(out)


def sample_stacks(duration_s: float = 1.0, interval_s: float = 0.01,
                  thread_filter: Optional[str] = None) -> Dict[str, Any]:
    """Sample every thread's stack for ``duration_s``.  Returns raw
    timestamped samples plus aggregate metadata; feed the result to
    :func:`collapsed_text` / :func:`chrome_trace`.  ``thread_filter``
    keeps only threads whose name contains the substring (profile one
    actor: its executor threads are named ``actor-<name>...``)."""
    duration_s = min(float(duration_s), 60.0)
    interval_s = max(float(interval_s), 0.001)
    me = threading.get_ident()
    samples: List[Tuple[float, int, Tuple[str, ...]]] = []
    t0 = time.time()
    deadline = t0 + duration_s
    n = 0
    while time.time() < deadline and len(samples) < _MAX_SAMPLES:
        now = time.time()
        names = _thread_names()
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            if thread_filter and thread_filter not in names.get(
                    tid, ""):
                continue
            samples.append((now, tid, _frames_of(frame)))
        n += 1
        time.sleep(interval_s)
    return {
        "samples": samples,
        "threads": _thread_names(),
        "num_snapshots": n,
        "duration_s": round(time.time() - t0, 3),
        "interval_s": interval_s,
        "pid": os.getpid(),
    }


def collapsed_stacks(profile: Dict[str, Any]) -> Dict[str, int]:
    """Aggregate raw samples into {``frame;frame;...``: count}."""
    agg: Dict[str, int] = {}
    for _ts, _tid, frames in profile["samples"]:
        key = ";".join(frames)
        agg[key] = agg.get(key, 0) + 1
    return agg


def collapsed_text(profile: Dict[str, Any]) -> str:
    """Flamegraph collapsed-stack text (``flamegraph.pl`` /
    speedscope-compatible): one ``stack count`` line per distinct
    stack, heaviest first."""
    agg = collapsed_stacks(profile)
    lines = [f"{stack} {count}" for stack, count in
             sorted(agg.items(), key=lambda kv: -kv[1])]
    return "\n".join(lines)


def chrome_trace(profile: Dict[str, Any],
                 pid: Optional[str] = None) -> List[Dict]:
    """Reconstruct spans from consecutive samples: per thread, a frame
    that stays on the stack across adjacent samples is one ``X`` slice.
    The events share this process's timeline ``pid`` lane, so a
    profile merges straight into the cluster timeline view."""
    if pid is None:
        from .timeline import process_pid

        pid = f"{process_pid()}:profile"
    names = profile.get("threads", {})
    by_thread: Dict[int, List[Tuple[float, Tuple[str, ...]]]] = {}
    for ts, tid, frames in profile["samples"]:
        by_thread.setdefault(tid, []).append((ts, frames))
    interval = profile.get("interval_s", 0.01)
    events: List[Dict] = []
    for tid, rows in by_thread.items():
        rows.sort(key=lambda r: r[0])
        tname = names.get(tid, str(tid))
        # open[i] = (frame, start_ts) for stack depth i
        open_frames: List[Tuple[str, float]] = []
        last_ts = rows[0][0] if rows else 0.0
        for ts, frames in rows:
            # longest common prefix with the currently-open stack
            keep = 0
            while (keep < len(open_frames) and keep < len(frames)
                   and open_frames[keep][0] == frames[keep]):
                keep += 1
            for frame, start in reversed(open_frames[keep:]):
                events.append({"name": frame, "ph": "X", "pid": pid,
                               "tid": tname, "ts": start * 1e6,
                               "dur": max(last_ts - start,
                                          interval) * 1e6})
            del open_frames[keep:]
            for frame in frames[keep:]:
                open_frames.append((frame, ts))
            last_ts = ts
        end = last_ts + interval
        for frame, start in reversed(open_frames):
            events.append({"name": frame, "ph": "X", "pid": pid,
                           "tid": tname, "ts": start * 1e6,
                           "dur": max(end - start, interval) * 1e6})
    return events


def profile_process(duration_s: float = 1.0, interval_s: float = 0.01,
                    thread_filter: Optional[str] = None
                    ) -> Dict[str, Any]:
    """Profile THIS process; returns {collapsed, chrome, num_samples,
    ...} — the node RPC handler's payload shape."""
    prof = sample_stacks(duration_s, interval_s, thread_filter)
    return {
        "collapsed": collapsed_text(prof),
        "chrome": chrome_trace(prof),
        "num_samples": len(prof["samples"]),
        "num_snapshots": prof["num_snapshots"],
        "threads": sorted(prof["threads"].values()),
        "duration_s": prof["duration_s"],
        "pid": prof["pid"],
    }


# -------------------------------------------------------- stuck detector
STUCK_FACTOR = float(os.environ.get("RAY_TPU_STUCK_FACTOR", "3.0"))
_MIN_TRIGGER_S = 0.05

_watch_lock = threading.Lock()
_watches: Dict[int, Dict[str, Any]] = {}
_watch_ids = iter(range(1, 1 << 62))
_watchdog: Optional[threading.Thread] = None
_snapshots: deque = deque(maxlen=int(os.environ.get(
    "RAY_TPU_STUCK_SNAPSHOTS_MAX", "64")))


def _stuck_metrics():
    from . import metrics as _metrics

    return _metrics.metric_group("stuck", lambda: {
        "snapshots": _metrics.Counter(
            "ray_tpu_stuck_detector_snapshots",
            "stack snapshots auto-captured by the stuck detector "
            "(a guarded op ran FACTOR x past its deadline budget)",
            tag_keys=("kind",)),
    })


def _ensure_watchdog() -> None:
    global _watchdog
    if _watchdog is not None and _watchdog.is_alive():
        return
    _watchdog = threading.Thread(target=_watchdog_loop, daemon=True,
                                 name="stuck-watchdog")
    _watchdog.start()


_CAPTURE_COOLDOWN_S = float(os.environ.get(
    "RAY_TPU_STUCK_COOLDOWN_S", "1.0"))
_last_capture: Dict[str, float] = {}


def _watchdog_loop() -> None:
    while True:
        time.sleep(0.1)
        now = time.monotonic()
        fired = []
        with _watch_lock:
            for wid, w in _watches.items():
                if not w["fired"] and now >= w["trigger_at"]:
                    w["fired"] = True
                    # Per-kind cooldown: when a wedged async replica
                    # has dozens of in-flight guarded dispatches, they
                    # all overshoot in the same tick — one snapshot
                    # already holds every thread's stack; N more are
                    # pure burst load on a process that is already in
                    # trouble.
                    if now - _last_capture.get(w["kind"], -1e9) \
                            < _CAPTURE_COOLDOWN_S:
                        continue
                    _last_capture[w["kind"]] = now
                    fired.append(dict(w))
        for w in fired:
            _capture_snapshot(w)


def _capture_snapshot(watch: Dict[str, Any]) -> None:
    import traceback

    names = _thread_names()
    stacks: Dict[str, List[str]] = {}
    for tid, frame in sys._current_frames().items():
        tname = names.get(tid, str(tid))
        stacks[tname] = traceback.format_stack(frame)
    snap = {
        "ts": time.time(),
        "kind": watch["kind"],
        "detail": watch.get("detail") or {},
        "budget_s": watch["budget_s"],
        "overdue_factor": STUCK_FACTOR,
        "thread": watch.get("thread"),
        "stacks": stacks,
    }
    _snapshots.append(snap)
    try:
        _stuck_metrics()["snapshots"].inc(tags={"kind": watch["kind"]})
    except Exception:
        pass
    try:
        from .timeline import process_pid, record_event

        top = stacks.get(watch.get("thread") or "", [])
        record_event(
            "stuck_detector", "i", pid=process_pid(),
            tid=watch.get("thread") or "stuck-watchdog",
            args={"kind": watch["kind"],
                  "budget_s": watch["budget_s"],
                  **(watch.get("detail") or {}),
                  "stack_tail": "".join(top[-3:])})
    except Exception:
        pass
    try:
        import logging

        logging.getLogger("ray_tpu.stuck").warning(
            "stuck detector: %s ran %.1fx past its %.3fs budget "
            "(detail=%s) — stack snapshot captured",
            watch["kind"], STUCK_FACTOR, watch["budget_s"],
            watch.get("detail"))
    except Exception:
        pass


def stuck_snapshots() -> List[Dict[str, Any]]:
    return list(_snapshots)


def clear_stuck_snapshots() -> None:
    _snapshots.clear()


class stuck_guard:
    """``with stuck_guard("actor_dispatch", budget_s, detail): ...`` —
    registers the block with the watchdog; if it is still running
    ``STUCK_FACTOR × budget_s`` later, every thread's stack is
    snapshotted (once per guard).  Near-zero cost on the happy path:
    one dict insert/remove under a small lock."""

    __slots__ = ("_wid",)

    def __init__(self, kind: str, budget_s: Optional[float],
                 detail: Optional[Dict[str, Any]] = None):
        if budget_s is None or budget_s <= 0 or STUCK_FACTOR <= 0:
            self._wid = None
            return
        trigger = max(budget_s * STUCK_FACTOR, _MIN_TRIGGER_S)
        wid = next(_watch_ids)
        with _watch_lock:
            _watches[wid] = {
                "kind": kind,
                "budget_s": round(float(budget_s), 4),
                "detail": detail,
                "thread": threading.current_thread().name,
                "trigger_at": time.monotonic() + trigger,
                "fired": False,
            }
        self._wid = wid
        _ensure_watchdog()

    def __enter__(self) -> "stuck_guard":
        return self

    def __exit__(self, *exc) -> None:
        if self._wid is not None:
            with _watch_lock:
                _watches.pop(self._wid, None)

"""Structured log plane: trace-correlated records from every process.

Reference analogue: the per-session log files + ``log_monitor.py:103``
routing (per-worker stdout/stderr files tailed to the driver) and the
GCS-side log aggregation the dashboard's log module reads — grown into
a STRUCTURED plane: every record is a dict stamped with the ambient
trace id / span id / task / actor identity at emit time, so one trace
id pulls the log lines of a whole distributed pass out of every
process it touched.

Pieces:

- :class:`StructuredLogHandler` — a ``logging.Handler`` installed once
  per process (``install()``, called from runtime boot).  Records land
  in a bounded DROP-OLDEST in-memory ring (same discipline as
  ``observability.timeline``) and, when configured, in a bounded
  per-node JSONL ring file (``configure_ring_file``).
- stdout/stderr capture (``capture_stdio()``) — worker processes tee
  their streams into the same record stream (``record["stream"]`` is
  "stdout"/"stderr"), so bare prints in task code are correlated too.
- shipping — the in-memory ring exposes ``drain_since`` and the
  existing :class:`~ray_tpu_torch.observability.events.EventShipper` flush
  piggybacks the undrained records to the head's ``push_events``; the
  head keeps bounded per-node stores, answers the ``cluster_logs`` RPC
  with SERVER-SIDE filtering, publishes batches on the ``logs`` pubsub
  channel (follow mode), and renders records as instant events in the
  merged cluster timeline.

Env knobs:
  RAY_TPU_LOGGING=0          disable the plane (handler no-ops)
  RAY_TPU_LOG_LEVEL          level of the ``ray_tpu`` logger (INFO)
  RAY_TPU_LOG_BUFFER_MAX     in-memory ring capacity (20000 records)
  RAY_TPU_LOG_RING_BYTES     per ring file segment (8 MiB; 2 segments)
  RAY_TPU_HEAD_LOGS_MAX      head-side per-node store cap (50000)
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

_lock = threading.Lock()
_MAX_RECORDS = int(os.environ.get("RAY_TPU_LOG_BUFFER_MAX", "20000"))
_records: deque = deque()
_dropped = 0
_total = 0

_enabled = os.environ.get("RAY_TPU_LOGGING", "1").lower() not in (
    "0", "false", "off")

_LEVELS = {"CRITICAL": 50, "ERROR": 40, "WARNING": 30, "INFO": 20,
           "DEBUG": 10}


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn the plane into no-ops (the ``log_plane_overhead_pct`` bench
    phase measures its cost this way)."""
    global _enabled
    _enabled = False


def set_capacity(n: int) -> None:
    global _MAX_RECORDS
    with _lock:
        _MAX_RECORDS = max(1, int(n))
        _evict_locked()


def _evict_locked() -> None:
    global _dropped
    n = len(_records) - _MAX_RECORDS
    if n > 0:
        for _ in range(n):
            _records.popleft()
        _dropped += n


def dropped_records() -> int:
    with _lock:
        return _dropped


def clear() -> None:
    global _dropped, _total
    with _lock:
        _records.clear()
        _dropped = 0
        _total = 0


def drain_since(cursor: int) -> Tuple[List[Dict], int]:
    """Records at absolute index ≥ ``cursor`` still buffered, plus the
    new cursor (mirror of ``timeline.drain_since`` — each record
    crosses the wire once; evicted-before-drain records are counted in
    ``dropped_records`` and skipped)."""
    from itertools import islice

    with _lock:
        oldest = _total - len(_records)
        start = max(cursor, oldest)
        if start >= _total:
            return [], _total
        return list(islice(_records, start - oldest, None)), _total


# ------------------------------------------------------------ ring file
class RingFile:
    """Bounded two-segment JSONL ring: writes append to ``path`` until
    it exceeds ``max_bytes``, then ``path`` rotates to ``path.1``
    (replacing the previous segment) and a fresh segment starts — disk
    use is bounded at ~2×max_bytes per node with no external rotator.
    Write failures are counted, never raised (a full disk must not
    take the workload down with it)."""

    def __init__(self, path: str, max_bytes: int):
        self.path = path
        self.max_bytes = int(max_bytes)
        self.rotations = 0
        self.dropped = 0
        self._lock = threading.Lock()
        self._f = None
        self._size = 0
        self._open()

    def _open(self) -> None:
        try:
            self._f = open(self.path, "ab", buffering=0)
            self._size = self._f.tell()
        except OSError:
            self._f = None

    def write(self, line: str) -> None:
        data = line.encode("utf-8", errors="replace") + b"\n"
        with self._lock:
            if self._f is None:
                self._open()
                if self._f is None:
                    self.dropped += 1
                    return
            if self._size + len(data) > self.max_bytes and self._size:
                try:
                    self._f.close()
                    os.replace(self.path, self.path + ".1")
                except OSError:
                    pass
                self.rotations += 1
                self._size = 0
                self._open()
                if self._f is None:
                    self.dropped += 1
                    return
            try:
                self._f.write(data)
                self._size += len(data)
            except OSError:
                self.dropped += 1

    def read_lines(self) -> List[str]:
        """Both segments, oldest first (post-mortem reads)."""
        out: List[str] = []
        for p in (self.path + ".1", self.path):
            try:
                with open(p, "r", errors="replace") as f:
                    out.extend(line.rstrip("\n") for line in f)
            except OSError:
                pass
        return out

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None


_ring_file: Optional[RingFile] = None


def configure_ring_file(path: str,
                        max_bytes: Optional[int] = None) -> RingFile:
    """Mirror every record to a bounded JSONL ring file (worker nodes
    call this with ``<log-dir>/node-<id>.jsonl``)."""
    global _ring_file
    if _ring_file is not None:
        _ring_file.close()
    _ring_file = RingFile(path, max_bytes or int(os.environ.get(
        "RAY_TPU_LOG_RING_BYTES", str(8 * 1024 * 1024))))
    return _ring_file


def ring_file() -> Optional[RingFile]:
    return _ring_file


# ---------------------------------------------------------- record emit
def _lane() -> str:
    from .timeline import process_pid

    return process_pid()


def emit_record(record: Dict[str, Any]) -> None:
    """Append one structured record to the in-memory ring (and the
    ring file when configured).  Callers fill content; identity/stamp
    fields they omit are filled here."""
    global _total
    if not _enabled:
        return
    record.setdefault("ts", time.time())
    record.setdefault("pid", os.getpid())
    record.setdefault("lane", _lane())
    with _lock:
        _records.append(record)
        _total += 1
        _evict_locked()
    rf = _ring_file
    if rf is not None:
        try:
            rf.write(json.dumps(record, default=str))
        except (TypeError, ValueError):
            rf.dropped += 1


def _trace_context() -> Tuple[Optional[str], Optional[str],
                              Optional[str], Optional[str]]:
    """(trace_id, span_id, task_name, actor_id) from the executing
    task's context, else the thread's ambient tracing scope."""
    try:
        from ..core.runtime_context import current_task_context

        ctx = current_task_context()
        if ctx is not None and ctx.trace_id is not None:
            actor = ctx.actor_id.hex() if ctx.actor_id is not None \
                else None
            return ctx.trace_id, ctx.span_id, ctx.task_name, actor
    except Exception:
        pass
    try:
        from . import tracing

        cur = tracing.current()
        if cur is not None:
            return cur[0], cur[1], None, None
    except Exception:
        pass
    return None, None, None, None


def _stamp_identity(rec: Dict[str, Any]) -> None:
    """Fill the ambient trace/span/task/actor identity fields (ONE
    implementation — the logging handler and the stdio tee must stamp
    identically or one view silently de-correlates)."""
    trace_id, span_id, task, actor = _trace_context()
    if trace_id:
        rec["trace_id"] = trace_id
    if span_id:
        rec["span_id"] = span_id
    if task:
        rec["task"] = task
    if actor:
        rec["actor"] = actor


# Captured by capture_stdio BEFORE the tee wraps stderr: fallback
# console writes must not double back through the tee as a second
# structured record.
_orig_stderr = None


def _has_other_handlers(name: str) -> bool:
    """Would this record reach any output beyond the structured ring?"""
    lg = logging.getLogger(name)
    while lg is not None:
        for h in lg.handlers:
            if not isinstance(h, StructuredLogHandler):
                return True
        if not lg.propagate:
            return False
        lg = lg.parent
    return False


class StructuredLogHandler(logging.Handler):
    """Stamps each ``logging`` record with the ambient trace/span/task
    identity and lands it in the bounded record ring."""

    def emit(self, record: logging.LogRecord) -> None:
        if not _enabled:
            return
        try:
            msg = record.getMessage()
        except Exception:
            msg = str(record.msg)
        out: Dict[str, Any] = {
            "ts": record.created,
            "level": record.levelname,
            "levelno": record.levelno,
            "logger": record.name,
            "msg": msg,
            "thread": record.threadName,
        }
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = repr(record.exc_info[1])
        _stamp_identity(out)
        emit_record(out)
        # The ring must not SWALLOW console output: with this handler
        # on the root logger, stdlib lastResort (bare WARNING+ message
        # to stderr for apps with no logging config) never fires —
        # reproduce it, on the PRE-tee stream so the line doesn't
        # double back as a second structured record.
        if record.levelno >= logging.WARNING and \
                not _has_other_handlers(record.name):
            try:
                text = msg
                if record.exc_info and record.exc_info[0] is not None:
                    import traceback

                    text += "\n" + "".join(traceback.format_exception(
                        *record.exc_info)).rstrip()
                (_orig_stderr or sys.stderr).write(text + "\n")
            except Exception:
                pass


_handler: Optional[StructuredLogHandler] = None
_install_lock = threading.Lock()


def install() -> StructuredLogHandler:
    """Idempotently attach the structured handler to the root logger
    and give the ``ray_tpu`` logger tree its default level
    (``RAY_TPU_LOG_LEVEL``, INFO) so the runtime's own records flow
    without the user touching logging config.  User loggers keep their
    configured levels — the plane captures whatever propagates."""
    global _handler
    with _install_lock:
        if _handler is None:
            _handler = StructuredLogHandler()
            logging.getLogger().addHandler(_handler)
            pkg_logger = logging.getLogger("ray_tpu")
            if pkg_logger.level == logging.NOTSET:
                pkg_logger.setLevel(os.environ.get(
                    "RAY_TPU_LOG_LEVEL", "INFO").upper())
        return _handler


def uninstall() -> None:
    global _handler
    with _install_lock:
        if _handler is not None:
            logging.getLogger().removeHandler(_handler)
            _handler = None


# -------------------------------------------------------- stdio capture
class _StreamTee:
    """Wraps sys.stdout/sys.stderr: writes pass through to the original
    stream AND complete lines become structured records (worker prints
    correlated by trace like any log line)."""

    def __init__(self, orig, stream_name: str, levelno: int):
        self._orig = orig
        self._name = stream_name
        self._levelno = levelno
        self._buf = ""
        # Concurrent writers (actor executor threads printing at
        # once) must not interleave the buffer's read-modify-write —
        # a spliced/dropped line defeats the correlation promise.
        self._tee_lock = threading.Lock()

    def write(self, data: str) -> int:
        n = self._orig.write(data)
        if not (_enabled and data):
            return n
        lines: List[str] = []
        with self._tee_lock:
            self._buf += data
            while "\n" in self._buf:
                line, self._buf = self._buf.split("\n", 1)
                if line.strip():
                    lines.append(line)
        for line in lines:
            rec: Dict[str, Any] = {
                "level": logging.getLevelName(self._levelno),
                "levelno": self._levelno,
                "logger": self._name,
                "stream": self._name,
                "msg": line,
                "thread": threading.current_thread().name,
            }
            _stamp_identity(rec)
            emit_record(rec)
        return n

    def flush(self) -> None:
        self._orig.flush()

    def fileno(self) -> int:
        return self._orig.fileno()

    def isatty(self) -> bool:
        return False

    def __getattr__(self, name):
        return getattr(self._orig, name)


def capture_stdio() -> None:
    """Tee this process's stdout/stderr into the record stream (worker
    processes call this at boot; idempotent)."""
    global _orig_stderr
    if not isinstance(sys.stdout, _StreamTee):
        sys.stdout = _StreamTee(sys.stdout, "stdout", logging.INFO)
    if not isinstance(sys.stderr, _StreamTee):
        _orig_stderr = sys.stderr
        sys.stderr = _StreamTee(sys.stderr, "stderr", logging.WARNING)


# ------------------------------------------------------------ filtering
def level_number(level) -> Optional[int]:
    if level is None:
        return None
    if isinstance(level, int):
        return level
    try:
        return _LEVELS[str(level).upper()]
    except KeyError:
        # Silence here would mean a typo'd --level returns the FULL
        # stream looking like "everything matched".
        raise ValueError(
            f"unknown log level {level!r} "
            f"(expected one of {', '.join(_LEVELS)})") from None


def filter_records(records: Iterable[Dict], *,
                   trace_id: Optional[str] = None,
                   node: Optional[str] = None,
                   actor: Optional[str] = None,
                   level=None,
                   logger: Optional[str] = None,
                   since: Optional[float] = None,
                   until: Optional[float] = None,
                   text: Optional[str] = None,
                   limit: Optional[int] = None) -> List[Dict]:
    """The ONE filtering implementation: the head's ``cluster_logs``
    handler runs it server-side; local mode runs it over the process
    ring.  ``node``/``actor`` match by prefix (ids are long hex),
    ``level`` is a minimum, ``text`` a substring of the message."""
    min_level = level_number(level)
    out: List[Dict] = []
    for r in records:
        if trace_id is not None and r.get("trace_id") != trace_id:
            continue
        if node is not None and not str(r.get("node", "")).startswith(
                node):
            continue
        if actor is not None and not str(r.get("actor", "")).startswith(
                actor):
            continue
        if min_level is not None and r.get("levelno", 0) < min_level:
            continue
        if logger is not None and not str(r.get("logger", "")
                                          ).startswith(logger):
            continue
        ts = r.get("ts", 0)
        if since is not None and ts < since:
            continue
        if until is not None and ts > until:
            continue
        if text is not None and text not in str(r.get("msg", "")):
            continue
        out.append(r)
    out.sort(key=lambda r: r.get("ts", 0))
    if limit is not None and len(out) > limit:
        out = out[-limit:]
    return out


def query(**filters) -> List[Dict]:
    """Filter this process's in-memory ring (local-mode queries and
    tests; cluster queries go through ``cluster_logs``)."""
    with _lock:
        records = list(_records)
    return filter_records(records, **filters)


def query_cluster(client, timeout: float = 15.0, **filters) -> List[Dict]:
    """Server-side-filtered cluster query: flush this process's
    undrained records so the head's answer includes them, then ask the
    head's ``cluster_logs``."""
    shipper = getattr(client, "shipper", None)
    if shipper is not None:
        try:
            shipper.flush()
        except Exception:
            pass
    resp = client.head.call("cluster_logs", dict(filters),
                            timeout=timeout)
    return resp.get("records", [])


def follow(client, *, poll_timeout_s: float = 10.0,
           stop: Optional[threading.Event] = None, **filters):
    """Follow-mode record stream (``ray_tpu logs -f``): one
    outstanding long-poll against the head's ``logs`` pubsub channel
    (records the head ingested since the retained window), yielding
    filtered records as they land."""
    cursor = 0
    while stop is None or not stop.is_set():
        out = client.head.call(
            "pubsub_poll",
            {"cursors": {"logs": cursor},
             "timeout_s": poll_timeout_s},
            timeout=poll_timeout_s + 10.0)
        ch = (out or {}).get("logs")
        if not ch:
            continue
        cursor = ch["seq"]
        batch: List[Dict] = []
        for event in ch["events"]:
            batch.extend(event.get("records", ()))
        for r in filter_records(batch, **filters):
            yield r


def format_record(r: Dict[str, Any]) -> str:
    """One human-readable line (CLI rendering)."""
    ts = time.strftime("%H:%M:%S", time.localtime(r.get("ts", 0)))
    frac = int((r.get("ts", 0) % 1) * 1000)
    ident = r.get("node", "")[:8] or r.get("lane", "")
    trace = r.get("trace_id", "")
    trace = f" [{trace}]" if trace else ""
    actor = r.get("actor", "")
    actor = f" actor={actor[:8]}" if actor else ""
    return (f"{ts}.{frac:03d} {r.get('level', '?'):7s} "
            f"{ident} {r.get('logger', '')}{trace}{actor}: "
            f"{r.get('msg', '')}")


def to_timeline_events(records: Iterable[Dict]) -> List[Dict]:
    """Render records as Chrome-trace INSTANT events so the merged
    cluster timeline interleaves log lines with spans — a trace id
    links spans ↔ logs in one view."""
    out = []
    for r in records:
        args = {k: v for k, v in r.items()
                if k in ("msg", "logger", "level", "trace_id",
                         "span_id", "task", "actor", "node", "stream")}
        out.append({
            "name": f"log:{r.get('level', '?')}",
            "ph": "i", "s": "p",
            "pid": r.get("lane", "driver"),
            "tid": r.get("thread", "main"),
            "ts": r.get("ts", 0) * 1e6,
            "args": args,
        })
    return out

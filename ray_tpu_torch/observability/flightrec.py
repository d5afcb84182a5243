"""Crash-safe flight recorder: the process black box.

The live observability planes (timeline ring, structured logs, metric
registry) die with the process — a kill -9, an OOM kill, or a native
fault erases the very seconds a postmortem needs.  This module keeps a
bounded ON-DISK record that survives every death mode because it is
already written when death arrives:

- a two-segment JSONL ring (``logs.RingFile``, the PR-7 machinery)
  continuously snapshotting recent timeline events, structured log
  records, and periodic metric-gauge digests (HBM gauges included —
  they live in the same registry);
- a ``faulthandler`` stacks file: final thread stacks dumped by the
  C-level handler on SIGSEGV/SIGABRT/SIGBUS/SIGILL/SIGFPE;
- a ``.final`` JSONL file fed by sys/threading excepthook wrappers and
  an atexit hook — fatal Python exits leave a typed last record.

Crash-hook discipline (enforced by raylint's ``crash-handler-safety``
rule): code reachable from the excepthook/atexit hooks writes ONLY via
``os.write`` on a file descriptor opened at install time — no locks,
no allocation through the metrics/TSDB plane, no RPC.  A hook that
takes a lock can deadlock the dying process; a hook that RPCs can hang
it; both would lose the record they exist to write.

Reference analogue: the event/export surface the GCS task-event path
and ``ray logs`` provide after a worker death (SURVEY §core_worker /
§gcs), collapsed into a per-process black box + the supervisor-side
exit-cause classifiers below.

Env knobs:
  RAY_TPU_FLIGHTREC=0            disable install at runtime boot
  RAY_TPU_FLIGHTREC_DIR          record directory (default
                                 <tmpdir>/ray_tpu_flightrec)
  RAY_TPU_FLIGHTREC_FLUSH_S      snapshot period (default 0.5)
  RAY_TPU_FLIGHTREC_RING_BYTES   per ring segment (4 MiB; 2 segments)
"""

from __future__ import annotations

import json
import os
import signal as _signal
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from . import logs as _logs
from . import timeline as _timeline

DEFAULT_FLUSH_S = float(os.environ.get("RAY_TPU_FLIGHTREC_FLUSH_S",
                                       "0.5"))
RING_BYTES = int(os.environ.get("RAY_TPU_FLIGHTREC_RING_BYTES",
                                str(4 * 1024 * 1024)))
# Events/records per JSONL line: bounds the line a crash can truncate.
_CHUNK = 500
# Gauge digests land every Nth snapshot tick (they are the heaviest
# record and the slowest-moving signal).
_GAUGE_EVERY = 5

_enabled = True


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    """Make the snapshot loop a no-op (the ``flightrec_overhead_pct``
    bench phase toggles the plane cluster-wide this way)."""
    global _enabled
    _enabled = False


def default_dir() -> str:
    return os.environ.get("RAY_TPU_FLIGHTREC_DIR") or os.path.join(
        tempfile.gettempdir(), "ray_tpu_flightrec")


class FlightRecorder:
    """One per process.  ``base`` is a path prefix; the recorder owns
    ``<base>.jsonl`` (+ ``.jsonl.1``), ``<base>.stacks`` and
    ``<base>.final``."""

    def __init__(self, base: str,
                 interval_s: Optional[float] = None):
        self.base = base
        self._interval = (DEFAULT_FLUSH_S if interval_s is None
                          else float(interval_s))
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        self.ring = _logs.RingFile(base + ".jsonl", RING_BYTES)
        # faulthandler keeps the fd for the life of the process; the
        # file object is pinned on self so GC can't close it under the
        # C handler.  Truncate: stacks are only meaningful for THIS
        # incarnation.
        self._stacks_f = open(base + ".stacks", "wb", buffering=0)
        try:
            import faulthandler

            faulthandler.enable(file=self._stacks_f,
                                all_threads=True)
        except Exception:
            pass
        # Final-record fd: crash hooks write here with bare os.write
        # (flush-to-fd only — see module docstring).
        self._final_fd = os.open(base + ".final",
                                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                                 0o644)
        self._ev_cursor = 0
        self._log_cursor = 0
        self._ticks = 0
        self._stop = threading.Event()
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        self._prev_thread_hook = threading.excepthook
        threading.excepthook = self._thread_excepthook
        import atexit

        atexit.register(self._on_atexit)
        self.ring.write(json.dumps({
            "kind": "boot", "ts": time.time(), "pid": os.getpid(),
            "argv": sys.argv[:4], "base": base}))
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"flightrec-{os.getpid()}")
        self._thread.start()

    # ------------------------------------------------------- snapshots
    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.snapshot()
            except Exception:
                pass  # a full disk must not take the process down

    def snapshot(self) -> int:
        """Drain everything new from the timeline/log rings onto disk
        (non-destructive cursors — the EventShipper keeps its own).
        Returns records written."""
        if not _enabled:
            return 0
        written = 0
        now = time.time()
        events, self._ev_cursor = _timeline.drain_since(self._ev_cursor)
        for i in range(0, len(events), _CHUNK):
            self.ring.write(json.dumps(
                {"kind": "events", "ts": now,
                 "events": events[i:i + _CHUNK]}, default=str))
            written += 1
        records, self._log_cursor = _logs.drain_since(self._log_cursor)
        for i in range(0, len(records), _CHUNK):
            self.ring.write(json.dumps(
                {"kind": "logs", "ts": now,
                 "records": records[i:i + _CHUNK]}, default=str))
            written += 1
        self._ticks += 1
        if self._ticks % _GAUGE_EVERY == 1:
            try:
                from . import metrics as _metrics

                values = _metrics.metrics_summary()
                # Bounded digest: the full registry at scale is not a
                # flight-record payload.
                digest = dict(list(sorted(values.items()))[:200])
                self.ring.write(json.dumps(
                    {"kind": "gauges", "ts": now, "values": digest},
                    default=str))
                written += 1
            except Exception:
                pass
        return written

    # ------------------------------------------------------ crash path
    # Everything below here is reachable from crash hooks: flush-to-fd
    # only (no locks, no metrics plane, no RPC — crash-handler-safety).
    def _write_final(self, why: str, exc: Optional[BaseException] = None,
                     thread: str = "") -> None:
        payload: Dict[str, Any] = {
            "kind": "final", "why": why, "ts": time.time(),
            "pid": os.getpid(),
        }
        if thread:
            payload["thread"] = thread
        if exc is not None:
            payload["exc"] = f"{type(exc).__name__}: {exc}"
            payload["tb"] = traceback.format_exception(
                type(exc), exc, exc.__traceback__)
        # sys._current_frames is lock-free; threading.enumerate is not.
        stacks = []
        for tid, frame in sys._current_frames().items():
            stacks.append({"tid": tid,
                           "frames": traceback.format_stack(frame)})
        payload["stacks"] = stacks
        try:
            os.write(self._final_fd,
                     json.dumps(payload, default=str).encode(
                         "utf-8", errors="replace") + b"\n")
        except OSError:
            pass

    def _excepthook(self, exc_type, exc, tb) -> None:
        self._write_final("excepthook", exc)
        self._prev_excepthook(exc_type, exc, tb)

    def _thread_excepthook(self, args) -> None:
        if args.exc_type is not SystemExit:
            self._write_final(
                "thread-excepthook", args.exc_value,
                thread=getattr(args.thread, "name", "") or "")
        self._prev_thread_hook(args)

    def _on_atexit(self) -> None:
        self._write_final("atexit")

    # -------------------------------------------------------- lifecycle
    def stop(self) -> None:
        """Stop the snapshot thread and restore the hooks (tests)."""
        self._stop.set()
        self._thread.join(timeout=2.0)
        if sys.excepthook is self._excepthook:
            sys.excepthook = self._prev_excepthook
        if threading.excepthook is self._thread_excepthook:
            threading.excepthook = self._prev_thread_hook
        import atexit

        atexit.unregister(self._on_atexit)
        self.ring.close()
        # faulthandler must let go of the fd before it closes (a
        # rebase installs a NEW recorder right after, re-enabling it
        # against the new stacks file).
        try:
            import faulthandler

            faulthandler.disable()
        except Exception:
            pass
        try:
            self._stacks_f.close()
            os.close(self._final_fd)
        except OSError:
            pass


_recorder: Optional[FlightRecorder] = None
_install_lock = threading.Lock()


def install(directory: Optional[str] = None,
            interval_s: Optional[float] = None
            ) -> Optional[FlightRecorder]:
    """Idempotently install this process's recorder (runtime boot calls
    this).  A later call with an EXPLICIT different directory rebases —
    the worker entry point re-points the record at its --log-dir."""
    global _recorder
    if os.environ.get("RAY_TPU_FLIGHTREC", "1").lower() in (
            "0", "false", "off"):
        return None
    with _install_lock:
        want_dir = directory or default_dir()
        base = os.path.join(want_dir, f"flight-{os.getpid()}")
        if _recorder is not None:
            if directory is None or _recorder.base == base:
                return _recorder
            _recorder.stop()
            _recorder = None
        try:
            _recorder = FlightRecorder(base, interval_s=interval_s)
        except OSError:
            _recorder = None  # unwritable dir: record-less, not dead
        return _recorder


def current() -> Optional[FlightRecorder]:
    return _recorder


def uninstall() -> None:
    global _recorder
    with _install_lock:
        if _recorder is not None:
            _recorder.stop()
            _recorder = None


def snapshot_now() -> int:
    """Force one snapshot pass (manual capture, tests)."""
    rec = _recorder
    return rec.snapshot() if rec is not None else 0


def base_for_pid(directory: str, pid: int) -> str:
    """The record base a process with ``pid`` writes under
    ``directory`` — the supervisor's pid→record resolution."""
    return os.path.join(directory, f"flight-{pid}")


# ----------------------------------------------------------- postmortem
def read_record(base: str) -> Dict[str, Any]:
    """Load a (possibly crashed) process's record from disk:
    ``{"records": [...], "final": [...], "stacks": str}``.  Lines a
    crash truncated mid-write parse-fail and are skipped."""
    records: List[Dict] = []
    for p in (base + ".jsonl.1", base + ".jsonl"):
        records.extend(_parse_jsonl(p))
    final = _parse_jsonl(base + ".final")
    try:
        with open(base + ".stacks", "r", errors="replace") as f:
            stacks = f.read()
    except OSError:
        stacks = ""
    return {"base": base, "records": records, "final": final,
            "stacks": stacks}


def _parse_jsonl(path: str) -> List[Dict]:
    out: List[Dict] = []
    try:
        with open(path, "r", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # truncated by the crash mid-write
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


def record_events(record: Dict[str, Any]) -> List[Dict]:
    """Flatten a loaded record into Chrome-trace events: the snapshot
    ring's spans as-is, log records as instants, final records and
    stack dumps as ``fatal:*`` instants on the crashed lane."""
    events: List[Dict] = []
    lane = None
    for rec in record.get("records", ()):
        if rec.get("kind") == "events":
            evs = rec.get("events") or []
            events.extend(evs)
            for e in evs:
                lane = lane or e.get("pid")
        elif rec.get("kind") == "logs":
            events.extend(_logs.to_timeline_events(
                rec.get("records") or []))
    for fin in record.get("final", ()):
        events.append({
            "name": f"fatal:{fin.get('why', '?')}", "ph": "i",
            "s": "p", "pid": lane or f"pid:{fin.get('pid', '?')}",
            "tid": fin.get("thread", "main"),
            "ts": float(fin.get("ts", 0)) * 1e6,
            "args": {k: v for k, v in fin.items()
                     if k in ("why", "exc", "tb", "stacks")},
        })
    return events


# -------------------------------------------------- exit classification
# Signals whose default disposition is a fatal death (a supervisor
# seeing one of these on a child knows the process did not choose to
# exit).
_FATAL_SIGNALS = frozenset({
    _signal.SIGKILL, _signal.SIGSEGV, _signal.SIGABRT, _signal.SIGBUS,
    _signal.SIGILL, _signal.SIGFPE, _signal.SIGTERM, _signal.SIGQUIT,
})


def _signal_name(sig: int) -> str:
    try:
        return _signal.Signals(sig).name
    except ValueError:
        return f"SIG{sig}"


def classify_exit(returncode: Optional[int], *,
                  oom_evidence: str = "") -> Dict[str, Any]:
    """Typed exit-cause verdict from a dead child's returncode
    (``Popen`` semantics: negative = killed by that signal) plus any
    OOM evidence the supervisor gathered."""
    if returncode is None:
        return {"exit_code": None, "signal": None, "signal_name": None,
                "oom": False, "cause": "running"}
    rc = int(returncode)
    oom = bool(oom_evidence)
    if rc < 0:
        sig = -rc
        name = _signal_name(sig)
        # The kernel OOM killer delivers SIGKILL; evidence plus any
        # other signal stays classified by the signal (the evidence
        # may be a neighbour's kill in the same cgroup).
        cause = ("oom-kill" if oom and sig == int(_signal.SIGKILL)
                 else f"signal:{name}")
        return {"exit_code": rc, "signal": sig, "signal_name": name,
                "oom": oom and sig == int(_signal.SIGKILL),
                "cause": cause}
    if rc == 0:
        return {"exit_code": 0, "signal": None, "signal_name": None,
                "oom": False, "cause": "clean-exit"}
    return {"exit_code": rc, "signal": None, "signal_name": None,
            "oom": oom, "cause": f"exit:{rc}"}


_CGROUP_EVENT_FILES = (
    "/sys/fs/cgroup/memory.events",                    # cgroup v2
    "/sys/fs/cgroup/memory/memory.oom_control",        # cgroup v1
)


def read_cgroup_oom_count(text: Optional[str] = None) -> int:
    """The cgroup's cumulative oom-kill counter (``oom_kill N`` in v2
    memory.events / v1 oom_control).  ``text`` injects fake contents
    for tests; 0 when unreadable."""
    if text is None:
        for path in _CGROUP_EVENT_FILES:
            try:
                with open(path, "r") as f:
                    text = f.read()
                break
            except OSError:
                continue
        if text is None:
            return 0
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[0] == "oom_kill":
            try:
                return int(parts[1])
            except ValueError:
                return 0
    return 0


def gather_oom_evidence(pid: Optional[int] = None, *,
                        cgroup_text: Optional[str] = None,
                        dmesg_text: Optional[str] = None,
                        baseline_oom_count: int = 0) -> str:
    """Evidence string ("" = none) that a process death was an OOM
    kill.  Two sources: the cgroup oom_kill counter moving past the
    supervisor's baseline (counters are cumulative — a box with
    historical kills must not convict every SIGKILL), and a
    dmesg-style text naming the pid.  Both injectable for tests."""
    parts: List[str] = []
    count = read_cgroup_oom_count(cgroup_text)
    if count > int(baseline_oom_count):
        parts.append(f"cgroup oom_kill count {count} "
                     f"(baseline {baseline_oom_count})")
    if dmesg_text and pid is not None:
        for line in dmesg_text.splitlines():
            low = line.lower()
            if (("oom" in low or "out of memory" in low
                 or "killed process" in low)
                    and str(pid) in line):
                parts.append(f"kernel log: {line.strip()[:160]}")
                break
    return "; ".join(parts)

"""One ``torch.profiler`` capture of a traced run, and the reading of it.

The capture takes CPU and CUDA activity on every thread (the serving
engine launches from a thread of its own).  The serve driver prepares
it in set-up and only starts and stops recording inside the window, so
that sends are not held while the tracer sets up.  The harness marks
the steady slice it wants read with a ``bench.window`` range, and wraps
the calls it attributes work to in ranges of its own (``bench.*``).

The train driver records CUDA activity alone (recording every CPU
operation made the host, and not the card, pace the traced steps), and
marks its slice on the card's own timeline with two ``MARK`` kernels
(``torch.cuda._sleep``) instead of a range.

The exported chrome trace is read for:

- device operations (kernels, copies, fills) with their times,
- the host launch of each (by correlation id), and so the host range it
  was launched in,
- the host ranges (``user_annotation``).
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .stats import union_length

WINDOW = "bench.window"
MARK = "spin_kernel"
_KERNEL_CAT = "kernel"
_DEVICE_CATS = (_KERNEL_CAT, "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class CaptureError(RuntimeError):
    """The traced run's capture holds nothing to read."""


def _profiler(cpu: bool = True):
    """A profiler over CUDA and, with ``cpu`` or without a card, CPU on
    every thread."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu or not torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CPU)
    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    return torch.profiler.profile(activities=acts, **kw)


def start_capture(cpu: bool = True):
    """A profiler started now (set up and recording); returns it."""
    prof = _profiler(cpu)
    try:
        prof.start()
    except BaseException:
        quiet_stop(prof)
        raise
    return prof


def quiet_stop(prof) -> None:
    """Stop ``prof`` if it still records; a failure to stop is moot."""
    try:
        prof.stop()
    except Exception:  # noqa: BLE001 - it was not recording
        pass


def read_capture(prof) -> "Trace":
    """The stopped capture ``prof``, exported to a temporary file and
    parsed (raises ``CaptureError`` when it holds no kernel)."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return Trace.load(path)


def prepared_capture():
    """A profiler set up in the run's set-up and not yet recording.

    The process's first profiler start and stop are taken whole here,
    then a second profiler is prepared (its tracer set up).  The window
    then only calls ``start_trace()`` at the slice and ``stop_trace()``
    after it, so that no costly start falls inside the window."""
    first = _profiler()
    first.start()
    first.stop()
    prof = _profiler()
    prof.prepare_trace()
    return prof


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                 "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()[:120]


class Trace:
    """The parsed capture.  Times are in seconds on the trace's clock."""

    def __init__(self, events: List[dict]):
        self.ops: List[Tuple[str, float, float, Optional[int]]] = []
        launch: Dict[int, Tuple[object, float]] = {}
        self.ranges: List[Tuple[str, object, float, float]] = []
        kernels = 0
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts = float(e["ts"]) * 1e-6
            end = ts + float(e.get("dur", 0.0)) * 1e-6
            args = e.get("args") or {}
            if cat in _DEVICE_CATS:
                kernels += cat == _KERNEL_CAT
                self.ops.append((e.get("name", ""), ts, end,
                                 args.get("correlation")))
            elif cat in _LAUNCH_CATS and "correlation" in args:
                launch[args["correlation"]] = (e.get("tid"), ts)
            elif cat == "user_annotation":
                self.ranges.append((e.get("name", ""), e.get("tid"), ts, end))
        self.ops.sort(key=lambda o: o[1])
        self._launch = launch
        if not kernels:
            raise CaptureError(
                "the capture holds no kernel: CUPTI recorded nothing")

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events)

    # ----------------------------------------------------------- slices
    def window(self) -> Tuple[float, float]:
        """The slice: the ``WINDOW`` range, or else the card's time from
        the end of the first ``MARK`` kernel to the start of the next."""
        spans = [(s, e) for n, _t, s, e in self.ranges if n == WINDOW]
        if spans:
            return spans[0]
        marks = [(s, e) for n, s, e, _c in self.ops if MARK in n]
        if len(marks) < 2:
            raise CaptureError(f"the capture has no {WINDOW} range and "
                               f"no two {MARK} kernels")
        return marks[0][1], marks[1][0]

    def busy_s(self, lo: float, hi: float) -> float:
        """Seconds of [lo, hi] in which some device operation ran."""
        return union_length([(s, e) for _n, s, e, _c in self.ops], lo, hi)

    def ops_in(self, lo: float, hi: float):
        """Device operations that ran wholly inside [lo, hi]."""
        return [o for o in self.ops if o[1] >= lo and o[2] <= hi]

    # ------------------------------------------------------ attribution
    def by_range(self, prefix: str) -> Dict[str, List[tuple]]:
        """The device operations launched inside each host range whose
        name starts with ``prefix``: {range name: [ops]}.  A range's
        name is unique when the harness numbers its ranges."""
        per_tid: Dict[object, List[tuple]] = defaultdict(list)
        for name, tid, s, e in self.ranges:
            if name.startswith(prefix):
                per_tid[tid].append((s, e, name))
        for spans in per_tid.values():
            spans.sort()
        starts = {tid: [s for s, _e, _n in spans]
                  for tid, spans in per_tid.items()}
        out: Dict[str, List[tuple]] = defaultdict(list)
        for op in self.ops:
            hit = self._launch.get(op[3])
            if hit is None or hit[0] not in per_tid:
                continue
            tid, t = hit
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0:
                s, e, name = per_tid[tid][i]
                if s <= t <= e:
                    out[name].append(op)
        return out

    def range_span(self, name: str) -> Optional[Tuple[float, float]]:
        for n, _t, s, e in self.ranges:
            if n == name:
                return s, e
        return None

    # -------------------------------------------------------- breakdown
    def breakdown(self, lo: float, hi: float, top: int = 10) -> Dict:
        """The device operations that took most time in [lo, hi], and the
        longest idle gaps there, each named by the innermost harness or
        program range open on the host at the gap's middle."""
        per: Dict[str, float] = defaultdict(float)
        inside = self.ops_in(lo, hi)
        for name, s, e, _c in inside:
            per[short_name(name)] += e - s
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
        gaps, cur = [], lo
        for _n, s, e, _c in sorted(inside, key=lambda o: o[1]):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if hi > cur:
            gaps.append((cur, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        idle = []
        for s, e in gaps[:top]:
            mid = 0.5 * (s + e)
            open_ = [(re_ - rs, n) for n, _t, rs, re_ in self.ranges
                     if rs <= mid <= re_ and n != WINDOW]
            label = min(open_)[1].split("#")[0] if open_ else "no range"
            idle.append([label, e - s])
        return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": idle}

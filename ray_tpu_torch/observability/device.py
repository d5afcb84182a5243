"""Device-plane telemetry: the accelerator half of the observability
story, on ``torch.cuda``.

The host tiers (tracing/timeline, logs/profiling, metrics) watch the
*framework*; this module watches the *cards* it exists to drive.  Four
surfaces, one module (the reference's ``observability/device.py``
watches TPUs through jax; this one keeps its surfaces and its series):

1. **Memory sampler** — a per-process daemon thread reads every local
   CUDA device every ``RAY_TPU_DEVICE_SAMPLE_S`` seconds and sets the
   ``ray_tpu_device_hbm_bytes_{used,peak,limit}`` /
   ``ray_tpu_device_live_buffers`` gauges from the caching allocator's
   ``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` /
   ``.peak``, the device's total memory, ``allocation.all.current``.
   The sampler NEVER initialises CUDA itself: it idles until the
   process has (``torch.cuda.is_initialized()``), so a process that
   never touches the card pays one sleeping thread and nothing else —
   and no CUDA context.

2. **Kernel-build tracking** — the port's only compiles are the nvcc
   builds of its kernel libraries (``ops/_build.py``).  Each build
   calls :func:`record_kernel_build`, which adds a ``kernel_build``
   timeline span (stamped with the ambient trace id) plus
   ``ray_tpu_kernel_builds_total`` and a duration histogram.

3. **Device-trace capture** — :func:`capture_device_trace` runs
   ``torch.profiler`` over every thread of the process (CPU ranges and,
   on the card, CUDA kernels) for a window and zips the chrome trace
   into one artifact.  :func:`annotation` stamps host-side hot loops
   (train step, serve decode chunk) with a ``record_function`` range
   carrying the ambient trace id, so a device trace correlates with the
   cluster timeline by id.

4. **Model-plane series** — :func:`record_train_step` (per-step
   tokens/s + MFU from the train loop) and :func:`record_program_ema`
   (the serve engine's per-program execution-time EMAs) keep the
   reference's series names.

``disable()`` turns sampling, build tracking and annotations into
no-ops.

Env knobs:
  RAY_TPU_DEVICE_TELEMETRY       0 disables the whole plane
  RAY_TPU_DEVICE_SAMPLE_S        sampler period (default 1.0)
"""

from __future__ import annotations

import contextlib
import io
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

_enabled = os.environ.get("RAY_TPU_DEVICE_TELEMETRY", "1").lower() \
    not in ("0", "false", "off")

DEFAULT_SAMPLE_S = 1.0


def _sample_period() -> float:
    """Sampler period, re-read per tick: tests retune
    RAY_TPU_DEVICE_SAMPLE_S on a process whose sampler thread already
    runs."""
    try:
        return max(0.02, float(os.environ.get(
            "RAY_TPU_DEVICE_SAMPLE_S", DEFAULT_SAMPLE_S)))
    except ValueError:
        return DEFAULT_SAMPLE_S


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    """No-op the plane (measures its cost paired on/off)."""
    global _enabled
    _enabled = False


def _device_metrics():
    from . import metrics as _metrics

    return _metrics.metric_group("device", lambda: {
        "hbm_used": _metrics.Gauge(
            "ray_tpu_device_hbm_bytes_used",
            "device memory held by live tensors (the caching "
            "allocator's allocated_bytes.all.current)",
            tag_keys=("device",)),
        "hbm_peak": _metrics.Gauge(
            "ray_tpu_device_hbm_bytes_peak",
            "peak device memory held by live tensors (the caching "
            "allocator's allocated_bytes.all.peak)",
            tag_keys=("device",)),
        "hbm_limit": _metrics.Gauge(
            "ray_tpu_device_hbm_bytes_limit",
            "device memory capacity",
            tag_keys=("device",)),
        "hbm_util": _metrics.Gauge(
            "ray_tpu_device_hbm_utilization",
            "used / limit",
            tag_keys=("device",)),
        "live_buffers": _metrics.Gauge(
            "ray_tpu_device_live_buffers",
            "live allocations of the caching allocator "
            "(allocation.all.current)",
            tag_keys=("device",)),
        "kernel_builds": _metrics.Counter(
            "ray_tpu_kernel_builds_total",
            "nvcc builds of the port's kernel libraries (ops/_build.py)",
            tag_keys=("library",)),
        "kernel_build_seconds": _metrics.Histogram(
            "ray_tpu_kernel_build_seconds",
            "nvcc wall time of one kernel-library build",
            boundaries=[0.1, 1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 600.0]),
    })


def model_plane_metrics():
    """The model-plane gauges (train step + serve engine hot loops)."""
    from . import metrics as _metrics

    return _metrics.metric_group("model_plane", lambda: {
        "train_tokens_per_s": _metrics.Gauge(
            "ray_tpu_train_tokens_per_s",
            "per-step training throughput (tokens processed / step "
            "wall time), set by the train hot loop every step"),
        "train_mfu": _metrics.Gauge(
            "ray_tpu_train_mfu",
            "per-step model FLOP/s utilization (6N approximation "
            "against the card's bf16 dense peak; only exported where "
            "the peak is known — not on CPU)"),
        "train_step_seconds": _metrics.Gauge(
            "ray_tpu_train_step_seconds",
            "last training step wall time"),
        "program_ema": _metrics.Gauge(
            "ray_tpu_serve_program_seconds",
            "serve engine per-program execution-time EMA (prefill / "
            "decode_chunk / spec_round)",
            tag_keys=("deployment", "program")),
    })


def peak_bf16_flops(device_kind: str) -> Optional[float]:
    """Per-device dense bf16 peak by device name (NVIDIA spec sheets);
    None for unknown kinds (CPU) — callers skip the MFU gauge then."""
    kind = (device_kind or "").lower()
    table = [
        ("h100", 989e12),        # SXM / HBM3
    ]
    for key, flops in table:
        if key in kind:
            return flops
    return None


# ------------------------------------------------------------- sampler

def sample_devices() -> Optional[List[Dict[str, Any]]]:
    """One sample of every local CUDA device: ``{device, platform,
    used, peak, limit, live_buffers}`` per device.  Returns None until
    this process has initialised CUDA (the sampler must never do it —
    that is the worker's decision)."""
    if not torch.cuda.is_initialized():
        return None
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        used = int(stats.get("allocated_bytes.all.current", 0))
        peak = int(stats.get("allocated_bytes.all.peak", used))
        # The total that mem_get_info reports, read from the device's
        # properties: mem_get_info would make a context on a device
        # this process never used.
        limit = int(torch.cuda.get_device_properties(i).total_memory)
        out.append({"device": f"cuda:{i}", "platform": "gpu",
                    "used": used, "peak": peak, "limit": limit,
                    "live_buffers": int(stats.get(
                        "allocation.all.current", 0))})
    return out


def sample_once() -> Optional[List[Dict[str, Any]]]:
    """Sample and publish the device gauges (one sampler tick)."""
    if not _enabled:
        return None
    samples = sample_devices()
    if samples is None:
        return None
    m = _device_metrics()
    for s in samples:
        tags = {"device": s["device"]}
        m["hbm_used"].set(float(s["used"]), tags=tags)
        m["hbm_peak"].set(float(s["peak"]), tags=tags)
        m["hbm_limit"].set(float(s["limit"]), tags=tags)
        m["live_buffers"].set(float(s["live_buffers"]), tags=tags)
        if s["limit"] > 0:
            m["hbm_util"].set(s["used"] / s["limit"], tags=tags)
    return samples


_sampler_lock = threading.Lock()
_sampler_stop: Optional[threading.Event] = None


def install() -> None:
    """Start the per-process sampler thread (idempotent; called at
    Runtime boot next to the structured-log handler).  The thread
    no-ops until CUDA is initialised, so boot makes no CUDA context."""
    global _sampler_stop
    with _sampler_lock:
        if _sampler_stop is not None:
            return
        _sampler_stop = threading.Event()
        t = threading.Thread(target=_sampler_loop,
                             args=(_sampler_stop,), daemon=True,
                             name="device-sampler")
        t.start()


def uninstall() -> None:
    """Stop the sampler thread (tests)."""
    global _sampler_stop
    with _sampler_lock:
        if _sampler_stop is not None:
            _sampler_stop.set()
            _sampler_stop = None


def _sampler_loop(stop: threading.Event) -> None:
    while not stop.wait(_sample_period()):
        try:
            sample_once()
        except Exception:
            pass  # one bad tick must not kill the plane


# ----------------------------------------------------- build tracking

def record_kernel_build(library: str, duration_s: float) -> None:
    """One nvcc build of a kernel library (``ops/_build.py``): counter,
    histogram and a ``kernel_build`` timeline span.  Must never raise."""
    if not _enabled:
        return
    try:
        m = _device_metrics()
        m["kernel_builds"].inc(tags={"library": library})
        m["kernel_build_seconds"].observe(float(duration_s))
        from . import tracing
        from .timeline import process_pid, record_span

        now = time.time()
        args: Dict[str, Any] = {"library": library,
                                "duration_s": round(duration_s, 4)}
        ctx = tracing.current()
        if ctx is not None:
            args["trace_id"] = ctx[0]
        record_span("kernel_build", now - duration_s, now,
                    pid=process_pid(), tid="kernel-build", args=args)
    except Exception:
        pass  # telemetry must never break a build


# ------------------------------------------------ device-trace capture

_capture_lock = threading.Lock()


def _profiler_activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def capture_device_trace(duration_s: float = 1.0,
                         tmp_root: Optional[str] = None
                         ) -> Dict[str, Any]:
    """Capture a device profile of THIS process for ``duration_s``:
    ``torch.profiler`` over every thread (the ranges of
    :func:`annotation` are entered on the engines' own threads) →
    sleep → stop, then zip the chrome trace into one artifact.
    Returns ``{name, data (zip bytes), files, duration_s, trace_id}``.
    Serialized per process — one profiler may run at a time."""
    import shutil
    import tempfile
    import zipfile

    from torch._C._profiler import _ExperimentalConfig

    from . import tracing

    duration_s = min(max(float(duration_s), 0.05), 60.0)
    ctx = tracing.current()
    trace_id = ctx[0] if ctx else None
    with _capture_lock:
        out_dir = tempfile.mkdtemp(prefix="ray_tpu_devtrace_",
                                   dir=tmp_root)
        try:
            prof = torch.profiler.profile(
                activities=_profiler_activities(),
                experimental_config=_ExperimentalConfig(
                    profile_all_threads=True))
            prof.start()
            try:
                # The sleep IS the capture window, and the lock exists
                # exactly to serialize it: one profiler per process,
                # and nothing else ever takes this lock.
                time.sleep(duration_s)  # raylint: disable=blocking-under-lock -- dedicated capture lock; the bounded sleep is the capture window itself
            finally:
                prof.stop()
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
            buf = io.BytesIO()
            files = 0
            with zipfile.ZipFile(buf, "w",
                                 zipfile.ZIP_DEFLATED) as zf:
                for root, _dirs, names in os.walk(out_dir):
                    for fname in sorted(names):
                        path = os.path.join(root, fname)
                        zf.write(path, os.path.relpath(path, out_dir))
                        files += 1
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
    name = "device-trace-%d-%d.zip" % (os.getpid(),
                                       int(time.time() * 1000))
    return {"name": name, "data": buf.getvalue(), "files": files,
            "duration_s": duration_s, "trace_id": trace_id}


_NULL_CTX = contextlib.nullcontext()


def annotation(name: str):
    """A ``torch.profiler.record_function`` range carrying the ambient
    trace id (``name#trace=<id>``) so device-trace slices correlate
    with the cluster timeline — or a shared no-op context when the
    plane is disabled.  Cheap enough for per-chunk hot loops: a
    record_function with no profiler running is a few host
    instructions."""
    if not _enabled:
        return _NULL_CTX
    from . import tracing

    ctx = tracing.current()
    if ctx is not None:
        name = f"{name}#trace={ctx[0]}"
    return torch.profiler.record_function(name)


# ---------------------------------------------------- model-plane emit

def record_train_step(tokens: int, step_s: float,
                      n_params: Optional[int] = None,
                      device_kind: Optional[str] = None,
                      n_devices: int = 1) -> None:
    """Publish one training step's model-plane gauges: tokens/s
    always, MFU when the card's peak is known (6N dense-LM
    approximation).  ``tokens`` is the WHOLE step's token count, so a
    multi-card gang must pass its ``device_kind`` and distinct card
    count — the peak is per card.  Called from the train hot loop;
    must never raise."""
    if not _enabled or step_s <= 0:
        return
    try:
        m = model_plane_metrics()
        tps = tokens / step_s
        m["train_tokens_per_s"].set(tps)
        m["train_step_seconds"].set(step_s)
        if device_kind is None and torch.cuda.is_initialized():
            device_kind = torch.cuda.get_device_name()
        if n_params and device_kind:
            peak = peak_bf16_flops(device_kind)
            if peak:
                m["train_mfu"].set(
                    tps * 6 * n_params / (peak * max(1, n_devices)))
    except Exception:
        pass


def record_program_ema(deployment: str, program: str,
                       seconds: Optional[float]) -> None:
    """Publish a serve-engine per-program execution-time EMA gauge
    (prefill / decode_chunk / spec_round).  Must never raise."""
    if not _enabled or seconds is None:
        return
    try:
        model_plane_metrics()["program_ema"].set(
            float(seconds), tags={"deployment": deployment,
                                  "program": program})
    except Exception:
        pass

"""Per-process metric registry of the port's serving plane.

A stand-in for the reference's observability plane (``ray_tpu/
observability/metrics.py``) until that plane is ported (ROADMAP queue A,
'Device plane'): counters and gauges keyed by name and tag values, read
back by :func:`metrics_summary` in the reference's shape, ``{name:
{"tag,values": value}}``.  The paged KV plane's series keep the
reference's names (:func:`kv_cache_counters`), and so do the engine's
deadline sheds (:func:`overload_counters`) and its per-program time
EMAs (:func:`record_program_ema`, which the reference keeps in its
device plane, ``ray_tpu/observability/device.py``).  As in the reference, the
registry is one per process: every engine of the process adds to the
same series, told apart by their tags.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

_lock = threading.Lock()
_registry: Dict[str, "_Metric"] = {}


class _Metric:
    def __init__(self, name: str, description: str,
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._vlock = threading.Lock()

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple[str, ...]:
        tags = tags or {}
        return tuple(str(tags.get(k, "")) for k in self.tag_keys)

    def snapshot(self) -> Dict[Tuple[str, ...], float]:
        with self._vlock:
            return dict(self._values)


class Counter(_Metric):
    def inc(self, value: float = 1, tags=None) -> None:
        key = self._key(tags)
        with self._vlock:
            self._values[key] = self._values.get(key, 0) + value


class Gauge(_Metric):
    def set(self, value: float, tags=None) -> None:
        key = self._key(tags)
        with self._vlock:
            self._values[key] = value


def _get(cls, name: str, description: str, tag_keys: Sequence[str]):
    with _lock:
        m = _registry.get(name)
        if m is None:
            m = _registry[name] = cls(name, description, tag_keys)
        return m


def metrics_summary() -> Dict[str, Dict[str, float]]:
    """{metric name: {comma-joined tag values: value}} of everything."""
    with _lock:
        metrics = dict(_registry)
    return {name: {",".join(k): v for k, v in m.snapshot().items()}
            for name, m in metrics.items()}


def kv_cache_counters() -> Dict[str, _Metric]:
    """The paged KV plane's series, under the reference's names (the
    handoff series of disaggregated serving are not ported)."""
    return {
        "blocks_used": _get(
            Gauge, "ray_tpu_kv_blocks_used",
            "KV-cache blocks currently allocated (refcount > 0, incl. "
            "blocks pinned by the prefix cache)", ("pool",)),
        "blocks_free": _get(
            Gauge, "ray_tpu_kv_blocks_free",
            "KV-cache blocks on the free list", ("pool",)),
        "prefix_hits": _get(
            Counter, "ray_tpu_prefix_cache_hits",
            "prompt-prefix lookups that reused >= 1 cached block",
            ("pool",)),
        "prefix_misses": _get(
            Counter, "ray_tpu_prefix_cache_misses",
            "prompt-prefix lookups with no cached block", ("pool",)),
        "pool_bytes": _get(
            Gauge, "ray_tpu_kv_pool_bytes",
            "device bytes held by the paged KV pool (quantized pools "
            "include their per-row scale tensors)", ("pool", "dtype")),
        "spec_proposed": _get(
            Counter, "ray_tpu_spec_decode_proposed_tokens",
            "draft-model tokens proposed to the verifier",
            ("deployment",)),
        "spec_accepted": _get(
            Counter, "ray_tpu_spec_decode_accepted_tokens",
            "proposed tokens the target model verified and emitted "
            "(accept rate = accepted / proposed)", ("deployment",)),
    }


def overload_counters() -> Dict[str, _Metric]:
    """The overload series the engine feeds, under the reference's names
    (``ray_tpu/observability/metrics.py``)."""
    return {
        "expired_shed": _get(
            Counter, "ray_tpu_requests_expired_shed",
            "deadline-expired work shed before execution "
            "(user code never ran)", ("where",)),
    }


def model_plane_metrics() -> Dict[str, _Metric]:
    """The serve engine's model-plane gauge, under the reference's name
    (``ray_tpu/observability/device.py``)."""
    return {
        "program_ema": _get(
            Gauge, "ray_tpu_serve_program_seconds",
            "serve engine per-program execution-time EMA (prefill / "
            "decode_chunk / spec_round)", ("deployment", "program")),
    }


def record_program_ema(deployment: str, program: str,
                       seconds: Optional[float]) -> None:
    """Publish a serve-engine per-program execution-time EMA (prefill /
    decode_chunk / spec_round); ``None`` (no sample yet) is skipped."""
    if seconds is None:
        return
    model_plane_metrics()["program_ema"].set(
        float(seconds), tags={"deployment": deployment, "program": program})

"""Application + runtime metrics.

Reference: python/ray/util/metrics.py (Counter/Gauge/Histogram over
the C++ OpenCensus registry, stats/metric.h:103) — here a process-local
registry; the runtime increments task/object counters and
``metrics_summary()`` snapshots everything.

Cluster aggregation: ``export_state()`` is the picklable snapshot each
worker ships to the head (observability/events.py push_events), and
``render_exposition()`` renders any set of per-node snapshots as ONE
Prometheus text page with a ``node_id`` label on every series — the
head-side /metrics that unions head + worker series.  The local
``prometheus_text()`` is the single-process special case of the same
renderer.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_lock = threading.Lock()
_registry: Dict[str, "_Metric"] = {}

# Per-process incarnation id, minted once at import: pid alone recycles,
# so the start time rides along.  Shipped with every metrics snapshot
# (export_snapshot) so the head's TSDB can tell a *restarted* worker's
# counter reset from a decrementing series — without it, a restart
# looks like a huge negative rate() delta.
INCARNATION = f"{os.getpid():x}-{int(time.time() * 1000) & 0xFFFFFFFF:x}"


class _Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._values: Dict[Tuple, float] = {}
        self._vlock = threading.Lock()
        with _lock:
            existing = _registry.get(name)
            if existing is not None:
                # Re-declaring a metric returns the same series — but a
                # CONFLICTING re-declaration (different kind or tag
                # keys) would silently corrupt the series, so it is an
                # error, not a shrug.
                if type(existing) is not type(self):
                    raise ValueError(
                        f"metric {name!r} re-declared as "
                        f"{type(self).__name__}, but it was registered "
                        f"as a {type(existing).__name__}")
                if existing.tag_keys != self.tag_keys:
                    raise ValueError(
                        f"metric {name!r} re-declared with tag_keys="
                        f"{self.tag_keys}, but it was registered with "
                        f"tag_keys={existing.tag_keys}")
                self.__dict__ = existing.__dict__
            else:
                _registry[name] = self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        tags = tags or {}
        return tuple(tags.get(k, "") for k in self.tag_keys)

    def snapshot(self) -> Dict[Tuple, float]:
        with self._vlock:
            return dict(self._values)


class Counter(_Metric):
    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        k = self._key(tags)
        with self._vlock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(_Metric):
    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._vlock:
            self._values[self._key(tags)] = float(value)

    def remove(self, tags: Optional[Dict[str, str]] = None):
        """Drop one tagged series.  Gauges keyed by churning entities
        (actor mailboxes, serve replicas across rolling updates) must
        be removed on teardown or the registry and /metrics grow
        without bound and dead entities export stale values forever."""
        with self._vlock:
            self._values.pop(self._key(tags), None)


class Histogram(_Metric):
    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (), tag_keys=()):
        super().__init__(name, description, tag_keys)
        if not getattr(self, "boundaries", None):
            self.boundaries = sorted(boundaries) or [
                0.001, 0.01, 0.1, 1.0, 10.0, 100.0]
            self._counts: Dict[Tuple, List[int]] = {}
        elif boundaries and sorted(boundaries) != list(self.boundaries):
            # Same name, different buckets: observations would land in
            # the FIRST declaration's buckets while this caller reasons
            # about its own — raise instead of silently ignoring.
            raise ValueError(
                f"histogram {name!r} re-declared with boundaries="
                f"{sorted(boundaries)}, but it was registered with "
                f"boundaries={list(self.boundaries)}")

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None):
        k = self._key(tags)
        with self._vlock:
            counts = self._counts.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            counts[bisect.bisect_left(self.boundaries, value)] += 1
            self._values[k] = self._values.get(k, 0.0) + value  # sum

    def buckets(self, tags: Optional[Dict[str, str]] = None) -> List[int]:
        with self._vlock:
            return list(self._counts.get(self._key(tags), []))


def metrics_summary() -> Dict[str, Dict]:
    """{metric name: {tag-tuple repr: value}} snapshot of everything."""
    with _lock:
        metrics = dict(_registry)
    out = {}
    for name, m in metrics.items():
        snap = m.snapshot()
        out[name] = {
            ",".join(k) if k else "": v for k, v in snap.items()}
    return out


# ------------------------------------------------------------ exposition
def _escape_label_value(v) -> str:
    """Prometheus exposition format: label values escape backslash,
    double-quote, and newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def export_state() -> Dict[str, Dict]:
    """Picklable snapshot of every registered metric — name → {kind,
    description, tag_keys, values, and for histograms boundaries +
    bucket counts}.  This is what the event shipper sends to the head
    and what ``render_exposition`` consumes."""
    with _lock:
        metrics = dict(_registry)
    out: Dict[str, Dict] = {}
    for name, m in metrics.items():
        kind = ("counter" if isinstance(m, Counter)
                else "histogram" if isinstance(m, Histogram)
                else "gauge")
        entry = {
            "kind": kind,
            "description": m.description,
            "tag_keys": tuple(m.tag_keys),
            "values": m.snapshot(),
        }
        if isinstance(m, Histogram):
            with m._vlock:
                entry["boundaries"] = list(m.boundaries)
                entry["counts"] = {k: list(v)
                                   for k, v in m._counts.items()}
        out[name] = entry
    return out


def export_snapshot() -> Dict:
    """``export_state`` wrapped with its wall-clock timestamp and this
    process's :data:`INCARNATION` — the unit the event shipper pushes
    and the head TSDB ingests (observability/tsdb.py)."""
    return {"ts": time.time(), "incarnation": INCARNATION,
            "state": export_state()}


def render_exposition(states: Dict[Optional[str], Dict[str, Dict]]) -> str:
    """Render per-node ``export_state()`` snapshots as one Prometheus
    text page.  ``states`` maps node_id → state; a None key means "no
    node label" (the single-process exposition).  Every series from a
    labeled node carries ``node_id="..."`` so the head's aggregated
    /metrics distinguishes worker-recorded series."""
    # metric name -> [(node_id, entry)] preserving node order.
    by_name: Dict[str, List[Tuple[Optional[str], Dict]]] = {}
    for node_id, state in states.items():
        for name, entry in state.items():
            by_name.setdefault(name, []).append((node_id, entry))

    lines: List[str] = []
    for name in sorted(by_name):
        first = by_name[name][0][1]
        if first["description"]:
            lines.append(f"# HELP {name} {first['description']}")
        lines.append(f"# TYPE {name} {first['kind']}")
        for node_id, entry in by_name[name]:
            base_pairs = ([f'node_id="{_escape_label_value(node_id)}"']
                          if node_id is not None else [])
            tag_keys = entry["tag_keys"]

            def labelstr(key: Tuple, extra: Optional[str] = None) -> str:
                pairs = list(base_pairs)
                pairs += [f'{k}="{_escape_label_value(v)}"'
                          for k, v in zip(tag_keys, key) if v]
                if extra:
                    pairs.append(extra)
                return "{" + ",".join(pairs) + "}" if pairs else ""

            if entry["kind"] == "histogram":
                sums = entry["values"]
                for key, buckets in entry.get("counts", {}).items():
                    cum = 0
                    for bound, c in zip(entry["boundaries"], buckets):
                        cum += c
                        le = 'le="%s"' % bound
                        lines.append(
                            f"{name}_bucket{labelstr(key, le)} {cum}")
                    cum += buckets[-1]
                    inf = 'le="+Inf"'
                    lines.append(
                        f"{name}_bucket{labelstr(key, inf)} {cum}")
                    lines.append(f"{name}_count{labelstr(key)} {cum}")
                    lines.append(
                        f"{name}_sum{labelstr(key)} "
                        f"{sums.get(key, 0.0)}")
            else:
                for key, v in entry["values"].items():
                    lines.append(f"{name}{labelstr(key)} {v}")
    return "\n".join(lines) + "\n"


def prometheus_text() -> str:
    """Prometheus text exposition of every registered metric
    (reference: the node metrics agent's exposition endpoint,
    dashboard/modules/reporter/reporter_agent.py:336 +
    _private/metrics_agent.py)."""
    return render_exposition({None: export_state()})


_exposition_server = None


def start_metrics_server(port: int = 0) -> str:
    """Serve ``prometheus_text`` at ``GET /metrics`` (stdlib http;
    returns the bound address).  One per process — a second call
    returns the address of the already-running server."""
    global _exposition_server
    if _exposition_server is not None:
        return _exposition_server
    import http.server
    import threading as _threading

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            if self.path != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            body = prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    t = _threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    _exposition_server = f"127.0.0.1:{srv.server_address[1]}"
    return _exposition_server


def reset_metrics():
    with _lock:
        _registry.clear()


# Hot-path metric groups are built once and reused until
# reset_metrics() wipes the registry: callers sit on per-record paths
# (task completions, ring frames, rpc retries), so the rebuild check
# must be one dict lookup + identity compare, not a registry lock.
_groups: Dict[str, Tuple[Dict[str, "_Metric"], "_Metric"]] = {}


def metric_group(key: str, build) -> Dict[str, "_Metric"]:
    """Build-once {name: metric} group keyed by ``key``; ``build`` runs
    again only after reset_metrics() invalidated the group (detected by
    the first member falling out of the registry)."""
    entry = _groups.get(key)
    if entry is not None:
        group, anchor = entry
        if _registry.get(anchor.name) is anchor:
            return group
    group = build()
    _groups[key] = (group, next(iter(group.values())))
    return group


def runtime_counters():
    """Per-task-completion series (incremented by ray_tpu_torch.core.runtime)."""
    return metric_group("runtime", lambda: {
        "tasks_finished": Counter(
            "ray_tpu_tasks_finished", "tasks completed OK",
            tag_keys=("kind",)),
        "tasks_failed": Counter(
            "ray_tpu_tasks_failed", "tasks completed with error",
            tag_keys=("kind",)),
        "task_seconds": Histogram(
            "ray_tpu_task_seconds", "task execution wall time",
            tag_keys=("kind",)),
    })


def overload_counters():
    """The overload-protection plane's series (deadline sheds,
    admission-control rejections, circuit-breaker state, bounded-queue
    depths) — incremented by core/deadlines.py, core/actor_runtime.py,
    serve/handle.py, serve/batching.py, cluster/client.py."""
    return metric_group("overload", lambda: {
        "expired_shed": Counter(
            "ray_tpu_requests_expired_shed",
            "deadline-expired work shed before execution "
            "(user code never ran)", tag_keys=("where",)),
        "backpressure": Counter(
            "ray_tpu_backpressure_rejections",
            "typed admission-control rejections (BackPressureError / "
            "PendingCallsLimitExceededError)", tag_keys=("where",)),
        "breaker_state": Gauge(
            "ray_tpu_circuit_breaker_state",
            "per-replica router circuit breaker "
            "(0 closed, 1 half-open, 2 open)",
            tag_keys=("deployment", "replica")),
        "breaker_trips": Counter(
            "ray_tpu_circuit_breaker_trips",
            "closed->open breaker transitions",
            tag_keys=("deployment",)),
        "queue_depth": Gauge(
            "ray_tpu_queue_depth",
            "bounded-queue depths (actor mailboxes, @serve.batch "
            "queues, object-plane push streams)", tag_keys=("queue",)),
    })


def kv_cache_counters():
    """The paged-KV serving plane's series (serve/kv_cache.py +
    serve/llm.py): block-pool occupancy, prefix-cache effectiveness,
    decode-batch utilization, and KV handoff traffic between
    disaggregated prefill/decode replicas."""
    return metric_group("kv_cache", lambda: {
        "blocks_used": Gauge(
            "ray_tpu_kv_blocks_used",
            "KV-cache blocks currently allocated (refcount > 0, "
            "incl. blocks pinned by the prefix cache)",
            tag_keys=("pool",)),
        "blocks_free": Gauge(
            "ray_tpu_kv_blocks_free",
            "KV-cache blocks on the free list", tag_keys=("pool",)),
        "prefix_hits": Counter(
            "ray_tpu_prefix_cache_hits",
            "prompt-prefix lookups that reused >= 1 cached block",
            tag_keys=("pool",)),
        "prefix_misses": Counter(
            "ray_tpu_prefix_cache_misses",
            "prompt-prefix lookups with no cached block",
            tag_keys=("pool",)),
        "batch_occupancy": Gauge(
            "ray_tpu_decode_batch_occupancy",
            "active slots in the last launched decode chunk",
            tag_keys=("deployment",)),
        "kv_handoff_bytes": Counter(
            "ray_tpu_kv_handoff_bytes",
            "KV-block bytes handed prefill->decode, by transport "
            "(shm = same-host channel ring, dcn = striped object "
            "plane)", tag_keys=("transport",)),
        "kv_handoffs": Counter(
            "ray_tpu_kv_handoff_total",
            "prefill->decode KV handoffs completed, by transport",
            tag_keys=("transport",)),
        "pool_bytes": Gauge(
            "ray_tpu_kv_pool_bytes",
            "device bytes held by the paged KV pool (quantized pools "
            "include their per-block scale tensors)",
            tag_keys=("pool", "dtype")),
        "spec_proposed": Counter(
            "ray_tpu_spec_decode_proposed_tokens",
            "draft-model tokens proposed to the verifier",
            tag_keys=("deployment",)),
        "spec_accepted": Counter(
            "ray_tpu_spec_decode_accepted_tokens",
            "proposed tokens the target model verified and emitted "
            "(accept rate = accepted / proposed)",
            tag_keys=("deployment",)),
    })


def shuffle_counters():
    """The push-exchange data plane's series (data/exchange.py): bytes
    moved per transport, reduce-partition completions, spill volume,
    and the reducers' buffered-fragment depth — the signals that tell a
    skewed or memory-bound shuffle apart from a healthy one."""
    return metric_group("shuffle", lambda: {
        "bytes": Counter(
            "ray_tpu_shuffle_bytes",
            "fragment payload bytes pushed map->reduce, by transport "
            "(shm = same-host channel ring, dcn = striped push "
            "sockets, obj = object-plane fallback)",
            tag_keys=("transport",)),
        "partitions": Counter(
            "ray_tpu_shuffle_partitions_total",
            "reduce partitions finalized (merged and handed "
            "downstream)"),
        "spilled_bytes": Counter(
            "ray_tpu_shuffle_spilled_bytes",
            "buffered fragment bytes a reducer moved to plasma when a "
            "reduce partition outgrew shuffle_spill_limit_bytes"),
        "reduce_queue_depth": Gauge(
            "ray_tpu_shuffle_reduce_queue_depth",
            "fragments buffered in this process's reducers, received "
            "but not yet merged into an output partition"),
    })


def dropped_events_counter() -> Counter:
    """Timeline ring-buffer evictions (observability/timeline.py
    increments this so drops show up in metrics_summary())."""
    return metric_group("timeline", lambda: {
        "dropped": Counter(
            "ray_tpu_timeline_dropped_events",
            "timeline events evicted by the drop-oldest ring buffer"),
    })["dropped"]

"""Typed runtime config flag table with env-var override.

Reference semantics: src/ray/common/ray_config.h:60 + ray_config_def.h —
a table of typed flags, each overridable via a ``RAY_<name>`` environment
variable or an explicit ``_system_config`` dict at init time.  Here the
prefix is ``RAY_TPU_`` and the table is a dataclass-like registry; every
process (driver + spawned workers) receives the serialized overrides so
the whole cluster sees one consistent config (ray_config.h:95).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict

_ENV_PREFIX = "RAY_TPU_"

_BOOL_TRUE = {"1", "true", "True", "yes", "on"}
_BOOL_FALSE = {"0", "false", "False", "no", "off"}


def _parse(type_: type, raw: str) -> Any:
    if type_ is bool:
        if raw in _BOOL_TRUE:
            return True
        if raw in _BOOL_FALSE:
            return False
        raise ValueError(f"cannot parse bool from {raw!r}")
    if type_ is str:
        return raw
    return type_(raw)


class _Flag:
    __slots__ = ("name", "type", "default", "doc")

    def __init__(self, name: str, type_: type, default: Any, doc: str):
        self.name = name
        self.type = type_
        self.default = default
        self.doc = doc


class Config:
    """Registry of typed flags. Resolution order: explicit override >
    environment variable > default."""

    def __init__(self):
        self._flags: Dict[str, _Flag] = {}
        self._overrides: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def define(self, name: str, type_: type, default: Any, doc: str = ""):
        self._flags[name] = _Flag(name, type_, default, doc)

    def get(self, name: str) -> Any:
        flag = self._flags[name]
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
        env = os.environ.get(_ENV_PREFIX + name)
        if env is not None:
            return _parse(flag.type, env)
        return flag.default

    def set(self, name: str, value: Any):
        flag = self._flags[name]
        if not isinstance(value, flag.type):
            value = flag.type(value)
        with self._lock:
            self._overrides[name] = value

    def update(self, system_config: Dict[str, Any]):
        for k, v in system_config.items():
            self.set(k, v)

    def serialize_overrides(self) -> str:
        with self._lock:
            return json.dumps(self._overrides)

    def load_overrides(self, blob: str):
        self.update(json.loads(blob))

    def reset(self):
        with self._lock:
            self._overrides.clear()

    def __getattr__(self, name: str) -> Callable[[], Any]:
        # config.task_retry_delay_ms() style accessors, mirroring
        # RayConfig::instance().flag() in the reference.
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._flags:
            raise AttributeError(f"unknown config flag: {name}")
        return lambda: self.get(name)

    def describe(self) -> Dict[str, Any]:
        return {
            name: {"type": f.type.__name__, "default": f.default, "doc": f.doc}
            for name, f in self._flags.items()
        }


GLOBAL_CONFIG = Config()
_d = GLOBAL_CONFIG.define

# --- core scheduling / tasks ------------------------------------------------
_d("task_retry_delay_ms", int, 0, "Delay before owner-side task resubmission.")
_d("max_pending_lease_requests_per_scheduling_category", int, 10,
   "Parallel lease requests per SchedulingKey (normal_task_submitter.h).")
_d("scheduler_spread_threshold", float, 0.5,
   "Hybrid policy: prefer local node until utilization crosses this.")
_d("num_workers_per_node", int, 0,
   "Worker processes per node; 0 = num_cpus.")
_d("worker_lease_timeout_ms", int, 30_000, "Lease grant timeout.")
_d("actor_creation_timeout_ms", int, 60_000, "Actor readiness timeout.")
_d("max_direct_call_object_size", int, 100 * 1024,
   "Results at or below this inline into the owner's memory store "
   "(reference ray_config_def.h max_direct_call_object_size).")

# --- object store -----------------------------------------------------------
_d("object_store_memory_bytes", int, 2 * 1024**3,
   "Host shared-memory store capacity per node.")
_d("object_spilling_threshold", float, 0.8,
   "Fraction of store capacity that triggers spilling.")
_d("object_spilling_directory", str, "",
   "Directory for spilled objects; empty = <session_dir>/spill.")
_d("object_store_full_delay_ms", int, 100, "Retry delay when store is full.")
_d("object_chunk_bytes", int, 4 * 1024 * 1024,
   "Chunk size for inter-node object pulls (object_buffer_pool.h).")
_d("object_shm_directory", str, "/dev/shm",
   "tmpfs directory for shared-memory primary copies (plasma proper, "
   "store.h:55); empty disables shm re-homing.")
_d("object_shm_min_bytes", int, 1024 * 1024,
   "Primary copies at or above this size are re-homed to shared "
   "memory at seal time; 0 disables.")
_d("object_pull_streams", int, 4,
   "Cap on parallel TCP connections per chunked pull/push.  One socket "
   "serializes all chunks behind one reader thread (~0.8 GB/s "
   "loopback); striping chunks over N sockets multiplies throughput "
   "until memory bandwidth (recv copies release the GIL).  The actual "
   "stream count adapts to payload size (cluster/geometry.py): small "
   "payloads ride one stream, big ones scale up to this cap.")
_d("object_stream_stripe_bytes", int, 16 * 1024 * 1024,
   "Payload bytes per additional transfer stream: a pull/push opens "
   "ceil(total / this) streams, capped at object_pull_streams "
   "(cluster/geometry.py adaptive geometry).")
_d("object_broadcast_fanout", int, 2,
   "Children per node in the push-based broadcast tree "
   "(push_manager.h:30 analogue; depth = log_fanout(n)).")
_d("max_lineage_bytes", int, 100 * 1024 * 1024,
   "Lineage pinned for reconstruction, per owner (task_manager.h:219).")

# --- isolated worker pool (N8) + memory monitor (N22) -----------------------
_d("isolated_pool_prestart", int, 0,
   "Worker subprocesses spawned ahead of demand "
   "(worker_pool.h:216 prestart).")
_d("isolated_pool_max_workers", int, 8,
   "Max concurrent isolated worker subprocesses per node.")
_d("isolated_pool_idle_timeout_s", float, 60.0,
   "Idle pooled workers beyond the prestart count are reaped after "
   "this long (worker_pool.h idle killing).")
_d("memory_usage_threshold", float, 0.95,
   "Node memory fraction that triggers the OOM killer on isolated "
   "workers (ray_config_def.h memory_usage_threshold).")
_d("memory_monitor_refresh_ms", int, 250,
   "Memory watermark poll period; 0 disables the monitor "
   "(memory_monitor.h:52).")

# --- fault tolerance --------------------------------------------------------
_d("health_check_period_ms", int, 1000, "GCS → node health probe period.")
_d("health_check_failure_threshold", int, 5,
   "Missed probes before a node is declared dead.")
_d("task_events_max_buffer_size", int, 10_000,
   "Per-worker buffered task events before flush to GCS.")
_d("gcs_storage", str, "memory", "GCS table storage backend: memory | file.")

# --- chaos / testing (reference: rpc_chaos.h, asio_chaos.h) -----------------
_d("testing_rpc_failure", str, "",
   'Fault injection: "Method=max_failures" drops matching RPCs.')
_d("testing_delay_us", str, "",
   'Fault injection: "Method=min:max" adds random handler delay.')

# --- logging / observability ------------------------------------------------
_d("event_stats", bool, True, "Record per-handler event-loop stats.")
_d("metrics_report_interval_ms", int, 2000, "Metrics push period.")

# --- TPU / mesh -------------------------------------------------------------
_d("tpu_premap_ici_mesh", bool, True,
   "Lay out device meshes along physical ICI torus coordinates.")
_d("default_remat_policy", str, "nothing_saveable",
   "jax.checkpoint policy for train steps built by ray_tpu_torch.train.")

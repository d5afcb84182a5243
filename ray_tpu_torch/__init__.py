"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

The port is a package of its own beside ``ray_tpu``: it imports
``torch``, numpy and the standard library only, never ``jax`` and
nothing of ``ray_tpu``.  Where it needs a module of the JAX package that
is framework-agnostic Python it keeps its own copy
(``tests/test_torch_copies.py`` holds each copy to its original).

Public surface, as the reference's (python/ray/__init__.py):
``init/shutdown/remote/get/put/wait/cancel/kill`` on the local-mode
runtime, with the GPU as the scheduled accelerator resource
(``num_gpus``, ``"GPU"``), plus ``serve``.  Cluster mode
(``init(address=...)``, ``isolate=True``, the DAG API, ``timeline()``)
is not ported yet and raises ``NotImplementedError``.

Layout mirrors the JAX package so counterparts are easy to find:

- ``core/`` — the local runtime: tasks, actors, object store,
  scheduler, resources (``core/resources.py`` counts the CUDA devices)
- ``cluster/serialization.py`` — the object boundary; ``torch.Tensor``
  leaves are cloned on their own device at seal and on every read, and
  cross the wire as raw bytes with their dtype and device
- ``observability/`` — metrics, tracing, logs; ``device.py`` is the
  device plane on ``torch.cuda`` (memory gauges, kernel-library
  builds, ``torch.profiler`` traces)
- ``serve/`` — controller, replicas, handles, HTTP/gRPC ingress;
  ``serve/llm.py`` the continuous-batching ``LLMServer`` (dense and
  paged KV planes, int8/fp8 KV blocks, speculative decoding) and
  ``serve/kv_cache.py`` its block allocator and prefix cache
- ``models/llama.py``, ``models/moe.py`` — the model families;
  ``models/convert.py`` JAX (numpy) pytree <-> torch tensors
- ``ops/flash_attention.py`` + ``ops/csrc/`` — the flash-attention
  kernels for sm_90a, their plain PyTorch versions, and the wrappers
- ``parallel/``, ``train/`` — meshes, sharding, pipeline stages, the
  train step
- ``tools/kernel_ab.py`` — times the kernels against another checkout's

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``core/device.py``).  Importing the package creates no CUDA context.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Sequence, Union

from ._version import version as __version__
from . import exceptions
from .core.actor import ActorClass, ActorHandle, ActorMethod, exit_actor
from .core.config import GLOBAL_CONFIG
from .core.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from .core.object_ref import ObjectRef, ObjectRefGenerator
from .core.remote_function import RemoteFunction
from .core import runtime as _runtime_mod
from .core.runtime import (get_runtime, is_initialized, try_get_runtime)
from .core.task_spec import (DefaultSchedulingStrategy,
                             NodeAffinitySchedulingStrategy,
                             NodeLabelSchedulingStrategy,
                             PlacementGroupSchedulingStrategy,
                             SpreadSchedulingStrategy)

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "cancel", "kill", "get_actor", "method", "exit_actor", "nodes",
    "cluster_resources", "available_resources", "get_runtime_context",
    "ObjectRef", "ObjectRefGenerator", "ActorClass", "ActorHandle",
    "exceptions", "timeline", "__version__",
]


def init(address: Optional[str] = None, *,
         num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         namespace: Optional[str] = None,
         runtime_env: Optional[dict] = None,
         ignore_reinit_error: bool = False,
         log_to_driver: bool = True,
         _system_config: Optional[Dict[str, Any]] = None,
         **kwargs):
    """Start (or connect to) the runtime.

    Reference: ray.init (python/ray/_private/worker.py:1270).  With no
    address this boots an in-process head (local node, scheduler, object
    store).  ``address="auto"``/host:port attaches to a running cluster
    (ray_tpu_torch.core.node, cluster mode).
    """
    if is_initialized():
        if ignore_reinit_error:
            return get_runtime()
        raise RuntimeError(
            "ray_tpu_torch.init() called twice — pass "
            "ignore_reinit_error=True to allow")
    if _system_config:
        GLOBAL_CONFIG.update(_system_config)
    if address not in (None, "local"):
        raise NotImplementedError(
            f"init(address={address!r}): cluster mode is not ported yet "
            "(ROADMAP queue A item 4, cluster sub-slice)")
    return _runtime_mod.init_runtime(
        num_cpus=num_cpus, num_gpus=num_gpus, resources=resources,
        namespace=namespace or "", runtime_env=runtime_env)


def shutdown():
    _runtime_mod.shutdown_runtime()


def _auto_init():
    if not is_initialized():
        _runtime_mod.init_runtime()
    return get_runtime()


def remote(*args, **kwargs):
    """Decorator converting a function into a RemoteFunction or a class
    into an ActorClass (reference: worker.py:3352)."""

    def make(target, options):
        if inspect.isclass(target):
            return ActorClass(target, options)
        if not callable(target):
            raise TypeError(f"@remote target must be callable, got "
                            f"{type(target)}")
        return RemoteFunction(target, options)

    if len(args) == 1 and not kwargs and callable(args[0]):
        return make(args[0], {})
    if args:
        raise TypeError("@remote accepts only keyword options, e.g. "
                        "@remote(num_cpus=2)")
    return lambda target: make(target, kwargs)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    return _auto_init().get(refs, timeout=timeout)


def put(value: Any) -> ObjectRef:
    return _auto_init().put(value)


def wait(refs, *, num_returns: int = 1, timeout: Optional[float] = None,
         fetch_local: bool = True):
    return _auto_init().wait(refs, num_returns=num_returns, timeout=timeout,
                             fetch_local=fetch_local)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    get_runtime().cancel(ref, force=force, recursive=recursive)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    if not isinstance(actor, ActorHandle):
        raise TypeError(f"kill() expects an ActorHandle, got {type(actor)}")
    get_runtime().kill_actor(actor._actor_id, no_restart=no_restart)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    rt = get_runtime()
    ns = namespace if namespace is not None else rt.namespace
    actor_id = rt.actor_manager.get_named(name, ns)
    if actor_id is None:
        if rt.cluster is not None:
            found = rt.cluster.lookup_named_actor(name, ns)
            if found is not None:
                aid_bytes, klass, _node, _addr = found
                return ActorHandle(ActorID(aid_bytes), klass, rt)
        raise ValueError(
            f"no actor named {name!r} in namespace {ns!r}")
    return rt.actor_manager.get_handle(actor_id)


def method(**options):
    """Per-method default options decorator (reference: ray.method)."""

    def decorator(fn):
        fn.__ray_tpu_method_options__ = options
        return fn

    return decorator


def get_runtime_context():
    return get_runtime().runtime_context


def nodes():
    rt = get_runtime()
    if rt.cluster is not None:
        return [{
            "NodeID": n["node_id"], "Alive": n["alive"],
            "Resources": n["total"], "alive": n["alive"],
            "NodeManagerAddress": n["address"],
        } for n in rt.cluster.list_nodes()]
    return [{
        "NodeID": rt.node_id.hex(),
        "Alive": True,
        "Resources": rt.node_resources.total,
        "alive": True,
    }]


def _sum_view(rt, key: str) -> Dict[str, float]:
    """Aggregate over the heartbeat-synced resource view (ray_syncer
    role: no head RPC on the hot path); falls back to one list_nodes
    RPC when the view is stale."""
    view = rt.cluster.resource_view()
    total: Dict[str, float] = {}
    if view is not None:
        for rec in view.values():
            if rec["alive"]:
                for k, v in rec.get(key, {}).items():
                    total[k] = total.get(k, 0) + v
        return total
    for n in rt.cluster.list_nodes():
        if n["alive"]:
            for k, v in n[key].items():
                total[k] = total.get(k, 0) + v
    return total


def cluster_resources() -> Dict[str, float]:
    rt = get_runtime()
    if rt.cluster is not None:
        return _sum_view(rt, "total")
    return rt.node_resources.total


def available_resources() -> Dict[str, float]:
    rt = get_runtime()
    if rt.cluster is not None:
        return _sum_view(rt, "available")
    return rt.node_resources.available()


def timeline(filename: Optional[str] = None):
    """Chrome-trace export of task events (reference: ray.timeline,
    _private/state.py:948).  In cluster mode this is the MERGED
    cluster timeline: every node's shipped events in one trace, one
    pid lane per process, with flow arrows stitching cross-process
    ring edges."""
    raise NotImplementedError(
        "timeline() is not ported yet "
        "(ROADMAP queue A item 4, cluster sub-slice)")

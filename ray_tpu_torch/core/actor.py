"""Actor user API: @remote classes, handles, methods.

Reference semantics: python/ray/actor.py — ActorClass (:602) with
``.remote(...)`` / ``.options(...)``, ActorHandle (:1265) whose attribute
access returns ActorMethod (:116) objects, named/detached actors, and the
``.options(name=..., get_if_exists=True)`` get-or-create pattern.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from .ids import ActorID
from .runtime import get_runtime
from .remote_function import _build_options

_ACTOR_OPTION_KEYS = {
    "name", "namespace", "lifetime", "max_restarts", "max_task_retries",
    "max_concurrency", "max_pending_calls", "num_cpus", "num_gpus",
    "resources", "memory", "scheduling_strategy",
    "get_if_exists", "runtime_env", "_metadata", "isolate",
}


class ActorClass:
    def __init__(self, klass: type, default_options: Dict[str, Any]):
        self._klass = klass
        self._default_options = default_options
        functools.update_wrapper(self, klass, updated=[])

    def remote(self, *args, **kwargs) -> "ActorHandle":
        return self._create(args, kwargs, {})

    def options(self, **overrides) -> "_ActorOptionsHandle":
        unknown = set(overrides) - _ACTOR_OPTION_KEYS
        if unknown:
            raise ValueError(f"unknown actor options: {sorted(unknown)}")
        return _ActorOptionsHandle(self, overrides)

    def bind(self, *args, **kwargs):
        raise NotImplementedError(
            "the DAG API is not ported yet "
            "(ROADMAP queue A item 4, cluster sub-slice)")

    def _create(self, args, kwargs, overrides) -> "ActorHandle":
        merged = dict(self._default_options)
        merged.update(overrides)
        return get_runtime().create_actor(
            self._klass, args, kwargs,
            name=merged.get("name", "") or "",
            namespace=merged.get("namespace"),
            max_restarts=merged.get("max_restarts", 0),
            max_task_retries=merged.get("max_task_retries", 0),
            max_concurrency=merged.get("max_concurrency"),
            max_pending_calls=merged.get("max_pending_calls", -1),
            lifetime=merged.get("lifetime"),
            num_cpus=merged.get("num_cpus"),
            num_gpus=merged.get("num_gpus"),
            resources=merged.get("resources"),
            scheduling_strategy=merged.get("scheduling_strategy"),
            get_if_exists=merged.get("get_if_exists", False),
            isolate=bool(merged.get("isolate", False)),
        )

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._klass.__name__} cannot be instantiated "
            f"directly — use .remote()")

    @property
    def bound_class(self) -> type:
        return self._klass


class _ActorOptionsHandle:
    def __init__(self, actor_class: ActorClass, overrides: Dict[str, Any]):
        self._actor_class = actor_class
        self._overrides = overrides

    def remote(self, *args, **kwargs) -> "ActorHandle":
        return self._actor_class._create(args, kwargs, self._overrides)

    def bind(self, *args, **kwargs):
        raise NotImplementedError(
            "the DAG API is not ported yet "
            "(ROADMAP queue A item 4, cluster sub-slice)")


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 overrides: Optional[Dict[str, Any]] = None):
        self._handle = handle
        self._method_name = method_name
        self._overrides = overrides or {}

    def remote(self, *args, **kwargs):
        # Per-method defaults from @ray_tpu_torch.method(...) sit between the
        # built-in defaults and .options() overrides.
        method = getattr(self._handle._klass, self._method_name, None)
        decorated = getattr(method, "__ray_tpu_method_options__", {})
        options = _build_options({"max_retries": 0, **decorated},
                                 self._overrides)
        return get_runtime().submit_actor_task(
            self._handle._actor_id, self._method_name, args, kwargs,
            options, klass=self._handle._klass)

    def options(self, **overrides) -> "ActorMethod":
        return ActorMethod(self._handle, self._method_name, overrides)

    def bind(self, *args, **kwargs):
        raise NotImplementedError(
            "the DAG API is not ported yet "
            "(ROADMAP queue A item 4, cluster sub-slice)")

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor method {self._method_name} cannot be called directly — "
            f"use .remote()")


class ActorHandle:
    def __init__(self, actor_id: ActorID, klass: type, runtime,
                 creation_ref=None):
        self._actor_id = actor_id
        self._klass = klass
        self._runtime = runtime
        # Holding the creation ref keeps creation errors retrievable.
        self._creation_ref = creation_ref

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        if not callable(getattr(self._klass, name, None)):
            raise AttributeError(
                f"{self._klass.__name__} has no method {name!r}")
        return ActorMethod(self, name)

    def _actor_ready(self, timeout: Optional[float] = None):
        """Block until the constructor finished (raises on failure)."""
        core = self._runtime.actor_manager.get_core(self._actor_id)
        if core is not None:
            core.wait_ready(timeout)
        elif self._runtime.cluster is not None:
            self._runtime.cluster.wait_remote_actor_ready(
                self._actor_id, timeout)

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def __repr__(self):
        return (f"ActorHandle({self._klass.__name__}, "
                f"{self._actor_id.hex()[:16]})")

    def __reduce__(self):
        return (_rebuild_handle, (self._actor_id, self._klass))

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return (isinstance(other, ActorHandle)
                and self._actor_id == other._actor_id)


def _rebuild_handle(actor_id, klass):
    from .runtime import get_runtime

    return ActorHandle(actor_id, klass, get_runtime())


def exit_actor():
    """Terminate the current actor from inside one of its methods
    (reference: ray.actor.exit_actor)."""
    from .actor_runtime import ActorExitSignal
    from . import runtime_context as rc

    ctx = rc.current_task_context()
    if ctx is None or ctx.actor_id is None:
        raise RuntimeError("exit_actor() called outside an actor method")
    raise ActorExitSignal()

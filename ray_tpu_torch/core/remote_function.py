"""@remote functions.

Reference semantics: python/ray/remote_function.py:41,303 — the decorator
wraps a function into a handle whose ``.remote(...)`` submits a task and
returns ObjectRef futures; ``.options(...)`` overrides submission options
per call-site; calling the function directly raises (push users toward
explicit remote/local split).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

from .runtime import get_runtime
from .task_spec import TaskOptions, STREAMING

_OPTION_KEYS = {
    "num_returns", "num_cpus", "num_gpus", "resources",
    "max_retries", "retry_exceptions", "scheduling_strategy", "name",
    "runtime_env", "memory", "_metadata", "concurrency_group",
    "isolate", "deadline_s",
}


def _build_options(defaults: Dict[str, Any],
                   overrides: Dict[str, Any]) -> TaskOptions:
    merged = dict(defaults)
    merged.update(overrides)
    unknown = set(merged) - _OPTION_KEYS
    if unknown:
        raise ValueError(f"unknown options: {sorted(unknown)}")
    resources = dict(merged.get("resources") or {})
    if merged.get("memory"):
        resources["memory"] = float(merged["memory"])
    return TaskOptions(
        num_returns=merged.get("num_returns", 1),
        num_cpus=merged.get("num_cpus"),
        num_gpus=merged.get("num_gpus"),
        resources=resources,
        max_retries=merged.get("max_retries", 3),
        retry_exceptions=merged.get("retry_exceptions", False),
        scheduling_strategy=merged.get("scheduling_strategy"),
        name=merged.get("name", ""),
        runtime_env=merged.get("runtime_env"),
        isolate=bool(merged.get("isolate", False)),
        deadline_s=merged.get("deadline_s"),
        _metadata=merged.get("_metadata") or {},
    )


class RemoteFunction:
    def __init__(self, function: Callable, default_options: Dict[str, Any]):
        self._function = function
        self._default_options = default_options
        functools.update_wrapper(self, function)

    def remote(self, *args, **kwargs):
        return self._submit(args, kwargs, {})

    def options(self, **overrides) -> "_OptionsHandle":
        return _OptionsHandle(self, overrides)

    def _submit(self, args, kwargs, overrides):
        options = _build_options(self._default_options, overrides)
        return get_runtime().submit_task(self._function, args, kwargs,
                                         options)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._function.__name__} cannot be called "
            f"directly — use .remote() (or access the original via "
            f".bound_function)")

    @property
    def bound_function(self) -> Callable:
        return self._function

    def bind(self, *args, **kwargs):
        """DAG-node construction (compiled-graph API; reference
        dag/dag_node.py). Returns a FunctionNode for lazy composition."""
        raise NotImplementedError(
            "the DAG API is not ported yet "
            "(ROADMAP queue A item 4, cluster sub-slice)")


class _OptionsHandle:
    def __init__(self, remote_fn: RemoteFunction, overrides: Dict[str, Any]):
        self._remote_fn = remote_fn
        self._overrides = overrides

    def remote(self, *args, **kwargs):
        return self._remote_fn._submit(args, kwargs, self._overrides)

    def bind(self, *args, **kwargs):
        raise NotImplementedError(
            "the DAG API is not ported yet "
            "(ROADMAP queue A item 4, cluster sub-slice)")

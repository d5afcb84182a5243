"""Task specifications and function descriptors.

Reference semantics: src/ray/common/task/task_spec.h — an immutable
description of one invocation: function descriptor, argument refs/values,
return count, resource demand, retry policy, scheduling strategy, and the
actor it belongs to (if any).  Specs are retained by the owner for lineage
reconstruction (task_manager.h:219).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

from .ids import ActorID, JobID, ObjectID, TaskID


@dataclass(frozen=True)
class FunctionDescriptor:
    module_name: str
    function_name: str
    class_name: str = ""

    @classmethod
    def from_function(cls, fn: Callable) -> "FunctionDescriptor":
        return cls(getattr(fn, "__module__", "") or "",
                   getattr(fn, "__qualname__", repr(fn)))

    @classmethod
    def from_class(cls, klass: type) -> "FunctionDescriptor":
        return cls(getattr(klass, "__module__", "") or "",
                   "__init__", klass.__qualname__)

    def repr_name(self) -> str:
        if self.class_name:
            return f"{self.class_name}.{self.function_name}"
        return self.function_name


# Scheduling strategies (reference: python/ray/util/scheduling_strategies.py)
@dataclass(frozen=True)
class DefaultSchedulingStrategy:
    pass


@dataclass(frozen=True)
class SpreadSchedulingStrategy:
    pass


@dataclass(frozen=True)
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False


@dataclass(frozen=True)
class PlacementGroupSchedulingStrategy:
    placement_group: Any
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass(frozen=True)
class NodeLabelSchedulingStrategy:
    hard: Dict[str, Any] = field(default_factory=dict)
    soft: Dict[str, Any] = field(default_factory=dict)


SchedulingStrategy = Union[
    DefaultSchedulingStrategy, SpreadSchedulingStrategy,
    NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy,
    NodeLabelSchedulingStrategy, str, None,
]


def normalize_strategy(strategy: SchedulingStrategy) -> SchedulingStrategy:
    """Map the string spellings the reference API accepts
    ("SPREAD"/"DEFAULT", util/scheduling_strategies.py) onto the
    dataclass forms the dispatchers match on."""
    if isinstance(strategy, str):
        name = strategy.upper()
        if name == "SPREAD":
            return SpreadSchedulingStrategy()
        if name == "DEFAULT":
            return None
        raise ValueError(
            f"unknown scheduling_strategy string {strategy!r} "
            "(expected 'DEFAULT' or 'SPREAD')")
    return strategy

STREAMING = "streaming"


@dataclass
class TaskOptions:
    """Resolved ``.options(...)`` for one submission (remote_function.py)."""

    num_returns: Union[int, str] = 1
    num_cpus: Optional[float] = None
    num_gpus: Optional[float] = None
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: int = 3
    retry_exceptions: Union[bool, Sequence[type]] = False
    scheduling_strategy: SchedulingStrategy = None
    name: str = ""
    runtime_env: Optional[dict] = None
    # Run in a pooled worker subprocess (N8 process isolation) instead
    # of inline in the node process.
    isolate: bool = False
    # End-to-end budget in seconds (core/deadlines.py): resolved to an
    # ABSOLUTE deadline at submission; None inherits the submitter's
    # ambient deadline.
    deadline_s: Optional[float] = None
    _metadata: Dict[str, Any] = field(default_factory=dict)

    def resource_demand(self, default_cpus: float = 1.0) -> Dict[str, float]:
        demand = dict(self.resources)
        cpus = self.num_cpus if self.num_cpus is not None else default_cpus
        if cpus:
            demand["CPU"] = cpus
        if self.num_gpus:
            demand["GPU"] = self.num_gpus
        return demand


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    function: Optional[Callable]
    descriptor: FunctionDescriptor
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    num_returns: Union[int, str]
    resources: Dict[str, float]
    max_retries: int
    retry_exceptions: Union[bool, Sequence[type]]
    scheduling_strategy: SchedulingStrategy = None
    name: str = ""
    # Actor linkage
    actor_id: Optional[ActorID] = None
    is_actor_creation: bool = False
    is_actor_task: bool = False
    concurrency_group: str = ""
    # Process isolation (N8): execute in a pooled subprocess.
    isolate: bool = False
    # Ownership / lineage
    parent_task_id: Optional[TaskID] = None
    attempt_number: int = 0
    return_ids: Tuple[ObjectID, ...] = ()
    # Trace propagation (observability/tracing.py): the submitter's
    # trace id + span, carried with the spec across process hops so the
    # span this execution records attaches to the right trace.
    trace_id: Optional[str] = None
    parent_span_id: Optional[str] = None
    # Absolute end-to-end deadline (epoch seconds, core/deadlines.py):
    # carried next to the trace id across every hop; dequeue points
    # shed the spec with DeadlineExceededError once it passes.
    deadline: Optional[float] = None
    # Cluster: nodes that already failed this task (spillback exclusion,
    # reference: normal_task_submitter.cc:455 retry_at_raylet_address).
    _excluded_nodes: Tuple[str, ...] = ()

    def exclude_node(self, node_id: str):
        if node_id not in self._excluded_nodes:
            self._excluded_nodes = self._excluded_nodes + (node_id,)

    def trace_ctx(self) -> Optional[Tuple[str, Optional[str]]]:
        """(trace_id, parent_span_id) for wire propagation, or None."""
        if self.trace_id is None:
            return None
        return (self.trace_id, self.parent_span_id)

    def excluded_nodes(self) -> Tuple[str, ...]:
        return self._excluded_nodes

    def repr_name(self) -> str:
        return self.name or self.descriptor.repr_name()

    def should_retry(self, error: BaseException) -> bool:
        if self.attempt_number >= self.max_retries:
            return False
        # Application errors retry only if retry_exceptions allows
        # (reference: max_retries counts system failures by default;
        # retry_exceptions=True/[...] opts user exceptions in).
        from ..exceptions import (ActorDiedError, NodeDiedError,
                                  OutOfMemoryError, TaskError,
                                  WorkerCrashedError)

        # Unwrap TaskError: execute_task_inline wraps in-task raises,
        # so a WorkerCrashedError from the isolated pool arrives as
        # TaskError(cause=WorkerCrashedError).
        unwrapped = error.cause if isinstance(error, TaskError) else error
        system_failure = isinstance(
            unwrapped, (NodeDiedError, OutOfMemoryError,
                        WorkerCrashedError)) or (
            # An actor dying with its node is a system failure for the
            # CALL; the budget (max_retries = the actor's
            # max_task_retries) gates how many such deaths a call may
            # survive (reference: actor_task_submitter.h:75).
            self.is_actor_task and isinstance(
                unwrapped, ActorDiedError))
        if system_failure:
            return True
        if self.retry_exceptions is True:
            return True
        if self.retry_exceptions:
            cause = error.cause if isinstance(error, TaskError) else error
            return isinstance(cause, tuple(self.retry_exceptions))
        return False

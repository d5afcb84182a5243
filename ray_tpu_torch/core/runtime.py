"""The single-controller runtime: init/shutdown, task submission, execution.

Reference semantics: this file plays the role of CoreWorker
(src/ray/core_worker/core_worker.h:162) + the driver-side of worker.py —
it owns the object store view, reference counter, task manager, local
scheduler, and actor manager, and it executes user code (the in-process
analogue of the task-execution callback, _raylet.pyx:2244).

Architecture note: the runtime is deliberately single-controller per
process.  Distributed execution attaches node backends (cluster mode)
underneath the same submission API; compute *inside* a task is torch's
and the port's CUDA kernels' job, not the runtime's — the runtime
orchestrates processes and objects, and schedules the card as the
``GPU`` resource.
"""

from __future__ import annotations

import atexit
import inspect
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from . import deadlines as _deadlines
from . import runtime_context as rc_mod
from .actor_runtime import (ActorExitSignal, ActorInfo, ActorManager,
                            ActorState)
from .config import GLOBAL_CONFIG
from .ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from .object_ref import ObjectRef, ObjectRefGenerator
from .object_store import MemoryStore, RayObject, wait_refs
from .reference_count import ReferenceCounter
from .resources import ResourceSet, detect_node_resources
from .runtime_context import RuntimeContext, TaskContext
from .scheduler import LocalScheduler
from .streaming import StreamingGeneratorManager
from .task_manager import TaskManager
from .task_spec import (STREAMING, FunctionDescriptor, TaskOptions,
                        TaskSpec, normalize_strategy)
from ..exceptions import (ActorError, BackPressureError, ChannelError,
                          DeadlineExceededError, ObjectLostError,
                          TaskCancelledError, TaskError)
from ..observability import tracing as _tracing

# System fault-tolerance errors surface TYPED at the driver (reference:
# RayActorError/ObjectLostError are not buried inside RayTaskError) —
# a compiled-DAG pass that dies to a peer failure must be catchable as
# ActorDiedError, not as a generic task wrapper.  The overload plane's
# errors belong here too: a @serve.batch rejection/shed raised inside
# replica user code must reach the router/proxies typed (route
# elsewhere, 503 + Retry-After), not as a generic TaskError.
_FT_ERRORS = (TaskError, ActorError, ObjectLostError, ChannelError,
              BackPressureError, DeadlineExceededError)

_global_lock = threading.Lock()
_global_runtime: Optional["Runtime"] = None

# Per-execution structured log records ride this logger's level gate
# (observability/logs.py stamps + ships them).
_task_logger = logging.getLogger("ray_tpu.task")


class Runtime:
    def __init__(self, *, num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 namespace: str = "", runtime_env: Optional[dict] = None,
                 job_id: Optional[JobID] = None):
        self.job_id = job_id or JobID.from_int(1)
        self.node_id = NodeID.from_random()
        self.worker_id = WorkerID.from_random()
        self.namespace = namespace or "default"
        self.runtime_env = runtime_env
        self.is_shutdown = False
        # Guards the exactly-once actor-resource release across the
        # kill / failed-creation / acquire-thread paths.
        self._resource_release_lock = threading.Lock()
        self.start_time = time.time()

        self.object_store = MemoryStore()
        # Node-level object plane: primary copies of task returns pinned
        # for remote owners + spill-past-capacity (core/plasma.py).
        from .plasma import LocalObjectStore

        self.plasma = LocalObjectStore()
        self.reference_counter = ReferenceCounter(
            on_object_out_of_scope=self._free_object)
        # Single-flight lineage recovery per creating task
        # (object_recovery_manager.h:41).
        self._recovery_lock = threading.Lock()
        self._recovering: Dict[TaskID, threading.Event] = {}
        # Single-flight pulls of located objects (one chunked pull per
        # object regardless of concurrent getters).
        self._materializing: Dict[ObjectID, threading.Event] = {}
        self.streaming_manager = StreamingGeneratorManager()
        self.task_manager = TaskManager(self)
        self.node_resources = ResourceSet(
            detect_node_resources(num_cpus, num_gpus, resources))
        self.scheduler = LocalScheduler(
            self.node_resources,
            execute_fn=self.execute_task_inline,
            on_cancelled=self._on_task_cancelled,
            object_store=self.object_store)
        self.actor_manager = ActorManager(self)
        self.runtime_context = RuntimeContext(self)
        # Structured log plane (observability/logs.py): every process
        # running a Runtime stamps its log records with trace/task
        # identity; cluster mode ships them on the EventShipper rails.
        from ..observability import logs as _logs_mod

        _logs_mod.install()
        # Device-plane telemetry (observability/device.py): a sampler
        # thread that idles until this process initialises CUDA, then
        # sets the device-memory gauges.
        from ..observability import device as _device_mod

        _device_mod.install()
        # Flight recorder (observability/flightrec.py): crash-safe
        # on-disk ring of recent spans/logs/gauges plus faulthandler
        # stacks, so a kill -9'd process still leaves forensics its
        # supervisor can ship into a postmortem bundle.
        from ..observability import flightrec as _flightrec_mod

        _flightrec_mod.install()

        self._driver_task_id = TaskID.for_driver(self.job_id)
        self._put_counters: Dict[TaskID, int] = {}
        self._put_lock = threading.Lock()
        self._pg_counter = 0
        # Cluster attachment (ray_tpu_torch.cluster.client.ClusterClient);
        # None = single-process mode.
        self.cluster = None
        # Isolated worker pool (N8): created on first isolate=True use.
        self._isolated_pool = None
        self._isolated_pool_lock = threading.Lock()

    @property
    def isolated_pool(self):
        raise NotImplementedError(
            "isolate=True is not ported yet "
            "(ROADMAP queue A item 4, cluster sub-slice)")

    @property
    def address(self) -> str:
        """This node's object-service address ("" in local mode)."""
        return self.cluster.address if self.cluster is not None else ""

    def attach_cluster(self, head_address: str, node_name: str = "",
                       labels: Optional[Dict[str, str]] = None):
        raise NotImplementedError(
            "cluster mode is not ported yet "
            "(ROADMAP queue A item 4, cluster sub-slice)")

    # ------------------------------------------------------------------ ids
    def current_task_id(self) -> TaskID:
        ctx = rc_mod.current_task_context()
        return ctx.task_id if ctx else self._driver_task_id

    def _next_put_id(self) -> ObjectID:
        task_id = self.current_task_id()
        with self._put_lock:
            idx = self._put_counters.get(task_id, 0)
            self._put_counters[task_id] = idx + 1
        return ObjectID.for_put(task_id, idx)

    def _free_object(self, oid: ObjectID):
        """Out-of-scope hook: free the local copy; if it was borrowed
        from another node, release our hold with the owner; if its
        primary copy is pinned on a remote holder, free it there."""
        self.object_store.free(oid)
        if self.cluster is not None:
            self.cluster.release_borrowed(oid)
            self.cluster.free_primary_of(oid)

    def register_object_location(self, oid: ObjectID, node_id: str,
                                 address: str) -> None:
        """Owner-side object directory entry for a primary copy pinned
        on ``node_id`` (ownership_based_object_directory.h)."""
        if self.cluster is not None:
            self.cluster.register_location(oid, node_id, address)

    # ------------------------------------------------------------- objects
    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("put() of an ObjectRef is not allowed "
                            "(matches reference semantics)")
        oid = self._next_put_id()
        self.reference_counter.add_owned_object(oid)
        self.object_store.put(
            oid, RayObject(value=value))
        return ObjectRef(oid, self)

    def get(self, refs: Union[ObjectRef, Sequence[ObjectRef]],
            timeout: Optional[float] = None):
        single = isinstance(refs, (ObjectRef, ObjectRefGenerator))
        if single:
            ref_list = [refs]
        else:
            try:
                ref_list = list(refs)
            except TypeError:
                raise TypeError(
                    f"get() expects an ObjectRef or a list of ObjectRefs, "
                    f"got {type(refs).__name__}")
        # An ambient end-to-end deadline (a task executing under one, a
        # serve request scope) bounds the wait even when the caller
        # passed no timeout: get() must not outwait the request budget.
        ambient = _deadlines.current()
        if ambient is not None:
            left = ambient - time.time()
            if left <= 0:
                from ..exceptions import DeadlineExceededError

                raise DeadlineExceededError(
                    "get(): request deadline already exceeded",
                    deadline=ambient)
            if timeout is None or timeout > left:
                timeout = left
        deadline = None if timeout is None else time.monotonic() + timeout
        values = []
        for ref in ref_list:
            if isinstance(ref, ObjectRefGenerator):
                raise TypeError(
                    "get() on a streaming generator — iterate it instead")
            if not isinstance(ref, ObjectRef):
                raise TypeError(f"get() expects ObjectRefs, got {type(ref)}")
            if self.cluster is not None:
                # Borrowed ref owned by another node: pull + cache a
                # local immutable copy before waiting.
                self.cluster.ensure_local(ref)
            t = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            try:
                obj = self.object_store.wait_and_get(ref.object_id(), t)
                if obj.is_located_only():
                    obj = self._materialize_located(ref.object_id(),
                                                    deadline)
            except TimeoutError:
                if not _deadlines.expired(ambient):
                    raise
                from ..exceptions import DeadlineExceededError

                # The request budget, not the caller's timeout, was the
                # binding constraint: surface it typed.
                raise DeadlineExceededError(
                    "get(): request deadline exceeded while waiting",
                    deadline=ambient) from None
            if obj.is_error():
                raise obj.error
            values.append(obj.value)
        return values[0] if single else values

    def _materialize_located(self, oid: ObjectID,
                             deadline: Optional[float] = None):
        """Pull a located object's primary copy into the local store;
        on holder death, reconstruct it from lineage and retry
        (object_recovery_manager.h:41).  Single-flight per object: the
        first caller pulls, concurrent getters wait on its result.  The
        caller's deadline bounds every phase (pull, recovery)."""
        def remaining(default: float) -> float:
            if deadline is None:
                return default
            left = deadline - time.monotonic()
            if left <= 0:
                from ..exceptions import GetTimeoutError

                raise GetTimeoutError(
                    f"get() timed out materializing {oid!r}")
            return min(left, default)

        attempts = 0
        while True:
            obj = self.object_store.wait_and_get(oid, remaining(3600.0))
            if not obj.is_located_only():
                return obj
            with self._recovery_lock:
                ev = self._materializing.get(oid)
                mine = ev is None
                if mine:
                    ev = self._materializing[oid] = threading.Event()
            if not mine:
                ev.wait(remaining(300.0))
                continue  # loser re-reads the store
            try:
                node_id, address = obj.location
                try:
                    sealed = self.cluster.pull_sealed(
                        oid, address, timeout=remaining(300.0))
                    self.object_store.materialize(oid, sealed)
                except (ConnectionError, TimeoutError):
                    attempts += 1
                    self.cluster._report_node_failure(node_id, address)
                    if attempts > 3:
                        from ..exceptions import ObjectLostError

                        self.object_store.invalidate_for_recovery(oid)
                        self.object_store.put(oid, RayObject(
                            error=ObjectLostError(
                                reason=f"{oid!r}: holder unreachable "
                                       f"and recovery kept failing")))
                        continue
                    self.recover_object(oid, dead_node=node_id,
                                        timeout=remaining(300.0))
            finally:
                with self._recovery_lock:
                    self._materializing.pop(oid, None)
                ev.set()

    def recover_object(self, oid: ObjectID, dead_node: Optional[str] = None,
                       timeout: float = 300.0) -> bool:
        """Owner-side lineage reconstruction: re-execute the pinned
        creating task so a lost return is re-sealed (reference:
        object_recovery_manager.h:41 + lineage pinning
        task_manager.h:219-240; tested upstream by
        python/ray/tests/test_reconstruction.py).

        Missing *arguments* of the re-run recover recursively: the
        executing node's fetch fails against the dead holder, reports
        the loss here, and this method runs again for the argument.
        Actor-task outputs are not reconstructable (function is None) —
        they seal ObjectLostError, matching the default reference
        behavior for non-retryable lineage.  Returns True if the object
        is usable (sealed, relocated, or in flight) after the call."""
        from ..exceptions import ObjectLostError

        store = self.object_store
        tid = oid.task_id()
        with self._recovery_lock:
            existing = self._recovering.get(tid)
            mine = existing is None
            ev = existing if existing is not None else threading.Event()
            if mine:
                self._recovering[tid] = ev
        if not mine:
            ev.wait(timeout)
        else:
            try:
                obj = store.get_if_exists(oid)
                if obj is not None and (obj.sealed is not None
                                        or obj.is_error()):
                    pass  # already usable / already failed
                elif self.task_manager.is_pending(tid):
                    pass  # creating task in flight; wait below
                else:
                    spec = self.task_manager.take_lineage_for_recovery(tid)
                    recoverable = (
                        spec is not None and spec.function is not None
                        and spec.max_retries != 0)
                    if not recoverable:
                        if spec is not None:
                            # Stale location records must clear or the
                            # error seal below is a no-op (the store
                            # keeps the first entry).
                            for rid in spec.return_ids:
                                e = store.get_if_exists(rid)
                                if e is not None and e.is_located_only():
                                    store.invalidate_for_recovery(rid)
                                    if self.cluster is not None:
                                        self.cluster.drop_location(rid)
                            self.task_manager.reregister_for_recovery(spec)
                            self.task_manager.complete_error(
                                spec, ObjectLostError(
                                    reason=f"{oid!r} lost and its "
                                    "creating task is not retriable"),
                                allow_retry=False)
                        else:
                            store.invalidate_for_recovery(oid)
                            store.put(oid, RayObject(error=ObjectLostError(
                                reason=f"{oid!r} lost with no pinned "
                                       f"lineage (owner restarted or "
                                       f"lineage released)")))
                    else:
                        if dead_node:
                            spec.exclude_node(dead_node)
                        spec.attempt_number += 1
                        for rid in spec.return_ids:
                            e = store.get_if_exists(rid)
                            if e is not None and e.is_located_only():
                                store.invalidate_for_recovery(rid)
                                if self.cluster is not None:
                                    self.cluster.drop_location(rid)
                        self.task_manager.reregister_for_recovery(spec)
                        self._dispatch(spec)
            finally:
                with self._recovery_lock:
                    self._recovering.pop(tid, None)
                ev.set()
        try:
            obj = store.wait_and_get(oid, timeout)
        except Exception:  # raylint: disable=ft-exception-swallow -- recovery verdict is boolean; the object itself carries the typed error and re-raises at get()
            return False
        return not obj.is_error()

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        if not isinstance(refs, list):
            raise TypeError("wait() expects a list of ObjectRefs")
        if len(set(r.object_id() for r in refs)) != len(refs):
            raise ValueError("wait() got duplicate ObjectRefs")
        if num_returns <= 0 or num_returns > len(refs):
            raise ValueError(f"num_returns must be in [1, {len(refs)}]")
        by_id = {r.object_id(): r for r in refs}
        ready_ids, not_ready_ids = wait_refs(
            self.object_store, [r.object_id() for r in refs], num_returns,
            timeout)
        return ([by_id[i] for i in ready_ids],
                [by_id[i] for i in not_ready_ids])

    # --------------------------------------------------------------- tasks
    def make_task_spec(self, function, args, kwargs,
                       options: TaskOptions) -> TaskSpec:
        parent = self.current_task_id()
        task_id = TaskID.for_task(ActorID.nil_for_job(self.job_id))
        n = options.num_returns
        if n == STREAMING:
            return_ids = (ObjectID.for_return(task_id, 0),)
        else:
            return_ids = tuple(
                ObjectID.for_return(task_id, i) for i in range(int(n)))
        # Trace propagation: inherit the active trace (a parent task or
        # a driver-side scope) or mint a root trace — each bare driver
        # submission is its own root operation.
        trace_id, parent_span = _tracing.for_submission()
        return TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            function=function,
            descriptor=FunctionDescriptor.from_function(function),
            args=tuple(args),
            kwargs=dict(kwargs),
            num_returns=n,
            resources=options.resource_demand(),
            max_retries=options.max_retries,
            retry_exceptions=options.retry_exceptions,
            scheduling_strategy=normalize_strategy(
                options.scheduling_strategy),
            name=options.name,
            isolate=options.isolate,
            parent_task_id=parent,
            return_ids=return_ids,
            trace_id=trace_id,
            parent_span_id=parent_span,
            deadline=_deadlines.for_submission(options.deadline_s),
        )

    def submit_task(self, function, args, kwargs, options: TaskOptions,
                    local_only: bool = False):
        """``local_only``: run on this node's scheduler unconditionally —
        used by the node server for tasks PUSHED here by a peer's
        placement decision, which must not re-enter cluster routing
        (a pushed hard-affinity task re-spilled elsewhere would violate
        its placement; a spill bounce could ping-pong)."""
        spec = self.make_task_spec(function, args, kwargs, options)
        self._apply_pg_strategy(spec)
        self._register_and_submit(spec, local_only=local_only)
        return self._refs_for(spec)

    def resubmit_task(self, spec: TaskSpec):
        delay_ms = GLOBAL_CONFIG.task_retry_delay_ms()
        if delay_ms:
            timer = threading.Timer(delay_ms / 1000.0,
                                    lambda: self._do_resubmit(spec))
            timer.daemon = True
            timer.start()
        else:
            self._do_resubmit(spec)

    def _do_resubmit(self, spec: TaskSpec):
        """Retries route actor tasks back to the actor core; only plain
        tasks go to the task scheduler."""
        if spec.is_actor_task and spec.actor_id is not None:
            from ..exceptions import ActorDiedError

            core = self.actor_manager.get_core(spec.actor_id)
            if core is None and self.cluster is not None:
                # Remote actor: wait out a head-driven restart and push
                # to the new location.  The wait can take seconds, so
                # it runs off the completion path.
                threading.Thread(
                    target=self.cluster.resubmit_actor_task,
                    args=(spec,), daemon=True).start()
                return
            if core is None or core.info.state == ActorState.DEAD:
                self.task_manager.complete_error(
                    spec, ActorDiedError(spec.actor_id, "actor is dead"),
                    allow_retry=False)
                return
            try:
                core.submit(spec, bypass_limit=True)
            except Exception as e:
                self.task_manager.complete_error(spec, e, allow_retry=False)
        else:
            self._dispatch(spec)

    def _register_and_submit(self, spec: TaskSpec,
                             local_only: bool = False):
        self.task_manager.register_pending(spec)
        arg_ids = [a.object_id() for a in spec.args
                   if isinstance(a, ObjectRef)]
        arg_ids += [v.object_id() for v in spec.kwargs.values()
                    if isinstance(v, ObjectRef)]
        self.reference_counter.add_submitted_task_references(arg_ids)
        if spec.num_returns == STREAMING:
            self.streaming_manager.create_stream(spec.return_ids[0])
        if local_only:
            self.scheduler.submit(spec)
        else:
            self._dispatch(spec)

    def _dispatch(self, spec: TaskSpec):
        """Route a plain task (reference hybrid policy: prefer local
        until packed, then spill — cluster_task_manager.cc:159, policies
        under raylet/scheduling/policy/).

        - No cluster → local scheduler.  Streaming tasks route like any
          other: a remote executor reports items back per-item
          (stream_item RPC, task_manager.h:301 analogue).
        - Spread / NodeAffinity / NodeLabel strategies → cluster
          placement (the head implements the policy; affinity to this
          node comes straight back to us).
        - Default: local when it can run here now; a task this node
          could never fit goes to the head unconditionally; a task that
          fits here *eventually* is first offered to a peer with
          current headroom and queues locally only if none has any.
        """
        from .task_spec import (NodeAffinitySchedulingStrategy,
                                NodeLabelSchedulingStrategy,
                                SpreadSchedulingStrategy)

        if self.cluster is None:
            self.scheduler.submit(spec)
            return
        strat = spec.scheduling_strategy
        if (isinstance(strat, NodeAffinitySchedulingStrategy)
                and strat.node_id == self.node_id.hex()
                and self.node_resources.can_ever_fit(spec.resources)):
            self.scheduler.submit(spec)
            return
        if isinstance(strat, (SpreadSchedulingStrategy,
                              NodeAffinitySchedulingStrategy,
                              NodeLabelSchedulingStrategy)):
            self.cluster.submit_remote_task(spec)
            return
        if not self.node_resources.can_ever_fit(spec.resources):
            self.cluster.submit_remote_task(spec)
            return
        # Saturated = no free resources now OR a backlog already queued
        # (fits_now alone misses a submission burst whose tasks haven't
        # been picked up by the dispatch thread yet).
        saturated = (not self.node_resources.fits_now(spec.resources)
                     or self.scheduler.backlog() > 0)
        if saturated and self.cluster.try_spill_task(spec):
            return
        self.scheduler.submit(spec)

    def _refs_for(self, spec: TaskSpec):
        if spec.num_returns == STREAMING:
            return ObjectRefGenerator(spec.return_ids[0], self)
        refs = [ObjectRef(oid, self, call_site=spec.repr_name())
                for oid in spec.return_ids]
        if spec.num_returns == 0:
            return None
        if spec.num_returns == 1:
            return refs[0]
        return refs

    def _apply_pg_strategy(self, spec: TaskSpec):
        """Rewrite resource demand onto placement-group synthetic
        resources (reference A.13: CPU_group_<pgid> resources)."""
        from ..util.placement_group import PlacementGroupSchedulingStrategy

        strat = spec.scheduling_strategy
        if not isinstance(strat, PlacementGroupSchedulingStrategy):
            return
        pg = strat.placement_group
        spec.resources = pg.wrap_resources(
            spec.resources, strat.placement_group_bundle_index)

    # ----------------------------------------------------------- execution
    def _resolve_args(self, spec: TaskSpec):
        """Top-level ObjectRef substitution; returns (args, kwargs, error)."""
        error = None

        def resolve(v):
            nonlocal error
            if isinstance(v, ObjectRef):
                obj = self.object_store.get_if_exists(v.object_id())
                if obj is None:
                    # Actor tasks dispatch FIFO with no scheduler
                    # dep-gating (submit_actor_task → core.submit), so a
                    # ref produced by a concurrently-running task may
                    # not be local yet: fetch remote-owned args, wait
                    # out locally-produced ones (reference: actor tasks
                    # execute in submission order with args resolved at
                    # dispatch, dependency_manager.h:49).
                    try:
                        if self.cluster is not None:
                            self.cluster.ensure_local(v)
                        obj = self.object_store.wait_and_get(
                            v.object_id(), timeout=600.0)
                    except Exception as e:  # noqa: BLE001
                        if error is None:
                            error = TaskError(
                                spec.repr_name(),
                                RuntimeError(
                                    f"dependency {v!r} unresolvable at "
                                    f"dispatch: {e!r}"))
                        return None
                if obj.is_located_only():
                    obj = self._materialize_located(v.object_id())
                if obj.is_error() and error is None:
                    error = obj.error
                    return None
                return obj.value
            return v

        args = tuple(resolve(a) for a in spec.args)
        kwargs = {k: resolve(v) for k, v in spec.kwargs.items()}
        return args, kwargs, error

    def _release_arg_refs(self, spec: TaskSpec):
        arg_ids = [a.object_id() for a in spec.args
                   if isinstance(a, ObjectRef)]
        arg_ids += [v.object_id() for v in spec.kwargs.values()
                    if isinstance(v, ObjectRef)]
        self.reference_counter.remove_submitted_task_references(arg_ids)

    def _lookup_callable(self, spec: TaskSpec, bound_instance):
        if bound_instance is not None and spec.is_actor_task:
            # Channel-transport trampoline (experimental.channel
            # CHANNEL_STEP_METHOD): resolves the edge's ring endpoints
            # inside this actor, runs the real method, tees the result
            # into the writer rings.
            if spec.descriptor.function_name == "__rt_channel_step__":
                from ..experimental.channel import bind_channel_step

                return bind_channel_step(bound_instance)
            return getattr(bound_instance, spec.descriptor.function_name)
        return spec.function

    def shed_expired_spec(self, spec: TaskSpec, where: str) -> bool:
        """Load shedding at a dequeue point: a spec whose end-to-end
        deadline already passed is completed with a typed
        ``DeadlineExceededError`` WITHOUT running user code (Tail at
        Scale: expired work only adds queueing delay for live work).
        Returns True when the spec was shed."""
        if spec.deadline is None or time.time() < spec.deadline:
            return False
        from ..exceptions import DeadlineExceededError
        from ..observability.metrics import overload_counters

        overload_counters()["expired_shed"].inc(tags={"where": where})
        self.task_manager.complete_error(
            spec, DeadlineExceededError(
                f"task {spec.repr_name()} shed at {where}: "
                f"deadline exceeded",
                deadline=spec.deadline,
                context={"where": where,
                         "late_by_s": round(
                             time.time() - spec.deadline, 4)}),
            allow_retry=False)
        return True

    def execute_task_inline(self, spec: TaskSpec, bound_instance=None,
                            actor_core=None):
        if self.shed_expired_spec(spec, "dispatch"):
            return
        args, kwargs, dep_error = self._resolve_args(spec)
        if dep_error is not None:
            # Dependency failed: propagate its error to our outputs
            # without retrying (matches owner failure propagation).
            self.task_manager.complete_error(spec, dep_error,
                                             allow_retry=False)
            return
        span_id = _tracing.new_span_id()
        ctx = TaskContext(spec.task_id, spec.repr_name(),
                          actor_id=spec.actor_id,
                          attempt_number=spec.attempt_number,
                          parent_task_id=spec.parent_task_id,
                          trace_id=spec.trace_id, span_id=span_id,
                          deadline=spec.deadline)
        rc_mod.set_task_context(ctx)
        # This task's span becomes the parent of everything it submits;
        # its remaining deadline budget bounds everything it awaits.
        prev_trace = _tracing.set_current(
            (spec.trace_id, span_id) if spec.trace_id else None)
        prev_deadline = _deadlines.set_current(spec.deadline)
        t_start = time.time()
        outcome = "ok"
        try:
            fn = self._lookup_callable(spec, bound_instance)
            if spec.isolate and not spec.is_actor_task:
                if spec.num_returns == STREAMING:
                    raise ValueError(
                        "isolate=True does not support streaming "
                        "generators (results cross a process boundary "
                        "as one reply)")
                result = self.isolated_pool.run(
                    fn, args, kwargs,
                    retriable=spec.attempt_number < spec.max_retries)
            else:
                result = fn(*args, **kwargs)
            if spec.num_returns == STREAMING:
                self._consume_stream(spec, result)
            else:
                self.task_manager.complete_success(spec, result)
        except ActorExitSignal:
            self.task_manager.complete_success(spec, None)
            if actor_core is not None:
                self.kill_actor(spec.actor_id, no_restart=True)
        except TaskCancelledError as e:
            outcome = "cancelled"
            self.task_manager.complete_error(spec, e, allow_retry=False)
        except BaseException as e:  # noqa: BLE001
            outcome = "error"
            err = e if isinstance(e, _FT_ERRORS) else TaskError(
                spec.repr_name(), e)
            self.task_manager.complete_error(spec, err)
        finally:
            rc_mod.set_task_context(None)
            _tracing.set_current(prev_trace)
            _deadlines.set_current(prev_deadline)
            self._record_task_event(spec, t_start, outcome,
                                    span_id=span_id)

    async def execute_task_inline_async(self, spec: TaskSpec,
                                        bound_instance=None,
                                        actor_core=None):
        import asyncio

        if self.shed_expired_spec(spec, "dispatch"):
            return
        # _resolve_args may block waiting for a not-yet-local dep; on
        # the async actor's event loop that would freeze the coroutines
        # producing it — offload the wait to a worker thread.
        args, kwargs, dep_error = await asyncio.get_event_loop() \
            .run_in_executor(None, self._resolve_args, spec)
        if dep_error is not None:
            self.task_manager.complete_error(spec, dep_error,
                                             allow_retry=False)
            return
        span_id = _tracing.new_span_id()
        ctx = TaskContext(spec.task_id, spec.repr_name(),
                          actor_id=spec.actor_id,
                          attempt_number=spec.attempt_number,
                          trace_id=spec.trace_id, span_id=span_id,
                          deadline=spec.deadline)
        rc_mod.set_task_context(ctx)
        prev_trace = _tracing.set_current(
            (spec.trace_id, span_id) if spec.trace_id else None)
        prev_deadline = _deadlines.set_current(spec.deadline)
        t_start = time.time()
        outcome = "ok"
        try:
            fn = self._lookup_callable(spec, bound_instance)
            result = fn(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = await result
            if spec.num_returns == STREAMING:
                if inspect.isasyncgen(result):
                    await self._consume_stream_async(spec, result)
                else:
                    self._consume_stream(spec, result)
            else:
                self.task_manager.complete_success(spec, result)
        except ActorExitSignal:
            self.task_manager.complete_success(spec, None)
            if actor_core is not None:
                self.kill_actor(spec.actor_id, no_restart=True)
        except TaskCancelledError as e:
            outcome = "cancelled"
            self.task_manager.complete_error(spec, e, allow_retry=False)
        except BaseException as e:  # noqa: BLE001
            outcome = "error"
            err = e if isinstance(e, _FT_ERRORS) else TaskError(
                spec.repr_name(), e)
            self.task_manager.complete_error(spec, err)
        finally:
            rc_mod.set_task_context(None)
            _tracing.set_current(prev_trace)
            _deadlines.set_current(prev_deadline)
            self._record_task_event(spec, t_start, outcome,
                                    span_id=span_id)

    def _record_task_event(self, spec: TaskSpec, t_start: float,
                           outcome: str, span_id: Optional[str] = None):
        """Timeline span + counters for one executed task (reference:
        TaskEventBuffer, task_event_buffer.h:220 → ray.timeline)."""
        from ..observability import logs as _logs
        from ..observability import metrics as _metrics
        from ..observability.timeline import record_span

        t_end = time.time()
        kind = ("actor_creation" if spec.is_actor_creation
                else "actor_task" if spec.is_actor_task else "task")
        # One structured log record per execution (the task context was
        # already torn down in the caller's finally, so identity fields
        # are stamped explicitly — the handler's ambient lookup would
        # come up empty).  Gated on the ray_tpu_torch.task logger level so
        # RAY_TPU_LOG_LEVEL=WARNING silences it.
        if _logs.enabled() and _task_logger.isEnabledFor(logging.INFO):
            rec = {"level": "INFO", "levelno": logging.INFO,
                   "logger": "ray_tpu.task",
                   "msg": f"{kind} {spec.repr_name()} {outcome} "
                          f"in {(t_end - t_start) * 1e3:.1f}ms",
                   "thread": threading.current_thread().name,
                   "task": spec.repr_name()}
            if spec.trace_id is not None:
                rec["trace_id"] = spec.trace_id
                if span_id is not None:
                    rec["span_id"] = span_id
            if spec.actor_id is not None:
                rec["actor"] = spec.actor_id.hex()
            _logs.emit_record(rec)
        args = {"task_id": spec.task_id.hex(), "kind": kind,
                "outcome": outcome,
                "attempt": spec.attempt_number}
        if spec.trace_id is not None:
            args["trace_id"] = spec.trace_id
            args["span_id"] = span_id or _tracing.new_span_id()
            if spec.parent_span_id:
                args["parent_span_id"] = spec.parent_span_id
        record_span(
            spec.repr_name(), t_start, t_end,
            pid=f"node:{self.node_id.hex()[:8]}",
            tid=threading.current_thread().name,
            args=args)
        counters = _metrics.runtime_counters()
        tags = {"kind": kind}
        if outcome == "ok":
            counters["tasks_finished"].inc(tags=tags)
        else:
            counters["tasks_failed"].inc(tags=tags)
        counters["task_seconds"].observe(t_end - t_start, tags=tags)

    def _seal_stream_item(self, spec: TaskSpec, index: int, item):
        item_id = ObjectID.for_return(spec.task_id, index + 1)
        self.reference_counter.add_owned_object(item_id)
        self.object_store.put(
            item_id, RayObject(value=item))
        self.streaming_manager.report_item(spec.return_ids[0], item_id)

    async def _consume_stream_async(self, spec: TaskSpec, agen):
        # Mirrors _consume_stream: mid-stream failures must not retry
        # (items already reported would be duplicated on a re-run).
        try:
            count = 0
            async for item in agen:
                self._seal_stream_item(spec, count, item)
                count += 1
            self.streaming_manager.finish(spec.return_ids[0])
            self.task_manager.complete_success(spec, None)
        except BaseException as e:  # noqa: BLE001
            err = e if isinstance(e, TaskError) else TaskError(
                spec.repr_name(), e)
            self.task_manager.complete_error(spec, err, allow_retry=False)
            self.streaming_manager.finish(spec.return_ids[0])

    def _consume_stream(self, spec: TaskSpec, generator):
        try:
            for i, item in enumerate(generator):
                self._seal_stream_item(spec, i, item)
            self.streaming_manager.finish(spec.return_ids[0])
            self.task_manager.complete_success(spec, None)
        except BaseException as e:  # noqa: BLE001
            err = e if isinstance(e, TaskError) else TaskError(
                spec.repr_name(), e)
            self.task_manager.complete_error(spec, err, allow_retry=False)
            self.streaming_manager.finish(spec.return_ids[0])

    def _on_task_cancelled(self, spec: TaskSpec):
        self.task_manager.complete_error(
            spec, TaskCancelledError(spec.task_id), allow_retry=False)

    # --------------------------------------------------------------- actors
    def create_actor(self, klass: type, args, kwargs, *,
                     name: str = "", namespace: Optional[str] = None,
                     max_restarts: int = 0, max_task_retries: int = 0,
                     max_concurrency: Optional[int] = None,
                     max_pending_calls: int = -1,
                     lifetime: Optional[str] = None,
                     num_cpus: Optional[float] = None,
                     num_gpus: Optional[float] = None,
                     resources: Optional[Dict[str, float]] = None,
                     scheduling_strategy=None,
                     get_if_exists: bool = False,
                     isolate: bool = False,
                     _actor_id: Optional[ActorID] = None,
                     _skip_cluster_routing: bool = False):
        from .actor import ActorHandle

        ns = namespace if namespace is not None else self.namespace
        if get_if_exists and name:
            existing = self.actor_manager.get_named(name, ns)
            if existing is not None:
                return self.actor_manager.get_handle(existing)
            if self.cluster is not None and not _skip_cluster_routing:
                found = self.cluster.lookup_named_actor(name, ns)
                if found is not None:
                    aid_bytes, found_klass, _node, _addr = found
                    return ActorHandle(ActorID(aid_bytes),
                                       found_klass, self)

        actor_id = _actor_id or ActorID.of(self.job_id)
        demand: Dict[str, float] = dict(resources or {})
        # Actors default to 1 CPU for *placement* but hold 0 while idle in
        # the reference; in-process we hold what was requested explicitly.
        if num_cpus:
            demand["CPU"] = float(num_cpus)
        if num_gpus:
            demand["GPU"] = float(num_gpus)
        from ..util.placement_group import PlacementGroupSchedulingStrategy

        if isinstance(scheduling_strategy, PlacementGroupSchedulingStrategy):
            demand = scheduling_strategy.placement_group.wrap_resources(
                demand, scheduling_strategy.placement_group_bundle_index)

        if demand and not self.node_resources.can_ever_fit(demand):
            if self.cluster is not None and not _skip_cluster_routing:
                # Doesn't fit here: place on a remote node via the head
                # (reference: GCS actor scheduling,
                # gcs_actor_scheduler.cc:49).
                self.cluster.create_remote_actor(
                    actor_id, klass, args, kwargs, {
                        "name": name, "namespace": ns,
                        "max_restarts": max_restarts,
                        "max_task_retries": max_task_retries,
                        "max_concurrency": max_concurrency,
                        "max_pending_calls": max_pending_calls,
                        "lifetime": lifetime,
                        "resources": demand,
                        "isolate": isolate,
                    }, demand)
                return ActorHandle(actor_id, klass, self)
            raise ValueError(
                f"actor {klass.__name__} demands {demand}, which can never "
                f"be satisfied by node resources {self.node_resources.total}")

        info = ActorInfo(
            actor_id, klass, args, kwargs, name=name or "", namespace=ns,
            max_restarts=max_restarts, max_task_retries=max_task_retries,
            max_concurrency=max_concurrency,
            max_pending_calls=max_pending_calls, lifetime=lifetime,
            resources=demand, isolate=isolate)
        core = self.actor_manager.create(info)
        if self.cluster is not None and not _skip_cluster_routing:
            # Publish EVERY actor cluster-wide (reference: GCS actor
            # registry) — a handle crossing to another node resolves
            # location through the head, named or not.
            from ..cluster.serialization import dumps as _dumps

            self.cluster.mut_call("register_actor", {
                "actor_id": actor_id.binary(),
                "node_id": self.cluster.node_id,
                "address": self.cluster.address,
                "name": name, "namespace": ns, "klass": _dumps(klass),
                "max_task_retries": max_task_retries,
                "max_restarts": max_restarts,
                "resources": dict(demand or {}),
                # Same creation bundle shape the node server's
                # create_actor handler takes: the head replays it on a
                # survivor if this node dies (locally-created actors
                # must be as restartable as spilled ones).
                "spec": _dumps({
                    "actor_id": actor_id, "klass": klass,
                    "args": args, "kwargs": kwargs, "options": {
                        "name": name, "namespace": ns,
                        "max_restarts": max_restarts,
                        "max_task_retries": max_task_retries,
                        "max_concurrency": max_concurrency,
                        "max_pending_calls": max_pending_calls,
                        "lifetime": lifetime,
                        "resources": demand,
                        "isolate": isolate,
                    },
                }),
            })

        creation_task_id = TaskID.for_task(actor_id)
        trace_id, parent_span = _tracing.for_submission()
        creation_spec = TaskSpec(
            task_id=creation_task_id, job_id=self.job_id, function=None,
            descriptor=FunctionDescriptor.from_class(klass),
            args=(), kwargs={}, num_returns=1, resources={},
            max_retries=0, retry_exceptions=False,
            actor_id=actor_id, is_actor_creation=True,
            return_ids=(ObjectID.for_return(creation_task_id, 0),),
            trace_id=trace_id, parent_span_id=parent_span,
        )
        self.task_manager.register_pending(creation_spec)
        core.creation_spec = creation_spec

        def acquire_and_go():
            from ..exceptions import ActorDiedError

            if demand:
                self.node_resources.acquire(demand)
                core.info.resources_acquired = True
            if core.info.state == ActorState.DEAD:
                # Killed while we were blocked in acquire: give back the
                # resources and resolve the creation ref, else both leak.
                self._release_actor_resources(core.info)
                self.task_manager.complete_error(
                    creation_spec,
                    ActorDiedError(actor_id,
                                   "actor was killed before creation"),
                    allow_retry=False)
                return
            try:
                core.submit(creation_spec)
            except ActorDiedError as e:
                # Kill landed between the DEAD check and the submit;
                # kill_actor usually resolves the creation ref, but
                # complete_error is idempotent so resolve here too
                # rather than crashing the daemon thread.
                self._release_actor_resources(core.info)
                if self.task_manager.is_pending(creation_spec.task_id):
                    self.task_manager.complete_error(creation_spec, e,
                                                     allow_retry=False)

        threading.Thread(target=acquire_and_go, daemon=True).start()
        return ActorHandle(actor_id, klass, self,
                           creation_ref=ObjectRef(
                               creation_spec.return_ids[0], self))

    def finish_actor_creation(self, core, spec: TaskSpec):
        if core.info.state == ActorState.ALIVE:
            self.task_manager.complete_success(spec, None)
        else:
            from ..exceptions import ActorDiedError

            err = ActorDiedError(
                core.info.actor_id,
                f"actor {core.info.display_name()} failed during creation: "
                f"{core._creation_error!r}")
            self.task_manager.complete_error(spec, err, allow_retry=False)
            self._release_actor_resources(core.info)
            core.stop()

    def submit_actor_creation_for_restart(self, core):
        creation_task_id = TaskID.for_task(core.info.actor_id)
        trace_id, parent_span = _tracing.for_submission()
        spec = TaskSpec(
            task_id=creation_task_id, job_id=self.job_id, function=None,
            descriptor=FunctionDescriptor.from_class(core.info.klass),
            args=(), kwargs={}, num_returns=1, resources={},
            max_retries=0, retry_exceptions=False,
            actor_id=core.info.actor_id, is_actor_creation=True,
            return_ids=(ObjectID.for_return(creation_task_id, 0),),
            trace_id=trace_id, parent_span_id=parent_span,
        )
        self.task_manager.register_pending(spec)
        core.submit(spec)

    def submit_actor_task(self, actor_id: ActorID, method_name: str,
                          args, kwargs, options: TaskOptions,
                          klass: Optional[type] = None):
        core = self.actor_manager.get_core(actor_id)
        if core is None:
            if self.cluster is not None:
                return self._submit_remote_actor_task(
                    actor_id, method_name, args, kwargs, options, klass)
            raise ValueError(f"no such actor {actor_id!r}")
        from ..exceptions import ActorDiedError

        task_id = TaskID.for_task(actor_id)
        n = options.num_returns
        if n == STREAMING:
            return_ids = (ObjectID.for_return(task_id, 0),)
        else:
            return_ids = tuple(
                ObjectID.for_return(task_id, i) for i in range(int(n)))
        trace_id, parent_span = _tracing.for_submission()
        spec = TaskSpec(
            task_id=task_id, job_id=self.job_id, function=None,
            descriptor=FunctionDescriptor(
                core.info.klass.__module__, method_name,
                core.info.klass.__qualname__),
            args=tuple(args), kwargs=dict(kwargs), num_returns=n,
            resources={}, max_retries=options.max_retries,
            retry_exceptions=options.retry_exceptions,
            name=options.name, actor_id=actor_id, is_actor_task=True,
            parent_task_id=self.current_task_id(), return_ids=return_ids,
            trace_id=trace_id, parent_span_id=parent_span,
            deadline=_deadlines.for_submission(options.deadline_s))
        self.task_manager.register_pending(spec)
        arg_ids = [a.object_id() for a in spec.args
                   if isinstance(a, ObjectRef)]
        arg_ids += [v.object_id() for v in spec.kwargs.values()
                    if isinstance(v, ObjectRef)]
        self.reference_counter.add_submitted_task_references(arg_ids)
        if n == STREAMING:
            self.streaming_manager.create_stream(spec.return_ids[0])
        if core.info.state == ActorState.DEAD:
            self.task_manager.complete_error(
                spec, ActorDiedError(actor_id, "actor is dead"),
                allow_retry=False)
        else:
            try:
                core.submit(spec)
            except ActorDiedError as e:
                # Raced a kill: same observable behavior as the DEAD
                # pre-check above (refs resolve to the error).
                self.task_manager.complete_error(spec, e,
                                                 allow_retry=False)
            except Exception:
                # Back out the owner-side bookkeeping (pending-table
                # entry + arg refs + never-handed-out return refs)
                # before re-raising, e.g. on
                # PendingCallsLimitExceededError.  The caller gets the
                # exception, not error-valued refs.
                if n == STREAMING:
                    self.streaming_manager.finish(spec.return_ids[0])
                self.task_manager.abandon(spec)
                raise
        return self._refs_for(spec)

    def _submit_remote_actor_task(self, actor_id: ActorID,
                                  method_name: str, args, kwargs,
                                  options: TaskOptions,
                                  klass: Optional[type]):
        """Owner-side submission of a method call on an actor hosted by
        another node (reference: actor_task_submitter.h:75 — per-actor
        client queue + direct push; ordering is preserved by the
        receiving node's inline submission of ``actor_call``)."""
        location, actor_state = \
            self.cluster.locate_actor_with_state(actor_id)
        if location is None and actor_state != "RESTARTING":
            if actor_state == "DEAD":
                # Reaped by the head: submission on the stale handle
                # gets the same typed, postmortem-enriched error as a
                # call caught mid-death, not a bare lookup failure.
                from ..exceptions import ActorDiedError

                raise ActorDiedError(
                    actor_id, "actor is dead (already reaped)",
                    context=self.cluster.death_context())
            raise ValueError(f"no such actor {actor_id!r}")
        n = options.num_returns
        if n == STREAMING:
            task_id = TaskID.for_task(actor_id)
            return_ids = (ObjectID.for_return(task_id, 0),)
        else:
            task_id = TaskID.for_task(actor_id)
            return_ids = tuple(
                ObjectID.for_return(task_id, i) for i in range(int(n)))
        trace_id, parent_span = _tracing.for_submission()
        spec = TaskSpec(
            task_id=task_id, job_id=self.job_id, function=None,
            descriptor=FunctionDescriptor(
                getattr(klass, "__module__", "") or "", method_name,
                getattr(klass, "__qualname__", "")),
            args=tuple(args), kwargs=dict(kwargs), num_returns=n,
            resources={},
            # A call may survive as many actor-node deaths as the
            # actor's max_task_retries allows (was silently forced 0).
            max_retries=self.cluster.actor_task_retries(actor_id),
            retry_exceptions=options.retry_exceptions,
            name=options.name, actor_id=actor_id, is_actor_task=True,
            parent_task_id=self.current_task_id(), return_ids=return_ids,
            trace_id=trace_id, parent_span_id=parent_span,
            deadline=_deadlines.for_submission(options.deadline_s))
        self.task_manager.register_pending(spec)
        arg_ids = [a.object_id() for a in spec.args
                   if isinstance(a, ObjectRef)]
        arg_ids += [v.object_id() for v in spec.kwargs.values()
                    if isinstance(v, ObjectRef)]
        self.reference_counter.add_submitted_task_references(arg_ids)
        if n == STREAMING:
            self.streaming_manager.create_stream(spec.return_ids[0])
        if actor_state == "RESTARTING":
            # Queue behind the head-driven restart instead of pushing
            # to the dead node's address.
            threading.Thread(
                target=self.cluster.resubmit_actor_task,
                args=(spec,), daemon=True).start()
        else:
            self.cluster.submit_remote_actor_task(spec, location)
        return self._refs_for(spec)

    def _release_actor_resources(self, info):
        """Release exactly once, and only after the creation thread's
        acquire has happened."""
        with self._resource_release_lock:
            if not (info.resources and info.resources_acquired
                    and not info.resources_released):
                return
            info.resources_released = True
        self.node_resources.release(info.resources)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        core = self.actor_manager.get_core(actor_id)
        if core is None and self.cluster is not None:
            self.cluster.kill_remote_actor(actor_id, no_restart)
            return
        self.actor_manager.kill(actor_id, no_restart)
        if core is not None and self.cluster is not None and no_restart:
            # Locally-hosted actors are registered cluster-wide; a kill
            # must retire the head entry too.
            from ..cluster.rpc import TRANSPORT_ERRORS as _TRANSPORT_ERRORS

            try:
                self.cluster.mut_call(
                    "remove_actor", {"actor_id": actor_id.binary()},
                    deadline_s=10.0)
            except _TRANSPORT_ERRORS:
                pass  # head unreachable: its reaper retires the entry
        if core is not None and core.info.state == ActorState.DEAD:
            self._release_actor_resources(core.info)
            # If the kill landed between the creation thread's acquire
            # and the creation task running, resolve the creation ref.
            spec = core.creation_spec
            if spec is not None and self.task_manager.is_pending(
                    spec.task_id):
                from ..exceptions import ActorDiedError

                self.task_manager.complete_error(
                    spec, ActorDiedError(actor_id, "actor was killed"),
                    allow_retry=False)

    # ------------------------------------------------------------- cancel
    def cancel(self, ref: ObjectRef, force: bool = False,
               recursive: bool = True):
        self.scheduler.cancel(ref.task_id(), force=force,
                              recursive=recursive)

    # ------------------------------------------------------------ shutdown
    def shutdown(self):
        if self.is_shutdown:
            return
        self.is_shutdown = True
        if self.cluster is not None:
            try:
                self.cluster.detach()
            except Exception:
                pass
            self.cluster = None
        self.actor_manager.shutdown()
        self.scheduler.shutdown()
        if self._isolated_pool is not None:
            self._isolated_pool.shutdown()
            self._isolated_pool = None
        self.plasma.destroy()


# ---------------------------------------------------------------- global API
def init_runtime(**kwargs) -> Runtime:
    global _global_runtime
    with _global_lock:
        if _global_runtime is not None and not _global_runtime.is_shutdown:
            return _global_runtime
        _global_runtime = Runtime(**kwargs)
        atexit.register(shutdown_runtime)
        return _global_runtime


def get_runtime() -> Runtime:
    rt = _global_runtime
    if rt is None or rt.is_shutdown:
        raise RuntimeError(
            "ray_tpu_torch has not been initialized — call "
            "ray_tpu_torch.init() first")
    return rt


def try_get_runtime() -> Optional[Runtime]:
    rt = _global_runtime
    if rt is None or rt.is_shutdown:
        return None
    return rt


def is_initialized() -> bool:
    return try_get_runtime() is not None


def shutdown_runtime():
    global _global_runtime
    with _global_lock:
        if _global_runtime is not None:
            _global_runtime.shutdown()
            _global_runtime = None

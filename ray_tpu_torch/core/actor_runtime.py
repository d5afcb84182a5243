"""Actor execution: per-actor ordered queues, concurrency, restarts.

Reference semantics:
- Server side: TaskReceiver + scheduling queues — sequential by default,
  threaded pool when ``max_concurrency > 1``, asyncio event loop for
  async actors (src/ray/core_worker/transport/task_receiver.h:51,
  actor_scheduling_queue.h, concurrency_group_manager.h, fiber.h).
- Control: GCS actor FSM DEPENDENCIES_UNREADY → PENDING_CREATION → ALIVE
  → RESTARTING/DEAD with ``max_restarts`` (gcs_actor_manager.h:308).
- Naming: named/detached actors in a namespace (worker.py:3010).
"""

from __future__ import annotations

import asyncio
import inspect
import queue
import threading
import time
from enum import Enum
from typing import Any, Callable, Dict, Optional, Tuple

from .ids import ActorID
from .task_spec import TaskSpec
from ..exceptions import (ActorDiedError, PendingCallsLimitExceededError,
                          TaskError)
from ..experimental import chaos as _chaos
from ..observability.profiling import stuck_guard as _stuck_guard


def _flightrec_context() -> Dict[str, Any]:
    """Context fragment pointing at this process's flight record, so a
    dead-actor error names where the local forensics live even before
    any supervisor-built postmortem bundle exists."""
    try:
        from ..observability import flightrec as _flightrec

        rec = _flightrec.current()
        if rec is not None:
            return {"flightrec": rec.base}
    except Exception:
        pass
    return {}


class ActorState(Enum):
    PENDING_CREATION = "PENDING_CREATION"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


class ActorExitSignal(BaseException):
    """Raised by exit_actor() inside a method to terminate the actor."""


class _ActorCore:
    """One live actor: instance + its execution queue/threads."""

    def __init__(self, runtime, info: "ActorInfo"):
        self._runtime = runtime
        self.info = info
        self._queue: "queue.Queue[Optional[TaskSpec]]" = queue.Queue()
        self._threads = []
        self._stopped = threading.Event()
        # Serializes submit() vs stop() so no spec can be enqueued
        # behind the shutdown sentinels (it would hang forever).
        self._submit_lock = threading.Lock()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.instance: Any = None
        self._creation_done = threading.Event()
        self._creation_error: Optional[BaseException] = None
        # Method calls queued but not yet started (decremented at dequeue);
        # the creation spec rides the same queue but must not count against
        # max_pending_calls.
        self._pending_calls = 0
        # Set by Runtime.create_actor; lets kill paths resolve a
        # still-pending creation ref.
        self.creation_spec = None

        if info.is_async:
            t = threading.Thread(target=self._async_main,
                                 name=f"actor-{info.name or info.actor_id.hex()[:8]}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        else:
            for i in range(max(1, info.max_concurrency)):
                t = threading.Thread(
                    target=self._sync_main,
                    name=f"actor-{info.name or info.actor_id.hex()[:8]}-{i}",
                    daemon=True)
                t.start()
                self._threads.append(t)

    # -- creation ------------------------------------------------------------
    def create_instance(self):
        info = self.info
        try:
            if info.isolate:
                # N8: the instance lives in a dedicated subprocess; a
                # crash there surfaces as WorkerCrashedError per call,
                # not as this node going down.
                if info.is_async:
                    raise ValueError(
                        "isolate=True does not support async actors "
                        "(coroutines cannot cross the worker process "
                        "boundary); use a sync actor or isolate=False")
                raise NotImplementedError(
                    "isolate=True is not ported yet "
                    "(ROADMAP queue A item 4, cluster sub-slice)")
            else:
                self.instance = info.klass(*info.init_args,
                                           **info.init_kwargs)
            info.state = ActorState.ALIVE
        except BaseException as e:  # noqa: BLE001
            self._creation_error = e
            info.state = ActorState.DEAD
        finally:
            self._creation_done.set()

    def wait_ready(self, timeout: Optional[float] = None) -> None:
        if not self._creation_done.wait(timeout):
            from ..exceptions import GetTimeoutError

            raise GetTimeoutError(
                f"actor {self.info.display_name()} not ready after "
                f"{timeout}s")
        if self._creation_error is not None:
            raise ActorDiedError(
                self.info.actor_id,
                f"actor {self.info.display_name()} failed during creation: "
                f"{self._creation_error!r}")

    # -- submission ----------------------------------------------------------
    def submit(self, spec: TaskSpec, bypass_limit: bool = False):
        """``bypass_limit``: retries of already-accepted tasks skip the
        pending-calls backpressure check (the limit is a submission-time
        contract, not a retry gate)."""
        with self._submit_lock:
            if self._stopped.is_set():
                raise self._dead_error()
            if not bypass_limit and self.info.max_pending_calls > 0 and (
                    self._pending_calls >= self.info.max_pending_calls):
                self._count_rejection()
                raise PendingCallsLimitExceededError(
                    f"actor {self.info.display_name()} has "
                    f"{self._pending_calls} pending calls "
                    f"(max_pending_calls={self.info.max_pending_calls})")
            if not spec.is_actor_creation:
                self._pending_calls += 1
                depth = self._pending_calls
            else:
                depth = None
            self._queue.put(spec)
        if depth is not None:
            self._gauge_depth(depth)

    def _count_rejection(self):
        """Bounded-mailbox admission rejection: typed AND counted, so
        the overload plane's /metrics shows where pressure lands."""
        try:
            from ..observability.metrics import overload_counters

            overload_counters()["backpressure"].inc(
                tags={"where": "max_pending_calls"})
        except Exception:
            pass

    def _gauge_depth(self, depth: int):
        try:
            from ..observability.metrics import overload_counters

            overload_counters()["queue_depth"].set(
                depth,
                tags={"queue": f"actor:{self.info.display_name()}"})
        except Exception:
            pass

    def _call_started(self, spec: TaskSpec):
        if not spec.is_actor_creation:
            with self._submit_lock:
                self._pending_calls -= 1
                depth = self._pending_calls
            self._gauge_depth(depth)

    # -- execution loops -----------------------------------------------------
    def _sync_main(self):
        while not self._stopped.is_set():
            spec = self._queue.get()
            if spec is None:
                return
            self._run_one(spec)

    def _async_main(self):
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        sem = asyncio.Semaphore(max(1, self.info.max_concurrency))

        async def pump():
            while not self._stopped.is_set():
                spec = await self._loop.run_in_executor(None, self._queue.get)
                if spec is None:
                    return
                await sem.acquire()
                task = self._loop.create_task(self._run_one_async(spec))
                task.add_done_callback(lambda _t: sem.release())

        try:
            self._loop.run_until_complete(pump())
        finally:
            pending = asyncio.all_tasks(self._loop)
            for t in pending:
                t.cancel()
            self._loop.close()

    def _run_one(self, spec: TaskSpec):
        if spec.is_actor_creation:
            t0 = time.time()
            self.create_instance()
            self._runtime.finish_actor_creation(self, spec)
            self._runtime._record_task_event(
                spec, t0,
                "ok" if self._creation_error is None else "error")
            return
        self._call_started(spec)
        # With max_concurrency > 1 another pool thread may still be
        # running __init__: no method executes before creation settles
        # (reference: tasks queue behind actor creation).
        self._creation_done.wait()
        if self.info.state == ActorState.DEAD:
            self._runtime.task_manager.complete_error(
                spec, self._dead_error(), allow_retry=False)
            return
        # Mailbox-dequeue load shedding: work whose end-to-end deadline
        # passed while it queued completes with DeadlineExceededError —
        # user code never runs (the overload plane's core invariant).
        if self._runtime.shed_expired_spec(spec, "actor_mailbox"):
            return
        # Stuck detector (observability/profiling.py): a dispatch that
        # is still running STUCK_FACTOR x past its remaining deadline
        # budget gets every thread's stack snapshotted — the deadline
        # plane promises the caller an answer by then, so overshooting
        # it this far means something is wedged, and the post-mortem
        # needs the stacks from the moment it happened.
        budget = (None if spec.deadline is None
                  else spec.deadline - time.time())
        with _stuck_guard("actor_dispatch", budget,
                          {"method": spec.descriptor.function_name,
                           "actor": self.info.display_name()}):
            if self._chaos_gate(spec):
                return
            self._runtime.execute_task_inline(
                spec, bound_instance=self.instance, actor_core=self)

    def _chaos_gate(self, spec: TaskSpec) -> bool:
        """Fault-injection hook before method dispatch: an active
        chaos schedule may kill this actor (with or without restart
        budget), fail just this call, or STALL it (load shaping:
        ``slow_method`` / ``stall_replica`` make this actor a hot/slow
        replica deterministically).  Returns True when the spec was
        consumed by an injected fault."""
        action = _chaos.actor_task_action(spec.descriptor.function_name,
                                          self.info.display_name())
        if action is None:
            return False
        method = spec.descriptor.function_name
        if action[0] == "slow":
            # Injected latency: the call still runs, late.  Sleeping
            # here (the dispatch path) stalls the whole actor — for an
            # async actor it blocks the event loop — which is exactly
            # the slow-replica failure mode under test.
            time.sleep(action[1])
            return False
        if action[0] == "kill":
            self._runtime.task_manager.complete_error(
                spec, ActorDiedError(
                    self.info.actor_id,
                    "chaos: actor killed before dispatch",
                    context={"method": method,
                             **_flightrec_context()}),
                allow_retry=False)
            self._runtime.kill_actor(self.info.actor_id,
                                     no_restart=action[1])
            return True
        self._runtime.task_manager.complete_error(
            spec, TaskError(spec.repr_name(), action[1]),
            allow_retry=False)
        return True

    async def _run_one_async(self, spec: TaskSpec):
        if spec.is_actor_creation:
            t0 = time.time()
            self.create_instance()
            self._runtime.finish_actor_creation(self, spec)
            self._runtime._record_task_event(
                spec, t0,
                "ok" if self._creation_error is None else "error")
            return
        self._call_started(spec)
        if not self._creation_done.is_set():
            # Creation runs synchronously on this loop, so normally it
            # finished before any method task started; guard anyway
            # without blocking the loop.
            await self._loop.run_in_executor(
                None, self._creation_done.wait)
        if self.info.state == ActorState.DEAD:
            self._runtime.task_manager.complete_error(
                spec, self._dead_error(), allow_retry=False)
            return
        # Same mailbox-dequeue shed as the sync path.
        if self._runtime.shed_expired_spec(spec, "actor_mailbox"):
            return
        # Same stuck guard as the sync path: a chaos-stalled (or truly
        # wedged) async replica blocks its event loop — the snapshot
        # shows the loop thread pinned inside the stall.
        budget = (None if spec.deadline is None
                  else spec.deadline - time.time())
        with _stuck_guard("actor_dispatch", budget,
                          {"method": spec.descriptor.function_name,
                           "actor": self.info.display_name()}):
            if self._chaos_gate(spec):
                return
            await self._runtime.execute_task_inline_async(
                spec, bound_instance=self.instance, actor_core=self)

    def _dead_error(self) -> ActorDiedError:
        suffix = ""
        if self._creation_error is not None:
            suffix = f" (creation failed: {self._creation_error!r})"
        return ActorDiedError(
            self.info.actor_id,
            f"actor {self.info.display_name()} is dead{suffix}",
            node_id=self._runtime.node_id.hex(),
            context={"restarts_used": self.info.num_restarts,
                     **_flightrec_context()})

    # -- teardown ------------------------------------------------------------
    def stop(self):
        inst = self.instance
        if inst is not None and hasattr(inst, "_ray_tpu_isolated_close"):
            try:
                inst._ray_tpu_isolated_close()
            except Exception:
                pass
        failed = []
        with self._submit_lock:
            self._stopped.set()
            # Drain under the lock; COMPLETE outside it.  complete_error
            # fans out to owner callbacks and (for remote owners) RPCs —
            # running those while holding the submit lock would block
            # every concurrent submitter behind user-visible work.
            try:
                while True:
                    spec = self._queue.get_nowait()
                    if spec is not None:
                        failed.append(spec)
            except queue.Empty:
                pass
            for _ in self._threads:
                self._queue.put(None)
        for spec in failed:
            self._runtime.task_manager.complete_error(
                spec, self._dead_error(), allow_retry=False)
        # Drop this mailbox's depth series: gauges keyed by actor name
        # would otherwise accumulate one stale entry per dead actor
        # (serve replicas churn names every rolling update).
        try:
            from ..observability.metrics import overload_counters

            overload_counters()["queue_depth"].remove(
                tags={"queue": f"actor:{self.info.display_name()}"})
        except Exception:
            pass


class ActorInfo:
    def __init__(self, actor_id: ActorID, klass: type, init_args, init_kwargs,
                 *, name: str = "", namespace: str = "", max_restarts: int = 0,
                 max_task_retries: int = 0,
                 max_concurrency: Optional[int] = None,
                 max_pending_calls: int = -1, lifetime: Optional[str] = None,
                 resources: Optional[Dict[str, float]] = None,
                 isolate: bool = False):
        self.actor_id = actor_id
        self.klass = klass
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.name = name
        self.namespace = namespace
        self.max_restarts = max_restarts
        self.max_task_retries = max_task_retries
        self.max_pending_calls = max_pending_calls
        self.lifetime = lifetime
        self.resources = resources or {}
        self.isolate = isolate
        # Resource-accounting flags: acquire happens on a background
        # thread at creation; release must happen exactly once across
        # the kill / failed-creation / double-kill paths.
        self.resources_acquired = False
        self.resources_released = False
        self.state = ActorState.PENDING_CREATION
        self.num_restarts = 0
        # Coroutine *and* async-generator methods make an actor async
        # (iscoroutinefunction alone misses ``async def`` generators).
        def _is_async_callable(m):
            return (inspect.iscoroutinefunction(m)
                    or inspect.isasyncgenfunction(m))

        self.is_async = bool(inspect.getmembers(klass, _is_async_callable))
        # Async actors default to high concurrency (reference: actor.py —
        # asyncio actors use max_concurrency=1000 unless set explicitly);
        # sync actors default to 1 (ordered execution).
        if max_concurrency is None:
            max_concurrency = 1000 if self.is_async else 1
        self.max_concurrency = max_concurrency

    def display_name(self) -> str:
        return self.name or f"{self.klass.__name__}({self.actor_id.hex()[:8]})"


class ActorManager:
    """Registry of actors — the in-process stand-in for the GCS actor
    table (gcs_actor_manager.h)."""

    def __init__(self, runtime):
        self._runtime = runtime
        self._lock = threading.Lock()
        self._cores: Dict[ActorID, _ActorCore] = {}
        self._named: Dict[Tuple[str, str], ActorID] = {}

    def create(self, info: ActorInfo) -> _ActorCore:
        with self._lock:
            key = (info.namespace, info.name)
            if info.name:
                if key in self._named:
                    existing = self._cores.get(self._named[key])
                    if existing is not None and existing.info.state not in (
                            ActorState.DEAD,):
                        raise ValueError(
                            f"actor name {info.name!r} already taken in "
                            f"namespace {info.namespace!r}")
                self._named[key] = info.actor_id
            core = _ActorCore(self._runtime, info)
            self._cores[info.actor_id] = core
            return core

    def get_core(self, actor_id: ActorID) -> Optional[_ActorCore]:
        with self._lock:
            return self._cores.get(actor_id)

    def get_named(self, name: str, namespace: str) -> Optional[ActorID]:
        with self._lock:
            return self._named.get((namespace, name))

    def list_named(self, namespace: Optional[str] = None):
        with self._lock:
            return [
                {"name": n, "namespace": ns, "actor_id": aid.hex()}
                for (ns, n), aid in self._named.items()
                if namespace is None or ns == namespace
            ]

    def actor_name(self, actor_id: ActorID) -> str:
        core = self.get_core(actor_id)
        return core.info.name if core else ""

    def num_restarts(self, actor_id: ActorID) -> int:
        core = self.get_core(actor_id)
        return core.info.num_restarts if core else 0

    def get_handle(self, actor_id: ActorID):
        from .actor import ActorHandle

        core = self.get_core(actor_id)
        if core is None:
            raise ValueError(f"no such actor: {actor_id!r}")
        return ActorHandle(actor_id, core.info.klass, self._runtime)

    def kill(self, actor_id: ActorID, no_restart: bool = True):
        core = self.get_core(actor_id)
        if core is None:
            return
        info = core.info
        if (not no_restart and info.max_restarts != 0
                and (info.max_restarts < 0
                     or info.num_restarts < info.max_restarts)):
            # Restart: new core, re-run constructor (state is lost —
            # matches reference restart semantics).
            info.num_restarts += 1
            info.state = ActorState.RESTARTING
            # The restart is a load-bearing moment in any recovery
            # story — mark it in the (shipped) timeline so the merged
            # trace shows WHERE the gap in an actor's lane came from.
            try:
                from ..observability.timeline import (process_pid,
                                                      record_event)

                record_event(
                    "actor_restart", "i", pid=process_pid(),
                    tid=threading.current_thread().name,
                    args={"actor_id": actor_id.hex()[:16],
                          "name": info.display_name(),
                          "restarts_used": info.num_restarts})
            except Exception:
                pass
            core.stop()
            new_core = _ActorCore(self._runtime, info)
            with self._lock:
                self._cores[actor_id] = new_core
            self._runtime.submit_actor_creation_for_restart(new_core)
            return
        info.state = ActorState.DEAD
        core.stop()
        # The dead core stays (it answers later calls with the typed
        # death error) but lets go of the instance and its constructor
        # arguments: a model's tensors on the card are freed at kill.
        core.instance = None
        info.init_args, info.init_kwargs = (), {}
        with self._lock:
            if info.name and self._named.get(
                    (info.namespace, info.name)) == actor_id:
                del self._named[(info.namespace, info.name)]

    def shutdown(self):
        with self._lock:
            cores = list(self._cores.values())
        for core in cores:
            core.info.state = ActorState.DEAD
            core.stop()

    def num_alive(self) -> int:
        with self._lock:
            return sum(1 for c in self._cores.values()
                       if c.info.state == ActorState.ALIVE)

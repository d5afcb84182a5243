"""Programmable fault injection: the testing surface of the failure
model (reference: src/ray/common/test/rpc_chaos.h:23 —
``RAY_testing_rpc_failure`` — grown into a first-class, queryable API).

A :class:`ChaosSchedule` is a seeded, deterministic list of rules the
runtime consults at its chaos hook points:

- ``cluster/rpc.py``: every outgoing RPC (``drop_rpc`` raises
  ConnectionError at the caller, ``delay_rpc`` stalls it) — exercises
  retry/backoff/idempotency paths.
- ``experimental/channel.py``: every ring-frame write (``kill_at_ring_
  write`` simulates the producer dying mid-pass WITHOUT flushing an
  error frame; ``sever_ring`` closes the ring under both endpoints
  mid-frame) — exercises reader deadlines, peer-liveness probing, and
  DAG re-planning.
- ``core/actor_runtime.py``: every actor method dispatch
  (``kill_on_method`` marks the actor dead — with or without restart
  budget — before the call runs; ``raise_on_method`` injects an
  application error) — exercises restart FSM and caller retries.

Schedules are installed process-wide for a scope::

    sched = (chaos.schedule(seed=7)
             .drop_rpc("register_actor", count=2)
             .kill_at_ring_write("dag0-1", nth=3, no_restart=False))
    with sched:
        ...  # faults fire deterministically
    assert sched.fired("ring_kill") == 1

and are queryable afterwards (``events()`` is the ordered record of
every fired fault).  The legacy ``RAY_TPU_TESTING_RPC_FAILURE=
"method=N,..."`` env knob is subsumed: :func:`env_rpc_budget` is the
same parser, still honored per-RpcClient so subprocess workers inherit
faults through the environment.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "ChaosSchedule", "ChaosKill", "schedule", "active", "current",
    "on_rpc", "ring_write_action", "actor_task_action",
    "env_rpc_budget", "EnvRpcBudget",
    # Control-plane chaos: head kill -9, node partitions,
    # heartbeat loss — the vcluster soak's fault vocabulary.
    "kill_head", "register_head_process", "partition_node",
    "drop_heartbeats", "reset",
]


class ChaosKill(BaseException):
    """Injected hard death of the executing actor.  BaseException so
    generic ``except Exception`` recovery code cannot swallow a
    simulated crash; the hook sites translate it into the real kill
    path (no error frames, no cleanup — that is the point)."""

    def __init__(self, reason: str = "chaos-injected kill",
                 no_restart: bool = True):
        super().__init__(reason)
        self.no_restart = no_restart


class _Rule:
    __slots__ = ("kind", "target", "nth", "count", "delay_s", "prob",
                 "no_restart", "exc_type", "jitter_s", "hits", "fires",
                 "until")

    def __init__(self, kind: str, target: str, *, nth: int = 1,
                 count: int = 1, delay_s: float = 0.0, prob: float = 1.0,
                 no_restart: bool = True, exc_type: type = RuntimeError,
                 jitter_s: float = 0.0, until: float = 0.0):
        self.kind = kind
        self.target = target
        self.nth = max(1, int(nth))
        self.count = int(count)
        self.delay_s = float(delay_s)
        self.prob = float(prob)
        self.no_restart = bool(no_restart)
        self.exc_type = exc_type
        self.jitter_s = float(jitter_s)
        self.until = float(until)  # monotonic window end (0 = no window)
        self.hits = 0    # matching hook invocations seen
        self.fires = 0   # faults actually injected


class ChaosSchedule:
    """Deterministic rule set.  Rule matching is by method name (RPC and
    actor hooks) or ring-path substring (channel hooks); firing is a
    pure function of the per-rule hit counter (and, for ``prob < 1``,
    of the schedule's seeded RNG), so the same schedule against the
    same execution order injects the same faults."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._rules: List[_Rule] = []
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------ rule builders
    def drop_rpc(self, method: str, count: int = 1, *,
                 delay_s: float = 0.0, prob: float = 1.0
                 ) -> "ChaosSchedule":
        """Fail the first ``count`` calls of ``method`` with
        ConnectionError at the caller (after ``delay_s`` if set)."""
        self._rules.append(_Rule("rpc_drop", method, count=count,
                                 delay_s=delay_s, prob=prob))
        return self

    def delay_rpc(self, method: str, delay_s: float,
                  count: int = 1 << 30) -> "ChaosSchedule":
        """Stall the first ``count`` calls of ``method`` by
        ``delay_s`` seconds (then let them proceed)."""
        self._rules.append(_Rule("rpc_delay", method, count=count,
                                 delay_s=delay_s))
        return self

    def kill_at_ring_write(self, ring: str, nth: int = 1, *,
                           no_restart: bool = True) -> "ChaosSchedule":
        """Kill the producer actor at its ``nth`` write to any ring
        whose path contains ``ring`` — a sudden death mid-pass: no
        error frame is flushed, readers must detect the dead peer."""
        self._rules.append(_Rule("ring_kill", ring, nth=nth,
                                 no_restart=no_restart))
        return self

    def sever_ring(self, ring: str, at_frame: int = 1) -> "ChaosSchedule":
        """Close the ring under both endpoints at the writer's
        ``at_frame``-th write (both sides observe ChannelClosed)."""
        self._rules.append(_Rule("ring_sever", ring, nth=at_frame))
        return self

    def kill_on_method(self, method: str, nth: int = 1, *,
                       no_restart: bool = True) -> "ChaosSchedule":
        """Kill the executing actor at its ``nth`` dispatch of
        ``method`` (before user code runs)."""
        self._rules.append(_Rule("actor_kill", method, nth=nth,  # raylint: disable=unbounded-mailbox -- schedule BUILDER (finite test-authored rule list), not a request path; 'on_' in the name trips the dispatch heuristic
                                 no_restart=no_restart))
        return self

    def raise_on_method(self, method: str, nth: int = 1,
                        count: int = 1,
                        exc_type: type = RuntimeError) -> "ChaosSchedule":
        """Inject ``exc_type`` at the ``nth``..``nth+count-1`` dispatch
        of ``method``."""
        self._rules.append(_Rule("actor_raise", method, nth=nth,  # raylint: disable=unbounded-mailbox -- schedule BUILDER (finite test-authored rule list), not a request path; 'on_' in the name trips the dispatch heuristic
                                 count=count, exc_type=exc_type))
        return self

    # Load-shaping injections (overload testing): make a method or a
    # whole replica deterministically SLOW instead of dead — the "hot
    # replica" half of the fault model, where the system must degrade
    # by shedding rather than by latency collapse.
    def slow_method(self, method: str, delay_s: float, *,
                    jitter_s: float = 0.0, nth: int = 1,
                    count: int = 1 << 30) -> "ChaosSchedule":
        """Stall the ``nth``..``nth+count-1`` dispatches of ``method``
        by ``delay_s`` (+ uniform [0, jitter_s) drawn from the
        schedule's seeded RNG) BEFORE user code runs.  The stall sits
        on the actor's dispatch path, so an async replica's event loop
        blocks for the duration — a realistically sick replica."""
        self._rules.append(_Rule("actor_slow", method, nth=nth,
                                 count=count, delay_s=delay_s,
                                 jitter_s=jitter_s))
        return self

    def stall_replica(self, actor_name: str, stall_s: float, *,
                      count: int = 1 << 30) -> "ChaosSchedule":
        """Stall EVERY method dispatch of any actor whose display name
        contains ``actor_name`` (serve replicas are named
        ``SERVE_<deployment>#<version>_<rid>``, so one replica of a
        deployment can be targeted by its ``#v_rid`` suffix)."""
        self._rules.append(_Rule("actor_stall", actor_name,
                                 count=count, delay_s=stall_s))
        return self

    # Control-plane chaos: the vcluster soak's fault model —
    # node↔head partitions and heartbeat loss on the RPC layer (the
    # head kill -9 is the imperative module-level kill_head()).
    def partition_node(self, substr: str,
                       duration_s: float) -> "ChaosSchedule":
        """Drop EVERY outgoing RPC whose caller tag (RpcClient
        .chaos_tag, defaulting to the peer address) contains
        ``substr``, for ``duration_s`` starting NOW — a symmetric
        network partition as seen from this process.  The node misses
        lease renewals, the head declares it dead, and any write it
        had in flight comes back ``StaleEpochError`` once the
        partition heals."""
        self._rules.append(_Rule(
            "rpc_partition", substr, count=1 << 30,
            until=time.monotonic() + float(duration_s)))
        return self

    def drop_heartbeats(self, frac: float, *,
                        duration_s: float = 0.0) -> "ChaosSchedule":
        """Drop each ``heartbeat`` RPC with probability ``frac``
        (drawn from the schedule's seeded RNG) — degraded-fabric lease
        renewal.  Matches the method EXACTLY: the vcluster pump runs
        this hook once per virtual node before batching, so matching
        the ``heartbeat_batch`` wire call too would drop whole
        connections' batches on top of the per-node losses (~2x the
        asked-for fraction, correlated).  ``duration_s`` bounds the
        window (0 = until the schedule deactivates)."""
        until = (time.monotonic() + float(duration_s)
                 if duration_s else 0.0)
        self._rules.append(_Rule("rpc_dropfrac", "heartbeat",
                                 count=1 << 30, prob=float(frac),
                                 until=until))
        return self

    # ----------------------------------------------------------- queries
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def fired(self, kind: Optional[str] = None,
              target: Optional[str] = None) -> int:
        with self._lock:
            return sum(
                1 for e in self._events
                if (kind is None or e["kind"] == kind)
                and (target is None or e["target"] == target))

    # ------------------------------------------------------------- scope
    def __enter__(self) -> "ChaosSchedule":
        _install(self)
        return self

    def __exit__(self, *exc) -> None:
        _uninstall(self)

    # ----------------------------------------------------- hook dispatch
    def _record(self, rule: _Rule, detail: Dict[str, Any]) -> None:
        rule.fires += 1
        self._events.append({
            "kind": rule.kind, "target": rule.target,
            "t": time.monotonic(), **detail})
        # Every injected fault is also a TAGGED timeline event, so the
        # merged cluster trace shows exactly where chaos struck and
        # tests can assert recovery THROUGH the observability plane.
        try:
            from ..observability.timeline import (process_pid,
                                                  record_event)

            record_event(f"chaos:{rule.kind}", "i",
                         pid=process_pid(),
                         tid=threading.current_thread().name,
                         args={"chaos": True, "kind": rule.kind,
                               "target": rule.target, **detail})
        except Exception:
            pass

    def _match(self, kinds: Tuple[str, ...], key: str,
               substring: bool = False):
        """First firing rule of ``kinds`` matching ``key``, advancing
        hit counters; returns (rule, detail) or None.  Caller holds no
        locks; counter updates are under the schedule lock."""
        with self._lock:
            for rule in self._rules:
                if rule.kind not in kinds:
                    continue
                if substring:
                    if rule.target not in key:
                        continue
                elif rule.target != key:
                    continue
                rule.hits += 1
                if rule.kind in ("rpc_drop", "rpc_delay", "actor_raise",
                                 "actor_slow", "actor_stall"):
                    window = (rule.nth <= rule.hits
                              < rule.nth + rule.count)
                else:
                    window = rule.hits == rule.nth
                if not window:
                    continue
                if rule.prob < 1.0 and self._rng.random() >= rule.prob:
                    continue
                return rule
        return None

    def rpc_hook(self, method: str, tag: str = "") -> None:
        # Windowed control-plane faults first: partitions match the
        # CALLER tag (substring), heartbeat loss matches the method
        # family probabilistically.
        now = time.monotonic()
        with self._lock:
            for rule in self._rules:
                if rule.until and now >= rule.until:
                    continue
                if rule.kind == "rpc_partition" and rule.target in tag:
                    rule.hits += 1
                    self._record(rule, {"method": method, "tag": tag})
                    raise ConnectionError(
                        f"[chaos] partition: rpc {method!r} from "
                        f"{tag!r} dropped")
                if rule.kind == "rpc_dropfrac" and \
                        method == rule.target:
                    rule.hits += 1
                    if self._rng.random() < rule.prob:
                        self._record(rule, {"method": method,
                                            "tag": tag})
                        raise ConnectionError(
                            f"[chaos] heartbeat dropped "
                            f"({method!r}, hit {rule.hits})")
        rule = self._match(("rpc_drop", "rpc_delay"), method)
        if rule is None:
            return
        self._record(rule, {"method": method})
        if rule.delay_s > 0:
            time.sleep(rule.delay_s)
        if rule.kind == "rpc_drop":
            raise ConnectionError(
                f"[chaos] injected rpc failure for {method!r} "
                f"(hit {rule.hits})")

    def ring_hook(self, path: str, seq: int) -> Optional[Tuple]:
        # Ring rules key on the WRITER'S frame sequence ("kill actor P
        # at its Nth write to ring R"), not on hook-call order, so the
        # trigger point is independent of when the scope was entered.
        fired = None
        with self._lock:
            for rule in self._rules:
                if rule.kind not in ("ring_kill", "ring_sever"):
                    continue
                if rule.target not in path:
                    continue
                rule.hits += 1
                if rule.fires or seq != rule.nth:
                    continue
                self._record(rule, {"path": path, "write_seq": seq})
                fired = rule
                break
        if fired is None:
            return None
        if fired.kind == "ring_kill":
            return ("kill", fired.no_restart)
        return ("sever",)

    def actor_hook(self, method: str,
                   actor_name: str = "") -> Optional[Tuple]:
        rule = self._match(("actor_kill", "actor_raise"), method)
        if rule is not None:
            self._record(rule, {"method": method})
            if rule.kind == "actor_kill":
                return ("kill", rule.no_restart)
            return ("raise", rule.exc_type(
                f"[chaos] injected failure in {method!r} "
                f"(hit {rule.hits})"))
        # Load shaping: per-method slowdown, then whole-replica stall
        # (matched on the actor's display name, substring).
        rule = self._match(("actor_slow",), method)
        if rule is None and actor_name:
            rule = self._match(("actor_stall",), actor_name,
                               substring=True)
        if rule is None:
            return None
        delay = rule.delay_s
        if rule.jitter_s:
            with self._lock:
                delay += self._rng.random() * rule.jitter_s
        self._record(rule, {"method": method, "actor": actor_name,
                            "delay_s": round(delay, 4)})
        return ("slow", delay)


def schedule(seed: int = 0) -> ChaosSchedule:
    """A fresh, empty schedule (builder entry point)."""
    return ChaosSchedule(seed)


# ---------------------------------------------------------------------------
# Process-wide active schedule
# ---------------------------------------------------------------------------

_active: Optional[ChaosSchedule] = None
_active_lock = threading.Lock()


def _install(sched: ChaosSchedule) -> None:
    global _active
    with _active_lock:
        if _active is not None and _active is not sched:
            raise RuntimeError(
                "a chaos schedule is already active in this process")
        _active = sched


def _uninstall(sched: ChaosSchedule) -> None:
    global _active
    with _active_lock:
        if _active is sched:
            _active = None


def active(sched: ChaosSchedule):
    """Alias for ``with sched: ...`` (reads better at call sites that
    receive the schedule from elsewhere)."""
    return sched


def current() -> Optional[ChaosSchedule]:
    return _active


def _ensure_active(seed: int = 0) -> ChaosSchedule:
    """The active schedule, installing a fresh one process-wide if
    none is active — the imperative chaos API (partition_node /
    drop_heartbeats called as functions, soak-harness style) rides
    this.  Pair with :func:`reset` in teardown."""
    global _active
    with _active_lock:
        if _active is None:
            _active = ChaosSchedule(seed)
        return _active


def reset() -> None:
    """Deactivate whatever schedule is installed (test teardown for
    the imperative API; the context-manager API self-uninstalls)."""
    global _active
    with _active_lock:
        _active = None


def partition_node(substr: str, duration_s: float) -> ChaosSchedule:
    """Imperative form of :meth:`ChaosSchedule.partition_node`: start
    dropping RPCs from callers tagged ``substr`` NOW, for
    ``duration_s``, on the active (or a freshly installed) schedule."""
    return _ensure_active().partition_node(substr, duration_s)


def drop_heartbeats(frac: float, *,
                    duration_s: float = 0.0) -> ChaosSchedule:
    """Imperative form of :meth:`ChaosSchedule.drop_heartbeats`."""
    return _ensure_active().drop_heartbeats(frac,
                                            duration_s=duration_s)


# ---------------------------------------------------------------------------
# Head kill -9 (the control-plane chaos the vcluster soak is built on)
# ---------------------------------------------------------------------------

_head_proc = None
_head_proc_lock = threading.Lock()


def register_head_process(proc) -> None:
    """Tell chaos which subprocess is the head (cluster_utils /
    vcluster call this when they spawn one); ``kill_head()`` targets
    it."""
    global _head_proc
    with _head_proc_lock:
        _head_proc = proc


def kill_head(sig: Optional[int] = None):
    """SIGKILL the registered head process — a true kill -9: no
    snapshot flush, no socket teardown, journal possibly torn
    mid-record.  Returns the killed process object.  Raises
    RuntimeError when no head subprocess was registered (an in-process
    head cannot be kill -9'd without taking the test down too)."""
    import signal as _signal

    with _head_proc_lock:
        proc = _head_proc
    if proc is None or proc.poll() is not None:
        raise RuntimeError(
            "chaos.kill_head: no live head subprocess registered "
            "(spawn the head via tools.vcluster or register it with "
            "chaos.register_head_process)")
    proc.send_signal(_signal.SIGKILL if sig is None else sig)
    proc.wait(timeout=10.0)
    return proc


# ---------------------------------------------------------------------------
# Hook points (called by the runtime; near-zero cost when inactive)
# ---------------------------------------------------------------------------

def on_rpc(method: str, tag: str = "") -> None:
    """cluster/rpc.py: may raise ConnectionError (drop) or stall.
    ``tag`` names the caller for targeted rules (partition_node)."""
    sched = _active
    if sched is not None:
        sched.rpc_hook(method, tag)


def ring_write_action(path: str, seq: int) -> Optional[Tuple]:
    """experimental/channel.py, before the writer's ``seq``-th frame:
    None | ("kill", no_restart) | ("sever",)."""
    sched = _active
    if sched is None:
        return None
    return sched.ring_hook(path, seq)


def actor_task_action(method: str,
                      actor_name: str = "") -> Optional[Tuple]:
    """core/actor_runtime.py, before dispatching a method:
    None | ("kill", no_restart) | ("raise", exc) | ("slow", delay_s)."""
    sched = _active
    if sched is None:
        return None
    return sched.actor_hook(method, actor_name)


# ---------------------------------------------------------------------------
# Legacy env knob (superseded but still honored)
# ---------------------------------------------------------------------------

class EnvRpcBudget:
    """Parses ``RAY_TPU_TESTING_RPC_FAILURE="method=N,method2=M"`` and
    drops the first N calls of each listed method — the reference's
    static chaos knob (rpc_chaos.h:23), kept per-RpcClient so worker
    subprocesses inherit faults through the environment.  New code
    should prefer a :class:`ChaosSchedule`."""

    def __init__(self, spec: Optional[str] = None):
        self._budget: Dict[str, int] = {}
        self._lock = threading.Lock()
        spec = (os.environ.get("RAY_TPU_TESTING_RPC_FAILURE", "")
                if spec is None else spec)
        for part in spec.split(","):
            if "=" in part:
                method, n = part.split("=", 1)
                try:
                    self._budget[method.strip()] = int(n)
                except ValueError:
                    pass

    def maybe_fail(self, method: str) -> None:
        with self._lock:
            left = self._budget.get(method, 0)
            if left > 0:
                self._budget[method] = left - 1
                raise ConnectionError(
                    f"[chaos] injected rpc failure for {method!r}")


def env_rpc_budget() -> EnvRpcBudget:
    return EnvRpcBudget()

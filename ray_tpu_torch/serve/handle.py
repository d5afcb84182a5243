"""Deployment handles + the power-of-two-choices router.

Reference: serve/_private/handle.py:619 (``DeploymentHandle``) →
router.py:334/:559 (``AsyncioRouter.assign_request``) →
replica_scheduler/pow_2_scheduler.py:52 (power-of-two-choices over
replica queue lengths).  The router balances on client-local
outstanding counts PLUS each replica's self-reported queue depth,
piggybacked on every unary response — the cross-client load signal the
reference probes over RPC, here carried for free on the reply.

Overload robustness (Tail at Scale / DAGOR-style):

- ``handle.options(deadline_s=...)`` (or an ambient ingress deadline)
  mints an absolute end-to-end deadline carried with the request; the
  response's ``result()`` respects the remaining budget and raises a
  typed ``DeadlineExceededError``.
- A replica rejecting with ``PendingCallsLimitExceededError`` (bounded
  mailbox) is a *route-elsewhere* signal, not a failure: the router
  immediately re-picks; only when every replica rejects does the
  caller see a typed ``BackPressureError``.
- A per-replica CIRCUIT BREAKER trips after consecutive
  sick-replica strikes (deadline blowouts, deaths, overload
  rejections) and half-opens with single probes after a cooldown, so
  the router stops hammering a slow replica instead of queueing
  behind it.

Membership: the router re-checks the controller's membership version
at ~1 Hz (the reference's LongPoll channel, poll-based), so autoscaled
and rolling-updated replica sets take effect on live handles without
re-fetching them.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

from ..core import deadlines as _deadlines
from ..exceptions import (BackPressureError, DeadlineExceededError,
                          PendingCallsLimitExceededError)

_REFRESH_PERIOD_S = 1.0
# Bounded retries against dead replicas (routing re-resolves over the
# refreshed membership between attempts, with exponential backoff).
_DEAD_REPLICA_RETRIES = 3
_RETRY_BACKOFF_S = 0.05
# Circuit breaker: consecutive sick-replica strikes that open it, and
# how long it stays open before half-open single probes.
_BREAKER_THRESHOLD = 3
_BREAKER_COOLDOWN_S = 2.0

# The admission-control rejections the router routes AROUND (replica
# saturated, not broken) instead of failing the request.
_OVERLOAD_ERRORS = (PendingCallsLimitExceededError, BackPressureError)

# Replica responses piggyback their queue depth under this key
# (serve/replica.py wraps, DeploymentResponse.result unwraps).
_PIGGYBACK_KEY = "__serve_r__"


class NoLiveReplicasError(RuntimeError):
    """Every known replica is dead/evicted.  Retried like a dead
    replica (the controller's health check replaces replicas and bumps
    the membership version moments later); surfaces only once the
    bounded retries are exhausted."""


def _retry_backoff(attempt: int) -> None:
    time.sleep(min(_RETRY_BACKOFF_S * (2 ** attempt), 1.0))


def _unwrap(value):
    """Strip the replica's queue-depth piggyback envelope."""
    if isinstance(value, dict) and _PIGGYBACK_KEY in value:
        return value[_PIGGYBACK_KEY]
    return value


class _Breaker:
    """Per-replica circuit breaker state (guarded by the router lock)."""

    __slots__ = ("fails", "open_until", "probing")

    def __init__(self):
        self.fails = 0          # consecutive sick strikes
        self.open_until = 0.0   # monotonic; > now means OPEN
        self.probing = False    # a half-open probe is in flight

    def is_open(self) -> bool:
        return self.fails >= _BREAKER_THRESHOLD


class DeploymentResponse:
    """Future-like result of ``handle.remote()`` (reference:
    handle.py:326).  ``deadline`` is the request's absolute end-to-end
    deadline: ``result()`` never waits past it and raises a typed
    ``DeadlineExceededError`` when the budget runs out."""

    def __init__(self, ref, on_done, retry=None, deadline=None):
        self._ref = ref
        self._on_done = on_done
        self._done = False
        self._retry = retry
        self._deadline = deadline

    def _budget(self, timeout: Optional[float]) -> Optional[float]:
        left = _deadlines.remaining(self._deadline)
        if left is None:
            return timeout
        if left <= 0:
            raise DeadlineExceededError(
                "request deadline exceeded", deadline=self._deadline)
        return left if timeout is None else min(timeout, left)

    def result(self, timeout: Optional[float] = None):
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError

        attempts = 0
        while True:
            try:
                return _unwrap(ray_tpu_torch.get(self._ref,
                                           timeout=self._budget(timeout)))
            except _OVERLOAD_ERRORS:
                # The replica REJECTED the request (bounded mailbox /
                # batch queue) — it never ran, so re-routing elsewhere
                # is safe.  No backoff: rejections must stay fast, and
                # the router's breaker/depth state already steers the
                # re-pick away from the saturated replica.
                attempts += 1
                if self._retry is None or attempts > _DEAD_REPLICA_RETRIES:
                    raise
                self._ref = self._retry(dead=False)
            except ActorDiedError:
                # The replica died or was stopped (crash, autoscale-
                # down, rolling update) between our membership snapshot
                # and the call: re-resolve routing over the refreshed
                # set and retry against a live replica, with backoff so
                # a controller mid-update has time to converge
                # (reference: the router retries failed replicas).
                attempts += 1
                if self._retry is None or attempts > _DEAD_REPLICA_RETRIES:
                    raise
                _retry_backoff(attempts - 1)
                if _deadlines.expired(self._deadline):
                    raise DeadlineExceededError(
                        "request deadline exceeded during replica "
                        "failover", deadline=self._deadline) from None
                self._ref = self._retry()
            except GetTimeoutError:
                if _deadlines.expired(self._deadline):
                    raise DeadlineExceededError(
                        "request deadline exceeded while waiting for "
                        "the replica", deadline=self._deadline) from None
                raise

    def _settle(self):
        # Called exactly once, from the ref's completion callback —
        # result() must NOT settle (a timed-out result() would release
        # the routing slot while the request still runs).
        self._done = True
        self._on_done()

    @property
    def ref(self):
        """The raw ObjectRef.  NOTE: its sealed value is the replica's
        piggyback envelope ``{"__serve_r__": <user value>, "q": depth}``
        — ``result()`` unwraps it; a caller doing ``ray_tpu_torch.get(ref)``
        directly must unwrap with ``serve.handle._unwrap``."""
        return self._ref


class DeploymentResponseGenerator:
    """Iterates a streaming deployment response: yields VALUES as the
    replica yields them (reference: DeploymentResponseGenerator).
    ``deadline`` bounds every item wait: a stream stalling past the
    request budget raises a typed ``DeadlineExceededError`` instead of
    blocking the consumer forever."""

    def __init__(self, ref_generator, on_done, deadline=None,
                 on_verdict=None):
        self._gen = ref_generator
        self._on_done = on_done
        self._done = False
        self._deadline = deadline
        # Router health feedback: streams have no completion callback,
        # so the finish path must report sick-vs-healthy itself — a
        # half-open breaker probe routed to a stream would otherwise
        # stay "probing" forever and quarantine the replica.
        self._on_verdict = on_verdict

    def __iter__(self):
        return self

    def _budget(self):
        left = _deadlines.remaining(self._deadline)
        if left is not None and left <= 0:
            # The budget ran out BETWEEN item waits — on the consumer's
            # clock (slow per-item processing), not the replica's: no
            # sick-replica strike, or slow consumers with short
            # deadlines would circuit-break healthy replicas.  ok=None
            # frees a half-open probe without recording a verdict.
            self._finish(ok=None)
            raise DeadlineExceededError(
                "streaming response: request deadline exceeded",
                deadline=self._deadline)
        return left

    def __next__(self):
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import GetTimeoutError

        left = self._budget()
        try:
            if left is not None and hasattr(self._gen, "next_ref"):
                ref = self._gen.next_ref(timeout=left)
            else:
                ref = next(self._gen)
        except StopIteration:
            self._finish()
            raise
        except GetTimeoutError:
            self._finish(ok=False)
            raise DeadlineExceededError(
                "streaming response: request deadline exceeded "
                "waiting for the next item",
                deadline=self._deadline) from None
        try:
            return ray_tpu_torch.get(ref, timeout=self._budget())
        except GetTimeoutError:
            if _deadlines.expired(self._deadline):
                self._finish(ok=False)
                raise DeadlineExceededError(
                    "streaming response: request deadline exceeded",
                    deadline=self._deadline) from None
            raise
        except BaseException as e:
            from ray_tpu_torch.exceptions import ActorDiedError

            # A replica death or overload rejection mid-stream is a
            # sick-replica strike; user-code errors are healthy
            # responses (mirrors _Router.on_response).
            self._finish(ok=not isinstance(
                e, (ActorDiedError, DeadlineExceededError)
                + _OVERLOAD_ERRORS))
            raise

    def _finish(self, ok: Optional[bool] = True):
        """``ok=None`` means NO verdict (consumer-side abort): the
        router frees any half-open probe but records neither a success
        nor a strike."""
        if not self._done:
            self._done = True
            try:
                self._on_done()
            except Exception:
                pass
            if self._on_verdict is not None:
                try:
                    self._on_verdict(ok)
                except Exception:
                    pass

    def close(self):
        """Release the routing slot without draining (early-exit
        consumers must not leak outstanding counts; an early exit is
        neither a replica failure nor PROOF of health — a half-open
        probe abandoned here must not close the breaker)."""
        self._finish(ok=None)

    def __del__(self):
        self._finish(ok=None)


class _Router:
    """Shared routing state for every view of one deployment's handle:
    replica set, per-replica outstanding counts, membership version."""

    def __init__(self, deployment_name: str, replicas: List[Any],
                 controller=None, version: int = -1,
                 roles: Optional[List[str]] = None,
                 ingress_role: Optional[str] = None):
        self.deployment_name = deployment_name
        self._controller = controller
        self._version = version
        self._lock = threading.Lock()
        self._replicas = list(replicas)
        # Disaggregated-serving roles (prefill | decode | both), keyed
        # like everything else by replica id; ``_ingress_role`` is the
        # default pick() filter when the caller names none (prefill
        # replicas front a disaggregated LLM deployment).
        self._roles: Dict[Any, str] = {}
        if roles:
            for r, role in zip(self._replicas, roles):
                self._roles[self._key(r)] = role
        self._ingress_role = ingress_role
        # Keyed by replica actor id so counts survive membership swaps.
        self._outstanding: Dict[Any, int] = {
            self._key(r): 0 for r in self._replicas}
        # Replica-reported queue depth (ongoing + mailbox), piggybacked
        # on every unary response — the cross-client load signal.
        # Stored as (depth, monotonic timestamp): a report only counts
        # while fresh, or a replica that once reported high depth and
        # then stopped receiving traffic would be starved on a stale
        # signal it can never refresh.
        self._depth: Dict[Any, tuple] = {}
        # Per-replica circuit breakers (sick-replica avoidance).
        self._breakers: Dict[Any, _Breaker] = {}
        # model_id -> replica key: multiplexed requests prefer the
        # replica already holding their model (pow_2_scheduler.py:52
        # model-affinity tier; client-local view).
        self._model_affinity: Dict[str, Any] = {}
        self._last_refresh = time.monotonic()

    @staticmethod
    def _key(replica):
        return getattr(replica, "_actor_id", id(replica))

    @staticmethod
    def _key_label(key) -> str:
        hexfn = getattr(key, "hex", None)
        return hexfn()[:16] if callable(hexfn) else str(key)[:16]

    def _breaker_gauge(self, key, state: int):
        try:
            from ..observability.metrics import overload_counters

            overload_counters()["breaker_state"].set(
                state, tags={"deployment": self.deployment_name,
                             "replica": self._key_label(key)})
        except Exception:
            pass

    def _breaker_gauge_remove(self, key):
        """Drop a departed replica's breaker series: rolling updates
        mint fresh replica ids every version, so without removal the
        gauge registry grows per-deploy and dead replicas export their
        last state forever."""
        try:
            from ..observability.metrics import overload_counters

            overload_counters()["breaker_state"].remove(
                tags={"deployment": self.deployment_name,
                      "replica": self._key_label(key)})
        except Exception:
            pass

    # -- load + health signals (fed from completion callbacks) ----------
    # How long a piggybacked depth report stays a routing signal.
    _DEPTH_TTL_S = 3.0

    def note_depth(self, key, depth) -> None:
        with self._lock:
            if key in self._outstanding:
                self._depth[key] = (int(depth), time.monotonic())

    def record_success(self, key) -> None:
        """Any successful (or plain-user-error) response closes the
        replica's breaker: strikes must be CONSECUTIVE to open it."""
        with self._lock:
            b = self._breakers.get(key)
            if b is None or (b.fails == 0 and not b.probing):
                return
            b.fails = 0
            b.open_until = 0.0
            b.probing = False
        self._breaker_gauge(key, 0)

    def record_failure(self, key) -> None:
        """A sick-replica strike (death, deadline blowout, overload
        rejection).  After ``_BREAKER_THRESHOLD`` consecutive strikes
        the breaker opens for ``_BREAKER_COOLDOWN_S``; a failed
        half-open probe re-opens it."""
        tripped = False
        with self._lock:
            b = self._breakers.setdefault(key, _Breaker())
            was_open = b.is_open()
            b.fails += 1
            b.probing = False
            open_now = b.is_open()
            if open_now:
                b.open_until = time.monotonic() + _BREAKER_COOLDOWN_S
                tripped = not was_open
        if open_now:
            self._breaker_gauge(key, 2)
        if tripped:
            try:
                from ..observability.metrics import overload_counters

                overload_counters()["breaker_trips"].inc(
                    tags={"deployment": self.deployment_name})
            except Exception:
                pass

    # Depth-peek budget: the piggyback envelope rides INSIDE the sealed
    # payload, so reading it costs a full deserialization on the
    # completion-callback (RPC reader) thread, on top of the one
    # ``result()`` pays.  Only pay it for small responses — the depth
    # signal is advisory (outstanding counts + the next small reply
    # cover the gap), and located-only objects (cluster mode, large
    # results) aren't materialized here at all: ``.value`` would raise.
    _DEPTH_PEEK_MAX_BYTES = 64 * 1024

    def on_response(self, key, obj) -> None:
        """Completion-callback classifier: feed the breaker and the
        piggybacked depth from one sealed response object.  Must never
        raise — it runs inside the object-store completion fan-out."""
        err = getattr(obj, "error", None)
        if err is None:
            self.record_success(key)
            try:
                located = getattr(obj, "is_located_only", None)
                if ((located is None or not located())
                        and getattr(obj, "size_bytes", 0)
                        <= self._DEPTH_PEEK_MAX_BYTES):
                    value = getattr(obj, "value", None)
                else:
                    value = None
            except Exception:
                value = None
            if isinstance(value, dict) and _PIGGYBACK_KEY in value:
                q = value.get("q")
                if q is not None:
                    self.note_depth(key, q)
            return
        from ray_tpu_torch.exceptions import ActorDiedError

        if isinstance(err, (ActorDiedError, DeadlineExceededError)
                      + _OVERLOAD_ERRORS):
            self.record_failure(key)
        else:
            # A user-code exception IS a response: the replica is
            # healthy enough to answer.
            self.record_success(key)

    def force_refresh(self):
        self._last_refresh = 0.0
        self._maybe_refresh()

    def _maybe_refresh(self):
        if self._controller is None:
            return
        now = time.monotonic()
        if now - self._last_refresh < _REFRESH_PERIOD_S:
            return
        self._last_refresh = now
        import ray_tpu_torch

        try:
            update = ray_tpu_torch.get(self._controller.get_membership.remote(
                self.deployment_name, self._version), timeout=10.0)
        except Exception:
            return  # keep routing over the known set
        if update is None:
            return
        with self._lock:
            self._version = update["version"]
            self._replicas = list(update["replicas"])
            roles = update.get("roles")
            self._roles = ({self._key(r): role for r, role
                            in zip(self._replicas, roles)}
                           if roles else {})
            if "ingress_role" in update:
                self._ingress_role = update["ingress_role"]
            fresh = {}
            for r in self._replicas:
                k = self._key(r)
                fresh[k] = self._outstanding.get(k, 0)
            self._outstanding = fresh
            self._depth = {k: d for k, d in self._depth.items()
                           if k in fresh}
            departed = [k for k in self._breakers if k not in fresh]
            self._breakers = {k: b for k, b in self._breakers.items()
                              if k in fresh}
        for k in departed:
            self._breaker_gauge_remove(k)

    # A model-affine replica is used unless it's this much busier than
    # the least-loaded one (load still wins over cache warmth past it).
    _AFFINITY_SLACK = 8

    def _score(self, key) -> int:
        """Routing load: the larger of client-local outstanding and the
        replica's last FRESH self-reported queue depth (piggybacked on
        responses).  MAX, not sum: the reported depth already includes
        this client's own queued requests, so adding them would
        double-count and systematically bias pow-2 away from replicas
        this handle is using.  max() keeps whichever estimate of the
        replica's total load is larger — local outstanding when the
        report is behind our submissions, reported depth when other
        clients dominate."""
        score = self._outstanding.get(key, 0)
        d = self._depth.get(key)
        if d is not None and time.monotonic() - d[1] < self._DEPTH_TTL_S:
            score = max(score, d[0])
        return score

    def _admissible(self, key, now: float) -> bool:
        """Breaker gate (caller holds the lock; NO side effects):
        closed replicas pass; an open one passes only once its cooldown
        elapsed and no half-open probe is already in flight."""
        b = self._breakers.get(key)
        if b is None or not b.is_open():
            return True
        return now >= b.open_until and not b.probing

    def _mark_probe_if_open(self, key) -> None:
        """The request actually ROUTED to an open-breaker replica is
        its single half-open probe (caller holds the lock).  Marking at
        candidacy instead would burn the probe slot on replicas pow-2
        then didn't choose."""
        b = self._breakers.get(key)
        if b is not None and b.is_open():
            b.probing = True
            self._breaker_gauge(key, 1)

    def abort_probe(self, key) -> None:
        """A routed request died CLIENT-SIDE before reaching the
        replica (e.g. argument serialization failed).  If it was the
        half-open probe, free the slot WITHOUT recording a verdict —
        leaving ``probing`` set would make ``_admissible`` return False
        forever and permanently quarantine a healthy replica."""
        with self._lock:
            b = self._breakers.get(key)
            if b is not None:
                b.probing = False

    def _role_ok(self, key, role: Optional[str]) -> bool:
        """Role gate: a requested role matches replicas of that role
        or of role "both"; unknown replicas (no role info) pass."""
        if role is None:
            return True
        have = self._roles.get(key)
        return have is None or have == role or have == "both"

    def pick(self, model_id: str = "", role: Optional[str] = None):
        """Power-of-two-choices on outstanding + reported queue depth,
        with a model-affinity tier for multiplexed requests, a
        circuit-breaker gate, and (disaggregated deployments) a
        replica-role filter; returns (replica, key)."""
        self._maybe_refresh()
        now = time.monotonic()
        with self._lock:
            if role is None:
                role = self._ingress_role
            pool = [r for r in self._replicas
                    if self._role_ok(self._key(r), role)]
            if not pool:
                raise NoLiveReplicasError(
                    f"deployment {self.deployment_name!r} has no live "
                    f"replicas"
                    + (f" of role {role!r}" if role else ""))
            if model_id:
                by_key = {self._key(r): r for r in pool}
                k = self._model_affinity.get(model_id)
                if k in by_key and self._admissible(k, now):
                    least = min(self._score(self._key(r))
                                for r in pool)
                    if self._score(k) <= least + self._AFFINITY_SLACK:
                        self._mark_probe_if_open(k)
                        self._outstanding[k] = \
                            self._outstanding.get(k, 0) + 1
                        return by_key[k], k
            candidates = [i for i, r in enumerate(pool)
                          if self._admissible(self._key(r), now)]
            if not candidates:
                # Every replica's breaker is open and cooling: degrade
                # to least-loaded rather than failing outright (the
                # breaker is an avoidance bias, not an outage switch).
                candidates = list(range(len(pool)))
            if len(candidates) == 1:
                idx = candidates[0]
            else:
                a, b = random.sample(candidates, 2)
                ka = self._key(pool[a])
                kb = self._key(pool[b])
                idx = a if self._score(ka) <= self._score(kb) else b
            replica = pool[idx]
            k = self._key(replica)
            self._mark_probe_if_open(k)
            if model_id:
                self._model_affinity[model_id] = k
            self._outstanding[k] = self._outstanding.get(k, 0) + 1
            return replica, k

    def release(self, key):
        with self._lock:
            if key in self._outstanding:
                self._outstanding[key] -= 1

    def mark_dead(self, key):
        """Evict a replica observed dead (ActorDiedError) from the
        routing set.  Without this, power-of-two keeps choosing it: a
        dead replica fails instantly, so its outstanding count reads
        as least-loaded.  The next membership VERSION bump (controller
        health check replacing the replica) repopulates the set."""
        with self._lock:
            self._replicas = [r for r in self._replicas
                              if self._key(r) != key]
            self._outstanding.pop(key, None)
            self._depth.pop(key, None)
            self._breakers.pop(key, None)
            self._model_affinity = {m: k for m, k in
                                    self._model_affinity.items()
                                    if k != key}
        self._breaker_gauge_remove(key)


class DeploymentHandle:
    def __init__(self, deployment_name: str, replicas: List[Any],
                 method_name: str = "", controller=None,
                 version: int = -1, _router: Optional[_Router] = None,
                 stream: bool = False, multiplexed_model_id: str = "",
                 deadline_s: Optional[float] = None,
                 roles: Optional[List[str]] = None,
                 ingress_role: Optional[str] = None,
                 role: Optional[str] = None):
        self.deployment_name = deployment_name
        self._router = _router or _Router(deployment_name, replicas,
                                          controller, version,
                                          roles=roles,
                                          ingress_role=ingress_role)
        self._method = method_name
        self._stream = stream
        self._model_id = multiplexed_model_id
        self._deadline_s = deadline_s
        # Explicit replica-role target for this view (None = the
        # deployment's ingress default).
        self._role = role

    # -- calls -------------------------------------------------------------
    def remote(self, *args, **kwargs):
        from ..observability import tracing

        # Mint the request's absolute deadline: an explicit
        # options(deadline_s=...) wins, else inherit the ambient scope
        # (an ingress header, a parent task's budget).  Already-expired
        # requests shed HERE — before routing ever runs.
        deadline = _deadlines.for_submission(self._deadline_s)
        if _deadlines.expired(deadline):
            from ..observability.metrics import overload_counters

            overload_counters()["expired_shed"].inc(
                tags={"where": "router"})
            raise DeadlineExceededError(
                f"request to {self.deployment_name!r} shed at the "
                f"router: deadline exceeded", deadline=deadline,
                context={"where": "router"})
        if self._stream:
            with tracing.span(
                    f"serve:{self.deployment_name}."
                    f"{self._method or 'call'}"), \
                    _deadlines.scope(deadline):
                return self._remote_streaming(args, kwargs)
        # Each serve request is a driver-side root operation: the span
        # covers routing + submission, and the replica-side task span
        # attaches to the same trace (the deadline scope makes the
        # replica-bound task spec inherit the request budget).
        with tracing.span(f"serve:{self.deployment_name}."
                          f"{self._method or 'call'}"), \
                _deadlines.scope(deadline):
            ref, release, key = self._issue(args, kwargs)
        last_key = [key]

        def retry(dead: bool = True):
            # The failed attempt's slot was already released by its
            # completion callback (error seals fire it too) — releasing
            # here again would drive the dead replica's count negative
            # and bias the router TOWARD it.  A DEAD replica is evicted
            # from the routing set before re-resolving; an OVERLOADED
            # one stays (its breaker/depth state steers the re-pick
            # away) — it is saturated, not broken.
            if dead:
                self._router.mark_dead(last_key[0])
                self._router.force_refresh()
            with _deadlines.scope(deadline):
                new_ref, new_release, new_key = self._issue(args, kwargs)
            last_key[0] = new_key
            resp._on_done = new_release
            new_ref._on_completed(
                lambda o: (self._router.on_response(new_key, o),
                           new_release()))
            return new_ref

        resp = DeploymentResponse(ref, on_done=release, retry=retry,
                                  deadline=deadline)
        # Release the slot when the result lands even if .result() is
        # never called, and feed the router's breaker + depth state
        # from the sealed response (completion callback keeps counts
        # truthful).
        ref._on_completed(lambda o: (self._router.on_response(key, o),
                                     resp._settle()))
        return resp

    def _remote_streaming(self, args, kwargs):
        """Streaming response (reference: handle.options(stream=True),
        handle.py:496): routes to the replica's generator endpoint;
        returns a DeploymentResponseGenerator yielding values as the
        replica yields them (cross-node: streaming-generator item
        reporting).  Submission-time dead replicas get the same
        evict + refresh + backoff treatment as unary calls (mid-stream
        failures are NOT retried — items already yielded would
        duplicate)."""
        gen, key = self._submit_with_failover(
            lambda replica: replica.handle_request_streaming.options(
                num_returns="streaming").remote(
                self._method, args, kwargs, self._model_id))

        def verdict(ok: Optional[bool]):
            if ok is None:
                # Consumer-side deadline expiry between items: not the
                # replica's fault — free any half-open probe slot
                # without recording a verdict either way.
                self._router.abort_probe(key)
            elif ok:
                self._router.record_success(key)
            else:
                self._router.record_failure(key)

        return DeploymentResponseGenerator(
            gen, on_done=lambda: self._router.release(key),
            deadline=_deadlines.current(), on_verdict=verdict)

    def _submit_with_failover(self, submit):
        """Route + submit with failover: a replica whose actor table
        already reports it dead is evicted from the router and the
        request re-routed over refreshed membership (bounded retries
        with backoff); a replica REJECTING on its bounded mailbox
        (``PendingCallsLimitExceededError``) is a route-elsewhere
        signal — re-pick immediately, no backoff, and surface a typed
        ``BackPressureError`` only when every attempt rejected.
        Returns (ref_or_gen, routing key); the caller owns releasing
        the key."""
        from ray_tpu_torch.exceptions import ActorDiedError

        rejections = 0
        for attempt in range(_DEAD_REPLICA_RETRIES + 1):
            try:
                replica, key = self._router.pick(self._model_id,
                                                 role=self._role)
            except NoLiveReplicasError:
                # Router drained by mark_dead: ride out the window
                # until the controller's health check repopulates the
                # membership (same backoff as a dead replica).
                if attempt >= _DEAD_REPLICA_RETRIES:
                    raise
                _retry_backoff(attempt)
                self._router.force_refresh()
                continue
            try:
                return submit(replica), key
            except _OVERLOAD_ERRORS as e:
                # Saturated, not broken: give the slot back, strike the
                # breaker (consecutive rejections open it), and re-pick
                # — depth/outstanding already steer away.  Rejections
                # must stay FAST: no backoff sleeps on this path.
                self._router.release(key)
                self._router.record_failure(key)
                rejections += 1
                if attempt >= _DEAD_REPLICA_RETRIES:
                    from ..observability.metrics import overload_counters

                    overload_counters()["backpressure"].inc(
                        tags={"where": "router"})
                    raise BackPressureError(
                        f"deployment {self.deployment_name!r}: every "
                        f"routing attempt rejected "
                        f"({rejections} rejections)",
                        retry_after_s=_BREAKER_COOLDOWN_S / 4,
                        context={"deployment": self.deployment_name}
                    ) from e
            except ActorDiedError:
                self._router.release(key)
                self._router.mark_dead(key)
                if attempt >= _DEAD_REPLICA_RETRIES:
                    raise
                _retry_backoff(attempt)
                self._router.force_refresh()
            except BaseException:
                # Unexpected submission failure: give the slot back or
                # the router is permanently biased away from this
                # replica, and free any half-open probe slot this
                # request held (the replica never saw it — no verdict).
                self._router.release(key)
                self._router.abort_probe(key)
                raise

    def _issue(self, args, kwargs):
        ref, key = self._submit_with_failover(
            lambda replica: replica.handle_request.remote(
                self._method, args, kwargs, self._model_id))
        fired = [False]

        def release_once():
            # Single-fire: both the completion callback and explicit
            # paths may call this; the count must drop exactly once.
            if not fired[0]:
                fired[0] = True
                self._router.release(key)

        return ref, release_once, key

    def options(self, *, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                multiplexed_model_id: Optional[str] = None,
                deadline_s: Optional[float] = None,
                role: Optional[str] = None
                ) -> "DeploymentHandle":
        # Views share the router, so balance and membership are global
        # across method-scoped views of the same handle.
        return DeploymentHandle(
            self.deployment_name, [],
            method_name if method_name is not None else self._method,
            _router=self._router,
            stream=self._stream if stream is None else stream,
            multiplexed_model_id=(self._model_id
                                  if multiplexed_model_id is None
                                  else multiplexed_model_id),
            deadline_s=(self._deadline_s if deadline_s is None
                        else deadline_s),
            role=self._role if role is None else role)

    @property
    def method(self):
        class _MethodProxy:
            def __init__(proxy, handle):
                proxy._handle = handle

            def __getattr__(proxy, name):
                return proxy._handle.options(method_name=name)

        return _MethodProxy(self)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

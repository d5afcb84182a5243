"""The port's copy of ``tests/test_overload.py``, run against ray_tpu_torch
(its own runtime fixtures: ``_torch_runtime.py``).

Overload-robust request plane: end-to-end deadlines, admission
control, and load shedding from ingress to actor mailbox.

Acceptance: deadline propagates driver → RPC envelope →
actor mailbox → batch flush; already-expired work sheds typed without
running user code; bounded mailboxes reject with
``BackPressureError``/``PendingCallsLimitExceededError`` (HTTP 503 +
Retry-After / gRPC UNAVAILABLE); the router routes around saturated
replicas and circuit-breaks sick ones; and the chaos overload soak
proves goodput under 2× load with one stalled replica.
"""

import asyncio
import json
import math
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.core import deadlines
from ray_tpu_torch.exceptions import (BackPressureError, DeadlineExceededError,
                                PendingCallsLimitExceededError)
from ray_tpu_torch.experimental import chaos
from ray_tpu_torch.observability import metrics
from _torch_runtime import ray_start_regular, shutdown_only  # noqa: F401

pytestmark = pytest.mark.overload


@pytest.fixture
def serve_session(ray_start_regular):
    yield
    serve.shutdown()


def _metric_total(name: str) -> float:
    return sum((metrics.metrics_summary().get(name) or {}).values())


# ------------------------------------------------------------- deadlines
def test_deadline_option_reaches_task_context(ray_start_regular):
    @ray_tpu_torch.remote
    def budget():
        return ray_tpu_torch.get_runtime().runtime_context.remaining_deadline_s()

    assert ray_tpu_torch.get(budget.remote(), timeout=10) is None
    left = ray_tpu_torch.get(budget.options(deadline_s=5.0).remote(),
                       timeout=10)
    assert left is not None and 3.0 < left <= 5.0


def test_nested_submission_inherits_deadline(ray_start_regular):
    @ray_tpu_torch.remote
    def leaf():
        return ray_tpu_torch.get_runtime().runtime_context.get_deadline()

    @ray_tpu_torch.remote
    def parent():
        # No explicit option here: the child inherits the parent's
        # remaining budget through the ambient deadline scope.
        return ray_tpu_torch.get(leaf.remote(), timeout=10)

    dl = ray_tpu_torch.get(parent.options(deadline_s=5.0).remote(), timeout=10)
    assert dl is not None and 3.0 < dl - time.time() <= 5.0


def test_actor_mailbox_sheds_expired_without_running(ray_start_regular):
    ran = []

    @ray_tpu_torch.remote
    class A:
        def blocker(self):
            time.sleep(0.5)
            return "done"

        def victim(self):
            ran.append("victim")
            return "ran"

    before = _metric_total("ray_tpu_requests_expired_shed")
    a = A.remote()
    b = a.blocker.remote()
    v = a.victim.options(deadline_s=0.1).remote()  # queues behind blocker
    with pytest.raises(DeadlineExceededError):
        ray_tpu_torch.get(v, timeout=10)
    assert ray_tpu_torch.get(b, timeout=10) == "done"
    assert ran == [], "shed task must never run user code"
    assert _metric_total("ray_tpu_requests_expired_shed") >= before + 1


def test_async_actor_deadline_isolation(ray_start_regular):
    """Concurrent requests on one async actor's event loop must not
    leak deadlines into each other (ContextVar, not threading.local):
    request B's expired budget must never poison request A's nested
    get()."""
    @ray_tpu_torch.remote
    def child():
        return "c"

    @ray_tpu_torch.remote
    class A:
        async def no_deadline(self):
            await asyncio.sleep(0.15)  # B's deadline installs meanwhile
            return ray_tpu_torch.get(child.remote(), timeout=10)

        async def with_deadline(self):
            await asyncio.sleep(0.4)   # suspended past its own budget
            return "b"

    a = A.remote()
    ra = a.no_deadline.remote()
    rb = a.with_deadline.options(deadline_s=0.05).remote()
    # A must succeed even though B's (long-expired) deadline was
    # installed on the shared loop while A was suspended.
    assert ray_tpu_torch.get(ra, timeout=10) == "c"
    assert ray_tpu_torch.get(rb, timeout=10) == "b"


def test_batch_rejection_typed_through_serve(serve_session):
    """A BackPressureError raised inside replica user code (batch
    queue overflow) must reach the caller TYPED, not wrapped in
    TaskError — the proxies' 503/UNAVAILABLE mapping depends on it."""
    @serve.deployment
    class B:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.3,
                     max_queue_size=2)
        async def run(self, xs):
            return list(xs)

        async def __call__(self, x):
            return await self.run(x)

    h = serve.run(B.bind())
    r1 = h.remote(1)
    r2 = h.remote(2)
    time.sleep(0.05)  # both coalescing in the bounded batch queue
    with pytest.raises(BackPressureError):
        h.remote(3).result(timeout=5)
    assert r1.result(timeout=5) == 1
    assert r2.result(timeout=5) == 2


def test_get_respects_ambient_deadline(ray_start_regular):
    @ray_tpu_torch.remote
    def never():
        time.sleep(30)

    ref = never.remote()
    t0 = time.monotonic()
    with deadlines.scope(time.time() + 0.3):
        with pytest.raises(DeadlineExceededError):
            ray_tpu_torch.get(ref)  # no explicit timeout: the scope bounds it
    assert time.monotonic() - t0 < 5.0
    ray_tpu_torch.cancel(ref, force=True)


# ----------------------------------------------------------- rpc envelope
def test_rpc_envelope_fifth_field_roundtrip():
    from ray_tpu_torch.cluster import rpc as rpc_mod

    a, b = socket.socketpair()
    lock = threading.Lock()
    try:
        rpc_mod._send_msg(a, "req", "id1", "m", {"x": 1}, lock,
                          trace=("t", "s"), deadline=123.5)
        kind, rid, method, raw, is_raw, trace, dl = rpc_mod._recv_msg(b)
        assert (kind, rid, method, is_raw) == ("req", "id1", "m", False)
        assert trace == ("t", "s") and dl == 123.5
        # raw frame carries it too
        rpc_mod._send_msg(a, "req", "id2", "m", b"bytes", lock,
                          deadline=9.0)
        kind, rid, _m, raw, is_raw, trace, dl = rpc_mod._recv_msg(b)
        assert is_raw and raw == b"bytes" and trace is None and dl == 9.0
        # legacy 3-field envelope still decodes (no deadline, no trace)
        rpc_mod._send_msg(a, "req", "id3", "m", None, lock)
        *_rest, trace, dl = rpc_mod._recv_msg(b)
        assert trace is None and dl is None
    finally:
        a.close()
        b.close()


def test_rpc_server_installs_deadline_scope():
    from ray_tpu_torch.cluster.rpc import RpcClient, RpcServer

    srv = RpcServer({"dl": lambda p: deadlines.current()})
    cl = RpcClient(srv.address)
    try:
        assert cl.call("dl", {}, timeout=10) is None
        want = time.time() + 7.0
        with deadlines.scope(want):
            got = cl.call("dl", {}, timeout=10)
        assert got is not None and abs(got - want) < 0.001
    finally:
        cl.close()
        srv.shutdown()


# -------------------------------------------------- serve: deadline plane
def test_serve_deadline_propagates_and_sheds(serve_session):
    @serve.deployment(max_ongoing_requests=1, max_queued_requests=8)
    class Obs:
        def __init__(self):
            self.ran = []

        async def __call__(self, tag):
            self.ran.append(tag)
            rc = ray_tpu_torch.get_runtime().runtime_context
            if tag == "blocker":
                await asyncio.sleep(0.5)
            return rc.get_deadline()

        async def ran_list(self):
            return list(self.ran)

    before = _metric_total("ray_tpu_requests_expired_shed")
    h = serve.run(Obs.bind())
    # (a) a deadline set at handle.remote() is observable in the
    # replica's task context
    dl = h.options(deadline_s=5.0).remote("probe").result(timeout=10)
    assert dl is not None and 3.0 < dl - time.time() <= 5.0
    # (b) an already-expired queued request sheds at dequeue without
    # running user code
    blocker = h.remote("blocker")
    victim = h.options(deadline_s=0.15).remote("victim")
    with pytest.raises(DeadlineExceededError):
        victim.result()
    blocker.result(timeout=10)
    time.sleep(0.2)  # let the mailbox drain the shed entry
    assert "victim" not in h.ran_list.remote().result(timeout=10)
    assert _metric_total("ray_tpu_requests_expired_shed") >= before + 1


def test_streaming_response_respects_deadline(serve_session):
    @serve.deployment
    class Stream:
        async def gen(self, n):
            for i in range(n):
                yield i
                if i == 1:
                    await asyncio.sleep(5.0)  # stall mid-stream

    h = serve.run(Stream.bind())
    gen = h.options(stream=True, method_name="gen",
                    deadline_s=0.5).remote(5)
    assert next(gen) == 0
    assert next(gen) == 1
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceededError):
        next(gen)  # the stall outlives the request budget
    assert time.monotonic() - t0 < 2.0


# ------------------------------------------- serve: admission + breaker
def test_router_routes_around_saturated_replica(serve_session):
    @serve.deployment(num_replicas=2, max_ongoing_requests=1,
                      max_queued_requests=1)
    class Slow:
        async def __call__(self, x):
            await asyncio.sleep(0.3)
            return x

    h = serve.run(Slow.bind())
    # Deployment-wide capacity is exactly 4 (2 executing + 2 queued):
    # all 4 only fit if the router spreads around each full mailbox.
    # Staggered slightly: a submission landing before the previous
    # one's DEQUEUE still counts it as mailbox-queued (that latency is
    # not the property under test).
    resps = []
    for i in range(4):
        resps.append(h.remote(i))
        time.sleep(0.05)
    assert sorted(r.result(timeout=10) for r in resps) == [0, 1, 2, 3]


def test_backpressure_typed_when_every_replica_full(serve_session):
    @serve.deployment(max_ongoing_requests=1, max_queued_requests=1)
    class Slow:
        async def __call__(self, x):
            await asyncio.sleep(0.5)
            return x

    before = _metric_total("ray_tpu_backpressure_rejections")
    h = serve.run(Slow.bind())
    accepted, rejected = [], []
    t_rej = []
    for i in range(6):
        t0 = time.monotonic()
        try:
            accepted.append(h.remote(i))
        except BackPressureError as e:
            t_rej.append(time.monotonic() - t0)
            rejected.append(e)
    assert len(accepted) == 2 and len(rejected) == 4
    for e in rejected:
        assert e.retry_after_s is not None and e.retry_after_s > 0
    # rejections are FAST (no backoff sleeps on the rejection path)
    assert max(t_rej) < 0.25
    for r in accepted:
        r.result(timeout=10)
    assert _metric_total("ray_tpu_backpressure_rejections") > before


def test_circuit_breaker_opens_and_half_opens():
    from ray_tpu_torch.serve.handle import (_BREAKER_COOLDOWN_S,
                                      _BREAKER_THRESHOLD, _Router)

    class FakeReplica:
        def __init__(self, k):
            self._actor_id = k

    r = _Router("dep", [FakeReplica("a"), FakeReplica("b")])
    for _ in range(_BREAKER_THRESHOLD):
        r.record_failure("a")
    # open: every pick avoids the sick replica
    for _ in range(20):
        _replica, k = r.pick()
        r.release(k)
        assert k == "b"
    # half-open after the cooldown: exactly one probe admits "a"
    brk = r._breakers["a"]
    brk.open_until = time.monotonic() - 0.01  # fast-forward the cooldown
    picked = set()
    for _ in range(40):
        _replica, k = r.pick()
        r.release(k)
        picked.add(k)
    assert picked == {"a", "b"}, "half-open must admit a single probe"
    assert brk.probing, "only ONE probe until it resolves"
    # a successful probe closes the breaker
    r.record_success("a")
    assert r._breakers["a"].fails == 0
    assert _BREAKER_COOLDOWN_S > 0


# ----------------------------------------------------------- @serve.batch
def test_batch_queue_cap_rejects():
    from ray_tpu_torch.serve.batching import batch

    calls = []

    @batch(max_batch_size=100, batch_wait_timeout_s=0.2,
           max_queue_size=3)
    async def fn(items):
        calls.append(list(items))
        return [i * 2 for i in items]

    async def main():
        waiters = [asyncio.ensure_future(fn(i)) for i in range(3)]
        await asyncio.sleep(0)  # let the submissions enqueue
        with pytest.raises(BackPressureError) as ei:
            await fn(99)
        assert ei.value.retry_after_s is not None
        return await asyncio.gather(*waiters)

    out = asyncio.new_event_loop().run_until_complete(main())
    assert out == [0, 2, 4] and calls == [[0, 1, 2]]


def test_batch_flush_drops_expired_entries():
    from ray_tpu_torch.serve.batching import batch

    calls = []

    @batch(max_batch_size=100, batch_wait_timeout_s=0.15)
    async def fn(items):
        calls.append(list(items))
        return [i * 10 for i in items]

    before = _metric_total("ray_tpu_requests_expired_shed")

    async def main():
        # one live entry, one whose deadline expires inside the
        # coalescing window.  A coroutine's first step (where the
        # entry enqueues and samples the ambient deadline) runs at the
        # NEXT loop tick, so yield while each scope is installed.
        prev = deadlines.set_current(time.time() + 0.02)
        doomed = asyncio.ensure_future(fn(1))
        await asyncio.sleep(0)
        deadlines.set_current(None)
        live = asyncio.ensure_future(fn(2))
        await asyncio.sleep(0)
        deadlines.set_current(prev)
        out = await live
        with pytest.raises(DeadlineExceededError):
            await doomed
        return out

    out = asyncio.new_event_loop().run_until_complete(main())
    assert out == 20
    assert calls == [[2]], "expired entry must not ride into the fn"
    assert _metric_total("ray_tpu_requests_expired_shed") >= before + 1


# -------------------------------------------------------------- ingress
def test_http_503_retry_after_and_504(serve_session):
    @serve.deployment(max_ongoing_requests=1, max_queued_requests=1)
    class Slow:
        async def __call__(self, x):
            await asyncio.sleep(0.6)
            return x

    h = serve.run(Slow.bind(), http_port=0)
    url = f"http://127.0.0.1:{h.http_port}/Slow"

    def post(deadline_s=None):
        req = urllib.request.Request(
            url, data=json.dumps(1).encode(),
            headers={"Content-Type": "application/json"})
        if deadline_s is not None:
            req.add_header("X-Request-Deadline-S", str(deadline_s))
        return urllib.request.urlopen(req, timeout=30)

    # 504: the deadline header bounds the request end to end
    with pytest.raises(urllib.error.HTTPError) as ei:
        post(deadline_s=0.15)
    assert ei.value.code == 504
    time.sleep(0.7)  # the 504'd request still runs to completion
    # 503 + Retry-After: fill the replica, then overflow it
    held = []
    for i in range(2):
        held.append(h.remote(i))
        time.sleep(0.05)
    with pytest.raises(urllib.error.HTTPError) as ei:
        post()
    assert ei.value.code == 503
    retry_after = ei.value.headers.get("Retry-After")
    assert retry_after is not None and int(retry_after) >= 1
    for r in held:
        r.result(timeout=10)


def test_grpc_unavailable_and_deadline(serve_session):
    pytest.importorskip("grpc")
    from ray_tpu_torch.serve.grpc_proxy import GrpcServeClient

    @serve.deployment(max_ongoing_requests=1, max_queued_requests=1)
    class Slow:
        async def __call__(self, x):
            await asyncio.sleep(0.6)
            return x

    h = serve.run(Slow.bind(), grpc_port=0)
    client = GrpcServeClient(f"127.0.0.1:{h.grpc_port}")
    try:
        with pytest.raises(DeadlineExceededError):
            client.call("Slow", 1, deadline_s=0.15)
        time.sleep(0.7)  # the timed-out request still runs to completion
        held = []
        for i in range(2):
            held.append(h.remote(i))
            time.sleep(0.05)
        with pytest.raises(BackPressureError) as ei:
            client.call("Slow", 1)
        assert ei.value.retry_after_s is not None
        for r in held:
            r.result(timeout=10)
    finally:
        client.close()


# ------------------------------------------------------ chaos load shaping
def test_chaos_slow_method_injects_latency(ray_start_regular):
    @ray_tpu_torch.remote
    class A:
        def work(self):
            return "ok"

    a = A.remote()
    ray_tpu_torch.get(a.work.remote(), timeout=10)  # warm
    sched = chaos.schedule(seed=3).slow_method("work", 0.3, count=1)
    with sched:
        t0 = time.monotonic()
        assert ray_tpu_torch.get(a.work.remote(), timeout=10) == "ok"
        assert time.monotonic() - t0 >= 0.3
    assert sched.fired("actor_slow") == 1
    assert sched.events()[0]["delay_s"] >= 0.3


# ------------------------------------------------------------- the soak
@pytest.mark.chaos
def test_overload_soak_2x_capacity_one_stalled_replica(serve_session):
    """Sustained 2× offered load against a 2-replica deployment with
    one chaos-stalled replica: goodput stays within 20% of a single
    healthy replica's capacity, every rejection is typed and arrives in
    < 10% of the deadline, admitted-request p99 ≤ the deadline, and the
    expired-work counter equals the number of deadline-expired requests
    that never executed (zero executed past deadline)."""
    SERVICE_S = 0.08
    MAX_ONGOING = 2
    DEADLINE_S = 1.0
    STALL_S = 1.3

    executed = []       # (tag, entry_time)
    violations = []     # executions entered past their deadline

    @serve.deployment(name="ovl", num_replicas=2,
                      max_ongoing_requests=MAX_ONGOING,
                      max_queued_requests=MAX_ONGOING)
    class Work:
        async def __call__(self, tag):
            rc = ray_tpu_torch.get_runtime().runtime_context
            dl = rc.get_deadline()
            now = time.time()
            executed.append(tag)
            if dl is not None and now > dl:
                violations.append((tag, now - dl))
            await asyncio.sleep(SERVICE_S)
            return tag

    h = serve.run(Work.bind())
    # Measure the effective service latency on THIS box (CI-speed
    # independent capacity anchor).
    for i in range(3):
        h.remote(f"warm{i}").result(timeout=10)
    t0 = time.monotonic()
    for i in range(6):
        h.remote(f"lat{i}").result(timeout=10)
    svc = (time.monotonic() - t0) / 6
    single_cap = MAX_ONGOING / svc          # req/s, one healthy replica
    offered = 2.0 * 2 * single_cap          # 2× the 2-replica capacity
    n_threads = 4
    period = n_threads / offered
    duration = 2.5

    hd = h.options(deadline_s=DEADLINE_S)
    records = []
    rec_lock = threading.Lock()
    expired_before = _metric_total("ray_tpu_requests_expired_shed")

    def waiter(resp, rec):
        try:
            resp.result()
            rec["outcome"] = "ok"
        except BackPressureError:
            rec["outcome"] = "backpressure"
        except DeadlineExceededError:
            rec["outcome"] = "deadline"
        except Exception as e:  # noqa: BLE001
            rec["outcome"] = f"other:{type(e).__name__}"
        rec["t_done"] = time.monotonic()

    def submitter(idx):
        i = 0
        end = time.monotonic() + duration
        while time.monotonic() < end:
            tag = f"s{idx}-{i}"
            i += 1
            rec = {"tag": tag, "t_submit": time.monotonic()}
            with rec_lock:
                records.append(rec)
            try:
                resp = hd.remote(tag)
            except BackPressureError:
                rec["outcome"] = "backpressure"
                rec["t_done"] = time.monotonic()
            except DeadlineExceededError:
                rec["outcome"] = "deadline"
                rec["t_done"] = time.monotonic()
            else:
                threading.Thread(target=waiter, args=(resp, rec),
                                 daemon=True).start()
            time.sleep(period)

    sched = chaos.schedule(seed=11).stall_replica("ovl#1_0", STALL_S)
    with sched:
        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(n_threads)]
        t_start = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # Drain in two stages: client outcomes resolve at the request
        # budget, but SERVER-side sheds land later — the stalled
        # replica's dispatch unwinds serially (one STALL_S per admitted
        # request) before its mailbox drains the expired entries.
        deadline_drain = time.monotonic() + DEADLINE_S + \
            (MAX_ONGOING + 2) * STALL_S + 3.0
        while time.monotonic() < deadline_drain:
            with rec_lock:
                resolved = all("outcome" in r for r in records)
            if resolved:
                executed_now = set(executed)
                with rec_lock:
                    shed_now = sum(
                        1 for r in records
                        if r.get("outcome") == "deadline"
                        and r["tag"] not in executed_now)
                if (_metric_total("ray_tpu_requests_expired_shed")
                        - expired_before) >= shed_now:
                    break
            time.sleep(0.1)
    t_end = time.monotonic()

    with rec_lock:
        done = [r for r in records if "outcome" in r]
    assert len(done) == len(records), "requests left unresolved"
    by = {}
    for r in done:
        by.setdefault(r["outcome"], []).append(r)
    oks = by.get("ok", [])
    rejections = by.get("backpressure", [])
    deadline_failed = by.get("deadline", [])
    assert not [k for k in by if k.startswith("other")], \
        f"untyped failures: { {k: len(v) for k, v in by.items()} }"
    assert len(done) >= 50, "soak generated too little load to judge"

    # (1) goodput within 20% of one healthy replica's capacity
    goodput = len(oks) / (t_end - t_start)
    assert goodput >= 0.8 * single_cap * \
        (duration / (t_end - t_start)), \
        f"goodput {goodput:.1f}/s vs single healthy {single_cap:.1f}/s"

    # (2) rejections typed AND fast (< 10% of the deadline)
    assert rejections, "2x load with bounded mailboxes must shed"
    rej_lat = sorted(r["t_done"] - r["t_submit"] for r in rejections)
    assert rej_lat[-1] < 0.1 * DEADLINE_S, \
        f"slowest rejection {rej_lat[-1]:.3f}s"

    # (3) admitted-request p99 <= deadline
    ok_lat = sorted(r["t_done"] - r["t_submit"] for r in oks)
    p99 = ok_lat[min(len(ok_lat) - 1, math.ceil(0.99 * len(ok_lat)))]
    assert p99 <= DEADLINE_S + 0.05, f"admitted p99 {p99:.3f}s"

    # (4) zero requests EXECUTED past their deadline, and the expired
    # counter accounts for every deadline-failed request that never ran
    assert violations == [], f"executed past deadline: {violations[:5]}"
    executed_tags = set(executed)
    shed_not_run = [r for r in deadline_failed
                    if r["tag"] not in executed_tags]
    expired_count = (_metric_total("ray_tpu_requests_expired_shed")
                     - expired_before)
    assert expired_count == len(shed_not_run), \
        (f"expired-shed counter {expired_count} != "
         f"{len(shed_not_run)} shed requests")

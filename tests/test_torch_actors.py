"""The port's copy of ``tests/test_actors.py``, run against ray_tpu_torch
(its own runtime fixtures: ``_torch_runtime.py``).

Actor semantics (reference: python/ray/tests/test_actor*.py family)."""

import asyncio
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import exceptions
from _torch_runtime import ray_start_regular, shutdown_only  # noqa: F401


@ray_tpu_torch.remote
class Counter:
    def __init__(self, start=0):
        self.value = start

    def increment(self, by=1):
        self.value += by
        return self.value

    def get_value(self):
        return self.value

    def fail(self):
        raise RuntimeError("method error")

    def quit(self):
        ray_tpu_torch.exit_actor()


def test_actor_basic(ray_start_regular):
    c = Counter.remote()
    assert ray_tpu_torch.get(c.increment.remote()) == 1
    assert ray_tpu_torch.get(c.increment.remote(5)) == 6
    assert ray_tpu_torch.get(c.get_value.remote()) == 6


def test_actor_init_args(ray_start_regular):
    c = Counter.remote(100)
    assert ray_tpu_torch.get(c.get_value.remote()) == 100


def test_actor_method_ordering(ray_start_regular):
    c = Counter.remote()
    refs = [c.increment.remote() for _ in range(50)]
    assert ray_tpu_torch.get(refs) == list(range(1, 51))


def test_actor_method_error_keeps_actor_alive(ray_start_regular):
    c = Counter.remote()
    with pytest.raises(exceptions.TaskError):
        ray_tpu_torch.get(c.fail.remote())
    assert ray_tpu_torch.get(c.increment.remote()) == 1


def test_actor_creation_failure(ray_start_regular):
    @ray_tpu_torch.remote
    class Broken:
        def __init__(self):
            raise ValueError("cannot create")

        def ping(self):
            return "pong"

    b = Broken.remote()
    with pytest.raises(exceptions.ActorDiedError):
        ray_tpu_torch.get(b.ping.remote(), timeout=10)


def test_kill_actor(ray_start_regular):
    c = Counter.remote()
    assert ray_tpu_torch.get(c.increment.remote()) == 1
    ray_tpu_torch.kill(c)
    time.sleep(0.1)
    with pytest.raises(exceptions.ActorDiedError):
        ray_tpu_torch.get(c.increment.remote(), timeout=10)


def test_exit_actor(ray_start_regular):
    c = Counter.remote()
    ray_tpu_torch.get(c.quit.remote())
    time.sleep(0.2)
    with pytest.raises(exceptions.ActorDiedError):
        ray_tpu_torch.get(c.increment.remote(), timeout=10)


def test_named_actor(ray_start_regular):
    Counter.options(name="global_counter").remote(7)
    handle = ray_tpu_torch.get_actor("global_counter")
    assert ray_tpu_torch.get(handle.get_value.remote()) == 7


def test_named_actor_collision(ray_start_regular):
    Counter.options(name="dup").remote()
    with pytest.raises(ValueError):
        Counter.options(name="dup").remote()


def test_get_if_exists(ray_start_regular):
    a = Counter.options(name="shared", get_if_exists=True).remote(5)
    ray_tpu_torch.get(a.increment.remote())
    b = Counter.options(name="shared", get_if_exists=True).remote(5)
    assert ray_tpu_torch.get(b.get_value.remote()) == 6


def test_namespace_isolation(ray_start_regular):
    Counter.options(name="c", namespace="ns1").remote(1)
    Counter.options(name="c", namespace="ns2").remote(2)
    c1 = ray_tpu_torch.get_actor("c", namespace="ns1")
    c2 = ray_tpu_torch.get_actor("c", namespace="ns2")
    assert ray_tpu_torch.get(c1.get_value.remote()) == 1
    assert ray_tpu_torch.get(c2.get_value.remote()) == 2


def test_threaded_actor_concurrency(ray_start_regular):
    @ray_tpu_torch.remote
    class Slow:
        def work(self):
            time.sleep(0.3)
            return threading_ident()

    import threading

    def threading_ident():
        return 1

    s = Slow.options(max_concurrency=4).remote()
    t0 = time.time()
    ray_tpu_torch.get([s.work.remote() for _ in range(4)])
    elapsed = time.time() - t0
    assert elapsed < 1.0, f"threaded actor should overlap calls: {elapsed}"


def test_async_actor(ray_start_regular):
    @ray_tpu_torch.remote
    class AsyncWorker:
        async def compute(self, x):
            await asyncio.sleep(0.2)
            return x * 2

    w = AsyncWorker.options(max_concurrency=8).remote()
    t0 = time.time()
    out = ray_tpu_torch.get([w.compute.remote(i) for i in range(8)])
    elapsed = time.time() - t0
    assert out == [i * 2 for i in range(8)]
    assert elapsed < 1.5, f"async actor should overlap awaits: {elapsed}"


def test_actor_handle_passing(ray_start_regular):
    @ray_tpu_torch.remote
    def bump(counter):
        return ray_tpu_torch.get(counter.increment.remote())

    c = Counter.remote()
    assert ray_tpu_torch.get(bump.remote(c)) == 1
    assert ray_tpu_torch.get(bump.remote(c)) == 2


def test_actor_pending_calls_limit(ray_start_regular):
    @ray_tpu_torch.remote
    class Slow:
        def work(self):
            time.sleep(10)

    s = Slow.options(max_pending_calls=2).remote()
    s._actor_ready()
    s.work.remote()
    time.sleep(0.2)  # let the first call start executing
    s.work.remote()
    s.work.remote()
    with pytest.raises(exceptions.PendingCallsLimitExceededError):
        for _ in range(3):
            s.work.remote()


def test_actor_restart_on_kill(ray_start_regular):
    c = Counter.options(max_restarts=1).remote(10)
    assert ray_tpu_torch.get(c.increment.remote()) == 11
    ray_tpu_torch.kill(c, no_restart=False)
    time.sleep(0.3)
    # State reset by restart: constructor re-ran.
    assert ray_tpu_torch.get(c.get_value.remote(), timeout=10) == 10
    assert ray_tpu_torch.get_runtime_context  # smoke


def test_streaming_actor_method(ray_start_regular):
    @ray_tpu_torch.remote
    class Gen:
        def stream(self, n):
            for i in range(n):
                yield i

    g = Gen.remote()
    refs = list(g.stream.options(num_returns="streaming").remote(4))
    assert [ray_tpu_torch.get(r) for r in refs] == [0, 1, 2, 3]

"""The port's copy of ``tests/test_core_api.py``, run against ray_tpu_torch
(its own runtime fixtures: ``_torch_runtime.py``).

Core task/object API behavior (reference: python/ray/tests/test_basic.py
family)."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import exceptions
from _torch_runtime import ray_start_regular, shutdown_only  # noqa: F401


def test_put_get(ray_start_regular):
    ref = ray_tpu_torch.put({"a": 1})
    assert ray_tpu_torch.get(ref) == {"a": 1}


def test_put_get_list(ray_start_regular):
    refs = [ray_tpu_torch.put(i) for i in range(10)]
    assert ray_tpu_torch.get(refs) == list(range(10))


def test_simple_task(ray_start_regular):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    assert ray_tpu_torch.get(add.remote(1, 2)) == 3


def test_task_with_ref_args(ray_start_regular):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    x = ray_tpu_torch.put(10)
    y = add.remote(x, 5)
    z = add.remote(y, y)
    assert ray_tpu_torch.get(z) == 30


def test_task_kwargs_and_options(ray_start_regular):
    @ray_tpu_torch.remote(num_cpus=2)
    def f(a, b=1):
        return a * b

    assert ray_tpu_torch.get(f.remote(3, b=4)) == 12
    assert ray_tpu_torch.get(f.options(num_cpus=1, name="custom").remote(2)) == 2


def test_multiple_returns(ray_start_regular):
    @ray_tpu_torch.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert ray_tpu_torch.get([a, b, c]) == [1, 2, 3]


def test_task_error_propagates(ray_start_regular):
    @ray_tpu_torch.remote(max_retries=0)
    def boom():
        raise ValueError("bad")

    with pytest.raises(exceptions.TaskError) as ei:
        ray_tpu_torch.get(boom.remote())
    assert isinstance(ei.value.cause, ValueError)


def test_error_chains_through_dependencies(ray_start_regular):
    @ray_tpu_torch.remote(max_retries=0)
    def boom():
        raise ValueError("root cause")

    @ray_tpu_torch.remote
    def consume(x):
        return x

    ref = consume.remote(consume.remote(boom.remote()))
    with pytest.raises(exceptions.TaskError) as ei:
        ray_tpu_torch.get(ref)
    assert isinstance(ei.value.cause, ValueError)


def test_retries_on_retry_exceptions(ray_start_regular):
    attempts = []

    @ray_tpu_torch.remote(max_retries=3, retry_exceptions=True)
    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise RuntimeError("transient")
        return "ok"

    assert ray_tpu_torch.get(flaky.remote()) == "ok"
    assert len(attempts) == 3


def test_no_retry_by_default_for_app_errors(ray_start_regular):
    attempts = []

    @ray_tpu_torch.remote
    def fails():
        attempts.append(1)
        raise RuntimeError("app error")

    with pytest.raises(exceptions.TaskError):
        ray_tpu_torch.get(fails.remote())
    assert len(attempts) == 1


def test_wait_basic(ray_start_regular):
    @ray_tpu_torch.remote
    def fast():
        return "fast"

    @ray_tpu_torch.remote
    def slow():
        time.sleep(5)
        return "slow"

    f, s = fast.remote(), slow.remote()
    ready, not_ready = ray_tpu_torch.wait([f, s], num_returns=1, timeout=3)
    assert ready == [f]
    assert not_ready == [s]


def test_wait_timeout_empty(ray_start_regular):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(5)

    ready, not_ready = ray_tpu_torch.wait([slow.remote()], timeout=0.1)
    assert ready == []
    assert len(not_ready) == 1


def test_get_timeout(ray_start_regular):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(5)

    with pytest.raises(exceptions.GetTimeoutError):
        ray_tpu_torch.get(slow.remote(), timeout=0.1)


def test_nested_tasks(ray_start_regular):
    @ray_tpu_torch.remote
    def inner(x):
        return x * 2

    @ray_tpu_torch.remote
    def outer(x):
        return ray_tpu_torch.get(inner.remote(x)) + 1

    assert ray_tpu_torch.get(outer.remote(10)) == 21


def test_cancel_pending(ray_start_regular):
    @ray_tpu_torch.remote
    def blocker():
        time.sleep(60)

    @ray_tpu_torch.remote(num_cpus=8)
    def big():
        return 1

    # Fill the node so `victim` stays queued, then cancel it.
    b = blocker.remote()
    victim = big.remote()
    time.sleep(0.2)
    ray_tpu_torch.cancel(victim)
    with pytest.raises(exceptions.TaskCancelledError):
        ray_tpu_torch.get(victim, timeout=5)
    ray_tpu_torch.cancel(b, force=True)


def test_cancel_running(ray_start_regular):
    @ray_tpu_torch.remote
    def spin():
        t0 = time.time()
        while time.time() - t0 < 30:
            time.sleep(0.01)
        return "finished"

    ref = spin.remote()
    time.sleep(0.3)
    ray_tpu_torch.cancel(ref, force=True)
    with pytest.raises(exceptions.TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=10)


def test_streaming_generator(ray_start_regular):
    @ray_tpu_torch.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * i

    out = [ray_tpu_torch.get(ref) for ref in gen.remote(5)]
    assert out == [0, 1, 4, 9, 16]


def test_object_ref_in_nested_structure_not_resolved(ray_start_regular):
    @ray_tpu_torch.remote
    def f(d):
        return d["ref"]

    inner = ray_tpu_torch.put(42)
    out = ray_tpu_torch.get(f.remote({"ref": inner}))
    assert isinstance(out, ray_tpu_torch.ObjectRef)
    assert ray_tpu_torch.get(out) == 42


def test_runtime_context(ray_start_regular):
    @ray_tpu_torch.remote
    def who():
        ctx = ray_tpu_torch.get_runtime_context()
        return ctx.get_task_id(), ctx.get_job_id()

    task_id, job_id = ray_tpu_torch.get(who.remote())
    assert task_id is not None
    assert job_id == ray_tpu_torch.get_runtime_context().get_job_id()


def test_cluster_and_available_resources(ray_start_regular):
    total = ray_tpu_torch.cluster_resources()
    assert total["CPU"] == 8.0

    @ray_tpu_torch.remote(num_cpus=4)
    def hold():
        time.sleep(1.0)
        return 1

    ref = hold.remote()
    time.sleep(0.3)
    avail = ray_tpu_torch.available_resources()
    assert avail["CPU"] == 4.0
    assert ray_tpu_torch.get(ref) == 1


def test_resource_gating_limits_concurrency(ray_start_regular):
    running = []

    @ray_tpu_torch.remote(num_cpus=4)
    def task(i):
        running.append(i)
        time.sleep(0.3)
        return len(running)

    refs = [task.remote(i) for i in range(4)]
    ray_tpu_torch.get(refs)
    # With 8 CPUs and 4-CPU tasks, at most 2 run concurrently; the test
    # just asserts completion (timing asserted via available_resources
    # in the previous test).
    assert len(running) == 4


def test_put_objectref_rejected(ray_start_regular):
    with pytest.raises(TypeError):
        ray_tpu_torch.put(ray_tpu_torch.put(1))


def test_infeasible_task_rejected(ray_start_regular):
    @ray_tpu_torch.remote(num_cpus=1000)
    def huge():
        return 1

    with pytest.raises(ValueError):
        huge.remote()


def test_broadcast_local_mode_is_noop(ray_start_regular):
    """util.broadcast with no cluster attached replicates nowhere."""
    from ray_tpu_torch.util import broadcast

    assert broadcast(ray_tpu_torch.put([1, 2, 3])) == 0

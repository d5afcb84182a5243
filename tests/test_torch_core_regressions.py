"""The port's copy of ``tests/test_core_regressions.py``, run against ray_tpu_torch
(its own runtime fixtures: ``_torch_runtime.py``).

Regression tests for owner-side bookkeeping bugs found in review
(actor retry routing, kill/acquire races, streaming + backout leaks)."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import PendingCallsLimitExceededError
from _torch_runtime import ray_start_regular, shutdown_only  # noqa: F401


def _wait(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_actor_task_retry_reruns_on_actor(ray_start_regular):
    @ray_tpu_torch.remote
    class Flaky:
        def __init__(self):
            self.calls = 0

        def flaky(self):
            self.calls += 1
            if self.calls == 1:
                raise ValueError("first call fails")
            return self.calls

    a = Flaky.remote()
    ref = a.flaky.options(max_retries=2, retry_exceptions=True).remote()
    assert ray_tpu_torch.get(ref) == 2


def test_async_actor_streaming_completes_bookkeeping(ray_start_regular):
    @ray_tpu_torch.remote
    class Gen:
        async def agen(self):
            for i in range(3):
                yield i

    g = Gen.remote()
    out = list(ray_tpu_torch.get(r) for r in
               g.agen.options(num_returns="streaming").remote())
    assert out == [0, 1, 2]
    rt = ray_tpu_torch.get_runtime()
    assert _wait(lambda: rt.task_manager.num_pending() == 0)


def test_async_streaming_error_does_not_retry(ray_start_regular):
    @ray_tpu_torch.remote
    class Gen:
        def __init__(self):
            self.runs = 0

        async def agen(self):
            self.runs += 1
            yield 1
            raise ValueError("boom")

        def runs_count(self):
            return self.runs

    g = Gen.remote()
    gen = g.agen.options(num_returns="streaming", max_retries=3,
                         retry_exceptions=True).remote()
    items = []
    with pytest.raises(Exception):
        for r in gen:
            items.append(ray_tpu_torch.get(r))
    assert items == [1]
    assert ray_tpu_torch.get(g.runs_count.remote()) == 1


def test_double_kill_releases_resources_once(ray_start_regular):
    @ray_tpu_torch.remote(num_cpus=4)
    class Big:
        def ping(self):
            return "pong"

    b = Big.remote()
    assert ray_tpu_torch.get(b.ping.remote()) == "pong"
    before = ray_tpu_torch.available_resources()["CPU"]
    ray_tpu_torch.kill(b)
    ray_tpu_torch.kill(b)
    assert _wait(lambda: ray_tpu_torch.available_resources()["CPU"]
                 == before + 4)


def test_kill_while_waiting_for_resources(ray_start_regular):
    """Killing an actor blocked in resource acquisition must not leak
    the resources nor leave its creation ref unresolved."""
    @ray_tpu_torch.remote(num_cpus=8)
    class Hog:
        def ping(self):
            return "pong"

    @ray_tpu_torch.remote(num_cpus=8)
    class Blocked:
        def ping(self):
            return "pong"

    hog = Hog.remote()
    assert ray_tpu_torch.get(hog.ping.remote()) == "pong"
    blocked = Blocked.remote()
    time.sleep(0.1)  # let its acquire thread block
    ray_tpu_torch.kill(blocked)
    ray_tpu_torch.kill(hog)
    # All 8 CPUs must come back (not stolen by the dead `blocked`).
    assert _wait(lambda: ray_tpu_torch.available_resources()["CPU"] == 8.0), \
        ray_tpu_torch.available_resources()


def test_pending_calls_limit_backout_no_leak(ray_start_regular):
    @ray_tpu_torch.remote(max_pending_calls=1)
    class Slow:
        def work(self, x=None):
            time.sleep(0.5)
            return 1

    s = Slow.remote()
    rt = ray_tpu_torch.get_runtime()
    arg = ray_tpu_torch.put("payload")
    refs = []
    raised = False
    for _ in range(20):
        try:
            refs.append(s.work.remote(arg))
        except PendingCallsLimitExceededError:
            raised = True
            break
    assert raised
    ray_tpu_torch.get(refs)  # queued ones still complete
    tracked_before = rt.reference_counter.num_tracked()
    del refs
    # The rejected call must not have pinned `arg` or leaked return-id
    # entries: after the accepted calls finish and refs drop, only
    # `arg` itself (+ nothing else) should be pinned by us.
    assert _wait(lambda: rt.task_manager.num_pending() == 0)
    assert rt.reference_counter.num_tracked() <= tracked_before


def test_retry_bypasses_pending_calls_limit(ray_start_regular):
    @ray_tpu_torch.remote(max_pending_calls=1)
    class Flaky:
        def __init__(self):
            self.calls = 0

        def flaky(self):
            self.calls += 1
            if self.calls == 1:
                raise ValueError("first call fails")
            return self.calls

    a = Flaky.remote()
    ref = a.flaky.options(max_retries=3, retry_exceptions=True).remote()
    # The retry of an accepted task must not be rejected by the
    # submission-time pending-calls limit.
    assert ray_tpu_torch.get(ref) == 2

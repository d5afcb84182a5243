"""The port's copy of ``tests/test_serve.py``, run against ray_tpu_torch
(its own runtime fixtures: ``_torch_runtime.py``).

ray_tpu.serve: deployments, routing, batching, HTTP, LLM decode
(reference test strategy: serve/tests/ + local_testing_mode)."""

import asyncio
import json
import os
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from _torch_runtime import ray_start_regular, shutdown_only  # noqa: F401


@pytest.fixture
def serve_session(ray_start_regular):
    yield
    serve.shutdown()


def test_function_deployment(serve_session):
    @serve.deployment
    def double(x):
        return x * 2

    handle = serve.run(double.bind())
    assert handle.remote(21).result(timeout=30) == 42


def test_class_deployment_methods(serve_session):
    @serve.deployment
    class Calc:
        def __init__(self, base):
            self.base = base

        def __call__(self, x):
            return self.base + x

        def mul(self, x):
            return self.base * x

    handle = serve.run(Calc.bind(10))
    assert handle.remote(5).result(timeout=30) == 15
    assert handle.mul.remote(5).result(timeout=30) == 50


def test_replica_load_balancing(serve_session):
    @serve.deployment(num_replicas=2)
    class Who:
        def __call__(self, _):
            import threading
            time.sleep(0.05)
            return id(self)

    handle = serve.run(Who.bind())
    responses = [handle.remote(None) for _ in range(16)]
    ids = {r.result(timeout=30) for r in responses}
    assert len(ids) == 2, "both replicas should take traffic"


def test_serve_batch(serve_session):
    @serve.deployment
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        async def __call__(self, xs):
            self.batch_sizes.append(len(xs))
            return [x * 10 for x in xs]

        def seen(self, _):
            return self.batch_sizes

    handle = serve.run(Batched.bind())
    responses = [handle.remote(i) for i in range(8)]
    assert [r.result(timeout=30) for r in responses] == \
        [i * 10 for i in range(8)]
    sizes = handle.seen.remote(None).result(timeout=30)
    assert max(sizes) > 1, f"no batching happened: {sizes}"


def test_reconfigure_user_config(serve_session):
    @serve.deployment
    class Cfg:
        def __init__(self):
            self.factor = 1

        def reconfigure(self, cfg):
            self.factor = cfg["factor"]

        def __call__(self, x):
            return x * self.factor

    handle = serve.run(Cfg.bind())
    assert handle.remote(5).result(timeout=30) == 5
    import ray_tpu_torch.serve as s

    controller = s._get_controller(create=False)
    ray_tpu_torch.get(controller.reconfigure.remote("Cfg", {"factor": 7}))
    assert handle.remote(5).result(timeout=30) == 35


def test_http_proxy(serve_session):
    @serve.deployment
    def greet(payload):
        return f"hello {payload['name']}"

    handle = serve.run(greet.bind(), http_port=0)
    port = handle.http_port
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/greet",
        data=json.dumps({"name": "tpu"}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        body = json.loads(resp.read())
    assert body["result"] == "hello tpu"


def test_status_and_delete(serve_session):
    @serve.deployment(num_replicas=2)
    def f(x):
        return x

    serve.run(f.bind())
    st = serve.status()
    assert st["f"]["num_replicas"] == 2
    assert serve.delete("f")
    assert "f" not in serve.status()


def test_autoscaling_up_then_down(serve_session):
    """Queue depth above target grows the replica set toward max;
    sustained idle shrinks it back to min (reference:
    serve autoscaling_policy.py)."""

    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 2, "interval_s": 0.1,
        "downscale_delay_s": 0.5})
    class Slow:
        async def __call__(self, t):
            await asyncio.sleep(t)
            return os.getpid()

    handle = serve.run(Slow.bind())
    assert serve.status()["Slow"]["num_replicas"] == 1
    # 12 long requests at target 2 → desired 3 (capped by max).
    resps = [handle.remote(3.0) for _ in range(12)]
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        if serve.status()["Slow"]["num_replicas"] == 3:
            break
        time.sleep(0.2)
    assert serve.status()["Slow"]["num_replicas"] == 3
    for r in resps:
        r.result(timeout=60)
    # New replicas actually receive traffic after the handle refresh.
    out = {handle.remote(0.01).result(timeout=30) for _ in range(20)}
    assert out  # calls succeed against the scaled set
    # Idle → back down to min after the downscale delay.
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if serve.status()["Slow"]["num_replicas"] == 1:
            break
        time.sleep(0.2)
    assert serve.status()["Slow"]["num_replicas"] == 1
    # And the handle still works over the shrunk set.
    assert handle.remote(0.0).result(timeout=30)


def test_rolling_update_zero_downtime(serve_session):
    """Redeploying a new version keeps serving: a background caller
    hammers the deployment through the roll and sees only valid
    responses (old version, then new), no failures (reference:
    deployment_state.py:1245 rolling updates)."""
    import threading

    @serve.deployment(num_replicas=2)
    class V:
        def __init__(self, version):
            self.version = version

        def __call__(self):
            return self.version

    handle = serve.run(V.bind(1))
    assert handle.remote().result(timeout=30) == 1

    results, errors = [], []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                results.append(handle.remote().result(timeout=30))
            except Exception as e:  # noqa: BLE001
                errors.append(e)
            time.sleep(0.01)

    t = threading.Thread(target=hammer)
    t.start()
    time.sleep(0.3)
    serve.run(V.bind(2))  # rolling redeploy
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and (not results
                                           or results[-1] != 2):
        time.sleep(0.1)
    time.sleep(0.5)
    stop.set()
    t.join()
    assert not errors, errors[:3]
    assert set(results) <= {1, 2}
    assert results[-1] == 2  # traffic fully on the new version
    assert serve.status()["V"]["version"] == 2


def test_streaming_handle_response(serve_session):
    """handle.options(stream=True) yields values as the replica yields
    them (reference: handle.py:496 generator responses)."""

    @serve.deployment
    class Tokens:
        def stream_out(self, n):
            for i in range(n):
                yield f"tok{i}"

        async def astream(self, n):
            import asyncio

            for i in range(n):
                await asyncio.sleep(0)
                yield i * 2

    handle = serve.run(Tokens.bind())
    out = list(handle.options(method_name="stream_out",
                              stream=True).remote(4))
    assert out == ["tok0", "tok1", "tok2", "tok3"]
    out = list(handle.astream.options(stream=True).remote(3))
    assert out == [0, 2, 4]


class TestMultiplexing:
    """Model multiplexing (reference serve/multiplex.py:22): LRU model
    cache per replica + model-affine routing."""

    def test_affinity_loads_each_model_once(self, ray_start_regular):
        from ray_tpu_torch import serve

        @ray_tpu_torch.remote
        class LoadCounter:
            def __init__(self):
                self.loads = []

            def record(self, mid):
                self.loads.append(mid)
                return True

            def all(self):
                return list(self.loads)

        counter = LoadCounter.options(name="mux-loads").remote()
        ray_tpu_torch.get(counter.all.remote(), timeout=30)

        @serve.deployment(num_replicas=2)
        class MultiModel:
            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id: str):
                h = ray_tpu_torch.get_actor("mux-loads")
                ray_tpu_torch.get(h.record.remote(model_id), timeout=30)
                return lambda x, m=model_id: f"{m}:{x}"

            def __call__(self, x):
                model = self.get_model(
                    serve.get_multiplexed_model_id())
                return model(x)

        handle = serve.run(MultiModel.bind())
        try:
            outs = []
            for i in range(12):
                mid = "m1" if i % 2 == 0 else "m2"
                outs.append(handle.options(
                    multiplexed_model_id=mid).remote(i).result(
                        timeout=60))
            assert outs[0] == "m1:0" and outs[1] == "m2:1"
            loads = ray_tpu_torch.get(counter.all.remote(), timeout=30)
            # Affinity: 12 requests over 2 models loaded each model
            # exactly ONCE across the whole replica set (no thrash).
            assert sorted(loads) == ["m1", "m2"], loads
        finally:
            serve.shutdown()

    def test_lru_evicts_past_capacity(self, ray_start_regular):
        from ray_tpu_torch import serve

        @ray_tpu_torch.remote
        class LoadCounter:
            def __init__(self):
                self.loads = []

            def record(self, mid):
                self.loads.append(mid)
                return True

            def all(self):
                return list(self.loads)

        counter = LoadCounter.options(name="mux-loads-lru").remote()
        ray_tpu_torch.get(counter.all.remote(), timeout=30)

        @serve.deployment(num_replicas=1)
        class OneReplica:
            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id: str):
                h = ray_tpu_torch.get_actor("mux-loads-lru")
                ray_tpu_torch.get(h.record.remote(model_id), timeout=30)
                return lambda x, m=model_id: m

            def __call__(self, x):
                return self.get_model(
                    serve.get_multiplexed_model_id())(x)

        handle = serve.run(OneReplica.bind())
        try:
            for mid in ("a", "b", "c", "a"):
                assert handle.options(
                    multiplexed_model_id=mid).remote(0).result(
                        timeout=60) == mid
            loads = ray_tpu_torch.get(counter.all.remote(), timeout=30)
            # Capacity 2: loading c evicted a (LRU), so the final a
            # call re-loads it — exactly 4 loads in this order.
            assert loads == ["a", "b", "c", "a"], loads
        finally:
            serve.shutdown()

    def test_model_id_empty_outside_request(self, ray_start_regular):
        from ray_tpu_torch import serve

        assert serve.get_multiplexed_model_id() == ""


class TestGrpcIngress:
    """gRPC ingress (reference serve/_private/proxy.py:538): the
    generic protoless service routes unary and streaming calls to
    deployment handles."""

    def test_unary_and_streaming(self, ray_start_regular):
        import numpy as np

        from ray_tpu_torch import serve
        from ray_tpu_torch.serve.grpc_proxy import GrpcServeClient

        @serve.deployment(num_replicas=2)
        class Echo:
            def __call__(self, x):
                return {"doubled": np.asarray(x) * 2}

            def stream(self, n):
                for i in range(n):
                    yield i * 10

        handle = serve.run(Echo.bind(), grpc_port=0)
        client = GrpcServeClient(f"127.0.0.1:{handle.grpc_port}")
        try:
            out = client.call("Echo", np.arange(4))
            assert out["doubled"].tolist() == [0, 2, 4, 6]
            items = list(client.call_stream("Echo", 3, method="stream"))
            assert items == [0, 10, 20]
            with pytest.raises(KeyError):
                client.call("Nope", 1)
        finally:
            client.close()
            serve.shutdown()

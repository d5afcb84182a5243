"""The port's rewritten runtime modules: the object boundary with
``torch.Tensor`` leaves (``cluster/serialization.py``), the GPU as the
scheduled accelerator (``core/resources.py``), the device plane on
``torch.cuda`` (``observability/device.py``), and the metrics plane's
series against the JAX package's."""

import json
import threading
import time
import zipfile
import io

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.cluster import serialization as ser
from ray_tpu_torch.core import resources
from ray_tpu_torch.observability import device as port_device
from ray_tpu_torch.observability import metrics as port_metrics
from _torch_runtime import ray_start_regular, shutdown_only  # noqa: F401

_DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8,
           torch.float8_e4m3fn, torch.float8_e5m2]


def _tensor(dtype, seed=0, shape=(3, 5)):
    x = torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(
            np.float32) * 4)
    return x.to(dtype)


def _same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.device == b.device
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


def _wire(value):
    return ser.loads(ser.dumps(value))


def _flat(value):
    meta, bufs = ser.wire_layout(ser.serialize(value))
    flat = b"".join(bytes(b) for b in bufs)
    assert len(flat) == ser.wire_size(meta)
    return ser.deserialize(ser.sealed_from_flat(meta, flat))


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("path", ["in_process", "wire", "flat"])
def test_tensor_round_trip_keeps_bits_dtype_and_device(dtype, path):
    x = _tensor(dtype)
    value = {"x": x, "n": np.arange(3), "s": "tag", "t": [x[1:]]}
    if path == "in_process":
        out = ser.deserialize(ser.serialize(value))
    else:
        out = (_wire if path == "wire" else _flat)(value)
    assert _same_bits(out["x"], x)
    assert _same_bits(out["t"][0], x[1:].contiguous())
    assert out["n"].tolist() == [0, 1, 2] and out["s"] == "tag"


@pytest.mark.parametrize("path", ["in_process", "wire", "flat"])
def test_get_results_never_alias(path):
    """The producer's later writes, and one consumer's writes, reach
    neither another consumer nor the sealed copy."""
    x = _tensor(torch.bfloat16)
    keep = x.clone()
    sealed = ser.serialize({"x": x})
    x.zero_()  # producer writes after the seal
    if path == "in_process":
        read = lambda: ser.deserialize(sealed)["x"]  # noqa: E731
    elif path == "wire":
        frame = ser.to_wire(sealed)
        read = lambda: ser.deserialize(ser.from_wire(frame))["x"]  # noqa
    else:
        meta, bufs = ser.wire_layout(sealed)
        flat = b"".join(bytes(b) for b in bufs)
        read = lambda: ser.deserialize(  # noqa: E731
            ser.sealed_from_flat(meta, flat))["x"]
    a, b = read(), read()
    a.fill_(7)
    assert _same_bits(b, keep)
    assert _same_bits(read(), keep)


def test_put_get_through_the_runtime_clones(ray_start_regular):
    x = _tensor(torch.float32)
    keep = x.clone()
    ref = ray_tpu_torch.put(x)
    x.add_(1)
    a = ray_tpu_torch.get(ref)
    a.mul_(0)
    assert torch.equal(ray_tpu_torch.get(ref), keep)

    @ray_tpu_torch.remote
    def twice(t):
        t.mul_(2)  # a task's argument is its own copy too
        return t

    assert torch.equal(ray_tpu_torch.get(twice.remote(ref)), keep * 2)
    assert torch.equal(ray_tpu_torch.get(ref), keep)


def test_parameter_and_grad_flag_survive():
    p = torch.nn.Parameter(_tensor(torch.float32))
    for out in (ser.deserialize(ser.serialize(p)), _wire(p)):
        assert isinstance(out, torch.nn.Parameter) and out.requires_grad
        assert torch.equal(out.detach(), p.detach())


@pytest.mark.parametrize("count", [2, 0])
def test_gpu_count_is_advertised(monkeypatch, shutdown_only, count):
    """``init()`` with no arguments advertises the visible CUDA devices
    as ``GPU`` (none: no ``GPU`` key), without initialising CUDA."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert resources.detect_node_resources().get("GPU", 0) == count
    ray_tpu_torch.init(num_cpus=4)
    total = ray_tpu_torch.cluster_resources()
    assert total.get("GPU", 0) == count
    assert not torch.cuda.is_initialized()
    if count:
        @ray_tpu_torch.remote(num_gpus=1)
        def held():
            return ray_tpu_torch.available_resources()["GPU"]

        assert ray_tpu_torch.get(held.remote(), timeout=30) == count - 1
        assert ray_tpu_torch.available_resources()["GPU"] == count
    else:
        @ray_tpu_torch.remote(num_gpus=1)
        def never():
            return 1

        with pytest.raises(Exception, match="GPU"):
            ray_tpu_torch.get(never.remote(), timeout=30)


def test_gpu_actor_holds_the_card(monkeypatch, shutdown_only):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    ray_tpu_torch.init(num_cpus=4)

    @ray_tpu_torch.remote(num_gpus=1)
    class Holder:
        def ping(self):
            return "pong"

    h = Holder.remote()
    assert ray_tpu_torch.get(h.ping.remote(), timeout=30) == "pong"
    assert ray_tpu_torch.available_resources()["GPU"] == 0
    ray_tpu_torch.kill(h)
    deadline = time.time() + 10
    while ray_tpu_torch.available_resources().get("GPU") != 1:
        assert time.time() < deadline
        time.sleep(0.05)


def test_killed_actor_releases_its_instance(shutdown_only):
    """A killed actor's core answers later calls with the death error
    but holds neither its instance nor its constructor arguments (a
    model's tensors on the card are freed at kill)."""
    import gc
    import weakref

    ray_tpu_torch.init(num_cpus=4)

    class Model:
        def __init__(self, weights):
            self.weights = weights

        def norm(self):
            return float(self.weights.norm())

    Remote = ray_tpu_torch.remote(Model)
    h = Remote.remote(torch.ones(1000))
    assert ray_tpu_torch.get(h.norm.remote(), timeout=30) > 0
    core = ray_tpu_torch.get_runtime().actor_manager.get_core(h._actor_id)
    inst = weakref.ref(core.instance)
    weights = weakref.ref(core.instance.weights)
    ray_tpu_torch.kill(h)
    gc.collect()
    assert inst() is None and weights() is None
    with pytest.raises(Exception, match="dead"):
        ray_tpu_torch.get(h.norm.remote(), timeout=30)


def test_cluster_mode_paths_raise():
    with pytest.raises(NotImplementedError, match="cluster sub-slice"):
        ray_tpu_torch.init(address="127.0.0.1:1")
    with pytest.raises(NotImplementedError, match="cluster sub-slice"):
        ray_tpu_torch.timeline()


def test_no_device_sample_before_cuda_is_initialised(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    calls = []
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda i: calls.append(i) or {})
    assert port_device.sample_devices() is None
    assert port_device.sample_once() is None
    assert calls == []


def test_device_sample_reads_the_caching_allocator(monkeypatch):
    stats = {"allocated_bytes.all.current": 3 << 20,
             "allocated_bytes.all.peak": 5 << 20,
             "allocation.all.current": 4}

    class Props:
        total_memory = 80 << 30

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: dict(stats))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props())
    (s,) = port_device.sample_once()
    assert (s["device"], s["used"], s["peak"], s["limit"],
            s["live_buffers"]) == ("cuda:0", 3 << 20, 5 << 20, 80 << 30, 4)
    summary = port_metrics.metrics_summary()
    assert summary["ray_tpu_device_hbm_bytes_used"]["cuda:0"] == 3 << 20
    assert summary["ray_tpu_device_hbm_bytes_peak"]["cuda:0"] == 5 << 20


def test_kernel_build_is_counted():
    before = port_metrics.metrics_summary().get(
        "ray_tpu_kernel_builds_total", {}).get("flash_test", 0)
    port_device.record_kernel_build("flash_test", 1.5)
    after = port_metrics.metrics_summary()[
        "ray_tpu_kernel_builds_total"]["flash_test"]
    assert after == before + 1


def test_device_trace_holds_annotations_of_other_threads():
    """``capture_device_trace`` sees the ``annotation`` ranges an engine
    enters on its own thread."""
    stop = threading.Event()

    def engine():
        while not stop.is_set():
            with port_device.annotation("serve.decode_chunk"):
                torch.ones(64).sum()
            time.sleep(0.005)

    t = threading.Thread(target=engine)
    t.start()
    try:
        art = port_device.capture_device_trace(0.3)
    finally:
        stop.set()
        t.join()
    with zipfile.ZipFile(io.BytesIO(art["data"])) as zf:
        assert art["files"] == len(zf.namelist()) >= 1
        trace = json.loads(zf.read("trace.json"))
    names = {e.get("name", "").split("#")[0]
             for e in trace["traceEvents"]}
    assert "serve.decode_chunk" in names


def test_series_match_the_jax_package():
    """The same calls through the JAX package's planes and through the
    port's give the same named series (each package keeps its own
    per-process registry)."""
    from ray_tpu.observability import device as jax_device
    from ray_tpu.observability import metrics as jax_metrics

    def feed(metrics, device):
        metrics.overload_counters()["expired_shed"].inc(
            tags={"where": "parity_where"})
        metrics.overload_counters()["backpressure"].inc(
            2, tags={"where": "parity_where"})
        kv = metrics.kv_cache_counters()
        kv["blocks_used"].set(5, tags={"pool": "parity_pool"})
        kv["prefix_hits"].inc(tags={"pool": "parity_pool"})
        kv["spec_proposed"].inc(8, tags={"deployment": "parity_dep"})
        kv["pool_bytes"].set(1024, tags={"pool": "parity_pool",
                                         "dtype": "int8"})
        device.record_program_ema("parity_dep", "decode_chunk", 0.25)
        device.record_program_ema("parity_dep", "prefill", None)

    def parity_series(metrics):
        return {name: {k: v for k, v in vals.items() if "parity" in k}
                for name, vals in metrics.metrics_summary().items()
                if any("parity" in k for k in vals)}

    before_j = parity_series(jax_metrics)
    before_p = parity_series(port_metrics)
    feed(jax_metrics, jax_device)
    feed(port_metrics, port_device)

    def moved(before, after):
        return {name: {k: v - before.get(name, {}).get(k, 0)
                       if "ray_tpu_kv_" not in name
                       and "program" not in name else v
                       for k, v in vals.items()}
                for name, vals in after.items()}

    got = moved(before_p, parity_series(port_metrics))
    expect = moved(before_j, parity_series(jax_metrics))
    assert got == expect
    assert got["ray_tpu_serve_program_seconds"] == {
        "parity_dep,decode_chunk": 0.25}
    assert got["ray_tpu_requests_expired_shed"] == {"parity_where": 1}

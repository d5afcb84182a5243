"""The slice's parity gates: the port's Serve plane serving its
LLMServer against the JAX package's Serve plane serving its own, on the
same converted f32 weights and the same prompts (the port's rewrite of
the reference's ``test_llm_continuous_batching``), and the deployment
name on every series the engine feeds.

Each package runs its own local runtime in this process, one after the
other: ``ray_tpu.init`` / ``ray_tpu_torch.init`` each boot a runtime of
their own package, and each is shut down before the next starts.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jax_serve
from ray_tpu.models import llama as jl
from ray_tpu.observability import device as jax_device
from ray_tpu.observability import metrics as jax_metrics
from ray_tpu.serve.llm import LLMServer as JaxServer
from ray_tpu_torch import serve
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.observability import device as port_device
from ray_tpu_torch.observability import metrics as port_metrics
from ray_tpu_torch.serve.llm import LLMServer

_ENGINE = dict(model_preset="debug_f32", max_slots=4, max_len=64,
               prefill_buckets=(8, 16), decode_chunk=4, prefill_groups=(4,))
_PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14, 15, 16]]
_NEW = 6


@pytest.fixture
def f32_preset(monkeypatch):
    """An f32 ``debug`` preset on both config classes (the servers read
    their config from a preset; the in-process replicas see it)."""
    monkeypatch.setattr(jl.LlamaConfig, "debug_f32", classmethod(
        lambda cls, **kw: cls.debug(dtype=jnp.float32, **kw)),
        raising=False)
    monkeypatch.setattr(tl.LlamaConfig, "debug_f32", classmethod(
        lambda cls, **kw: cls.debug(dtype=torch.float32, **kw)),
        raising=False)


def _down():
    jax_serve.shutdown()
    ray_tpu.shutdown()
    serve.shutdown()
    ray_tpu_torch.shutdown()
    # Each runtime's boot starts its package's device sampler, which
    # outlives the runtime; stop both (the JAX package's reads jax's
    # devices once a second, and a thread inside jax while the
    # interpreter exits can abort it).
    jax_device.uninstall()
    port_device.uninstall()


@pytest.fixture
def runtimes():
    """Neither package's runtime up before or after the test."""
    _down()
    yield
    _down()


def _via_handle(handle, prompts):
    responses = [handle.generate.remote(
        {"prompt": p, "max_new_tokens": _NEW}) for p in prompts]
    return [r.result(timeout=120)["tokens"] for r in responses]


def _via_http(port, name, prompt):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{name}",
        data=json.dumps({"prompt": prompt,
                         "max_new_tokens": _NEW}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        body = json.loads(resp.read())
    return body["result"]["tokens"]


def test_deployment_tokens_equal_jax_deployment(f32_preset, runtimes):
    """Three prompts through four slots on each package's deployment:
    the port's handle and its HTTP proxy give the JAX deployment's
    greedy tokens, and those are the tokens of stepwise full
    recomputation on the JAX model."""
    cfg = jl.LlamaConfig.debug_f32(max_seq_len=64)
    pj = jl.init_params(jax.random.key(0), cfg)
    pt = convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")

    ray_tpu.init(num_cpus=8, num_tpus=0)
    handle = jax_serve.run(jax_serve.deployment(JaxServer).bind(
        params=pj, **_ENGINE))
    expect = _via_handle(handle, _PROMPTS)
    jax_serve.shutdown()
    ray_tpu.shutdown()

    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    handle = serve.run(
        serve.deployment(LLMServer, name="llama").bind(
            params=pt, device="cpu", **_ENGINE), http_port=0)
    got = _via_handle(handle, _PROMPTS)
    got_http = [_via_http(handle.http_port, "llama", p) for p in _PROMPTS]

    assert got == expect
    assert got_http == expect
    assert all(len(t) == _NEW for t in got)
    for p, out in zip(_PROMPTS, expect):
        toks = list(p)
        for _ in range(_NEW):
            logits = jl.forward(pj, jnp.asarray([toks], jnp.int32), cfg)
            toks.append(int(jnp.argmax(logits[0, -1])))
        assert toks[len(p):] == out, (p, toks, out)


_TAGGED = ("ray_tpu_kv_blocks_used", "ray_tpu_kv_blocks_free",
           "ray_tpu_kv_pool_bytes", "ray_tpu_serve_program_seconds")


def _llama_tags(summary):
    return {name: sorted(k for k in summary.get(name, {})
                         if k.split(",")[0] == "llama")
            for name in _TAGGED}


def test_engine_series_carry_the_deployment_name(runtimes):
    """An engine deployed as ``llama`` tags its pool series and its
    program-time EMAs ``llama``, as the reference's engine does for the
    same deployment (the replica injects ``serve_deployment``)."""
    engine = dict(model_preset="debug", max_slots=2, max_len=64,
                  prefill_buckets=(16,), decode_chunk=4, prefill_groups=(2,),
                  paged=True, block_size=8)
    request = {"prompt": [1, 2, 3, 4], "max_new_tokens": 5}

    ray_tpu.init(num_cpus=8, num_tpus=0)
    handle = jax_serve.run(jax_serve.deployment(JaxServer, name="llama")
                           .bind(warmup=False, **engine))
    handle.generate.remote(dict(request)).result(timeout=120)
    expect = _llama_tags(jax_metrics.metrics_summary())
    jax_serve.shutdown()
    ray_tpu.shutdown()

    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    handle = serve.run(serve.deployment(LLMServer, name="llama")
                       .bind(device="cpu", warmup=False, **engine))
    handle.generate.remote(dict(request)).result(timeout=120)
    got = _llama_tags(port_metrics.metrics_summary())

    assert got == expect
    assert got["ray_tpu_kv_blocks_used"] == ["llama"]
    assert got["ray_tpu_kv_pool_bytes"] == ["llama,bf16"]
    assert {"llama,prefill", "llama,decode_chunk"} <= set(
        got["ray_tpu_serve_program_seconds"])

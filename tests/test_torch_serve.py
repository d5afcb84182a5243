"""The port's dense LLMServer (ray_tpu_torch.serve.llm) against the JAX
package's: same converted weights, same prompts, identical greedy tokens
under continuous batching; plus its typed rejections and option
validation (the paged plane is tested in test_torch_paged.py)."""

import asyncio
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve.llm import LLMServer as JaxServer
from ray_tpu_torch.core import deadlines
from ray_tpu_torch.exceptions import BackPressureError, DeadlineExceededError
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve.llm import LLMServer

_ENGINE = dict(model_preset="debug_f32", max_slots=4, max_len=64,
               prefill_buckets=(16,), decode_chunk=8, prefill_groups=(4,))


@pytest.fixture
def f32_preset(monkeypatch):
    """An f32 ``debug`` preset on both config classes (the servers read
    their config from a preset); no file of either package changes."""
    monkeypatch.setattr(jl.LlamaConfig, "debug_f32", classmethod(
        lambda cls, **kw: cls.debug(dtype=jnp.float32, **kw)),
        raising=False)
    monkeypatch.setattr(tl.LlamaConfig, "debug_f32", classmethod(
        lambda cls, **kw: cls.debug(dtype=torch.float32, **kw)),
        raising=False)


def _generate(server, prompts, n):
    async def run():
        outs = await asyncio.gather(*[
            server.generate({"prompt": p, "max_new_tokens": n})
            for p in prompts])
        return [o["tokens"] for o in outs]

    return asyncio.run(run())


def test_greedy_tokens_identical_to_jax_server(f32_preset):
    """Six prompts through four slots: requests join and leave the batch
    at chunk boundaries on both engines, and every token matches."""
    pj = jl.init_params(jax.random.key(0), jl.LlamaConfig.debug_f32())
    pt = convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, n).tolist() for n in (5, 3, 10, 7, 12, 2)]
    ref = JaxServer(params=pj, **_ENGINE)
    try:
        expect = _generate(ref, prompts, 10)
    finally:
        ref.shutdown()
    port = LLMServer(params=pt, device="cpu", **_ENGINE)
    try:
        got = _generate(port, prompts, 10)
    finally:
        port.shutdown()
    assert got == expect
    assert all(len(t) == 10 for t in got)


def test_typed_rejections(f32_preset):
    server = LLMServer(device="cpu", warmup=False, **_ENGINE)
    try:
        with pytest.raises(DeadlineExceededError) as e:
            asyncio.run(server.generate({"prompt": [1, 2, 3],
                                         "max_new_tokens": 4,
                                         "deadline_s": -1.0}))
        assert e.value.context["where"] == "llm_admission"
        with deadlines.scope(time.time() - 1.0):  # ambient deadline
            with pytest.raises(DeadlineExceededError):
                asyncio.run(server.generate({"prompt": [4, 5]}))
        server._queue_cap = 0  # the next submission finds it full
        with pytest.raises(BackPressureError) as e:
            asyncio.run(server.generate({"prompt": [1, 2, 3]}))
        assert e.value.context["where"] == "llm_queue"
        assert e.value.retry_after_s == 0.1
        with pytest.raises(ValueError, match="largest prefill bucket"):
            asyncio.run(server.generate({"prompt": list(range(1, 40))}))
        assert server.check_health()
    finally:
        server.shutdown()
    assert not server.check_health()


@pytest.mark.parametrize("kw", [dict(kv_quant="int8"), dict(spec_k=2),
                                dict(role="decode"),
                                dict(paged=True, role="decode")])
def test_unported_engine_options_raise(f32_preset, kw):
    """The reference's typed validation: int8/fp8 KV, speculative
    decoding and a disaggregated role need the paged plane (ValueError);
    a disaggregated role on the paged plane is not ported yet."""
    paged = kw.get("paged", False)
    with pytest.raises(NotImplementedError if paged else ValueError,
                       match="ROADMAP" if paged else "paged"):
        LLMServer(device="cpu", warmup=False, **{**_ENGINE, **kw})


def _shed_counts(counter):
    return {k[0]: v for k, v in counter.snapshot().items()}


def test_expired_shed_counter_matches_jax_engine(f32_preset):
    """An expired request moves ``ray_tpu_requests_expired_shed`` by one
    under the same ``where`` tag on both engines (each package keeps its
    own per-process registry)."""
    from ray_tpu.observability.metrics import overload_counters as jax_oc
    from ray_tpu_torch.observability.metrics import \
        overload_counters as port_oc

    request = {"prompt": [1, 2, 3], "max_new_tokens": 4, "deadline_s": -1.0}
    moved = {}
    for name, make, counters in (
            ("jax", lambda: JaxServer(warmup=False, **_ENGINE), jax_oc),
            ("port", lambda: LLMServer(device="cpu", warmup=False,
                                       **_ENGINE), port_oc)):
        before = _shed_counts(counters()["expired_shed"])
        server = make()
        try:
            # Each package raises its own DeadlineExceededError.
            with pytest.raises(Exception, match="deadline exceeded") as e:
                asyncio.run(server.generate(dict(request)))
            assert type(e.value).__name__ == "DeadlineExceededError"
        finally:
            server.shutdown()
        after = _shed_counts(counters()["expired_shed"])
        moved[name] = {k: after[k] - before.get(k, 0) for k in after
                       if after[k] != before.get(k, 0)}
    assert moved["port"] == moved["jax"] == {"llm_admission": 1}


@pytest.mark.parametrize("kw,programs", [
    (dict(), ("prefill", "decode_chunk")),
    (dict(paged=True, block_size=8, spec_k=2, draft_layers=1),
     ("prefill", "spec_round")),
])
def test_program_seconds_gauge_set_for_each_program(f32_preset, kw,
                                                    programs):
    """A served request sets ``ray_tpu_serve_program_seconds{deployment,
    program}`` for every program the engine ran (the EMA the feasibility
    shed steers by), under the reference's tags."""
    from ray_tpu_torch.observability.device import model_plane_metrics

    gauge = model_plane_metrics()["program_ema"]
    for key in list(gauge.snapshot()):
        gauge._values.pop(key)
    server = LLMServer(device="cpu", warmup=False, **{**_ENGINE, **kw})
    try:
        _generate(server, [[1, 2, 3, 4]], 9)
    finally:
        server.shutdown()
    seen = gauge.snapshot()
    assert gauge.tag_keys == ("deployment", "program")
    for program in programs:
        assert seen.get(("llm", program), 0.0) > 0.0, (program, seen)

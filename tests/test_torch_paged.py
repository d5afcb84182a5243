"""The port's paged KV serving plane (ray_tpu_torch.serve.llm with
paged=True): block pool, copy-on-write prefix cache, int8/fp8 KV blocks
and speculative decoding.

- Against the JAX package's paged engine: the same converted weights and
  prompts give identical greedy tokens on every plane (f32 ``debug``).
- Within the port, the reference's own gates (tests/test_kv_cache.py,
  tests/test_spec_decode.py): dense == paged == int8 == spec == spec+int8,
  warm == cold, the same-wave pair, pool pressure, rollback refcounts.

Tolerance everywhere: exact tokens.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve.llm import LLMServer as JaxServer
from ray_tpu_torch.exceptions import BackPressureError
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve.kv_cache import NULL_BLOCK
from ray_tpu_torch.serve.llm import LLMServer

_ENGINE = dict(max_slots=4, max_len=64, prefill_buckets=(16,),
               decode_chunk=8, prefill_groups=(4,))
_PAGED = dict(paged=True, block_size=8)
_PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9],
            [11, 12, 13, 14, 15, 16, 17, 18, 19, 20]]
# Prefix sharing: a 14-token prompt (one full 8-token block) and a
# 13-token one.
_SHARED = [(i * 13) % 101 + 1 for i in range(14)]
_PAIR = [(i * 7) % 89 + 2 for i in range(13)]


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


@pytest.fixture(scope="module")
def weights():
    """Target and independent draft weights, JAX and converted."""
    cfg = jl.LlamaConfig.debug(dtype=jnp.float32)
    out = {}
    for name, seed in (("target", 0), ("draft", 1)):
        pj = jl.init_params(jax.random.key(seed), cfg)
        out[name] = (pj, convert.from_jax_params(
            jax.tree.map(np.asarray, pj), device="cpu"))
    return out


def _generate(server, prompts, n):
    async def run():
        outs = await asyncio.gather(*[
            server.generate({"prompt": p, "max_new_tokens": n})
            for p in prompts])
        return [o["tokens"] for o in outs]

    return asyncio.run(run())


def _script(server):
    """Interleaved batching, then a cold and a warm run of one prompt,
    then two identical prompts in one wave."""
    return (_generate(server, _PROMPTS, 10)
            + _generate(server, [_SHARED], 6)
            + _generate(server, [_SHARED], 6)
            + _generate(server, [_PAIR, _PAIR], 6))


def _port(**kw):
    return LLMServer(device="cpu", **{**_ENGINE, **kw})


def _run(server, fn):
    try:
        return fn(server)
    finally:
        server.shutdown()


_PLANES = {
    "paged": {},
    "int8": dict(kv_quant="int8"),
    "fp8": dict(kv_quant="fp8"),
    "spec_self_draft": dict(spec_k=4, draft_layers=1),
    "spec_separate_draft": dict(spec_k=4, draft_preset="debug_f32"),
}


@pytest.mark.parametrize("plane", list(_PLANES))
def test_tokens_identical_to_jax_paged_engine(f32_preset, weights, plane):
    kw = {**_PAGED, **_PLANES[plane]}
    pj, pt = weights["target"]
    jkw, tkw = dict(kw), dict(kw)
    if "draft_preset" in kw:
        jkw["draft_params"], tkw["draft_params"] = weights["draft"]
    expect = _run(JaxServer(model_preset="debug_f32", params=pj,
                            warmup=False, **_ENGINE, **jkw), _script)
    port = _port(model_preset="debug_f32", params=pt, **tkw)
    got = _run(port, _script)
    assert got == expect, (plane, got, expect)
    assert port.kv_stats()["allocator"]["used"] == 0  # all released


@pytest.mark.parametrize("preset", ["debug", "debug_f32"])
def test_tokens_identical_across_planes(f32_preset, preset):
    """dense == paged == paged+int8 == paged+spec (self-draft) ==
    paged+spec+int8, interleaved continuous batching on every side."""
    ref = _run(_port(model_preset=preset),
               lambda s: _generate(s, _PROMPTS, 10))
    for kw in ({}, dict(kv_quant="int8"),
               dict(spec_k=4, draft_layers=1),
               dict(spec_k=3, draft_layers=1, kv_quant="int8")):
        got = _run(_port(model_preset=preset, **_PAGED, **kw),
                   lambda s: _generate(s, _PROMPTS, 10))
        assert got == ref, (preset, kw, got, ref)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_warm_equals_cold_and_same_wave_pair(kv_quant):
    """A prefix-cache hit (suffix-only prefill attending shared blocks)
    decodes its cold run's tokens; two identical prompts admitted in one
    wave both match the dense engine (the trie publishes at harvest, so
    neither gathers the other's unwritten blocks)."""
    dense = _port(model_preset="debug")
    paged = _port(model_preset="debug", kv_quant=kv_quant, **_PAGED)
    try:
        cold = _generate(paged, [_SHARED], 10)[0]
        hits = paged.kv_stats()["ray_tpu_prefix_cache_hits"].get("llm", 0)
        warm = _generate(paged, [_SHARED], 10)[0]
        assert warm == cold
        assert paged.kv_stats()["ray_tpu_prefix_cache_hits"]["llm"] > hits
        ref = _generate(dense, [_PAIR], 6)[0]
        assert _generate(paged, [_PAIR, _PAIR], 6) == [ref, ref]
    finally:
        dense.shutdown()
        paged.shutdown()


def test_pool_pressure_preempts_and_sheds_typed():
    """6 usable blocks (< 1.5 requests' worth): the working set preempts
    (recompute on readmit) instead of failing, every request completes
    with its tokens, the allocator returns to the trie's count; a
    request that can never fit (8 blocks) sheds with BackPressureError."""
    srv = _port(model_preset="debug", num_blocks=7, **_PAGED)
    roomy = _port(model_preset="debug", **_PAGED)
    try:
        prompts = [[i + 1] * 10 for i in range(4)]
        outs = _generate(srv, prompts, 30)
        assert outs == _generate(roomy, prompts, 30)
        assert srv.allocator.used_blocks == srv.prefix_cache.num_blocks
        with pytest.raises(BackPressureError):
            _generate(srv, [[1] * 12], 60)
        assert srv.allocator.used_blocks == srv.prefix_cache.num_blocks
        srv.release_kv_cache()
        assert srv.allocator.used_blocks == 0
    finally:
        srv.shutdown()
        roomy.shutdown()


def test_rollback_returns_blocks_and_reports_accept_rate():
    """An independent draft is rejected almost every round: after the
    requests drain, the allocator holds exactly the trie's blocks and a
    shared prefix chain's refcounts are back where they were."""
    srv = _port(model_preset="debug", spec_k=4, draft_preset="debug",
                **_PAGED)
    try:
        _generate(srv, [_SHARED], 10)  # publishes the prefix
        trie = [n.block for n in srv.prefix_cache._root.children.values()]
        assert trie
        before = [srv.allocator.refcount(b) for b in trie]
        _generate(srv, [_SHARED, _SHARED, [5] * 12], 20)
        assert [srv.allocator.refcount(b) for b in trie] == before
        assert srv.allocator.used_blocks == srv.prefix_cache.num_blocks
        spec = srv.kv_stats()["spec"]
        assert spec["proposed"] > 0 and spec["accept_rate"] is not None
    finally:
        srv.shutdown()


def test_self_draft_accepts_and_counts():
    srv = _port(model_preset="debug", spec_k=4, draft_layers=1, **_PAGED)
    try:
        _generate(srv, _PROMPTS, 12)
        stats = srv.kv_stats()
    finally:
        srv.shutdown()
    spec = stats["spec"]
    assert spec["proposed"] > 0 and spec["accepted"] > 0
    assert spec["accept_rate"] == round(spec["accepted"]
                                        / spec["proposed"], 4)
    assert stats["ray_tpu_spec_decode_proposed_tokens"]["llm"] \
        >= spec["proposed"]


@pytest.mark.parametrize("kv_quant,dtype", [(None, torch.bfloat16),
                                            ("int8", torch.int8),
                                            ("fp8", torch.float8_e4m3fn)])
def test_pool_layout_bytes_and_finiteness(kv_quant, dtype):
    srv = _port(model_preset="debug", kv_quant=kv_quant, **_PAGED)
    try:
        _generate(srv, _PROMPTS, 10)
        stats = srv.kv_stats()
        pool = srv.pool
    finally:
        srv.shutdown()
    cfg = srv.cfg
    n = 1 + 4 * 8  # default: capacity parity with the dense plane
    assert pool["k"].shape == (n, cfg.n_layers, 8, cfg.n_kv_heads,
                               cfg.head_dim)
    assert pool["k"].dtype == dtype and stats["kv_quant"] == kv_quant
    per_block = 2 * cfg.n_layers * 8 * cfg.n_kv_heads * (
        cfg.head_dim * pool["k"].element_size() + (4 if kv_quant else 0))
    assert stats["pool_bytes"] == n * per_block
    assert stats["ray_tpu_kv_pool_bytes"][f"llm,{kv_quant or 'bf16'}"] \
        == n * per_block
    for t in pool.values():  # masked keys are harmless only if finite
        assert torch.isfinite(t.float()).all()


def test_padding_reads_and_writes_only_the_null_block():
    """Block-table padding names the null block: a gather there reads it
    and a scatter writes it, and no live block is touched."""
    srv = _port(model_preset="debug", warmup=False, **_PAGED)
    try:
        g = torch.Generator().manual_seed(0)
        for t in srv.pool.values():
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
        before = {k: t.clone() for k, t in srv.pool.items()}
        bt = torch.tensor([[3, 5, NULL_BLOCK, NULL_BLOCK],
                           [NULL_BLOCK] * 4])
        lay = srv._gather("k", bt, trash_row=True)
        assert lay.shape[2] == 4 * 8 + 1 and not lay[:, :, -1].any()
        blocks = lay[:, :, :32].unflatten(2, (4, 8))
        assert torch.equal(blocks[:, 0, 0], srv.pool["k"][3])
        assert torch.equal(blocks[:, 1, 3], srv.pool["k"][NULL_BLOCK])
        srv._scatter("k", bt, torch.zeros_like(lay))
        changed = [b for b in range(srv.num_blocks)
                   if not torch.equal(srv.pool["k"][b], before["k"][b])]
        assert changed == [NULL_BLOCK, 3, 5]
    finally:
        srv.shutdown()


def test_chunk_launch_path_never_reads_a_tensor_back(monkeypatch):
    """The one-deep pipeline needs launches that never wait on the
    device: no .item() / .tolist() / int() / float() of a tensor while
    the paged engine admits, prefills and decodes."""
    srv = _port(model_preset="debug", **_PAGED)

    def refuse(*_a, **_k):
        raise AssertionError("host read of a tensor on the launch path")

    try:
        _generate(srv, [_SHARED], 4)  # publishes a prefix for warm runs
        for name in ("item", "tolist", "__int__", "__float__"):
            monkeypatch.setattr(torch.Tensor, name, refuse)
        got = _generate(srv, _PROMPTS + [_SHARED], 12)
        monkeypatch.undo()
        assert all(len(t) == 12 for t in got)
        assert srv.check_health()
    finally:
        monkeypatch.undo()
        srv.shutdown()


@pytest.mark.parametrize("kw,match", [
    (dict(spec_k=2, draft_layers=2), "draft_layers"),
    (dict(spec_k=2, draft_preset="llama_125m"), "draft vocab"),
    (dict(kv_quant="int4"), "unknown kv_quant"),
    (dict(block_size=0), "block_size"),
])
def test_paged_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        _port(model_preset="debug", warmup=False, **{**_PAGED, **kw})


def test_draft_proposes_the_truncated_models_greedy_tokens(f32_preset):
    """The self-draft's proposals after its prefill are the greedy
    continuation of the target's first ``draft_layers`` layers (its own
    norm and head), as the full forward of that truncated model gives."""
    srv = _port(model_preset="debug_f32", spec_k=4, draft_layers=1,
                warmup=False, **_PAGED)
    try:
        prompt, first = _PROMPTS[2], 7
        P = len(prompt)
        toks = torch.zeros((4, 16), dtype=torch.long)
        toks[0, :P] = torch.tensor(prompt)
        lens = torch.ones(4, dtype=torch.long)
        lens[0] = P
        srv._draft_prefill(toks, lens, np.array([0, -1, -1, -1]))
        active = torch.tensor([True, False, False, False])
        got = srv._draft_propose(torch.full((4,), first),
                                 torch.full((4,), P), active, 4, 64)[:, 0]
        ctx = prompt + [first]
        for _ in range(4):
            logits = tl.forward(srv.draft_params, [ctx], srv.draft_cfg,
                                device="cpu")
            ctx.append(int(logits[0, -1].argmax()))
        assert got.tolist() == ctx[P + 1:]
    finally:
        srv.shutdown()

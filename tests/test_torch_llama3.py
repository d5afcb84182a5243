"""Parity of the port with the JAX package on a narrow ``llama3_8b``:
the preset's own classmethod with its widths and depth cut, so the
model keeps what sets it apart from the other presets (grouped-query
attention at group 4, an untied head, rope at theta 500,000).  f32 on
both sides, the same weights (JAX's ``init_params``, carried across with
``convert.from_jax_params``) and the same inputs (numpy, from a seed).

Covered: ``forward`` (dot; flash through the JAX package's Pallas
kernels in interpret mode and the port's plain version of its kernels),
``loss_fn`` and its gradients, 3 train steps (the optax chain and the
fused AdamW against the reference's chain), ``prefill_forward`` /
``insert_prefill`` / ``forward_with_cache``, and the greedy tokens of the
dense and paged engines (paged, int8, fp8, speculative) against the JAX
engines'.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve.llm import LLMServer as JaxServer
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve.llm import LLMServer
from ray_tpu_torch.train import optim

# llama3_8b's shape at test size: q heads 8 over 2 kv heads (group 4, as
# 32 over 8), untied head, theta and the rest of the preset unchanged.
NARROW = dict(vocab_size=512, hidden_size=128, n_layers=2, n_heads=8,
              n_kv_heads=2, head_dim=16, intermediate_size=448,
              max_seq_len=256)
# f32 both sides: the same math summed in another order (the tolerances
# of tests/test_torch_llama.py and tests/test_torch_train.py).
ATOL = 1e-4
ATOL_GRAD = 1e-5


def _cfgs(**kw):
    return (jl.LlamaConfig.llama3_8b(dtype=jnp.float32, **NARROW, **kw),
            tl.LlamaConfig.llama3_8b(dtype=torch.float32, **NARROW, **kw))


@pytest.fixture(scope="module")
def weights():
    cj, _ = _cfgs()
    pj = jl.init_params(jax.random.key(0), cj)
    pt = convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")
    return pj, pt


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, NARROW["vocab_size"], shape, dtype=np.int32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, dtype=np.float32), atol=atol)


def _jax_leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _torch_leaves(tree):
    return [t.detach().float().numpy() for t in optim.tree_leaves(tree)]


def test_narrow_config_keeps_the_presets_shape(weights):
    """Group 4, an untied head (its own ``lm_head`` leaf, carried across),
    theta 500,000, and the same param count in both packages."""
    pj, pt = weights
    _, ct = _cfgs()
    assert ct.n_heads // ct.n_kv_heads == 4
    assert not ct.tie_embeddings and ct.rope_theta == 500000.0
    assert tuple(pt["lm_head"].shape) == (128, 512)
    assert tuple(pt["layers"]["wk"].shape) == (2, 128, 32)
    assert tl.param_count(pt) == jl.param_count(pj)


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_forward_matches_jax(weights, impl):
    pj, pt = weights
    cj, ct = _cfgs(attention_impl=impl)
    toks = _tokens(1, (2, 40))
    _close(tl.forward(pt, toks, ct, device="cpu"),
           jl.forward(pj, jnp.asarray(toks), cj))


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_loss_and_grads_match_jax(weights, impl):
    """The flash side: the port's ``_FlashCore`` (k/v expanded to the q
    heads, dk/dv group-summed back) against the reference's custom VJP."""
    pj, pt = weights
    cj, ct = _cfgs(attention_impl=impl)
    toks = _tokens(2, (2, 32))
    lj, gj = jax.value_and_grad(jl.loss_fn)(
        pj, {"tokens": jnp.asarray(toks)}, cj)
    lt, gt = tl.value_and_grad(pt, {"tokens": torch.from_numpy(toks)}, ct,
                               device="cpu")
    np.testing.assert_allclose(float(lt), float(lj), atol=ATOL_GRAD)
    for a, b in zip(_torch_leaves(gt), _jax_leaves(gj)):
        np.testing.assert_allclose(a, b, atol=ATOL_GRAD)


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "fused"])
def test_train_steps_match_jax_optax_chain(weights, fused):
    """3 steps on one batch from the reference's weights, with the flash
    path and the remat policy the card's step uses, against the
    reference's optax-chain step (rtol and atol of
    tests/test_torch_train.py's 8-step trajectory)."""
    pj, pt = weights
    cj, ct = _cfgs(attention_impl="flash", remat_policy="attn")
    toks = _tokens(3, (4, 32))
    ref = jl.init_train_state(jax.random.key(0), cj)  # params == pj
    ref_step = jl.make_train_step(cj, donate=False)
    state = tl.init_train_state(ct, fused=fused, device="cpu")
    state["params"] = optim.tree_map(torch.clone, pt)
    step = tl.make_train_step(ct, fused=fused, device="cpu")
    losses = []
    for _ in range(3):
        ref, mr = ref_step(ref, {"tokens": jnp.asarray(toks)})
        state, mt = step(state, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(mt["loss"]), float(mr["loss"]),
                                   rtol=2e-6)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mr["grad_norm"]), rtol=2e-6)
        losses.append(float(mt["loss"]))
    assert losses[-1] < losses[0]
    for a, b in zip(_torch_leaves(state["params"]),
                    _jax_leaves(ref["params"])):
        np.testing.assert_allclose(a, b, atol=5e-5)


def test_kv_cache_path_matches_jax(weights):
    """prefill_forward -> insert_prefill (one member dropped) ->
    forward_with_cache, against the JAX functions step by step: the
    cache holds 2 kv heads and each decode attends it at group 4."""
    pj, pt = weights
    cj, ct = _cfgs()
    rng = np.random.default_rng(5)
    G, P, B, S = 3, 16, 4, 48
    toks = _tokens(6, (G, P))
    lens = np.array([16, 9, 4])
    slots = np.array([1, -1, 3])
    lj, ksj, vsj = jl.prefill_forward(pj, jnp.asarray(toks),
                                      jnp.asarray(lens), cj)
    lt, kst, vst = tl.prefill_forward(pt, torch.from_numpy(toks),
                                      torch.from_numpy(lens), ct)
    _close(lt, lj)
    _close(kst, ksj)
    _close(vst, vsj)
    assert kst.shape[-2] == 2

    cache_j = jl.init_kv_cache(cj, B, S)
    cache_t = tl.init_kv_cache(ct, B, S, device="cpu")
    cache_j = jl.insert_prefill(cache_j, ksj, vsj, jnp.asarray(slots))
    cache_t = tl.insert_prefill(cache_t, kst, vst, slots)
    pos = np.array([3, 16, 0, 4])
    for t in range(3):
        new = rng.integers(0, NARROW["vocab_size"], (B, 1))
        p = (pos + t)[:, None]
        lj2, cache_j = jl.forward_with_cache(pj, jnp.asarray(new),
                                             jnp.asarray(p), cache_j, cj)
        lt2, cache_t = tl.forward_with_cache(pt, torch.from_numpy(new),
                                             torch.from_numpy(p), cache_t,
                                             ct)
        _close(lt2, lj2)
    _close(cache_t["k"], cache_j["k"])
    _close(cache_t["v"], cache_j["v"])


_ENGINE = dict(max_slots=4, max_len=64, prefill_buckets=(16, 32),
               decode_chunk=8, prefill_groups=(4,))
_PROMPTS = [[5, 9, 200, 3, 77], [1, 2, 3], list(range(30, 51)),
            [(i * 37) % 509 + 1 for i in range(12)]]
_PLANES = {
    "dense": {},
    "paged": dict(paged=True, block_size=8),
    "int8": dict(paged=True, block_size=8, kv_quant="int8"),
    "fp8": dict(paged=True, block_size=8, kv_quant="fp8"),
    "spec": dict(paged=True, block_size=8, spec_k=4),
}


def _generate(server, prompts, n):
    async def run():
        outs = await asyncio.gather(*[
            server.generate({"prompt": p, "max_new_tokens": n})
            for p in prompts])
        return [o["tokens"] for o in outs]

    try:
        return asyncio.run(run())
    finally:
        server.shutdown()


@pytest.mark.parametrize("plane", list(_PLANES))
def test_engine_tokens_match_jax(weights, monkeypatch, plane):
    """The port's engine against the JAX engine, both built from the same
    test-local f32 preset (the preset classmethod with ``NARROW``), the
    same weights and prompts: exact greedy tokens.  The spec plane's
    draft is the default self-draft (the first ``n_layers // 4`` = 1
    layer with the target's norm and head)."""
    for mod, dtype in ((jl, jnp.float32), (tl, torch.float32)):
        monkeypatch.setattr(
            mod.LlamaConfig, "llama3_8b_narrow_f32", classmethod(
                lambda cls, _dt=dtype, **kw: cls.llama3_8b(
                    **{**NARROW, "dtype": _dt, **kw})),
            raising=False)
    pj, pt = weights
    kw = {**_ENGINE, **_PLANES[plane]}
    expect = _generate(JaxServer(model_preset="llama3_8b_narrow_f32",
                                 params=pj, warmup=False, **kw),
                       _PROMPTS, 12)
    port = LLMServer(model_preset="llama3_8b_narrow_f32", params=pt,
                     device="cpu", **kw)
    assert port.cfg.n_kv_heads == 2 and not port.cfg.tie_embeddings
    got = _generate(port, _PROMPTS, 12)
    assert all(len(t) == 12 for t in got)
    assert got == expect, (plane, got, expect)

"""Parity of the port's Llama model (ray_tpu_torch.models.llama) with the
JAX package's, on the ``debug`` config in f32 with the same weights
(carried across with ``convert.from_jax_params``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as tl

# f32 both sides: the same math summed in another order.
ATOL = 1e-4


def _cfgs(**kw):
    return (jl.LlamaConfig.debug(dtype=jnp.float32, **kw),
            tl.LlamaConfig.debug(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def weights():
    cj, _ = _cfgs()
    pj = jl.init_params(jax.random.key(0), cj)
    pt = convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")
    return pj, pt


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, dtype=np.float32), atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_is_bit_exact(dtype):
    cj, ct = _cfgs()
    pj = jl.init_params(jax.random.key(3), cj, dtype=getattr(jnp, dtype))
    pt = convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")
    assert pt["layers"]["wq"].dtype == getattr(torch, dtype)
    assert set(pt) == set(pj) and set(pt["layers"]) == set(pj["layers"])
    back = convert.to_numpy(pt)
    for path, leaf in jax.tree_util.tree_leaves_with_path(pj):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf, np.float32))


@pytest.mark.parametrize("preset", ["debug", "llama_125m", "llama_440m",
                                    "llama2_7b", "llama3_8b", "moe_debug",
                                    "llama_moe_1b"])
def test_presets_keep_their_numbers(preset):
    j = getattr(jl.LlamaConfig, preset)()
    t = getattr(tl.LlamaConfig, preset)()
    for f in dataclasses.fields(t):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.dtype == torch.bfloat16


@pytest.mark.parametrize("kw", [dict(moe_experts=4),
                                dict(attention_impl="ring"),
                                dict(pipeline_microbatches=2)])
def test_unported_features_raise(kw):
    """Features of the reference that the port once refused now build:
    MoE (a config with experts gets the router and expert weights and
    returns the aux loss), ring attention (resolves to the ring kernel
    path) and the pipeline schedule (a pipelined config builds)."""
    cfg = tl.LlamaConfig.debug(**kw)
    assert all(getattr(cfg, k) == v for k, v in kw.items())
    if cfg.attention_impl == "ring":
        from ray_tpu_torch.ops.ring_attention import \
            ring_attention_causal
        assert tl._get_attention_fn(cfg) is ring_attention_causal
    if cfg.moe_experts:
        params = tl.init_params(cfg, device="cpu")
        assert params["layers"]["router"].shape == (2, 64, 4)
        _, aux = tl.forward(params, torch.zeros((1, 8), dtype=torch.long),
                            cfg, device="cpu", return_aux=True)
        assert float(aux) > 0


def test_init_params_layout_matches_jax():
    cj, ct = _cfgs()
    pj = jl.init_params(jax.random.key(0), cj)
    pt = tl.init_params(ct, seed=0, device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(pj):
        node = pt
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
    w = pt["layers"]["w_up"]
    assert w.abs().max() <= 2.0 * ct.hidden_size ** -0.5 + 1e-6
    # Truncated N(0, 1) at +-2 sigma has std ~0.88.
    assert abs(w.std().item() * ct.hidden_size ** 0.5 - 0.88) < 0.05
    assert torch.equal(pt["layers"]["attn_norm"],
                       torch.ones_like(pt["layers"]["attn_norm"]))


@pytest.mark.parametrize("fn", ["rms_norm", "apply_rope", "dot_attention",
                                "_cache_attend"])
def test_building_blocks_match_jax(fn):
    rng = np.random.default_rng(0)
    B, S, Hq, Hkv, D = 2, 12, 4, 2, 16
    if fn == "rms_norm":
        x = rng.standard_normal((B, S, 64)).astype(np.float32)
        s = rng.standard_normal(64).astype(np.float32)
        _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5),
               jl.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5), 1e-5)
    elif fn == "apply_rope":
        x = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
        pos = rng.integers(0, 100, (B, S))
        sj, cj = jl.rope_table(jnp.asarray(pos), D, 10000.0)
        st, ct = tl.rope_table(torch.from_numpy(pos), D, 10000.0)
        _close(st, sj, 1e-5)
        _close(tl.apply_rope(torch.from_numpy(x), st, ct),
               jl.apply_rope(jnp.asarray(x), sj, cj), 1e-4)
    elif fn == "dot_attention":
        q, k, v = (rng.standard_normal((B, S, h, D)).astype(np.float32)
                   for h in (Hq, Hkv, Hkv))
        pos = np.stack([np.arange(S), np.r_[np.arange(5), np.arange(7)]])
        _close(tl.dot_attention(*map(torch.from_numpy, (q, k, v, pos))),
               jl.dot_attention(*map(jnp.asarray, (q, k, v, pos))), 1e-5)
    else:
        T, Sc = 3, 20
        q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
        ck, cv = (rng.standard_normal((B, Sc, Hkv, D)).astype(np.float32)
                  for _ in range(2))
        qpos = np.array([[4, 5, 6], [10, 11, 12]])
        _close(tl._cache_attend(*map(torch.from_numpy, (q, ck, cv, qpos)),
                                D ** -0.5),
               jl._cache_attend(*map(jnp.asarray, (q, ck, cv, qpos)),
                                D ** -0.5), 1e-5)


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_forward_matches_jax(weights, impl):
    """flash: JAX through the Pallas kernel in interpret mode, the port
    through the kernel's plain version (CPU tensors)."""
    pj, pt = weights
    cj, ct = _cfgs(attention_impl=impl)
    toks = np.random.default_rng(1).integers(0, 256, (2, 24))
    _close(tl.forward(pt, toks, ct, device="cpu"),
           jl.forward(pj, jnp.asarray(toks), cj))
    model = tl.LlamaModel(ct, params=pt, device="cpu")
    assert torch.equal(model(toks), tl.forward(pt, toks, ct, device="cpu"))


def test_forward_custom_positions(weights):
    pj, pt = weights
    cj, ct = _cfgs()
    toks = np.random.default_rng(2).integers(0, 256, (2, 16))
    pos = np.stack([np.arange(16), np.r_[np.arange(6), np.arange(10)]])
    _close(tl.forward(pt, toks, ct, positions=pos, device="cpu"),
           jl.forward(pj, jnp.asarray(toks), cj, positions=jnp.asarray(pos)))
    with pytest.raises(NotImplementedError, match="custom positions"):
        tl.forward(pt, toks, _cfgs(attention_impl="flash")[1],
                   positions=pos, device="cpu")


@pytest.mark.parametrize("variant", ["plain", "loss_mask", "positions"])
def test_loss_fn_matches_jax(weights, variant):
    pj, pt = weights
    cj, ct = _cfgs()
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, 256, (2, 20))}
    if variant == "loss_mask":
        batch["loss_mask"] = (rng.random((2, 20)) > 0.3).astype(np.int32)
    if variant == "positions":
        batch["positions"] = np.stack([np.arange(20),
                                       np.r_[np.arange(8), np.arange(12)]])
    lt = tl.loss_fn(pt, batch, ct, device="cpu")
    lj = jl.loss_fn(pj, {k: jnp.asarray(v) for k, v in batch.items()}, cj)
    assert abs(lt.item() - float(lj)) < 1e-5


def test_kv_cache_path_matches_jax(weights):
    """prefill_forward -> insert_prefill (one member dropped) ->
    forward_with_cache, against the JAX functions step by step."""
    pj, pt = weights
    cj, ct = _cfgs()
    rng = np.random.default_rng(5)
    G, P, B, S = 3, 8, 4, 32
    toks = rng.integers(0, 256, (G, P))
    lens = np.array([8, 5, 3])
    slots = np.array([2, -1, 0])

    lj, ksj, vsj = jl.prefill_forward(pj, jnp.asarray(toks),
                                      jnp.asarray(lens), cj)
    lt, kst, vst = tl.prefill_forward(pt, torch.from_numpy(toks),
                                      torch.from_numpy(lens), ct)
    _close(lt, lj)
    _close(kst, ksj)
    _close(vst, vsj)

    cache_j = jl.init_kv_cache(cj, B, S)
    cache_j = {n: a + 0.5 for n, a in cache_j.items()}  # visible untouched
    cache_t = tl.init_kv_cache(ct, B, S, device="cpu")
    cache_t = {n: a + 0.5 for n, a in cache_t.items()}
    cache_j = jl.insert_prefill(cache_j, ksj, vsj, jnp.asarray(slots))
    cache_t = tl.insert_prefill(cache_t, kst, vst, slots)
    _close(cache_t["k"], cache_j["k"])
    _close(cache_t["v"], cache_j["v"])
    assert torch.all(cache_t["k"][:, 1] == 0.5)  # dropped / unused slots
    assert torch.all(cache_t["k"][:, 3] == 0.5)

    T = 2
    new = rng.integers(0, 256, (B, T))
    pos = np.array([8, 3, 3, 31])[:, None] + np.arange(T)  # start clamps
    lj2, cache_j = jl.forward_with_cache(pj, jnp.asarray(new),
                                         jnp.asarray(pos), cache_j, cj)
    lt2, cache_t = tl.forward_with_cache(pt, torch.from_numpy(new),
                                         torch.from_numpy(pos), cache_t, ct)
    _close(lt2, lj2)
    _close(cache_t["k"], cache_j["k"])
    _close(cache_t["v"], cache_j["v"])


# Twins of tests/test_models.py's model invariants, on the port's
# ``debug`` config as the reference's (bf16 compute), on the CPU.
@pytest.fixture(scope="module")
def debug_params():
    cfg = tl.LlamaConfig.debug()
    return cfg, tl.init_params(cfg, seed=0, device="cpu")


def test_initial_loss_near_uniform(debug_params):
    cfg, params = debug_params
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 64))
    loss = float(tl.loss_fn(params, {"tokens": toks}, cfg, device="cpu"))
    uniform = np.log(cfg.vocab_size)
    assert abs(loss - uniform) < 1.5, (loss, uniform)


def test_causality(debug_params):
    """Changing a future token must not change past logits."""
    cfg, params = debug_params
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 16)))
    logits1 = tl.forward(params, toks, cfg, device="cpu")
    toks2 = toks.clone()
    toks2[0, 10] = (toks2[0, 10] + 1) % cfg.vocab_size
    logits2 = tl.forward(params, toks2, cfg, device="cpu")
    assert torch.equal(logits1[0, :10], logits2[0, :10])
    assert not torch.equal(logits1[0, 10:], logits2[0, 10:])

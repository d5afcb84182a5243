"""The port's MoE family (``ray_tpu_torch/models/moe.py`` and the MoE parts
of ``models/llama.py``) against the JAX package's, on the CPU in f32 with
the same weights (carried across with ``convert.from_jax_params``) and the
same inputs (numpy, from a seed).  Values to 1e-5 and gradients to 1e-4,
each as a whole (|got - ref|_2 / |ref|_2), as in test_torch_parallel.py:
the same math summed in another order.  The multi-rank expert-parallel
gates are in test_torch_parallel.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.models import moe as jm
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import moe as tm
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.parallel import MeshSpec, get_abstract_mesh, use_mesh
from ray_tpu_torch.serve.llm import LLMServer
from ray_tpu_torch.train import optim

VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-4
# Capacity factors: 0.5 drops (token, k) assignments, 1.25 is the
# presets' default, 4.0 is the reference's own parity test (no drops).
FACTORS = (0.5, 1.25, 4.0)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _cfgs(cf, **kw):
    base = dict(hidden_size=32, intermediate_size=64, n_experts=4, top_k=2,
                capacity_factor=cf)
    base.update(kw)
    return (jm.MoEConfig(dtype=jnp.float32, **base),
            tm.MoEConfig(dtype=torch.float32, **base))


def _setup(cf, seed=0, shape=(2, 16, 32), **kw):
    cj, ct = _cfgs(cf, **kw)
    pj = jm.init_moe_params(jax.random.key(seed), cj)
    pt = convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)
    return cj, ct, pj, pt, x


def _dropped(x, pt, ct):
    """How many (token, k) assignments overflow their expert."""
    xt = torch.from_numpy(x).reshape(-1, x.shape[-1])
    _, _, idx = tm._route(xt, pt["router"], ct.top_k)
    pos, _ = tm._positions(idx, ct.n_experts)
    return int((pos >= tm.capacity(xt.shape[0], ct)).sum())


# ---------------------------------------------------------------------------
# The Switch FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", FACTORS)
def test_moe_ffn_matches_jax(cf):
    """Output, aux and the routing against the reference's moe_ffn; at
    capacity factor 0.5 some (token, k) are dropped."""
    cj, ct, pj, pt, x = _setup(cf)
    out_j, aux_j = jm.moe_ffn(jnp.asarray(x), pj, cj)
    out_t, aux_t = tm.moe_ffn(torch.from_numpy(x), pt, ct)
    assert _rel(out_t, out_j) <= VALUE_RTOL
    assert _rel(aux_t, aux_j) <= VALUE_RTOL
    xt = x.reshape(-1, x.shape[-1])
    _, _, idx_j = jm._route(jnp.asarray(xt), pj["router"], cj.top_k)
    _, _, idx_t = tm._route(torch.from_numpy(xt), pt["router"], ct.top_k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert tm.capacity(32, ct) == int(max(1, round(32 * 2 / 4 * cf)))
    if cf < 1:
        assert _dropped(x, pt, ct) > 0


@pytest.mark.parametrize("cf", FACTORS)
def test_moe_ffn_matches_onehot_form(cf):
    """The index dispatch against the one-hot form on the same inputs:
    the expert inputs bit for bit (a one-hot product returns each row
    exactly), the output and aux to f32 summation order; at ample
    capacity both equal the no-drop oracle."""
    _, ct, _, pt, x = _setup(cf, seed=3)
    xx = torch.from_numpy(x)
    out, aux, expert_in = tm._moe_ffn(xx, pt, ct)
    out_1h, aux_1h, expert_in_1h = tm._moe_ffn_onehot(xx, pt, ct)
    assert torch.equal(expert_in, expert_in_1h)
    assert _rel(out, out_1h) <= VALUE_RTOL
    assert _rel(aux, aux_1h) <= VALUE_RTOL
    if cf == 4.0:
        assert _dropped(x, pt, ct) == 0
        assert _rel(out, tm.moe_ffn_reference(xx, pt, ct)) <= VALUE_RTOL


def test_moe_ffn_matches_jax_oracle():
    """The port's no-drop oracle is the reference's."""
    cj, ct, pj, pt, x = _setup(4.0, seed=4)
    ref = jm.moe_ffn_reference(jnp.asarray(x), pj, cj)
    assert _rel(tm.moe_ffn_reference(torch.from_numpy(x), pt, ct),
                ref) <= VALUE_RTOL


@pytest.mark.parametrize("cf", (0.5, 4.0))
def test_moe_grads_match_jax(cf):
    """Gradients of sum(out**2) + 0.01*aux for x, the router and the
    three expert weights against jax.grad of the reference: the router
    learns through the renormalised gates and the aux loss; the indices
    and positions carry none."""
    cj, ct, pj, pt, x = _setup(cf, seed=5)

    def loss_j(p, x):
        out, aux = jm.moe_ffn(x, p, cj)
        return jnp.sum(out ** 2) + 0.01 * aux

    gp_j, gx_j = jax.grad(loss_j, argnums=(0, 1))(pj, jnp.asarray(x))
    xx = torch.from_numpy(x).requires_grad_()
    leaves = {k: v.clone().requires_grad_() for k, v in pt.items()}
    out, aux = tm.moe_ffn(xx, leaves, ct)
    loss = (out ** 2).sum() + 0.01 * aux
    grads = torch.autograd.grad(loss, [xx, *leaves.values()])
    assert _rel(grads[0], gx_j) <= GRAD_RTOL
    for name, g in zip(leaves, grads[1:]):
        assert _rel(g, gp_j[name]) <= GRAD_RTOL, name
    if cf < 1:
        assert _dropped(x, pt, ct) > 0


def test_moe_grads_match_onehot_form():
    """The index form's gradients against the one-hot form's (with
    drops)."""
    _, ct, _, pt, x = _setup(0.5, seed=6)
    got = []
    for fn in (tm._moe_ffn, tm._moe_ffn_onehot):
        xx = torch.from_numpy(x).requires_grad_()
        leaves = {k: v.clone().requires_grad_() for k, v in pt.items()}
        out, aux, _ = fn(xx, leaves, ct)
        got.append(torch.autograd.grad((out ** 2).sum() + 0.01 * aux,
                                       [xx, *leaves.values()]))
    for a, b in zip(*got):
        assert _rel(a, b) <= GRAD_RTOL


def test_topk_ties_order_as_jax():
    """Equal probabilities order as jax.lax.top_k: the lower expert index
    first.  A zero router ties all four experts; a router with equal
    columns 1 and 3 ties those two."""
    x = np.random.default_rng(7).standard_normal((6, 8)).astype(np.float32)
    w = np.random.default_rng(8).standard_normal((8, 4)).astype(np.float32)
    w[:, 3] = w[:, 1]
    for router in (np.zeros((8, 4), np.float32), w):
        for k in (1, 2, 3):
            _, gj, ij = jm._route(jnp.asarray(x), jnp.asarray(router), k)
            _, gt, it = tm._route(torch.from_numpy(x),
                                  torch.from_numpy(router), k)
            np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
            np.testing.assert_allclose(gt.numpy(), np.asarray(gj),
                                       rtol=1e-6)
    _, _, it = tm._route(torch.from_numpy(x), torch.zeros(8, 4), 2)
    assert it.tolist() == [[0, 1]] * 6


def test_capacity_rounds_half_to_even():
    """Python's round, as the reference: 2.5 -> 2, 3.5 -> 4."""
    cfg = tm.MoEConfig(hidden_size=8, intermediate_size=8, n_experts=4,
                       top_k=1, capacity_factor=1.0)
    assert [tm.capacity(t, cfg) for t in (10, 14, 1)] == [2, 4, 1]


def test_moe_param_logical_axes_match_jax():
    assert tm.moe_param_logical_axes() == jm.moe_param_logical_axes()
    for tie in (True, False):
        assert tl.param_logical_axes(tl.LlamaConfig.moe_debug(
            tie_embeddings=tie)) == jl.param_logical_axes(
            jl.LlamaConfig.moe_debug(tie_embeddings=tie))


def test_init_moe_params_shapes():
    cj, ct = _cfgs(1.25)
    pt = tm.init_moe_params(ct, seed=0, device="cpu")
    pj = jm.init_moe_params(jax.random.key(0), cj)
    assert {k: tuple(v.shape) for k, v in pt.items()} == \
        {k: tuple(v.shape) for k, v in pj.items()}


# ---------------------------------------------------------------------------
# The MoE model family
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_weights():
    cj = jl.LlamaConfig.moe_debug(dtype=jnp.float32)
    pj = jl.init_params(jax.random.key(0), cj)
    pt = convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")
    return pj, pt


def _model_cfgs(**kw):
    return (jl.LlamaConfig.moe_debug(dtype=jnp.float32, **kw),
            tl.LlamaConfig.moe_debug(dtype=torch.float32, **kw))


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.update(_flat(tree[key], f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(tree[key], np.float32)
    return out


def test_moe_forward_matches_jax(moe_weights):
    """Twin of tests/test_models.py's MoE forward test: logits and the
    summed aux against JAX's forward(return_aux=True); aux sits in the
    reference's band around n_layers; return_aux=False is the logits."""
    pj, pt = moe_weights
    cj, ct = _model_cfgs()
    toks = _tokens(1, (2, 16))
    lj, aj = jl.forward(pj, jnp.asarray(toks), cj, return_aux=True)
    lt, at = tl.forward(pt, torch.from_numpy(toks), ct, device="cpu",
                        return_aux=True)
    assert lt.shape == (2, 16, ct.vocab_size)
    assert _rel(lt, lj) <= VALUE_RTOL
    assert _rel(at, aj) <= VALUE_RTOL
    assert 0.5 * ct.n_layers < float(at) < 3.0 * ct.n_layers
    assert torch.equal(tl.forward(pt, torch.from_numpy(toks), ct,
                                  device="cpu"), lt)


def test_dense_forward_return_aux_is_zero():
    cfg = tl.LlamaConfig.debug(dtype=torch.float32)
    params = tl.init_params(cfg, device="cpu")
    logits, aux = tl.forward(params, torch.zeros((1, 8), dtype=torch.long),
                             cfg, device="cpu", return_aux=True)
    assert float(aux) == 0.0 and logits.shape == (1, 8, cfg.vocab_size)


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_moe_loss_and_grads_match_jax(moe_weights, impl):
    """loss_fn (cross-entropy + moe_aux_weight * aux / n_layers) and its
    gradients against jax.value_and_grad of the reference."""
    pj, pt = moe_weights
    cj, ct = _model_cfgs(attention_impl=impl)
    toks = _tokens(2, (2, 32))
    lj, gj = jax.value_and_grad(jl.loss_fn)(
        pj, {"tokens": jnp.asarray(toks)}, cj)
    lt, gt = tl.value_and_grad(pt, {"tokens": torch.from_numpy(toks)}, ct,
                               device="cpu")
    assert _rel(lt, lj) <= VALUE_RTOL
    ref = _flat(jax.tree.map(np.asarray, gj))
    got = _flat(convert.to_numpy(gt))
    assert set(got) == set(ref)
    for key in ref:
        assert _rel(got[key], ref[key]) <= GRAD_RTOL, key


@pytest.mark.parametrize("policy", tl.REMAT_POLICIES)
def test_moe_remat_policy_keeps_loss_and_grads(moe_weights, policy,
                                               monkeypatch):
    """Every remat policy on a MoE layer gives the loss and gradients of
    remat=False on the flash path; the flash forward runs once per layer
    where the policy keeps its residuals ("attn", "attn_ffn") and twice
    where the layer is recomputed whole."""
    _, pt = moe_weights
    _, base = _model_cfgs(attention_impl="flash")
    toks = {"tokens": torch.from_numpy(_tokens(3, (2, 32)))}
    calls = []
    fwd = tfa._fwd

    def counting_fwd(*args, **kwargs):
        calls.append(1)
        return fwd(*args, **kwargs)

    monkeypatch.setattr(tfa, "_fwd", counting_fwd)
    want_loss, want = tl.value_and_grad(pt, toks, base, device="cpu")
    calls.clear()
    cfg = dataclasses.replace(base, remat=True, remat_policy=policy)
    loss, grads = tl.value_and_grad(pt, toks, cfg, device="cpu")
    per_step = 1 if policy in ("attn", "attn_ffn") else 2
    assert len(calls) == per_step * cfg.n_layers
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-6)
    for a, b in zip(optim.tree_leaves(grads), optim.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "fused"])
def test_moe_train_steps_match_jax_optax_chain(moe_weights, fused):
    """4 steps of the port's chain and fused steps against the
    reference's optax-chain make_train_step (donate=False): loss and
    grad norm per step."""
    pj, pt = moe_weights
    cj, ct = _model_cfgs()
    toks = _tokens(4, (8, 32))
    ref = {**jl.init_train_state(jax.random.key(0), cj), "params": pj}
    ref_step = jl.make_train_step(cj, donate=False)
    state = tl.init_train_state(ct, fused=fused, device="cpu")
    state["params"] = optim.tree_map(torch.clone, pt)
    step = tl.make_train_step(ct, fused=fused, device="cpu")
    for _ in range(4):
        ref, mr = ref_step(ref, {"tokens": jnp.asarray(toks)})
        state, mt = step(state, {"tokens": torch.from_numpy(toks)})
        assert _rel(float(mt["loss"]), float(mr["loss"])) <= VALUE_RTOL
        assert _rel(float(mt["grad_norm"]),
                    float(mr["grad_norm"])) <= GRAD_RTOL


def test_moe_train_step_reduces_loss():
    """Twin of tests/test_models.py's: the default moe_debug config (bf16
    compute, f32 params) learns one batch in 10 steps."""
    cfg = tl.LlamaConfig.moe_debug()
    state = tl.init_train_state(cfg, seed=0, device="cpu")
    step = tl.make_train_step(cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(5, (8, 32)))}
    losses = []
    for _ in range(10):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, losses


def test_llama_moe_1b_param_count():
    """Counted from shapes on both sides (nothing allocated): the
    reference's docstring says ~1.6B; the shapes say 2,549,597,184, of
    which 737,657,856 are active per token with top-2 of 8 experts."""
    cj = jl.LlamaConfig.llama_moe_1b()
    ct = tl.LlamaConfig.llama_moe_1b()
    nj = jl.param_count(jax.eval_shape(
        lambda: jl.init_params(jax.random.key(0), cj)))
    shapes = tl.param_shapes(ct)
    assert nj == tl.param_count(shapes) == 2_549_597_184
    experts = sum(shapes["layers"][k].numel() for k in tm.EXPERT_WEIGHTS)
    assert experts == 2_415_919_104
    assert nj - experts + experts * ct.moe_top_k // ct.moe_experts == \
        737_657_856


def test_param_shapes_match_init_params():
    for cfg in (tl.LlamaConfig.moe_debug(tie_embeddings=False),
                tl.LlamaConfig.debug()):
        got = _flat(convert.to_numpy(tl.init_params(cfg, device="cpu")))
        want = tl.param_shapes(cfg)
        assert {k: v.shape for k, v in got.items()} == {
            f"layers/{k}" if k in want["layers"] else k: tuple(v.shape)
            for k, v in {**want, **want["layers"]}.items()
            if k != "layers"}


def test_convert_round_trips_moe_params(moe_weights):
    """from_jax_params of a moe_debug pytree and back: bit for bit."""
    pj, pt = moe_weights
    back = convert.to_numpy(pt)
    ref = jax.tree.map(np.asarray, pj)
    assert set(_flat(back)) == set(_flat(ref))
    for key, value in _flat(ref).items():
        np.testing.assert_array_equal(_flat(back)[key], value)
    assert pt["layers"]["w_gate"].shape == (2, 4, 64, 128)


# ---------------------------------------------------------------------------
# What MoE refuses, with the reference's typed errors
# ---------------------------------------------------------------------------

def test_moe_refusals():
    """GPipe with MoE, and every KV-cache path on a MoE config
    (prefill_forward, forward_with_cache, LLMServer on the slot and
    paged planes), raise NotImplementedError before any work."""
    cfg = tl.LlamaConfig.moe_debug(dtype=torch.float32)
    params = tl.init_params(cfg, device="cpu")
    tok = torch.zeros((2, 8), dtype=torch.long)
    with use_mesh(get_abstract_mesh(MeshSpec(pipe=2))):
        with pytest.raises(NotImplementedError, match="pipeline stages"):
            tl.forward(params, tok, dataclasses.replace(
                cfg, pipeline_microbatches=2), device="cpu")
    with pytest.raises(NotImplementedError, match="KV-cache decode for MoE"):
        tl.prefill_forward(params, tok, torch.full((2,), 8), cfg)
    cache = tl.init_kv_cache(cfg, 2, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="KV-cache decode for MoE"):
        tl.forward_with_cache(params, tok, torch.arange(8).expand(2, 8),
                              cache, cfg)
    for paged in (False, True):
        with pytest.raises(NotImplementedError,
                           match="serve with a dense config"):
            LLMServer(model_preset="moe_debug", max_slots=2, max_len=32,
                      prefill_buckets=(16,), paged=paged, device="cpu")

"""Parity of the port's training path (``models.llama`` loss, gradients,
remat policies and train step; ``train.optim``) with the JAX package's,
on the ``debug`` config in f32 with the same weights (carried across with
``convert.from_jax_params``) and the same batches (numpy, from a seed).
The JAX flash path runs its Pallas kernels in interpret mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.train import optim


def _cfgs(**kw):
    return (jl.LlamaConfig.debug(dtype=jnp.float32, **kw),
            tl.LlamaConfig.debug(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def weights():
    cj, _ = _cfgs()
    pj = jl.init_params(jax.random.key(0), cj)
    pt = convert.from_jax_params(jax.tree.map(np.asarray, pj), device="cpu")
    return pj, pt


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _jax_leaves(tree):
    """JAX tree leaves in the port's order (sorted keys, as tree_leaves)."""
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _torch_leaves(tree):
    return [t.detach().float().numpy() for t in optim.tree_leaves(tree)]


def test_param_count_matches_jax(weights):
    pj, pt = weights
    assert tl.param_count(pt) == jl.param_count(pj)


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_loss_and_grads_match_jax(weights, impl):
    """loss_fn's value and gradients through autograd (the flash path:
    the _FlashCore autograd Function and the plain backward) against
    jax.value_and_grad of the reference (its custom VJP, interpret
    mode).  f32 both sides: the same math summed in another order."""
    pj, pt = weights
    cj, ct = _cfgs(attention_impl=impl)
    toks = _tokens(1, (2, 32))
    lj, gj = jax.value_and_grad(jl.loss_fn)(pj, {"tokens": jnp.asarray(toks)},
                                            cj)
    lt, gt = tl.value_and_grad(pt, {"tokens": torch.from_numpy(toks)}, ct,
                               device="cpu")
    np.testing.assert_allclose(float(lt), float(lj), atol=1e-5)
    for a, b in zip(_torch_leaves(gt), _jax_leaves(gj)):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("policy", tl.REMAT_POLICIES)
def test_remat_policy_keeps_loss_and_grads(weights, policy, monkeypatch):
    """Every remat policy gives the loss and gradients of remat=False on
    the flash path (a checkpointed segment recomputes the same f32 ops in
    the same order on the CPU; 1e-6 leaves room for nothing else).  The
    flash forward runs once per layer per step where the policy keeps
    its residuals ("attn", "attn_ffn") and twice where the layer is
    recomputed whole."""
    _, pt = weights
    _, base = _cfgs(attention_impl="flash")
    toks = {"tokens": torch.from_numpy(_tokens(2, (2, 32)))}
    calls = []
    fwd = tfa._fwd

    def counting_fwd(*args, **kwargs):
        calls.append(1)
        return fwd(*args, **kwargs)

    monkeypatch.setattr(tfa, "_fwd", counting_fwd)
    want_loss, want = tl.value_and_grad(pt, toks, base, device="cpu")
    assert len(calls) == base.n_layers
    calls.clear()
    cfg = dataclasses.replace(base, remat=True, remat_policy=policy)
    loss, grads = tl.value_and_grad(pt, toks, cfg, device="cpu")
    per_step = 1 if policy in ("attn", "attn_ffn") else 2
    assert len(calls) == per_step * cfg.n_layers
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-6)
    for a, b in zip(_torch_leaves(grads), _torch_leaves(want)):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_unknown_remat_policy_raises(weights):
    _, pt = weights
    cfg = dataclasses.replace(tl.LlamaConfig.debug(), remat=True,
                              remat_policy="bogus")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tl._remat_policy(cfg)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tl.loss_fn(pt, {"tokens": [[1, 2, 3]]}, cfg, device="cpu")


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "fused"])
def test_train_trajectory_matches_jax_optax_chain(weights, fused):
    """8 steps on one batch, shaped like tests/test_models.py's fused
    parity test: the port's chain step and its fused step each against
    the reference's optax-chain make_train_step (donate=False), in f32.
    Measured on the CPU: loss and grad norm agree per step to 3.4e-7 and
    6.8e-7 relative (rtol 2e-6 leaves room for thread-count-dependent
    sums).  After 8 steps params agree to 4.7e-6, except in the embedding
    rows whose f32 gradient is ~1e-5 or less: there summation order moves
    the gradient by ~1e-3 of itself, and Adam's per-element
    normalisation carries that into the update, up to 2.6e-5 at lr 3e-4
    (atol 5e-5; the reference's own fused-vs-chain test allows 1e-4)."""
    pj, pt = weights
    cj, ct = _cfgs()
    toks = _tokens(5, (8, 32))
    ref = jl.init_train_state(jax.random.key(0), cj)  # params == pj
    ref_step = jl.make_train_step(cj, donate=False)
    state = tl.init_train_state(ct, fused=fused, device="cpu")
    # The reference's weights; the moments start at zero either way.
    state["params"] = optim.tree_map(torch.clone, pt)
    step = tl.make_train_step(ct, fused=fused, device="cpu")
    for _ in range(8):
        ref, mr = ref_step(ref, {"tokens": jnp.asarray(toks)})
        state, mt = step(state, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(mt["loss"]), float(mr["loss"]),
                                   rtol=2e-6)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mr["grad_norm"]), rtol=2e-6)
        assert int(mt["step"]) == int(mr["step"])
    for a, b in zip(_torch_leaves(state["params"]),
                    _jax_leaves(ref["params"])):
        np.testing.assert_allclose(a, b, atol=5e-5)


@pytest.mark.parametrize("norm", [0.5, 3.0])
def test_clip_trigger_matches_optax(norm):
    """Below 1.0 the gradients pass untouched (bit for bit); at or above
    it they are scaled to norm 1.0, as optax.clip_by_global_norm(1.0)
    does on the same numbers."""
    rng = np.random.default_rng(6)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (5,))]
    scale = norm / np.sqrt(sum(float((x ** 2).sum()) for x in leaves))
    leaves = [(x * scale).astype(np.float32) for x in leaves]
    grads = {"a": torch.from_numpy(leaves[0]),
             "b": torch.from_numpy(leaves[1])}
    clipped, gnorm = optim._clip(optim.tree_leaves(grads), 1.0)
    np.testing.assert_allclose(float(gnorm), norm, rtol=1e-6)
    want, _ = optax.clip_by_global_norm(1.0).update(
        {"a": jnp.asarray(leaves[0]), "b": jnp.asarray(leaves[1])},
        optax.EmptyState())
    for got, ref, raw in zip(clipped, jax.tree.leaves(want), leaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
        if norm < 1.0:
            assert np.array_equal(got.numpy(), raw)
    new_norm = float(optim.global_norm(clipped))
    np.testing.assert_allclose(new_norm, min(norm, 1.0), rtol=1e-6)


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "fused"])
def test_donate_false_leaves_input_state_untouched(fused):
    cfg = tl.LlamaConfig.debug(dtype=torch.float32)
    state = tl.init_train_state(cfg, seed=0, fused=fused, device="cpu")
    step = tl.make_train_step(cfg, fused=fused, donate=False, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(7, (2, 16)))}
    state, _ = step(state, batch)  # non-zero moments and count
    before = [t.clone() for t in optim.tree_leaves(state)]
    new, metrics = step(state, batch)
    after = optim.tree_leaves(state)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(new["step"]) == 2 and int(metrics["step"]) == 2
    assert not torch.equal(new["params"]["final_norm"],
                           state["params"]["final_norm"])
    # donate=True updates the same tensors in place.
    donating = tl.make_train_step(cfg, fused=fused, device="cpu")
    ids = [t.data_ptr() for t in optim.tree_leaves(new)]
    newer, _ = donating(new, batch)
    assert [t.data_ptr() for t in optim.tree_leaves(newer)] == ids
    assert int(newer["step"]) == 3


def test_fused_with_an_optimizer_raises():
    cfg = tl.LlamaConfig.debug()
    with pytest.raises(ValueError, match="fused"):
        tl.make_train_step(cfg, optimizer=tl.default_optimizer(),
                           fused=True, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        tl.init_train_state(cfg, optimizer=tl.default_optimizer(),
                            fused=True, device="cpu")


def test_train_step_reduces_loss():
    """As tests/test_models.py checks the reference: the default debug
    config (bf16 compute, f32 params) learns one batch in 10 steps."""
    cfg = tl.LlamaConfig.debug()
    state = tl.init_train_state(cfg, seed=0, device="cpu")
    step = tl.make_train_step(cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(5, (8, 32)))}
    losses = []
    for _ in range(10):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses
    assert int(state["step"]) == 10


class _CountProducts(TorchDispatchMode):
    """Counts aten.mm / aten.bmm calls made while it is active."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def test_selective_remat_policies_keep_their_products(weights):
    """What each policy recomputes in the backward, counted: "dots"
    keeps every aten.mm output (the projections) and recomputes the
    rest, "dots_saveable" keeps aten.bmm too (the plain attention's
    products), "full" recomputes both."""
    _, pt = weights
    _, base = _cfgs(attention_impl="flash")
    toks = {"tokens": torch.from_numpy(_tokens(2, (2, 32)))}

    def backward_products(cfg):
        leaves = [t.detach().requires_grad_()
                  for t in optim.tree_leaves(pt)]
        loss = tl.loss_fn(optim.tree_unflatten(pt, leaves), toks, cfg,
                          device="cpu")
        with _CountProducts() as mode:
            torch.autograd.grad(loss, leaves)
        return mode.counts

    plain = backward_products(base)
    counts = {p: backward_products(dataclasses.replace(
        base, remat=True, remat_policy=p))
        for p in ("full", "dots", "dots_saveable")}
    assert counts["full"]["mm"] > plain["mm"]
    assert counts["full"]["bmm"] > plain["bmm"]
    assert counts["dots"] == {"mm": plain["mm"],
                              "bmm": counts["full"]["bmm"]}
    assert counts["dots_saveable"] == plain


def test_train_step_runs_under_a_profiler_range():
    """Each step is one ``train.step`` range in a profiler trace."""
    cfg = tl.LlamaConfig.debug(dtype=torch.float32)
    state = tl.init_train_state(cfg, seed=0, device="cpu")
    step = tl.make_train_step(cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(8, (2, 16)))}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state, _ = step(state, batch)
    ranges = [e for e in prof.events() if e.name == "train.step"]
    assert len(ranges) == 2

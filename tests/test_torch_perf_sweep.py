"""The port's throughput sweep (``ray_tpu_torch/tools/perf_sweep.py``)
against the repository's ``perf_sweep.py``, and the bf16 first moment it
needs (``train/optim.ClipAdamW(mu_dtype=...)``) against optax, on the
CPU.

- The case table is the reference's without its three ``scan_unroll``
  cases (the port's layers are a Python loop, not ``lax.scan``).
- ``ClipAdamW(mu_dtype=torch.bfloat16)`` against ``optax.chain(
  clip_by_global_norm(1.0), adamw(3e-4, weight_decay=0.1,
  mu_dtype=bfloat16))`` over 5 steps on seeded numpy params and
  gradients (global norms 2.6 to 12.9: the clip acts every step): the
  stored first moment bit for bit, params and the second moment to rtol
  1e-6 (f32 sums in another order).
- ``mu_dtype=None`` gives, bit for bit, what ``ClipAdamW`` gave before
  the option: a copy of that update is the oracle here.
- ``run_one`` on the CPU at a shrunken preset prints its JSON line.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import perf_sweep as ref
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.tools import perf_sweep as port
from ray_tpu_torch.train import optim

SCAN_UNROLL = {"attn-unroll2-b8", "attn-unroll4-b8", "full-unroll2-b8"}
SHAPES = {"a": (64, 32), "b": {"c": (128,), "d": (16, 8, 4)}}
STEPS = 5


def test_cases_are_the_references_without_scan_unroll():
    assert all("scan_unroll" in ref.CASES[t]["kw"] for t in SCAN_UNROLL)
    want = {t: c for t, c in ref.CASES.items() if t not in SCAN_UNROLL}
    assert port.CASES == want
    assert list(port.CASES) == list(want)


def _tree(rng, scale):
    return jax.tree.map(
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
        SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _inputs():
    rng = np.random.default_rng(0)
    return _tree(rng, 1.0), [_tree(rng, 0.05 * (i + 1))
                             for i in range(STEPS)]


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("inplace", [False, True])
def test_bf16_first_moment_matches_optax(inplace):
    params, grads = _inputs()
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(3e-4, weight_decay=0.1,
                                 mu_dtype=jnp.bfloat16))
    pj = jax.tree.map(jnp.asarray, params)
    sj = tx.init(pj)
    opt = optim.ClipAdamW(3e-4, weight_decay=0.1, clip_norm=1.0,
                          mu_dtype=torch.bfloat16)
    pt = _torch(params)
    st = opt.init(pt)
    assert all(m.dtype == torch.bfloat16 for m in optim.tree_leaves(st.mu))
    for g in grads:
        assert float(optax.global_norm(g)) > 1.0  # the clip acts
        u, sj = tx.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, u)
        ut, st = opt.update(_torch(g), st, pt, inplace=inplace)
        pt = optim.apply_updates(pt, ut, inplace=inplace)
    adam = sj[1][0]
    for j, t in zip(jax.tree.leaves(adam.mu), optim.tree_leaves(st.mu)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            np.asarray(j.astype(jnp.float32)), t.float().numpy())
    for j, t in zip(jax.tree.leaves(adam.nu) + jax.tree.leaves(pj),
                    optim.tree_leaves(st.nu) + optim.tree_leaves(pt)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    assert int(st.count) == int(adam.count) == STEPS


def _update_before_mu_dtype(grads, state, params, lr, b1, b2, eps, wd,
                            clip):
    """ClipAdamW.update as it was before ``mu_dtype`` (not in place)."""
    g, _ = optim._clip(optim.tree_leaves(grads), clip)
    mu = [t.clone() for t in optim.tree_leaves(state.mu)]
    nu = [t.clone() for t in optim.tree_leaves(state.nu)]
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, g, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
    count = state.count + 1
    c1, c2 = optim._bias_corrections(count, b1, b2)
    denom = torch._foreach_div(nu, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    u = torch._foreach_div(mu, c1)
    torch._foreach_div_(u, denom)
    torch._foreach_add_(u, optim.tree_leaves(params), alpha=wd)
    torch._foreach_mul_(u, -lr)
    return (optim.tree_unflatten(grads, u),
            optim.ClipAdamWState(count, optim.tree_unflatten(state.mu, mu),
                                 optim.tree_unflatten(state.nu, nu)))


def test_f32_first_moment_is_unchanged():
    params, grads = _inputs()
    opt = optim.ClipAdamW(3e-4, weight_decay=0.1, clip_norm=1.0)
    assert opt.mu_dtype is None
    pt, po = _torch(params), _torch(params)
    st, so = opt.init(pt), opt.init(po)
    for g in grads:
        ut, st = opt.update(_torch(g), st, pt)
        pt = optim.apply_updates(pt, ut)
        uo, so = _update_before_mu_dtype(_torch(g), so, po, 3e-4, 0.9,
                                         0.999, 1e-8, 0.1, 1.0)
        po = optim.apply_updates(po, uo)
        for a, b in zip(optim.tree_leaves((ut, st.mu, st.nu, pt)),
                        optim.tree_leaves((uo, so.mu, so.nu, po))):
            assert a.dtype == torch.float32
            assert torch.equal(a, b)


def test_run_one_prints_a_line_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(port, "SEQ", 32)
    monkeypatch.setattr(tl.LlamaConfig, "llama_440m", classmethod(
        lambda cls, **kw: cls.debug(**{"attention_impl": "flash",
                                       "remat": True,
                                       "remat_policy": "attn", **kw})))
    monkeypatch.setitem(port.CASES, "tiny-bf16mu",
                        dict(kw={"n_layers": 1}, batch=2, bf16_mu=True))
    tps = port.run_one("tiny-bf16mu", device="cpu")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"tag": "tiny-bf16mu", "tps": round(tps, 1), "mfu": None}
    assert tps > 0

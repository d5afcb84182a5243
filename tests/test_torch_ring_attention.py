"""The port's ring attention (ray_tpu_torch.ops.ring_attention) against
the JAX package's reference attention, on the CPU (where each ring step
runs the flash kernels' plain versions), as tests/test_ops.py:84 and :95
check the JAX ring: the forward per shard count and the backward.  The
distributed ring runs on eight gloo processes (tests/
_torch_gloo_worker.py); the on-device chunk schedule, which chip_smoke.py
runs on the card, in this process.  f32; tolerances as the reference's
tests state them (forward 2e-5, backward 5e-4, absolute and relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_gloo_worker as gloo
from ray_tpu.models.llama import dot_attention
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops import ring_attention as tra

FWD_TOL = 2e-5
BWD_TOL = 5e-4


def _qkv(seed, B, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, h, D)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]


def _positions(B, S):
    return jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))


def _ref_grads(q, k, v):
    pos = _positions(q.shape[0], q.shape[1])

    def loss(q, k, v):
        return jnp.sum(dot_attention(q, k, v, pos) ** 2)

    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


@pytest.mark.net
def test_ring_forward_and_backward_match_reference(tmp_path):
    """Eight ranks: the ring over seq=2 and seq=4 shards (the other ranks
    of the mesh on the data axis) against dot_attention, and the
    gradients of sum(out**2) at seq=4 against JAX's."""
    B, S, Hq, Hkv, D = 2, 256, 4, 2, 32
    q, k, v = _qkv(4, B, S, Hq, Hkv, D)
    ref = np.asarray(dot_attention(*map(jnp.asarray, (q, k, v)),
                                   _positions(B, S)))
    grads = [np.asarray(g) for g in _ref_grads(q, k, v)]
    outs = gloo.run_ranks("ring", 8, tmp_path, {"q": q, "k": k, "v": v})
    for out in outs:
        for seq in (2, 4):
            np.testing.assert_allclose(out[f"fwd_seq{seq}"], ref,
                                       atol=FWD_TOL, rtol=FWD_TOL)
        for name, want in zip("qkv", grads):
            np.testing.assert_allclose(out[f"grad_{name}"], want,
                                       atol=BWD_TOL, rtol=BWD_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_chunk_schedule_matches_reference(n):
    """The ring's schedule over n chunks held on one device (what
    chip_smoke.py runs on the card): the outputs and the gradients of
    sum(out**2) against JAX's dot_attention, GQA included."""
    B, S, Hq, Hkv, D = 1, 256, 4, 2, 32
    q, k, v = _qkv(5, B, S, Hq, Hkv, D)
    ref = np.asarray(dot_attention(*map(jnp.asarray, (q, k, v)),
                                   _positions(B, S)))
    grads = _ref_grads(q, k, v)
    ins = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    chunks = [t.chunk(n, dim=1) for t in ins]
    out = torch.cat(tra._ring_chunks(*chunks), dim=1)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=FWD_TOL,
                               rtol=FWD_TOL)
    got = torch.autograd.grad((out ** 2).sum(), ins)
    for name, g, want in zip("qkv", got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   atol=BWD_TOL, rtol=BWD_TOL, err_msg=name)


def test_merge_ignores_a_masked_partial():
    """A partial whose lse is -1e30 contributes nothing to the merge."""
    g = torch.Generator().manual_seed(0)
    o = torch.randn(1, 2, 8, 4, generator=g)
    lse = torch.randn(1, 2, 8, 1, generator=g)
    m_o, m_lse = tra._merge(o, lse, torch.randn(1, 2, 8, 4, generator=g),
                            torch.full_like(lse, tfa.NEG_INF))
    assert torch.equal(m_o, o) and torch.allclose(m_lse, lse)


def test_ring_without_mesh_is_flash_attention():
    """No mesh (or a trivial seq axis): the reference's fallback to
    single-device flash attention."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(6, 1, 64, 2, 2, 16))
    assert torch.equal(tra.ring_attention(q, k, v),
                       tfa.flash_attention(q, k, v, causal=True))

"""Parity of the port's flash attention, forward and backward
(ray_tpu_torch.ops.flash_attention), with the JAX package's Pallas
kernels, run in interpret mode on the CPU.

On the CPU the port's wrappers run the kernels' plain versions
(``_fwd_reference``, ``_bwd_reference``); the CUDA kernels themselves are
checked against those plain versions on the card
(``tests/test_torch_flash_kernels.py -m cuda``, and chip_smoke.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("ray_tpu.ops.flash_attention")

# f32: same algorithm, sums in another order (online vs global max).
# bf16: both sides round p and o to bf16, at different points.
_ATOL = {"f32": 1e-5, "bf16": 2e-2}
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(seed, B, Hq, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32) * D ** -0.5
    k = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa", "mqa"])
def test_fwd_reference_matches_jax_fwd(heads, causal, dtype):
    """o and the width-1 lse of the plain version equal the Pallas
    kernel's (interpret mode), two 64-wide tiles per axis so the JAX
    side runs its online softmax across blocks."""
    Hq, Hkv = heads
    Sq, Sk = (128, 128) if causal else (64, 128)
    q, k, v = _inputs(0, 2, Hq, Hkv, Sq, Sk, 32)
    oj, lj = jfa._fwd(*(jnp.asarray(a).astype(_JDT[dtype])
                        for a in (q, k, v)),
                      causal=causal, block_q=64, block_k=64, interpret=True)
    ot, lt = tfa._fwd(*(torch.from_numpy(a).to(_TDT[dtype])
                        for a in (q, k, v)), causal)
    assert ot.dtype == _TDT[dtype] and lt.dtype == torch.float32
    assert tuple(lt.shape) == (2, Hq, Sq, 1)
    atol = _ATOL[dtype]
    np.testing.assert_allclose(ot.float().numpy(),
                               np.asarray(oj.astype(jnp.float32)), atol=atol)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=atol)


def test_flash_attention_causal_pad_path_matches_jax():
    """S=100 is not a multiple of 128: both wrappers pad, run, slice."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 100, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 100, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 100, 2, 16)).astype(np.float32)
    oj = jfa.flash_attention_causal(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v))
    ot = tfa.flash_attention_causal(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v))
    assert tuple(ot.shape) == (2, 100, 4, 16)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)


def test_fully_masked_rows_give_zero_and_neg_inf_lse():
    q = torch.randn(1, 2, 5, 16)
    k = v = torch.zeros(1, 1, 0, 16)
    o, lse = tfa._fwd(q, k, v, causal=False)
    assert torch.equal(o, torch.zeros_like(q))
    assert torch.all(lse == tfa.NEG_INF)


def test_custom_positions_rejected():
    q = torch.randn(1, 8, 2, 16)
    pos = torch.arange(8)[None] + 3
    with pytest.raises(NotImplementedError, match="standard causal"):
        tfa.flash_attention_causal(q, q, q, positions=pos)
    # The default layout passes.
    out = tfa.flash_attention_causal(q, q, q, positions=torch.arange(8)[None])
    assert out.shape == q.shape


def test_requires_grad_raises():
    """A call whose inputs require grad now returns gradients (finite,
    one per input, in the inputs' shapes and dtypes); what still raises
    is a backward call whose k/v are not at q's heads."""
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 1, 16, requires_grad=True)
    v = torch.randn(1, 8, 1, 16, requires_grad=True)
    out = tfa.flash_attention_causal(q, k, v)
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    for t, g in zip((q, k, v), grads):
        assert g.shape == t.shape and g.dtype == t.dtype
        assert torch.isfinite(g).all() and g.abs().sum() > 0
    qt = q.detach().transpose(1, 2)
    o, lse = tfa._fwd(qt, k.detach().transpose(1, 2),
                      v.detach().transpose(1, 2), True)
    with pytest.raises(ValueError, match="q's heads"):
        tfa._bwd_impl(qt, k.detach().transpose(1, 2),
                      v.detach().transpose(1, 2), o, lse, o, True)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    tfa.reset_launch_counts()
    q = torch.randn(1, 2, 64, 16)
    o, lse = tfa._fwd(q, q, q, causal=True)
    ro, rl = tfa._fwd_reference(q, q, q, causal=True)
    assert torch.equal(o, ro) and torch.equal(lse, rl)
    assert tfa.launch_counts["flash_fwd"] == 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa", "mqa"])
def test_bwd_reference_matches_jax_bwd_impl(heads, causal, dtype):
    """dq, dk, dv of the plain backward equal the Pallas dq and dk/dv
    kernels' (interpret mode, two 64-wide tiles per axis), with k/v
    expanded to q's heads as the custom VJP does, from the same q, k, v,
    do and the same forward o and lse."""
    Hq, Hkv = heads
    Sq, Sk = (128, 128) if causal else (64, 128)
    q, k, v = _inputs(2, 2, Hq, Hkv, Sq, Sk, 32)
    k, v = (np.repeat(a, Hq // Hkv, axis=1) for a in (k, v))
    do = np.random.default_rng(3).standard_normal(q.shape).astype(
        np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(_JDT[dtype])
                       for a in (q, k, v, do))
    o, lse = jfa._fwd(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                      interpret=True)
    want = jfa._bwd_impl(jq, jk, jv, o, lse, jdo, causal=causal,
                         block_q=64, block_k=64, interpret=True)
    tq, tk, tv, tdo, to = (
        torch.from_numpy(np.array(a.astype(jnp.float32))).to(_TDT[dtype])
        for a in (jq, jk, jv, jdo, o))
    got = tfa._bwd_impl(tq, tk, tv, to, torch.from_numpy(np.array(lse)),
                        tdo, causal)
    for name, t, j in zip(("dq", "dk", "dv"), got, want):
        assert t.dtype == torch.float32, name
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   atol=_ATOL[dtype], err_msg=name)


def test_flash_attention_causal_grads_match_jax():
    """torch.autograd.grad through the port's flash_attention_causal
    against jax.vjp of the JAX one, f32, GQA (4 q heads on 2 kv heads)
    at S=100: the pad path, the scale chain (dq through q * D**-0.5) and
    the group-sum of dk/dv.  f32 both sides: the same math summed in
    another order."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 100, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 100, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 100, 2, 16)).astype(np.float32)
    do = rng.standard_normal((2, 100, 4, 16)).astype(np.float32)
    _, vjp = jax.vjp(jfa.flash_attention_causal, jnp.asarray(q),
                     jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention_causal(*ins)
    got = torch.autograd.grad(out, ins, torch.from_numpy(do))
    for name, t, i, j in zip(("dq", "dk", "dv"), got, ins, want):
        assert t.shape == i.shape, name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("dtype,D,family", [
    (torch.bfloat16, 128, "wgmma"), (torch.float16, 64, "wgmma"),
    (torch.float16, 16, "wgmma"), (torch.float32, 128, "simple"),
    (torch.bfloat16, 72, "simple"), (torch.float16, 8, "simple"),
    (torch.float32, 256, "simple"), (torch.bfloat16, 512, "simple"),
])
def test_kernel_family_by_dtype_and_head_dim(dtype, D, family):
    """The CUDA dispatch picks its kernels by dtype and head dim, as the
    reference's flash_attention picks its path by shape: bf16 and f16 at
    the wgmma head dims run the wgmma kernels, f32 and every other head
    dim the reference tiles (D <= 128, multiples of 128) the simple
    family."""
    assert tfa.kernel_family(dtype, D) == family


def test_kernel_family_refuses_what_no_kernel_takes():
    """Only another dtype and a head dim below 1 are refused: the
    reference's flash_attention returns a result at every D, and the
    simple family takes every D >= 1 (wider than 128 in slices of 128
    columns), in f32, bf16 and f16."""
    with pytest.raises(TypeError, match="f32, bf16 or f16"):
        tfa.kernel_family(torch.float64, 128)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for D in (200, 640, 1024):
            assert tfa.kernel_family(dtype, D) == "simple", (dtype, D)
        with pytest.raises(ValueError, match="D >= 1"):
            tfa.kernel_family(dtype, 0)


def test_f32_and_other_head_dims_match_jax_on_the_cpu():
    """The dtypes and head dims of the simple family (f32; D = 72, 256,
    and 200 and 640, which the kernels split into 128-column slices)
    through the port's wrappers (their plain versions here) against the
    JAX kernels in interpret mode, forward and backward."""
    for D, Sq in ((72, 128), (256, 64), (200, 64), (640, 64)):
        q, k, v = _inputs(7, 1, 2, 2, Sq, Sq, D)
        jo, jl = jfa._fwd(*map(jnp.asarray, (q, k, v)), causal=True,
                          block_q=None, block_k=None, interpret=True)
        o, lse = tfa._fwd(*map(torch.from_numpy, (q, k, v)), causal=True)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-5)
        do = np.random.default_rng(8).standard_normal(q.shape).astype(
            np.float32)
        ref = jfa._bwd_impl(*map(jnp.asarray, (q, k, v)), jo, jl,
                            jnp.asarray(do), causal=True, block_q=None,
                            block_k=None, interpret=True)
        got = tfa._bwd_impl(*map(torch.from_numpy, (q, k, v)), o, lse,
                            torch.from_numpy(do), causal=True)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4,
                                       rtol=1e-4)

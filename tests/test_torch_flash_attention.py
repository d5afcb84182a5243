"""Parity of the port's flash forward (ray_tpu_torch.ops.flash_attention)
with the JAX package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the port's wrapper runs the kernel's plain version
(``_fwd_reference``); the CUDA kernel itself is checked against that
plain version on the card (``-m cuda``, and chip_smoke.py).
"""

import importlib

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
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        tfa.flash_attention_causal(q, q.detach(), q.detach())
    with torch.no_grad():
        tfa.flash_attention_causal(q, q, q)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    tfa.reset_launch_counts()
    q = torch.randn(1, 2, 64, 16)
    o, lse = tfa._fwd(q, q, q, causal=True)
    ro, rl = tfa._fwd_reference(q, q, q, causal=True)
    assert torch.equal(o, ro) and torch.equal(lse, rl)
    assert tfa.launch_counts["flash_fwd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("shape,causal", [
    ((2, 8, 2, 256, 256, 128), True),
    ((1, 4, 4, 100, 190, 64), False),
    ((1, 2, 1, 77, 77, 16), True),
])
def test_kernel_matches_plain_version_on_card(shape, causal, layout):
    """The sm_90a kernel against its plain version on the same bf16
    inputs (o within a few bf16 ulps, lse to f32 summation order), on
    contiguous (B, H, S, D) tensors and on (B, H, S, D) views of the
    model's (B, S, H, D) tensors, which it reads through their strides."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    B, Hq, Hkv, Sq, Sk, D = shape
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(b, h, s, d):
        if layout == "bhsd":
            return torch.randn(b, h, s, d, generator=g, device="cuda"
                               ).to(torch.bfloat16)
        return torch.randn(b, s, h, d, generator=g, device="cuda"
                           ).to(torch.bfloat16).transpose(1, 2)

    q = randn(B, Hq, Sq, D) * D ** -0.5
    k, v = randn(B, Hkv, Sk, D), randn(B, Hkv, Sk, D)
    before = tfa.launch_counts["flash_fwd"]
    o, lse = tfa._fwd(q, k, v, causal)
    ro, rl = tfa._fwd_reference(q, k, v, causal)
    assert tfa.launch_counts["flash_fwd"] == before + 1
    assert o.stride() == q.stride()
    assert (o.float() - ro.float()).abs().max().item() <= 1e-2
    assert (lse - rl).abs().max().item() <= 1e-3

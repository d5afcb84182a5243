"""The port's flash-attention CUDA kernels against their plain PyTorch
versions, on the card.  They need an NVIDIA GPU (sm_90a) and nvcc and
skip without one.  This file imports neither jax nor ray_tpu, so it runs
on a GPU machine that has only the port's requirements:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_kernels.py
"""

import ctypes
import subprocess

import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as tfa

# Tolerances, kernel vs plain version on the same bf16 inputs.
# Forward: o is rounded to bf16 (a few ulps of |o| < ~1), lse is an f32
# log-sum-exp of identical f32 scores summed in another order.
TOL_O = 1e-2
TOL_LSE = 1e-3
# Backward: the error of each gradient as a whole, |got - ref|_2 /
# |ref|_2 (the reference first rounded to the gradient's own dtype).
# Both versions round p and ds to bf16 at the same points from f32
# values that differ only in summation order and exp's last bits, so a
# rounding flips by one bf16 ulp (2**-8 relative) in a small share of the
# elements.  A bound on the largest element would not do: causal dq and
# dv peak in the first rows or last keys at 10-100x their typical size,
# and a kernel that drops whole tiles of the later rows stays under it
# (test_grad_check_refuses_planted_fault).
TOL_GRAD_REL = 1e-3
# Whole autograd chains, the card's against the CPU's (forward kernel
# included): o is rounded to bf16 in both, and the forward kernel's o
# differs from the plain forward's by one bf16 ulp in some elements;
# delta = rowsum(do * o) carries that into every ds of the row, and dk,
# a sum of ds that nearly cancel, feels it most.  Read on an H100: dk
# 1.04e-3 at (2, 200, 8->2, 64).
TOL_CHAIN_GRAD_REL = 5e-3


def _grad_err(got, ref):
    """|got - ref|_2 / |ref|_2 in f32, ``ref`` rounded to got's dtype."""
    ref = ref.to(got.dtype).float()
    return ((got.float() - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")


def _randn(g, layout, b, h, s, d):
    """A bf16 (B, H, S, D) tensor on the card: contiguous (``"bhsd"``) or
    a view of a (B, S, H, D) tensor (``"bshd"``, the model's layout)."""
    if layout == "bhsd":
        return torch.randn(b, h, s, d, generator=g, device="cuda"
                           ).to(torch.bfloat16)
    return torch.randn(b, s, h, d, generator=g, device="cuda"
                       ).to(torch.bfloat16).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("shape,causal", [
    ((2, 8, 2, 256, 256, 128), True),
    ((1, 4, 4, 100, 190, 64), False),
    ((1, 2, 1, 77, 77, 16), True),
    ((1, 4, 2, 100, 0, 64), False),
    ((1, 32, 8, 2048, 2048, 128), True),
])
def test_kernel_matches_plain_version_on_card(shape, causal, layout):
    """The sm_90a forward kernel against its plain version on the same
    bf16 inputs, on contiguous (B, H, S, D) tensors and on (B, H, S, D)
    views of the model's (B, S, H, D) tensors, which it reads through
    their strides; with Sk = 0 every row is fully masked.  The last case
    is llama3_8b's attention (32 q heads over 8 kv heads) at a mid
    length."""
    _needs_card()
    B, Hq, Hkv, Sq, Sk, D = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    q = _randn(g, layout, B, Hq, Sq, D) * D ** -0.5
    k, v = _randn(g, layout, B, Hkv, Sk, D), _randn(g, layout, B, Hkv, Sk, D)
    before = tfa.launch_counts["flash_fwd"]
    o, lse = tfa._fwd(q, k, v, causal)
    ro, rl = tfa._fwd_reference(q, k, v, causal)
    assert tfa.launch_counts["flash_fwd"] == before + 1
    assert o.stride() == q.stride()
    assert (o.float() - ro.float()).abs().max().item() <= TOL_O
    assert (lse - rl).abs().max().item() <= TOL_LSE


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("shape,causal", [
    ((2, 4, 256, 256, 128), True),
    ((1, 4, 100, 190, 64), False),
    ((1, 2, 77, 77, 16), True),
    ((1, 2, 130, 70, 32), True),
    ((1, 2, 100, 190, 64), True),
    ((2, 3, 50, 50, 128), True),
    ((2, 2, 200, 100, 128), False),
    ((1, 32, 2048, 2048, 128, 8), True),
])
def test_bwd_kernels_match_plain_version_on_card(shape, causal, layout):
    """dq (B2) and dk/dv (B3) against ``_bwd_reference`` on the same bf16
    inputs, with ragged tiles on both axes, each launch counter rising by
    one per call.  Sq = 50 leaves B2's second consumer warpgroup (rows
    64..127) without rows; Sq = 130 gives B2 a block whose second
    warpgroup has none; Sk = 100 and 190 end inside a 64-key tile.  A
    sixth entry is a kv head count: k/v are drawn with that many heads
    and expanded to q's as ``_FlashCore`` does (the last case is
    llama3_8b's attention, group 4, at a mid length)."""
    _needs_card()
    B, H, Sq, Sk, D, *kv = shape
    Hkv = kv[0] if kv else H
    g = torch.Generator(device="cuda").manual_seed(1)
    q = _randn(g, layout, B, H, Sq, D) * D ** -0.5
    k, v = (_randn(g, layout, B, Hkv, Sk, D),
            _randn(g, layout, B, Hkv, Sk, D))
    if Hkv != H:
        k, v = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    do = _randn(g, layout, B, H, Sq, D)
    o, lse = tfa._fwd(q, k, v, causal)
    before = dict(tfa.launch_counts)
    grads = tfa._bwd_impl(q, k, v, o, lse, do, causal)
    refs = tfa._bwd_reference(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert tfa.launch_counts["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert tfa.launch_counts["flash_bwd_dkdv"] == \
        before["flash_bwd_dkdv"] + 1
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert torch.isfinite(got).all(), name
        err = _grad_err(got, ref)
        assert err <= TOL_GRAD_REL, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("D", tfa._SUPPORTED_D)
def test_every_head_dim_on_card(D):
    """Every supported head dimension runs on the card, forward and
    backward, against the plain versions: up to 64 the kernels use one
    64-column box per tile, above it two, and TMA zero-fills the columns
    past D.  Ragged Sq != Sk, causal, GQA in the forward."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    q = _randn(g, "bshd", 1, 4, 150, D) * D ** -0.5
    k, v = _randn(g, "bshd", 1, 2, 130, D), _randn(g, "bshd", 1, 2, 130, D)
    o, lse = tfa._fwd(q, k, v, True)
    ro, rl = tfa._fwd_reference(q, k, v, True)
    assert (o.float() - ro.float()).abs().max().item() <= TOL_O
    assert (lse - rl).abs().max().item() <= TOL_LSE
    k, v = (t.repeat_interleave(2, dim=1) for t in (k, v))
    do = _randn(g, "bshd", 1, 4, 150, D)
    grads = tfa._bwd_impl(q, k, v, o, lse, do, True)
    refs = tfa._bwd_reference(q, k, v, o, lse, do, True)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        err = _grad_err(got, ref)
        assert err <= TOL_GRAD_REL, (name, err)


@pytest.mark.cuda
def test_flash_core_gradients_on_card_match_plain_version():
    """Autograd through flash_attention_causal on the card (GQA, S not a
    multiple of 128: pad, scale, both kernels, group-sum, slice) against
    the same chain on the CPU, where the wrappers run the plain
    versions, from the same bf16 inputs."""
    _needs_card()
    g = torch.Generator().manual_seed(2)
    shapes = [(2, 200, 8, 64), (2, 200, 2, 64), (2, 200, 2, 64),
              (2, 200, 8, 64)]
    q, k, v, do = (torch.randn(*s, generator=g).to(torch.bfloat16)
                   for s in shapes)
    out = {}
    for device in ("cuda", "cpu"):
        ins = [t.to(device).requires_grad_() for t in (q, k, v)]
        o = tfa.flash_attention_causal(*ins)
        out[device] = torch.autograd.grad(o, ins, do.to(device))
    for name, got, ref in zip(("dq", "dk", "dv"), out["cuda"], out["cpu"]):
        assert got.dtype == torch.bfloat16
        err = _grad_err(got.cpu(), ref)
        assert err <= TOL_CHAIN_GRAD_REL, (name, err)


@pytest.mark.cuda
def test_zero_stride_gradient_takes_a_contiguous_copy_on_card(monkeypatch):
    """The gradient autograd hands over after a ``sum()`` is an expanded
    tensor with zero strides, which the kernels cannot read: the wrapper
    copies it, and the result matches the CPU chain's."""
    _needs_card()
    zero_strided = []
    operand = tfa._kernel_operand

    def recording_operand(t, *args):
        if t.is_cuda and 0 in t.stride():
            zero_strided.append(tuple(t.stride()))
        return operand(t, *args)

    monkeypatch.setattr(tfa, "_kernel_operand", recording_operand)
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 128, 2, 32, generator=g).to(torch.bfloat16)
               for _ in range(3))
    out = {}
    for device in ("cuda", "cpu"):
        ins = [t.to(device).requires_grad_() for t in (q, k, v)]
        o = tfa.flash_attention_causal(*ins)
        out[device] = torch.autograd.grad(o.sum(), ins)
    assert zero_strided, "the gradient reached the kernels with strides"
    for name, got, ref in zip(("dq", "dk", "dv"), out["cuda"], out["cpu"]):
        err = _grad_err(got.cpu(), ref)
        assert err <= TOL_CHAIN_GRAD_REL, (name, err)


# The f32 simple family against the plain version in f32: both sum f32
# products of the same f32 inputs, in another order (and the kernel's
# softmax online), so each output as a whole agrees to a few f32 ulps of
# accumulation: |got - ref|_2 / |ref|_2.
TOL_F32_REL = 1e-5


def _randn_dtype(g, dtype, b, h, s, d):
    """A (B, H, S, D) view of a (B, S, H, D) tensor of ``dtype`` on the
    card."""
    return torch.randn(b, s, h, d, generator=g, device="cuda"
                       ).to(dtype).transpose(1, 2)


def _check_fwd_bwd(dtype, shape, causal, family, seed):
    """Forward and backward of ``family`` at ``dtype`` against the plain
    versions on the same inputs, each launch counter rising by one."""
    B, Hq, Hkv, Sq, Sk, D = shape
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 oracle
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn_dtype(g, dtype, B, Hq, Sq, D) * D ** -0.5
    k, v = (_randn_dtype(g, dtype, B, Hkv, Sk, D) for _ in range(2))
    sfx = {"simple": "_simple", "wgmma": "_f16"}[family]
    before = dict(tfa.launch_counts)
    o, lse = tfa._fwd(q, k, v, causal)
    ro, rl = tfa._fwd_reference(q, k, v, causal)
    assert tfa.launch_counts["flash_fwd" + sfx] == \
        before["flash_fwd" + sfx] + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.float32:
        assert _grad_err(o, ro) <= TOL_F32_REL
        assert _grad_err(lse, rl) <= TOL_F32_REL
    else:
        assert (o.float() - ro.float()).abs().max().item() <= TOL_O
        assert (lse - rl).abs().max().item() <= TOL_LSE
    kf, vf = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (k, v))
    do = _randn_dtype(g, dtype, B, Hq, Sq, D)
    grads = tfa._bwd_impl(q, kf, vf, o, lse, do, causal)
    refs = tfa._bwd_reference(q, kf, vf, o, lse, do, causal)
    torch.cuda.synchronize()
    for kernel in ("flash_bwd_dq", "flash_bwd_dkdv"):
        assert tfa.launch_counts[kernel + sfx] == before[kernel + sfx] + 1
    tol = TOL_F32_REL if dtype == torch.float32 else TOL_GRAD_REL
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        err = _grad_err(got, ref)
        assert err <= tol, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [
    ((2, 4, 2, 256, 256, 128), True),
    ((1, 4, 4, 100, 190, 64), False),
    ((1, 2, 1, 77, 77, 16), True),
])
def test_f16_wgmma_kernels_match_plain_version_on_card(shape, causal):
    """B1, B2 and B3 instantiated for f16 (f16 tensor maps and wgmma
    operands, f32 lse and gradients) against the plain versions."""
    _needs_card()
    assert tfa.kernel_family(torch.float16, shape[-1]) == "wgmma"
    _check_fwd_bwd(torch.float16, shape, causal, "wgmma", seed=11)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape,causal", [
    ((1, 4, 2, 150, 130, 72), True),
    ((1, 2, 2, 100, 190, 40), False),
    ((1, 2, 1, 96, 96, 256), True),
    ((1, 2, 2, 70, 70, 512), False),
    ((2, 2, 2, 130, 130, 128), True),
    ((1, 4, 2, 150, 130, 200), True),
    ((1, 2, 2, 70, 70, 640), False),
])
def test_simple_family_matches_plain_version_on_card(dtype, shape, causal):
    """The simple CUDA-core family (forward, dq with its delta pre-pass,
    dk/dv) at each dtype and at head dims outside the wgmma kernels'
    (72, 40, 256, 512; 200 and 640; every D past 128 runs as 128-column
    slices), and at D = 128 in f32, against the plain versions; f32 to a
    relative 1e-5 (no tf32 anywhere)."""
    _needs_card()
    D = shape[-1]
    family = tfa.kernel_family(dtype, D)
    if family != "simple":
        pytest.skip(f"{dtype} at D={D} runs on the wgmma kernels")
    _check_fwd_bwd(dtype, shape, causal, "simple", seed=12)


# Planted faults: each inserts one line before an anchor of a kernel
# source (a copy, built apart from the real library) so that a kernel
# drops one tile's contribution.  The consumer warpgroups skip a tile
# after it has landed and, once all four of their warps have seen it,
# still release its stage, so the producer's ring runs on.
_B2_ANCHOR = "      if (skip) {"
_B3_ANCHOR = "        const int q0 = i * kDkdvRows;"
_B1_ANCHOR = "      const int k0 = (n_tiles - 1 - it) * kBlockN;"
_RELEASE = ("bar_sync(threadIdx.x / 128, 128); if (tid == 0) "
            "mbar_arrive(empty + st); continue;")
_FAULTS = {
    # B2 skips the second K/V tile it walks from the diagonal in every
    # block.
    "dq_skips_a_k_tile": (_B2_ANCHOR, "      skip = skip || it == 1;\n",
                          "dq"),
    # B2 skips it in the last q tile of each (b, h) only (the blocks
    # launched first).
    "dq_skips_a_k_tile_in_one_block": (
        _B2_ANCHOR, "      skip = skip || (it == 1 && blockIdx.z == 0);\n",
        "dq"),
    # B3 skips the third 64-row q tile of every 128-key tile but the last
    # (which has two).
    "dkdv_skips_a_q_tile": (
        _B3_ANCHOR, f"        if (i == first + 2) {{ {_RELEASE} }}\n",
        "dv"),
}
_FWD_FAULTS = {
    # B1 skips the second K/V tile it walks in every q tile past the first.
    "fwd_skips_a_kv_tile": (
        _B1_ANCHOR, "      if (it == 1) { mbar_wait(full_v + st, ph); "
        f"{_RELEASE} }}\n"),
}

# The simple family's: B1s and B3s walk a stream of chunks, each behind
# one barrier, so skipping a chunk's product (after its barrier) keeps
# the ring running.
_SIMPLE_FAULTS = {
    # B1s skips the PV chunks of the second K/V tile of every q tile past
    # the first.
    "fwd_simple_skips_a_kv_tile": (
        "      const float* Pc = Ps + vc * kChunk;",
        "      if (k0 == kFwdKeys) continue;\n", "o"),
    # B2s skips the dQ += dS K chunks of the second K/V tile of every q
    # tile past the first.
    "dq_simple_skips_a_k_tile": (
        "      const float* dSc = Ps + kc * kChunk;",
        "      if (k0 == kFwdKeys) continue;\n", "dq"),
    # B3s skips dV and dK of the third q tile of every key tile.
    "dkdv_simple_skips_a_q_tile": (
        "      const int pc = rc * kChunk;",
        "      if (q0 == (first + 2) * kBwdRows) continue;\n", "dv"),
}


def _planted_library(tmp_path, source, anchor, line):
    name = source.split(".")[0]
    src = (_build.CSRC / source).read_text()
    assert src.count(anchor) == 1, anchor
    cu = tmp_path / f"{name}_planted.cu"
    cu.write_text(src.replace(anchor, line + anchor))
    so = tmp_path / f"lib{name}_planted.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in tfa._LIBS[name][1].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_grad_check_refuses_planted_fault(fault, tmp_path, monkeypatch):
    """At the train path's shape and layout, (8, 8, 2048, 128) causal on
    (B, S, H, D) views, the real kernels pass the gradient check and a
    copy of them with one tile dropped fails it.  Prints both readings
    (run with ``-s``)."""
    _needs_card()
    anchor, line, grad = _FAULTS[fault]
    B, H, S, D = 8, 8, 2048, 128
    g = torch.Generator(device="cuda").manual_seed(4)
    q = _randn(g, "bshd", B, H, S, D) * D ** -0.5
    k, v = _randn(g, "bshd", B, H, S, D), _randn(g, "bshd", B, H, S, D)
    do = _randn(g, "bshd", B, H, S, D)
    o, lse = tfa._fwd(q, k, v, True)
    refs = dict(zip(("dq", "dk", "dv"),
                    tfa._bwd_reference(q, k, v, o, lse, do, True)))
    real = dict(zip(("dq", "dk", "dv"),
                    tfa._bwd_impl(q, k, v, o, lse, do, True)))
    lib = _planted_library(tmp_path, "flash_bwd.cu", anchor, line)
    real_lib = tfa._lib
    monkeypatch.setattr(tfa, "_lib", lambda name: lib if name == "flash_bwd"
                        else real_lib(name))
    planted = dict(zip(("dq", "dk", "dv"),
                       tfa._bwd_impl(q, k, v, o, lse, do, True)))
    real_err = _grad_err(real[grad], refs[grad])
    planted_err = _grad_err(planted[grad], refs[grad])
    print(f"{fault}: {grad} |d|/|ref| real {real_err:.3e}, planted "
          f"{planted_err:.3e} (tol {TOL_GRAD_REL})")
    assert real_err <= TOL_GRAD_REL
    assert planted_err > TOL_GRAD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(_FWD_FAULTS))
def test_fwd_check_refuses_planted_fault(fault, tmp_path, monkeypatch):
    """At the forward path's shape and layout, (4, 8, 2048, 128) causal on
    (B, S, H, D) views, the real forward kernel passes the check against
    its plain version (|do| <= 1e-2, |dlse| <= 1e-3) and a copy of it that
    drops one K/V tile fails it.  Prints both readings (run with
    ``-s``)."""
    _needs_card()
    anchor, line = _FWD_FAULTS[fault]
    B, H, S, D = 4, 8, 2048, 128
    g = torch.Generator(device="cuda").manual_seed(6)
    q = _randn(g, "bshd", B, H, S, D) * D ** -0.5
    k, v = _randn(g, "bshd", B, H, S, D), _randn(g, "bshd", B, H, S, D)
    ro, rl = tfa._fwd_reference(q, k, v, True)

    def readings():
        o, lse = tfa._fwd(q, k, v, True)
        return ((o.float() - ro.float()).abs().max().item(),
                (lse - rl).abs().max().item())

    real = readings()
    lib = _planted_library(tmp_path, "flash_fwd.cu", anchor, line)
    real_lib = tfa._lib
    monkeypatch.setattr(tfa, "_lib", lambda name: lib if name == "flash_fwd"
                        else real_lib(name))
    planted = readings()
    print(f"{fault}: max|do|, max|dlse| real {real[0]:.3e}, {real[1]:.3e}; "
          f"planted {planted[0]:.3e}, {planted[1]:.3e} (tol {TOL_O}, "
          f"{TOL_LSE})")
    assert real[0] <= TOL_O and real[1] <= TOL_LSE
    assert planted[0] > TOL_O or planted[1] > TOL_LSE


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(_SIMPLE_FAULTS))
def test_simple_check_refuses_planted_fault(fault, tmp_path, monkeypatch):
    """At the f32 path's shape and layout, (4, 8, 2048, 128) causal on
    (B, S, H, D) views, the real simple kernels pass the f32 check
    (|d|_2 / |ref|_2 <= 1e-5) and a copy of flash_simple.cu that drops
    one tile of B1s, B2s or B3s fails it.  The backward runs on the plain
    forward's o and lse, so each reading is of one kernel.  Prints both
    readings (run with ``-s``)."""
    _needs_card()
    anchor, line, out = _SIMPLE_FAULTS[fault]
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, S, D = 4, 8, 2048, 128
    g = torch.Generator(device="cuda").manual_seed(9)
    q = _randn_dtype(g, torch.float32, B, H, S, D) * D ** -0.5
    k, v, do = (_randn_dtype(g, torch.float32, B, H, S, D)
                for _ in range(3))
    ro, rl = tfa._fwd_reference(q, k, v, True)
    grads = ("dq", "dk", "dv")
    ref = dict(zip(grads, tfa._bwd_reference(q, k, v, ro, rl, do, True)),
               o=ro)

    def reading():
        if out == "o":
            return _grad_err(tfa._fwd(q, k, v, True)[0], ref["o"])
        got = dict(zip(grads, tfa._bwd_impl(q, k, v, ro, rl, do, True)))
        return _grad_err(got[out], ref[out])

    real = reading()
    lib = _planted_library(tmp_path, "flash_simple.cu", anchor, line)
    real_lib = tfa._lib
    monkeypatch.setattr(tfa, "_lib", lambda name: lib
                        if name == "flash_simple" else real_lib(name))
    planted = reading()
    print(f"{fault}: {out} |d|/|ref| real {real:.3e}, planted "
          f"{planted:.3e} (tol {TOL_F32_REL})")
    assert real <= TOL_F32_REL
    assert planted > TOL_F32_REL

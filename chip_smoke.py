#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 (or
another sm_90a card), nvcc and a CUDA build of PyTorch.  It builds every
kernel of the port's main path from the sources in the checkout, holds
each against its plain PyTorch version, times it, drives the main path
through the entry points a user would call, and checks the results:

1. card name and power limit (nvidia-smi);
2. kernel build (one nvcc per source, all started together: the wgmma
   forward, the wgmma backward and the simple family), with its time and
   ptxas register report; it fails if ptxas ignored a kernel's
   setmaxnreg or spilled its registers, or if the simple family's
   machine code (cuobjdump -sass) holds a tensor-core instruction;
3. flash forward kernel vs its plain version, bf16, at four shapes;
4. kernel time vs its bound, the plain version and PyTorch's SDPA
   (timed as a yardstick only; the port never calls it), at the
   forward's shape (B=4) and at the train step's (B=8);
5. llama_440m forward, attention_impl="flash", bf16, B=4 x S=2048, random
   weights from a seed: finite logits, 24 kernel launches, agreement
   with the same forward under attention_impl="dot";
6. LLMServer(llama_440m, max_slots=8, max_len=512) answering 8
   concurrent requests (bf16: TTFT and decode tok/s), then an f32 engine
   whose first tokens must equal the argmax of the port's forward;
6b. the paged serving plane at llama_440m (:func:`paged_phase`, block
   size 16, the default 257 blocks): the bf16 planes paged, paged+int8,
   paged+fp8 and paged+spec (spec_k=4, 6-layer self-draft) and a dense
   engine, 3 rounds in turns of 8 requests (TTFT, decode tok/s,
   allocator, pool bytes, accept rate, the pool sizes checked against
   their reckoning), each pool's gather + scatter of one chunk against
   its bound, the TTFT of 8 requests that share a 128-token prefix, cold
   and warm; then its gates: f32
   tokens identical across dense, paged, paged+spec with the self-draft
   and with an independent llama_125m draft; f32 warm == cold with prefix
   hits, a same-wave pair and a warm wave of 8 equal to dense; bf16
   self-draft spec == independent-draft spec; the int8/fp8 error bounds
   and fixed point on real K rows, with the card's bytes equal to the
   CPU's; pool pressure (preemption, f32 tokens equal to the unpressured
   run, the allocator back to the trie's count, typed shedding);
7. flash backward kernels (dq, dk/dv) vs their plain version, bf16, at
   four shapes, one of them through autograd and one through GQA;
8. their times vs their bounds, the plain version and SDPA's backward;
9. llama_440m loss gradients in bf16, flash and dot attention, against an
   f32 dot reference: the flash path may be no less accurate;
10. llama_440m training through init_train_state / make_train_step
    (fused AdamW, remat_policy="attn", B=8 x S=2048, bf16 compute, f32
    params and moments): 3 warm-up and 10 timed steps, finite and falling
    loss, 24 launches of each flash kernel per step; then 2 steps of the
    optax-chain counterpart, whose losses must match;
11. fault C1's kernels: the f16 instantiations of the three wgmma
    kernels and the simple CUDA-core family (f32 at the main path's
    shape (4, 8, 2048, 128), causal and not; bf16 and f32 at D = 256, at
    D = 72 and at D = 200, f32 at D = 640) against their plain versions,
    then their times against their bounds (the simple family's at the
    f32 CUDA-core peak), the plain versions and SDPA, with the kernels
    the profiler saw SDPA launch;
12. llama_440m on the flash path in f32 (the simple family) and in f16:
    the forward at B=4 x S=2048 (f32 against plain attention) and 3
    train steps each, finite and falling loss, with the launch counts;
13. ring attention's chunk schedule on one device (``ops/ring_attention.
    _ring_chunks``): Hq = Hkv = 8, D = 128, S = 8192 in 4 chunks, bf16
    (16 launches of each wgmma kernel: 4 diagonal, 12 off-diagonal),
    then f32 at S = 4096 on the simple family; output and gradients
    against flash attention on the whole sequence;
14. the llama_440m bf16 train step with its params through
    ``shard_params`` under ``use_mesh(local_mesh())``: the same losses,
    bit for bit, as without a mesh;
15. one JSON line per kernel, then the result line;
16. (run before 15) the MoE family (:func:`moe_ffn_phase`,
    :func:`moe_train_phase`): the Switch FFN's index dispatch against
    its one-hot plain version at one llama_moe_1b layer's width (D =
    1024, H = 4096, E = 8, top-2, capacity 1.25, T = 8 x 2048), output,
    aux, expert inputs and gradients in f32 and bf16, the drop share and
    both forms' times; then llama_moe_1b (2.55 B params, 737.7 M active
    per token) trained at B=8 x S=2048 with the fused AdamW: 2 warm-up
    and 5 timed steps, finite and falling loss, its aux in the
    reference's band, the flash launches per step, step time, tok/s, the
    6 N_active share of the bf16 peak and peak memory against its
    reckoning; then 2 steps of the optax-chain counterpart.
17. (run after 6b) the local runtime and the Serve plane
    (:func:`runtime_phase`), in a fresh ``ray_tpu_torch.init()``:
    the card advertised as ``GPU``; a 256 MiB bf16 CUDA tensor through
    ``put``/``get`` (same bytes on cuda:0, no aliasing, the times
    against one on-device copy's bound); a ``@remote(num_gpus=1)`` task
    running the llama_440m flash forward (B=4 x S=2048, bf16, 24 B1
    launches, added to the kernels line) whose last-position logits
    equal the direct call's bit for bit; f32 tokens equal between a
    direct engine, a deployment's handle and its HTTP proxy, the card
    held while deployed, the engine's series tagged with the deployment
    and the card's memory back after ``serve.delete``; bf16 TTFT and
    decode tok/s direct and deployed in turns, the handle hop and the
    device busy share of a device-plane trace; the device plane's
    gauges against ``torch.cuda.memory_stats`` and a trace holding
    ``serve.decode_chunk``.

``--profile DIR`` adds a torch.profiler pass over the forward, over one
more round of requests and over one train step, and writes op tables
under ``DIR``.

Any failed check exits non-zero before the result line is printed.  It
also exits non-zero, with no result, when no CUDA device is present or
the ``ray_tpu_torch`` package is not beside this script.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks of one H100 SXM (NVIDIA data sheet): bf16 (and
# fp16) tensor cores, f32 outside the tensor cores (the simple kernel
# family's FMAs; not the tf32 rate), and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12

# Tolerances.  Kernel vs plain version on the same bf16 inputs: o is
# rounded to bf16 (ulp 2**-8 relative) and p is rounded to bf16 against a
# running rather than global max, so |do| stays within a few bf16 ulps of
# |o| (|o| is mostly below 1 at these shapes; the largest |do| measured
# on an H100 is 3.9e-3); lse is an f32 log-sum-exp of identical f32
# scores summed in another order.
TOL_O = 1e-2
TOL_LSE = 1e-3
# llama_440m bf16 logits (and loss gradients) against an f32 reference:
# the flash path's max and mean error may exceed the plain dot path's by
# at most this factor (both are bf16 rounding compounded over 24 layers;
# the kernels round p, o and ds to bf16 at other points than the plain
# path does).
TOL_ERR_RATIO = 1.5
# Backward kernels vs their plain version on the same bf16 inputs: the
# error of each gradient as a whole, |got - ref|_2 / |ref|_2 (the
# reference first rounded to the gradient's own dtype where autograd
# returns bf16).  A largest-element rule cannot be used: causal dq and dv
# peak in the first rows or last keys at 10-100x their typical size, so
# a bound on the largest element lets a kernel drop whole tiles of the
# later rows.  Both versions round p and ds to bf16 at the same points
# from f32 values that differ only in summation order and exp's last
# bits, so a rounding flips by one bf16 ulp (2**-8 relative) in a small
# share of the elements.  On an H100 the error read 3.3e-5 to 1.9e-4 at
# the four shapes below, and 1.4e-2 to 3.8e-1 for kernels that drop one
# 64-wide tile at the first shape (tests/test_torch_flash_kernels.py::
# test_grad_check_refuses_planted_fault).
TOL_GRAD_REL = 1e-3
# Fused AdamW vs the optax-chain counterpart, first two losses from the
# same state and batch: the first is the same computation; the second
# runs on params that differ by the f32 rounding of one AdamW step, which
# can flip a few bf16 casts at the matmuls.
TOL_CHAIN_LOSS_REL = 1e-3
# Train phase shape (the repo's llama_440m bench shape) and step counts.
TRAIN_B, TRAIN_S, TRAIN_WARM, TRAIN_TIMED, CHAIN_STEPS = 8, 2048, 3, 10, 2
# Rounds of the paged phase's bf16 serving planes, run in turns.
SERVE_ROUNDS = 3
# The f32 simple family against the plain version on the same f32
# inputs: both sum f32 products in another order (and the kernel's
# softmax online), so each output as a whole, |got - ref|_2 / |ref|_2,
# agrees to a few f32 ulps of accumulation: o, lse, dq, dk, dv.
TOL_F32_REL = 1e-5
# llama_440m in f32 on the simple family against the same forward on
# plain attention: 24 layers of f32 sums in another order.
TOL_F32_MODEL_REL = 1e-4
# Ring attention against flash attention on the whole sequence, each
# output and gradient as a whole: bf16 (the merges round o to bf16 at
# each of n steps where one flash call rounds once) and f32.
TOL_RING_BF16_REL = 1e-2
TOL_RING_F32_REL = 1e-5
# Phase 16, the Switch FFN at llama_moe_1b's width: the index dispatch
# against the one-hot form on the same inputs.  f32: each output and
# gradient as a whole, |got - ref|_2 / |ref|_2; the forms sum the same
# f32 products in other orders (the one-hot combine over E*C slots, the
# router's gradient).  bf16: the expert inputs bit for bit (a one-hot
# product returns each row exactly, 1 * x plus zeros), the output within
# one bf16 ulp per element (both forms sum the same two exact products
# in f32, but a tensor core's f32 accumulation may round that sum
# otherwise than an IEEE add, which moves the bf16 rounding by one ulp at
# most), and each gradient as a whole within one bf16 ulp, 2**-8
# relative (the forms round the same f32 values at the same points; the
# gate gradient's D-long dot product is summed in another order before
# its bf16 rounding, which can flip that rounding by one ulp).
TOL_MOE_F32_REL = 1e-5
TOL_MOE_BF16_ULPS = 1
TOL_MOE_BF16_GRAD_REL = 2 ** -8
# Both forms' aux in either dtype: the same f32 probabilities, averaged
# as a sum over the count or by torch.mean (a multiply by 1/T).
TOL_MOE_AUX_REL = 1e-6
# llama_moe_1b train steps (the llama_440m shape) and its active params
# per token with top-2 of 8 experts, counted from the shapes.
MOE_WARM, MOE_TIMED = 2, 5
MOE_ACTIVE_PARAMS = 737_657_856
# What the kernels are built from, for the kernels line.
DESIGN = "wgmma+tma, warp-specialised"
DESIGN_SIMPLE = ("cuda-core f32 fma, 8x8 register micro-tiles fed by "
                 "128-bit shared loads, cp.async ring, 256 threads")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """The least time (ms) the card could take for this work at
    ``peak`` FLOP/s, and which of its peaks bounds it."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def visible_pairs(Sq, Sk, causal):
    """(row, key) pairs the kernels compute (causal: key j <= row i)."""
    return sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk


def attention_cost(B, Hq, Sq, Sk, D, causal, elem=2,
                   peak=PEAK_BF16_FLOPS):
    """FLOP and bytes one flash forward call needs at these shapes
    (``elem`` bytes an element), and its bound in ms at ``peak``."""
    flops = 4.0 * B * Hq * D * visible_pairs(Sq, Sk, causal)  # QK^T, PV
    # q, k, v read once (k/v at Hq heads here: MHA shapes), o and lse
    # written once.
    nbytes = elem * B * Hq * D * (Sq + 2 * Sk + Sq) + 4.0 * B * Hq * Sq
    return (flops, nbytes) + bound(flops, nbytes, peak)


def attention_bwd_cost(B, H, Sq, Sk, D, causal, elem=2,
                       peak=PEAK_BF16_FLOPS, suffix=""):
    """FLOP and bytes of the dq kernel (with its delta pre-pass) and of
    the dk/dv kernel at these shapes (k/v at q's heads; ``elem`` bytes an
    element), bound at ``peak``.  Returns {name + suffix: (flops, bytes,
    ms, bound_by)}."""
    pairs = visible_pairs(Sq, Sk, causal)
    out = {}
    # dq: S = QK^T, dP = dO V^T, dQ = dS K; delta = rowsum(dO * O).
    # Reads q, o, do (Sq rows) and k, v (Sk rows) and lse; writes delta
    # and dq in f32.
    flops = 6.0 * B * H * D * pairs + 2.0 * B * H * Sq * D
    nbytes = (elem * B * H * D * (3 * Sq + 2 * Sk) + 4.0 * B * H * Sq * 2
              + 4.0 * B * H * Sq * D)
    out["flash_bwd_dq" + suffix] = (flops, nbytes) + bound(flops, nbytes,
                                                           peak)
    # dk/dv: S^T, dP^T, dV = P^T dO, dK = dS^T Q.  Reads q, do, k, v and
    # lse, delta; writes dk, dv in f32.
    flops = 8.0 * B * H * D * pairs
    nbytes = (elem * B * H * D * (2 * Sq + 2 * Sk) + 4.0 * B * H * Sq * 2
              + 8.0 * B * H * Sk * D)
    out["flash_bwd_dkdv" + suffix] = (flops, nbytes) + bound(flops, nbytes,
                                                             peak)
    return out


def attention_inputs(torch, shape, seed, layout, scaled=True, dtype=None):
    """q (scaled by D**-0.5 unless ``scaled`` is False), k, v in
    ``dtype`` (bf16 unless given) on the card as (B, H, S, D) tensors:
    contiguous (``"bhsd"``) or views of (B, S, H, D) tensors (``"bshd"``,
    the layout the model hands the kernel)."""
    B, Hq, Hkv, Sq, Sk, D = shape
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(b, h, s, d):
        if layout == "bhsd":
            return torch.randn(b, h, s, d, generator=g, device="cuda"
                               ).to(dtype)
        return torch.randn(b, s, h, d, generator=g, device="cuda"
                           ).to(dtype).transpose(1, 2)

    q = randn(B, Hq, Sq, D)
    return (q * D ** -0.5 if scaled else q, randn(B, Hkv, Sk, D),
            randn(B, Hkv, Sk, D))


def check_kernel(fa, torch, shape, causal, seed, layout, padded=False):
    """Kernel vs plain version on the same bf16 inputs on the card.
    Returns (max|do|, max|dlse|).  ``padded`` runs flash_attention_causal
    (pad S to a multiple of 128, scale, kernel, slice) for o, and the
    kernel on that padded problem for lse; both are held against the
    plain version on the padded problem, at the unpadded rows."""
    B, Hq, Hkv, Sq, Sk, D = shape
    if padded:
        q, k, v = attention_inputs(torch, shape, seed, "bshd", scaled=False)
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))  # (B, S, H, D)
        o = fa.flash_attention_causal(qs, ks, vs).transpose(1, 2)
        scale = torch.tensor(D ** -0.5, dtype=torch.bfloat16)
        pad = (0, 0, 0, 0, 0, -Sq % 128)
        qp, kp, vp = (torch.nn.functional.pad(t, pad).transpose(1, 2)
                      for t in (qs * scale, ks, vs))
        _, lse = fa._fwd(qp, kp, vp, True)
        o_ref, lse_ref = fa._fwd_reference(qp, kp, vp, True)
        o_ref, lse, lse_ref = (t[:, :, :Sq] for t in (o_ref, lse, lse_ref))
    else:
        q, k, v = attention_inputs(torch, shape, seed, layout)
        o, lse = fa._fwd(q, k, v, causal)
        o_ref, lse_ref = fa._fwd_reference(q, k, v, causal)
    torch.cuda.synchronize()
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        fail(f"kernel output not finite at {shape}")
    return ((o.float() - o_ref.float()).abs().max().item(),
            (lse - lse_ref).abs().max().item())


def grad_err(got, ref):
    """max |got - ref| in f32, and |got - ref|_2 / |ref|_2 with ``ref``
    first rounded to ``got``'s dtype."""
    ref = ref.to(got.dtype).float()
    d = got.float() - ref
    return (d.abs().max().item(),
            (d.norm() / ref.norm().clamp_min(1e-30)).item())


def check_bwd(fa, torch, shape, causal, seed, layout, how):
    """The backward kernels against their plain version on the same bf16
    inputs on the card.  Returns {"dq"|"dk"|"dv": :func:`grad_err`}.  ``how`` is "impl" (``_bwd_impl`` with k/v
    expanded to q's heads), "core" (autograd through ``_FlashCore``,
    which expands k/v and group-sums dk/dv itself) or "padded" (autograd
    through ``flash_attention_causal``: pad S to a multiple of 128, scale,
    both kernels, slice; the plain version runs on the padded problem)."""
    B, Hq, Hkv, Sq, Sk, D = shape
    q, k, v = attention_inputs(torch, shape, seed, layout)
    do = attention_inputs(torch, shape, seed + 100, layout, scaled=False)[0]
    group = Hq // Hkv

    def expand(t):
        return t.repeat_interleave(group, dim=1) if group > 1 else t

    if how == "padded":
        qs, ks, vs, dos = (t.transpose(1, 2) for t in (
            attention_inputs(torch, shape, seed, layout, scaled=False)[0],
            k, v, do))  # (B, S, H, D)
        ins = [t.detach().requires_grad_() for t in (qs, ks, vs)]
        out = fa.flash_attention_causal(*ins)
        got = [g.transpose(1, 2) for g in torch.autograd.grad(out, ins, dos)]
        scale = torch.tensor(D ** -0.5, dtype=torch.bfloat16)
        pad = (0, 0, 0, 0, 0, -Sq % 128)
        qp, kp, vp, dop = (torch.nn.functional.pad(t, pad).transpose(1, 2)
                           for t in (qs * scale, ks, vs, dos))
        o, lse = fa._fwd(qp, kp, vp, True)
        dq, dk, dv = (g[:, :, :Sq] for g in fa._bwd_reference(
            qp, kp, vp, o, lse, dop, True))
        dq = dq.to(torch.bfloat16) * scale  # the q * scale chain
    elif how == "core":
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fa._FlashCore.apply(*ins, causal)
        got = torch.autograd.grad(out, ins, do)
        o, lse = fa._fwd(q, k, v, causal)
        dq, dk, dv = fa._bwd_reference(q, expand(k), expand(v), o, lse, do,
                                       causal)
        dk, dv = (g.reshape(B, Hkv, group, Sk, D).sum(dim=2)
                  for g in (dk, dv))
    else:
        k, v = expand(k), expand(v)
        o, lse = fa._fwd(q, k, v, causal)
        got = fa._bwd_impl(q, k, v, o, lse, do, causal)
        dq, dk, dv = fa._bwd_reference(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    errs = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        if g.shape != r.shape or not torch.isfinite(g).all():
            fail(f"backward {name} not finite / wrong shape at {shape}")
        errs[name] = grad_err(g, r)
    return errs


def run_requests(server, prompts, max_new):
    async def go():
        return await asyncio.gather(*[
            server.generate({"prompt": p, "max_new_tokens": max_new})
            for p in prompts])

    t0 = time.perf_counter()
    outs = asyncio.run(go())
    return outs, time.perf_counter() - t0


def serve_numbers(outs, wall):
    """(TTFT median, TTFT max, decode tok/s once every request has its
    first token) of one round of requests."""
    ttft = sorted(o["ttft_ms"] for o in outs)
    new = sum(len(o["tokens"]) - 1 for o in outs)
    return statistics.median(ttft), ttft[-1], new / (wall - ttft[-1] / 1e3)


def first_diff(got, ref):
    """(request, position) of the first token where two runs differ."""
    for i, (a, b) in enumerate(zip(got, ref)):
        for j, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return i, j
        if len(a) != len(b):
            return i, min(len(a), len(b))
    return None


def gate_same(what, got, ref, prompts=None, params=None, cfg=None):
    """Fail unless two runs' tokens are identical; on a difference, the
    target's top-2 logit gap at the first differing token (from the
    forward on that context) says whether it was a near-tie."""
    import torch

    from ray_tpu_torch.models import llama

    where = first_diff(got, ref)
    phase("paged", f"{what}: {'ok' if where is None else 'MISMATCH'}")
    if where is None:
        return
    i, j = where
    msg = (f"{what}: request {i} differs at token {j}: "
           f"{got[i][j:j + 4]} vs {ref[i][j:j + 4]}")
    if prompts is not None:
        ctx = torch.tensor([prompts[i] + ref[i][:j]],
                           device=params["embed_tokens"].device)
        top = llama.forward(params, ctx, cfg)[0, -1].float().topk(2)
        msg += (f"; forward top-2 {top.indices.tolist()} logit gap "
                f"{(top.values[0] - top.values[1]).item():.3e}")
    fail(msg)


def chunk_io(torch, server, name):
    """Time the paged plane's per-chunk data movement at the main path's
    widest table: the gather of 8 slots x 16 blocks of K and V into the
    compute layout and their scatter back (with the dequantize and
    requantize of a quantized pool).  The bound counts the pool blocks
    read once and written once."""
    g = torch.Generator().manual_seed(29)
    bt = torch.randint(1, server.num_blocks, (8, 16), generator=g).to(
        server.device)

    def chunk():
        for kv in ("k", "v"):
            server._scatter(kv, bt, server._gather(kv, bt, trash_row=True))

    ms = time_ms(chunk, reps=10, rounds=5)
    per_block = server.pool_bytes // server.num_blocks
    nbytes = 2 * bt.numel() * per_block
    phase("paged", f"{name} gather + scatter of one chunk's K and V (8 x 16 "
          f"blocks): {ms:.4f} ms, bound {nbytes / PEAK_HBM_BYTES_S * 1e3:.4f}"
          f" ms (bytes: {nbytes} B read and written once)")


def shared_prefix_ttft(torch, server):
    """TTFT of 8 requests sharing a 128-token prefix, cold (one wave, so
    nothing is published before its prefills) and warm (a second wave
    that reuses the prefix's 8 blocks): once with suffixes of 8-22 tokens
    (one prefill bucket, cold or warm) and once with 16-72 (the warm wave
    spreads over three buckets, so three prefill calls)."""
    g = torch.Generator().manual_seed(17)
    for lo, step in ((8, 2), (16, 8)):
        prefix = torch.randint(1, 32000, (128,), generator=g).tolist()
        waves = [[prefix + torch.randint(1, 32000, (lo + step * i,),
                                         generator=g).tolist()
                  for i in range(8)] for _ in range(2)]
        hits0 = server.kv_stats()["ray_tpu_prefix_cache_hits"].get("llm", 0)
        (cm, cx, _), (wm, wx, _) = [
            serve_numbers(*run_requests(server, w, 8)) for w in waves]
        hits = server.kv_stats()["ray_tpu_prefix_cache_hits"]["llm"] - hits0
        phase("paged", f"bf16 shared 128-token prefix + {lo}-"
              f"{lo + 7 * step} token suffixes, 8 requests x 8 tokens: TTFT "
              f"median/max cold {cm:.1f}/{cx:.1f} ms, warm {wm:.1f}/{wx:.1f}"
              f" ms; prefix hits {hits}")
        if hits < 8:
            fail(f"the warm wave hit the prefix cache {hits} times")


def paged_phase(torch, llama, fa, LLMServer, prompts, profile_dir):
    """6b. The paged serving plane at llama_440m, full width and depth:
    bf16 planes with their numbers, then the token-identity, prefix,
    quantization and pool-pressure gates."""
    from ray_tpu_torch.exceptions import BackPressureError
    from ray_tpu_torch.serve.kv_cache import blocks_for_bytes

    cfg = llama.LlamaConfig.llama_440m()
    p32 = llama.init_params(cfg, seed=0)
    dev = p32["embed_tokens"].device
    p16 = {k: ({kk: vv.to(cfg.dtype) for kk, vv in v.items()}
               if isinstance(v, dict) else v.to(cfg.dtype))
           for k, v in p32.items()}
    base = dict(model_preset="llama_440m", max_slots=8, max_len=512,
                paged=True, block_size=16)
    n_blocks = 1 + 8 * (512 // 16)  # the default: dense capacity
    # The pool reckoned from the config: K and V, every layer, bf16
    # values, or 8-bit values plus one f32 scale per row.
    rows = 2 * cfg.n_layers * 16 * cfg.n_kv_heads
    want_bytes = {None: n_blocks * rows * cfg.head_dim * 2,
                  "int8": n_blocks * rows * (cfg.head_dim + 4),
                  "fp8": n_blocks * rows * (cfg.head_dim + 4)}
    int8_blocks = blocks_for_bytes(want_bytes[None], cfg.n_layers, 16,
                                   cfg.n_kv_heads, cfg.head_dim,
                                   kv_quant="int8")
    phase("paged", f"reckoned pools of {n_blocks} blocks: bf16 "
          f"{want_bytes[None]} B, int8/fp8 {want_bytes['int8']} B "
          f"({want_bytes['int8'] / want_bytes[None]:.4f}x); the bf16 "
          f"budget buys {int8_blocks} int8 blocks")
    if int8_blocks != want_bytes[None] // (rows * (cfg.head_dim + 4)):
        fail("blocks_for_bytes disagrees with the reckoning")

    # bf16 planes, timed (warm-up on, as a server runs), with a dense
    # engine beside them: SERVE_ROUNDS rounds in turns (the order reversed
    # every other round), each round on fresh prompts of the same lengths
    # so that every plane prefills cold.
    planes = {"dense": dict(paged=False), "paged": {},
              "paged+int8": dict(kv_quant="int8"),
              "paged+fp8": dict(kv_quant="fp8"),
              "paged+spec": dict(spec_k=4, draft_layers=6)}
    g = torch.Generator().manual_seed(19)
    rounds = [prompts] + [[torch.randint(1, 32000, (len(q),),
                                         generator=g).tolist()
                           for q in prompts]
                          for _ in range(SERVE_ROUNDS - 1)]
    servers, runs, launches = {}, {n: [] for n in planes}, {}
    spec_tokens = None
    try:
        for name, kw in planes.items():
            servers[name] = LLMServer(params=p16, **{**base, **kw})
        for r, ps in enumerate(rounds):
            for name in (list(planes) if r % 2 == 0 else list(planes)[::-1]):
                fa.reset_launch_counts()
                outs, wall = run_requests(servers[name], ps, 32)
                launches[name] = launched(fa)
                if any(len(o["tokens"]) != 32 for o in outs):
                    fail(f"{name} returned "
                         f"{[len(o['tokens']) for o in outs]} tokens")
                runs[name].append(serve_numbers(outs, wall))
                if r == 0 and name == "paged+spec":
                    spec_tokens = [o["tokens"] for o in outs]
        for name, kw in planes.items():
            server = servers[name]
            stats = server.kv_stats()
            line = (f"llama_440m bf16 {name}, 8 requests x 32 tokens, "
                    f"{SERVE_ROUNDS} rounds in turns: TTFT median "
                    + "/".join(f"{x[0]:.1f}" for x in runs[name])
                    + " ms, max " + "/".join(f"{x[1]:.1f}"
                                             for x in runs[name])
                    + " ms, decode " + "/".join(f"{x[2]:.1f}"
                                               for x in runs[name])
                    + f" tok/s (medians {statistics.median(x[0] for x in runs[name]):.1f}"
                    f" ms, {statistics.median(x[2] for x in runs[name]):.1f}"
                    f" tok/s), launches {launches[name]}")
            if name != "dense":
                alloc = stats["allocator"]
                line += (f", allocator used {alloc['used']} free "
                         f"{alloc['free']} (prefix blocks "
                         f"{alloc['prefix_blocks']}), pool "
                         f"{stats['pool_bytes']} B")
            if "spec" in stats:
                sp = stats["spec"]
                line += (f", spec proposed {sp['proposed']} accepted "
                         f"{sp['accepted']} accept rate {sp['accept_rate']}")
            phase("paged", line)
            if name != "dense" and \
                    stats["pool_bytes"] != want_bytes[kw.get("kv_quant")]:
                fail(f"{name} pool holds {stats['pool_bytes']} B, reckoned "
                     f"{want_bytes[kw.get('kv_quant')]}")
            if name != "dense" and "spec_k" not in kw:
                chunk_io(torch, server, name)
            if name == "paged":
                shared_prefix_ttft(torch, server)
            if profile_dir and name in ("paged", "paged+spec"):
                profile_run(lambda: run_requests(server, prompts, 32),
                            f"serve_{name.replace('+', '_')}", profile_dir)
    finally:
        for server in servers.values():
            server.shutdown()
    del servers
    torch.cuda.empty_cache()

    # bf16 spec identity: opposite accept regimes, the same tokens.
    server = LLMServer(params=p16, **base, spec_k=4,
                       draft_preset="llama_125m")
    try:
        outs, _ = run_requests(server, prompts, 32)
        sp = server.kv_stats()["spec"]
    finally:
        server.shutdown()
    phase("paged", f"bf16 paged+spec with an independent llama_125m draft: "
          f"accept rate {sp['accept_rate']} ({sp['accepted']} of "
          f"{sp['proposed']})")
    gate_same("bf16 spec, self-draft == llama_125m draft",
              [o["tokens"] for o in outs], spec_tokens, prompts, p16, cfg)

    # f32 gates (the engines' numerics need no warm-up).
    f32 = dict(base, model_preset="llama_440m_f32", warmup=False)
    f32_cfg = llama.LlamaConfig.llama_440m_f32()  # flash: the simple family
    g = torch.Generator().manual_seed(23)
    p14 = torch.randint(1, 32000, (14 * 16,), generator=g).tolist()
    pair = torch.randint(1, 32000, (13 * 16 + 5,), generator=g).tolist()
    prefix = torch.randint(1, 32000, (128,), generator=g).tolist()
    wave = [prefix + torch.randint(1, 32000, (10 + 7 * i,),
                                   generator=g).tolist() for i in range(8)]

    def tokens(server, ps, n=8):
        outs, _ = run_requests(server, ps, n)
        if any(len(o["tokens"]) != n for o in outs):
            fail(f"returned {[len(o['tokens']) for o in outs]} tokens")
        return [o["tokens"] for o in outs]

    server = LLMServer(params=p32, **dict(f32, paged=False))
    try:
        dense = tokens(server, prompts)
        dense_p14, dense_pair = tokens(server, [p14, pair])
        dense_wave = tokens(server, wave)
    finally:
        server.shutdown()
    server = LLMServer(params=p32, **f32)
    try:
        gate_same("f32 paged == dense", tokens(server, prompts), dense,
                  prompts, p32, f32_cfg)
        unpressured = tokens(server, prompts, 32)
        cold = tokens(server, [p14])
        hits0 = server.kv_stats()["ray_tpu_prefix_cache_hits"]["llm"]
        warm = tokens(server, [p14])
        hits = server.kv_stats()["ray_tpu_prefix_cache_hits"]["llm"] - hits0
        phase("paged", f"f32 14-block prompt: prefix hits on the warm run "
              f"{hits}")
        gate_same("f32 14-block prompt cold == dense", cold, [dense_p14])
        gate_same("f32 14-block prompt warm == cold", warm, cold)
        if hits < 1:
            fail("the warm run never hit the prefix cache")
        gate_same("f32 same-wave pair == dense", tokens(server, [pair, pair]),
                  [dense_pair, dense_pair])
        tokens(server, wave[:1])  # publishes the shared prefix
        gate_same("f32 warm wave of 8 on a shared 128-token prefix == dense",
                  tokens(server, wave), dense_wave)
    finally:
        server.shutdown()
    for what, kw in (("self-draft (6 layers)", dict(draft_layers=6)),
                     ("independent llama_125m draft",
                      dict(draft_preset="llama_125m"))):
        server = LLMServer(params=p32, **f32, spec_k=4, **kw)
        try:
            got = tokens(server, prompts)
            sp = server.kv_stats()["spec"]
        finally:
            server.shutdown()
        phase("paged", f"f32 paged+spec {what}: accept rate "
              f"{sp['accept_rate']}")
        gate_same(f"f32 paged+spec {what} == dense", got, dense, prompts,
                  p32, f32_cfg)

    # Pool pressure: 22 usable blocks, ~1.5 of the largest request's 15
    # (200 + 32 positions); the first four admitted grow past the pool
    # within two chunks.
    server = LLMServer(params=p32, **dict(f32, num_blocks=23))
    try:
        got = tokens(server, prompts, 32)
        alloc = server.kv_stats()["allocator"]
        try:
            run_requests(server, [prompts[-1]], 400)
            shed = None
        except BackPressureError as e:
            shed = e
        after = server.kv_stats()["allocator"]
    finally:
        server.shutdown()
    phase("paged", f"f32 pool pressure (22 usable blocks): preempted "
          f"{alloc['preempted']}, allocator used {alloc['used']} = prefix "
          f"blocks {alloc['prefix_blocks']}; a request needing 32 blocks: "
          f"{type(shed).__name__}")
    gate_same("f32 pressured == unpressured", got, unpressured)
    if alloc["preempted"] < 1:
        fail("the pressured pool preempted nothing")
    if alloc["used"] != alloc["prefix_blocks"] or \
            after["used"] != after["prefix_blocks"]:
        fail(f"allocator did not return to the trie's count: {alloc} "
             f"{after}")
    if shed is None:
        fail("an impossible request was not shed with BackPressureError")

    # KV quantization on real rope'd K rows of the llama_440m prefill: the
    # 24 layers' rows as blocks of one layer and 256 positions.
    toks = torch.randint(1, 32000, (1, 256), generator=g).to(dev)
    _, ks, _ = llama.prefill_forward(p16, toks,
                                     torch.tensor([256], device=dev), cfg)
    rows16 = ks.reshape(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim)
    rows32 = rows16.float()
    # Per-row bounds: half a grid step of the row, int8 0.5/127 of its
    # amax, e4m3 half an ulp at the 448 binade (16/448 = 1/28); the 1e-6
    # is the f32 rounding of the scale and the quotient.
    for name, qmax, qdt, row_tol in (
            ("int8", 127.0, torch.int8, 0.5 / 127 + 1e-6),
            ("fp8", 448.0, torch.float8_e4m3fn, 1 / 28 + 1e-6)):
        q, s = llama.quantize_kv_blocks(rows32, qmax, qdt)
        y = llama.dequantize_kv_blocks(q, s, torch.float32)
        amax = rows32.abs().amax(-1, keepdim=True)
        per_row = ((y - rows32).abs() / (amax + 1e-9)).max().item()
        overall = ((y - rows32).abs().max() / rows32.abs().max()).item()
        q2, s2 = llama.quantize_kv_blocks(y, qmax, qdt)
        fixed32 = torch.equal(q2.view(torch.uint8), q.view(torch.uint8)) \
            and torch.equal(s2, s)
        qb, sb = llama.quantize_kv_blocks(rows16, qmax, qdt)
        qb2, sb2 = llama.quantize_kv_blocks(
            llama.dequantize_kv_blocks(qb, sb, cfg.dtype), qmax, qdt)
        fixed16 = torch.equal(qb2.view(torch.uint8), qb.view(torch.uint8)) \
            and torch.equal(sb2, sb)
        qc, sc = llama.quantize_kv_blocks(rows32.cpu(), qmax, qdt)
        same_cpu = torch.equal(qc.view(torch.uint8),
                               q.view(torch.uint8).cpu()) and \
            torch.equal(sc, s.cpu())
        ok = (per_row <= row_tol and fixed32 and fixed16 and same_cpu
              and (name != "int8" or overall <= 1 / 127))
        phase("paged", f"{name} on llama_440m K rows {tuple(rows32.shape)}: "
              f"per-row max |d|/amax {per_row:.6e} (tol {row_tol:.6e}), "
              f"overall {overall:.3e}"
              + (" (tol 7.874e-03)" if name == "int8" else "")
              + f", fixed point f32 {fixed32} bf16 {fixed16}, card bytes "
              f"== cpu bytes {same_cpu}: {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name} KV quantization outside its bounds")
    del p16, p32, ks, rows16, rows32
    torch.cuda.empty_cache()


def profile_run(fn, label: str, out_dir: str) -> None:
    """Run ``fn`` once under torch.profiler; print the device busy share
    of the wall time and write the op tables (by device time and by host
    time) to ``out_dir/profile_<label>.txt``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # Kernels and copies only: an operator's row repeats its kernels',
    # and a record_function range (train.step) also has a device row
    # that spans the kernels inside it.
    ranges = {e.key for e in ka
              if e.device_type == torch.autograd.DeviceType.CPU}
    on_device = [e for e in ka
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.key not in ranges]
    device_s = sum(e.self_device_time_total for e in on_device) / 1e6
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"profile_{label}.txt")
    with open(path, "w") as f:
        f.write(f"{label}: wall {wall:.4f} s (under the profiler), device "
                f"busy {device_s:.4f} s\n\n")
        f.write(ka.table(sort_by="self_device_time_total", row_limit=25))
        f.write("\n\n")
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=25))
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:5]
    # Where the host waited for the card: stream/device syncs (a
    # pageable copy makes one) and event syncs (the engine's token
    # harvests).
    syncs = {e.key: e.count for e in ka if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize")}
    phase("profile", f"{label}: wall {wall * 1e3:.1f} ms, device busy "
          f"{device_s * 1e3:.1f} ms ({100 * device_s / wall:.1f}%), host "
          f"syncs {syncs}, top device ops: " + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} ms"
              for e in top) + f" (tables in {path})")


def launched(fa):
    """The kernels launched since the counts were last set to 0, with
    their counts."""
    return {n: c for n, c in fa.launch_counts.items() if c}


def rel_err(got, ref):
    """|got - ref|_2 / |ref|_2 in f32."""
    d = got.float() - ref.float()
    return (d.norm() / ref.float().norm().clamp_min(1e-30)).item()


def check_variant(fa, torch, dtype, shape, causal, seed):
    """One kernel family at ``dtype`` against the plain versions on the
    same inputs, forward and backward (k/v expanded to q's heads for the
    backward), on (B, H, S, D) views of (B, S, H, D) tensors.  Returns
    (family, {name: error}, ok, {name: max |d|}): the error of the
    16-bit forward by max |do| and |dlse|, everything else (and all of
    f32) by |d|_2 / |ref|_2."""
    B, Hq, Hkv, Sq, Sk, D = shape
    family = fa.kernel_family(dtype, D)
    suffix = "_simple" if family == "simple" else (
        "_f16" if dtype == torch.float16 else "")
    q, k, v = attention_inputs(torch, shape, seed, "bshd", dtype=dtype)
    do = attention_inputs(torch, shape, seed + 100, "bshd", scaled=False,
                          dtype=dtype)[0]
    fa.reset_launch_counts()
    o, lse = fa._fwd(q, k, v, causal)
    ro, rl = fa._fwd_reference(q, k, v, causal)
    kf, vf = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (k, v))
    got = fa._bwd_impl(q, kf, vf, o, lse, do, causal)
    ref = fa._bwd_reference(q, kf, vf, o, lse, do, causal)
    torch.cuda.synchronize()
    counts = launched(fa)
    want = {"flash_fwd" + suffix: 1, "flash_bwd_dq" + suffix: 1,
            "flash_bwd_dkdv" + suffix: 1}
    if counts != want:
        fail(f"{dtype} D={D} launched {counts}, expected {want}")
    f32 = dtype == torch.float32
    errs = {}
    abs_errs = {"o": (o.float() - ro.float()).abs().max().item()}
    if f32:
        errs["o"], errs["lse"] = rel_err(o, ro), rel_err(lse, rl)
    else:
        errs["o"] = (o.float() - ro.float()).abs().max().item()
        errs["lse"] = (lse - rl).abs().max().item()
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        if not torch.isfinite(g).all():
            fail(f"{dtype} D={D} {name} not finite")
        errs[name] = rel_err(g, r.to(g.dtype))
        abs_errs[name] = (g.float() - r.float()).abs().max().item()
    if f32:
        ok = all(e <= TOL_F32_REL for e in errs.values())
    else:
        ok = (errs["o"] <= TOL_O and errs["lse"] <= TOL_LSE
              and all(errs[n] <= TOL_GRAD_REL for n in ("dq", "dk", "dv")))
    return family, errs, ok, abs_errs


def c1_kernel_phase(fa, torch, sdpa):
    """Fault C1's kernels: the f16 wgmma instantiations and the simple
    family (f32 at the main path's shape; bf16 and f32 at D = 256, 72 and
    200, f32 at D = 640) against their plain versions, then their times
    at the main path's shape, SDPA's with the device kernels the profiler
    saw it launch.  Returns {kernel name: its kernels-line numbers}."""
    from ray_tpu_torch.tools.kernel_ab import sdpa_backend

    shape = (4, 8, 8, 2048, 2048, 128)
    cases = [(torch.float16, shape, True), (torch.float16, shape, False),
             (torch.float32, shape, True), (torch.float32, shape, False),
             (torch.float32, (2, 8, 8, 1024, 1024, 256), True),
             (torch.bfloat16, (2, 8, 8, 1024, 1024, 256), True),
             (torch.float32, (2, 8, 4, 1000, 1500, 72), False),
             (torch.bfloat16, (2, 8, 4, 1000, 1500, 72), True),
             # Fault C3: D past 128 and not a multiple of it, and past
             # 512 (128-column slices).
             (torch.float32, (2, 8, 8, 1024, 1024, 200), True),
             (torch.bfloat16, (2, 8, 8, 1024, 1024, 200), True),
             (torch.float32, (1, 4, 4, 256, 256, 640), False)]
    worst = {}
    for i, (dtype, shp, causal) in enumerate(cases):
        family, errs, ok, abs_errs = check_variant(fa, torch, dtype, shp,
                                                   causal, seed=40 + i)
        f32 = dtype == torch.float32
        tol = (f"|d|/|ref| <= {TOL_F32_REL}" if f32 else
               f"max|do| <= {TOL_O}, max|dlse| <= {TOL_LSE}, grads "
               f"|d|/|ref| <= {TOL_GRAD_REL}")
        phase("c1", f"{family} {str(dtype)[6:]} {shp} causal={causal}: "
              + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
              + f" ({tol}) " + ("ok" if ok else "MISMATCH"))
        if not ok:
            fail(f"{family} kernels disagree with their plain version at "
                 f"{dtype} {shp}")
        suffix = "_f16" if dtype == torch.float16 else "_simple"
        if shp == shape:  # the main path's shape: the kernels line's error
            for kname, errs_of in (("flash_fwd", ("o",)),
                                   ("flash_bwd_dq", ("dq",)),
                                   ("flash_bwd_dkdv", ("dk", "dv"))):
                worst[kname + suffix] = max(
                    [worst.get(kname + suffix, 0.0)]
                    + [abs_errs[e] for e in errs_of])
        torch.cuda.empty_cache()

    out = {}
    B, H, S, D = 4, 8, 2048, 128
    for dtype, suffix in ((torch.float16, "_f16"),
                          (torch.float32, "_simple")):
        f32 = dtype == torch.float32
        elem, peak = (4, PEAK_F32_FLOPS) if f32 else (2, PEAK_BF16_FLOPS)
        reps = dict(reps=3, rounds=3) if f32 else {}
        q, k, v = attention_inputs(torch, (B, H, H, S, S, D), 50, "bshd",
                                   dtype=dtype)
        do = attention_inputs(torch, (B, H, H, S, S, D), 51, "bshd",
                              scaled=False, dtype=dtype)[0]
        ms = time_ms(lambda: fa._fwd(q, k, v, True), **reps)
        plain_ms = time_ms(lambda: fa._fwd_reference(q, k, v, True),
                           reps=3, rounds=3)
        library_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                          scale=1.0), **reps)
        backend = sdpa_backend(lambda: sdpa(q, k, v, is_causal=True,
                                            scale=1.0))
        flops, nbytes, b_ms, b_by = attention_cost(B, H, S, S, D, True,
                                                   elem, peak)
        phase("c1", f"flash_fwd{suffix} ({B},{H},{S},{D}) causal "
              f"{str(dtype)[6:]}: {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s), bound {b_ms:.4f} ms ({b_by} at "
              f"{peak / 1e12:.0f} TFLOP/s; {100 * b_ms / ms:.1f}% of it), "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms "
              f"(kernels {backend})")
        out["flash_fwd" + suffix] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms, max_abs_err=worst["flash_fwd" + suffix])
        o, lse = fa._fwd(q, k, v, True)
        args = fa._BwdArgs(q, k, v, o, lse, do, True)
        _, delta = fa._bwd_dq(args)
        bwd = {"flash_bwd_dq" + suffix: time_ms(lambda: fa._bwd_dq(args),
                                               **reps),
               "flash_bwd_dkdv" + suffix: time_ms(
                   lambda: fa._bwd_dkdv(args, delta), **reps)}
        plain_bwd = time_ms(lambda: fa._bwd_reference(q, k, v, o, lse, do,
                                                      True),
                            reps=2, rounds=3)
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        sd = sdpa(qq, kk, vv, is_causal=True, scale=1.0)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            sd, (qq, kk, vv), do, retain_graph=True), **reps)
        phase("c1", f"sdpa backward {str(dtype)[6:]} kernels "
              + str(sdpa_backend(lambda: torch.autograd.grad(
                  sd, (qq, kk, vv), do, retain_graph=True))))
        for name, (flops, nbytes, b_ms, b_by) in attention_bwd_cost(
                B, H, S, S, D, True, elem, peak, suffix).items():
            phase("c1", f"{name} ({B},{H},{S},{D}) causal "
                  f"{str(dtype)[6:]}: {bwd[name]:.4f} ms "
                  f"({flops / bwd[name] / 1e9:.1f} TFLOP/s), bound "
                  f"{b_ms:.4f} ms ({b_by}; {100 * b_ms / bwd[name]:.1f}% "
                  f"of it), plain backward {plain_bwd:.4f} ms, sdpa "
                  f"backward {lib_bwd:.4f} ms")
            out[name] = dict(ms=bwd[name], plain_ms=plain_bwd,
                             bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_bwd, max_abs_err=worst[name])
        del q, k, v, do, o, lse, args, delta, qq, kk, vv, sd
        torch.cuda.empty_cache()
    return out


def c1_model_phase(fa, torch, llama):
    """llama_440m on the flash path in f32 (the simple family) and in
    f16 (the f16 wgmma kernels), where before fault C1 was closed only
    attention_impl="dot" ran: the forward at B=4 x S=2048, compared in
    f32 with the same forward on plain attention, then train steps with
    finite, falling loss.  Each dtype's path runs with the launch counts
    set to 0 before it; returns {dtype name: its counts}."""
    out = {}
    g = torch.Generator(device="cuda")
    for dtype, steps in ((torch.float32, 3), (torch.float16, 3)):
        name = str(dtype)[6:]
        cfg = llama.LlamaConfig.llama_440m(dtype=dtype)
        g.manual_seed(60)
        tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=g,
                               device="cuda")
        fa.reset_launch_counts()
        params = llama.init_params(cfg, seed=0, dtype=dtype)
        t0 = time.perf_counter()
        logits = llama.forward(params, tokens, cfg)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        fwd_counts = launched(fa)
        if not torch.isfinite(logits).all():
            fail(f"llama_440m {name} flash logits not finite")
        line = (f"llama_440m {name} flash B=4 S=2048 forward "
                f"{fwd_s * 1e3:.1f} ms, launches {fwd_counts}")
        if dtype == torch.float32:
            dot = llama.forward(params, tokens, llama.LlamaConfig.llama_440m(
                dtype=dtype, attention_impl="dot"))
            err = rel_err(logits, dot)
            agree = (logits.argmax(-1) == dot.argmax(-1)).float().mean()
            line += (f"; vs plain attention |d|/|ref| = {err:.3e} (tol "
                     f"{TOL_F32_MODEL_REL}), argmax agree {agree:.5f}")
            if err > TOL_F32_MODEL_REL:
                fail("llama_440m f32 flash forward disagrees with dot")
            del dot
        phase("c1", line)
        del logits, params
        torch.cuda.empty_cache()
        state = llama.init_train_state(cfg, seed=0, fused=True)
        step = llama.make_train_step(cfg, fused=True)
        g.manual_seed(61)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 2048),
                                         generator=g, device="cuda")}
        losses = []
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(m["loss"].item())
        step_s = (time.perf_counter() - t0) / steps
        counts = launched(fa)
        phase("c1", f"llama_440m {name} flash train B=4 S=2048: losses "
              + " ".join(f"{x:.4f}" for x in losses)
              + f", {step_s * 1e3:.1f} ms a step (first included), "
              f"launches over the path {counts}")
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            fail(f"llama_440m {name} flash training: losses {losses}")
        out[name] = counts
        del state, step, batch
        torch.cuda.empty_cache()
    return out


def ring_phase(fa, torch, profile_dir=None):
    """Ring attention's chunk schedule on one device: llama_440m's
    attention width (Hq = Hkv = 8, D = 128) over S = 8192 in 4 chunks of
    2048, bf16 on the wgmma kernels, then f32 (S = 4096) on the simple
    family; the output and the three gradients against flash attention
    on the whole sequence.  Returns the bf16 run's launch counts."""
    from ray_tpu_torch.ops import ring_attention as ra

    out = {}
    for dtype, S, tol in ((torch.bfloat16, 8192, TOL_RING_BF16_REL),
                          (torch.float32, 4096, TOL_RING_F32_REL)):
        name = str(dtype)[6:]
        n, B, H, D = 4, 1, 8, 128
        g = torch.Generator(device="cuda")
        g.manual_seed(70)
        q, k, v, do = (torch.randn(B, S, H, D, generator=g, device="cuda")
                       .to(dtype) for _ in range(4))
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        ref = fa.flash_attention(*ins, causal=True)
        ref_g = torch.autograd.grad(ref, ins, do)
        chunks = [[c.detach().requires_grad_() for c in t.chunk(n, dim=1)]
                  for t in (q, k, v)]
        flat = [c for t in chunks for c in t]
        do_chunks = list(do.chunk(n, dim=1))
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        outs = ra._ring_chunks(*chunks)
        fwd_counts = launched(fa)
        got_g = torch.autograd.grad(outs, flat, do_chunks)
        torch.cuda.synchronize()
        counts = launched(fa)
        # Warm times by CUDA events: the ring against one flash call on
        # the whole sequence, forward and forward + backward.
        reps = dict(reps=5, rounds=3)
        with torch.no_grad():
            ring_fwd = time_ms(lambda: ra._ring_chunks(*chunks), **reps)
            whole_fwd = time_ms(lambda: fa.flash_attention(
                q, k, v, causal=True), **reps)
        ring_all = time_ms(lambda: torch.autograd.grad(
            ra._ring_chunks(*chunks), flat, do_chunks), **reps)
        whole_all = time_ms(lambda: torch.autograd.grad(
            fa.flash_attention(*ins, causal=True), ins, do), **reps)
        if profile_dir:
            profile_run(lambda: torch.autograd.grad(
                ra._ring_chunks(*chunks), flat, do_chunks),
                f"ring_{name}", profile_dir)
        errs = {"o": rel_err(torch.cat(outs, dim=1), ref)}
        for i, gname in enumerate(("dq", "dk", "dv")):
            errs[gname] = rel_err(torch.cat(got_g[n * i:n * (i + 1)], dim=1),
                                  ref_g[i])
        ok = all(e <= tol for e in errs.values())
        phase("ring", f"{name} ({B},{S},{H},{D}) in {n} chunks of {S // n}: "
              + " ".join(f"{e}={x:.3e}" for e, x in errs.items())
              + f" vs flash_attention on the whole sequence (|d|/|ref| <= "
              f"{tol}) {'ok' if ok else 'MISMATCH'}; ring forward "
              f"{ring_fwd:.4f} ms, forward + backward {ring_all:.4f} ms; "
              f"whole-sequence flash {whole_fwd:.4f} / {whole_all:.4f} ms; "
              f"launches forward {fwd_counts}, forward + backward {counts}")
        if not ok:
            fail(f"ring attention ({name}) disagrees with flash attention")
        per_pass = n * n  # n diagonal + n(n-1) off-diagonal steps
        suffix = "" if dtype == torch.bfloat16 else "_simple"
        want = {"flash_fwd" + suffix: per_pass,
                "flash_bwd_dq" + suffix: per_pass,
                "flash_bwd_dkdv" + suffix: per_pass}
        if counts != want:
            fail(f"ring ({name}) launched {counts}, expected {want}")
        out[name] = counts
        del q, k, v, do, ins, ref, ref_g, chunks, outs, got_g
        torch.cuda.empty_cache()
    return out


def mesh_phase(fa, torch, llama):
    """The llama_440m bf16 train step (B=8 x S=2048) with its params
    through shard_params under use_mesh(local_mesh()): the same losses
    as the same steps without a mesh, bit for bit (the constraints are
    no-ops on one device).  Returns the mesh run's launch counts."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import (local_mesh, shard_params,
                                        use_mesh)

    cfg = llama.LlamaConfig.llama_440m()
    g = torch.Generator(device="cuda")
    g.manual_seed(80)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                                     generator=g, device="cuda")}
    losses = {}
    for name in ("plain", "mesh"):
        state = llama.init_train_state(cfg, seed=0, fused=True)
        step = llama.make_train_step(cfg, fused=True)
        fa.reset_launch_counts()
        if name == "mesh":
            mesh = local_mesh()
            with use_mesh(mesh):
                state["params"] = shard_params(
                    state["params"], llama.param_logical_axes(cfg))
                run = [step(state, batch)[1]["loss"].item()
                       for _ in range(2)]
        else:
            run = [step(state, batch)[1]["loss"].item() for _ in range(2)]
        losses[name] = run
        counts = launched(fa)
        del state, step
        torch.cuda.empty_cache()
    same = losses["mesh"] == losses["plain"]
    phase("mesh", f"llama_440m bf16 B={TRAIN_B} S={TRAIN_S}, 2 fused steps: "
          f"losses under use_mesh(local_mesh()) {losses['mesh']} vs without "
          f"{losses['plain']}: {'identical' if same else 'MISMATCH'}; "
          f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}, launches "
          f"{counts}")
    if not same:
        fail("the one-device mesh changed the train step's losses")
    dist.destroy_process_group()
    return counts


def bf16_ulps(got, ref):
    """Per element, |got - ref| in bf16 ulps of ref (bf16 keeps 8
    significant bits: the ulp of v = m * 2**e, 0.5 <= |m| < 1, is
    2**(e - 8); of 0, the least subnormal 2**-133)."""
    import torch

    ref = ref.float()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    ulp = torch.where(ref == 0, torch.full_like(ref, 2.0 ** -133), ulp)
    return (got.float() - ref).abs() / ulp


def moe_ffn_phase(torch, moe, T=TRAIN_B * TRAIN_S, D=1024, H=4096,
                  device="cuda"):
    """The Switch FFN of one llama_moe_1b layer (D=1024, H=4096, E=8,
    top-2, capacity factor 1.25) at T = 8 x 2048 tokens: ``moe_ffn``'s
    index dispatch (``moe._moe_ffn``) against the one-hot form
    (``moe._moe_ffn_onehot``) on the same inputs, in f32 and in bf16:
    the output, the aux, the expert inputs and the gradients of
    sum(out**2) + 0.01 * aux for x, the router and the three expert
    weights, to the TOL_MOE_* rules; the drop share; each form's time,
    forward and forward + backward, in bf16.  Returns the times."""
    mk = dict(hidden_size=D, intermediate_size=H, n_experts=8, top_k=2,
              capacity_factor=1.25)
    B = TRAIN_B
    names = ["x", "router", *moe.EXPERT_WEIGHTS]
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        c = moe.MoEConfig(dtype=dtype, **mk)
        params = moe.init_moe_params(c, seed=90, device=device)
        g = torch.Generator(device=device)
        g.manual_seed(91)
        x = torch.randn((B, T // B, D), generator=g, device=device).to(dtype)
        forms = {}
        for form, fn in (("index", moe._moe_ffn),
                         ("onehot", moe._moe_ffn_onehot)):
            xx = x.clone().requires_grad_()
            leaves = {k: params[k].clone().requires_grad_() for k in names[1:]}
            out, aux, expert_in = fn(xx, leaves, c)
            grads = torch.autograd.grad(
                (out.float() ** 2).sum() + 0.01 * aux, [xx, *leaves.values()])
            forms[form] = (out.detach(), aux.detach(), expert_in.detach(),
                           dict(zip(names, grads)))
            del xx, leaves, out, aux, expert_in, grads
        (out, aux, ein, grads), (out1, aux1, ein1, grads1) = \
            forms["index"], forms["onehot"]
        name = str(dtype)[6:]
        aux_err = abs(aux.item() / aux1.item() - 1)
        grad_errs = {k: rel_err(grads[k], grads1[k]) for k in names}
        same = {k: (grads[k] == grads1[k]).float().mean().item()
                for k in names}
        ein_same = torch.equal(ein, ein1)
        if dtype == torch.float32:
            out_err = rel_err(out, out1)
            ok = (ein_same and out_err <= TOL_MOE_F32_REL
                  and all(e <= TOL_MOE_F32_REL for e in grad_errs.values()))
            out_line = f"out |d|/|ref| {out_err:.3e} (tol {TOL_MOE_F32_REL})"
            grad_tol = TOL_MOE_F32_REL
        else:
            ulps = bf16_ulps(out, out1)
            out_share = (ulps > 0).float().mean().item()
            ok = (ein_same and ulps.max().item() <= TOL_MOE_BF16_ULPS
                  and all(e <= TOL_MOE_BF16_GRAD_REL
                          for e in grad_errs.values()))
            out_line = (f"out max {ulps.max().item():.0f} bf16 ulps (tol "
                        f"{TOL_MOE_BF16_ULPS}), share not bit-equal "
                        f"{out_share:.2e}")
            grad_tol = TOL_MOE_BF16_GRAD_REL
        ok = ok and aux_err <= TOL_MOE_AUX_REL and all(
            torch.isfinite(t).all() for t in (out, *grads.values()))
        phase("moe", f"moe_ffn vs one-hot form, {name}, T={T} D={D} H={H} "
              f"E=8 K=2: expert_in bit-equal {ein_same}; {out_line}; aux "
              f"{aux.item():.6f} vs {aux1.item():.6f} (rel {aux_err:.1e}, "
              f"tol {TOL_MOE_AUX_REL}); grads |d|/|ref| " + ", ".join(
                  f"{k} {e:.2e}" for k, e in grad_errs.items())
              + f" (tol {grad_tol:.2e}), bit-equal shares " + ", ".join(
                  f"{k} {v:.4f}" for k, v in same.items())
              + f"; {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"moe_ffn disagrees with its one-hot form in {name}")
        del forms, out, out1, ein, ein1, grads, grads1
        if dtype == torch.bfloat16:
            xt = x.reshape(T, D)
            with torch.no_grad():
                _, _, idx = moe._route(xt, params["router"], c.top_k)
                pos, per_expert = moe._positions(idx, c.n_experts)
            cap = moe.capacity(T, c)
            dropped = (pos >= cap).view(T, c.top_k)
            phase("moe", f"capacity {cap} slots/expert; assignments per "
                  f"expert {per_expert.tolist()}; dropped (token, k) share "
                  f"{dropped.float().mean().item():.4f}, tokens dropped in "
                  f"both choices {int(dropped.all(1).sum())} (random "
                  f"weights, seed 90)")
            for form, fn in (("index", moe._moe_ffn),
                             ("onehot", moe._moe_ffn_onehot)):
                def fwd():
                    with torch.no_grad():
                        fn(x, params, c)

                xx = x.clone().requires_grad_()
                leaves = {k: params[k].clone().requires_grad_()
                          for k in names[1:]}

                def fwd_bwd():
                    o, a, _ = fn(xx, leaves, c)
                    torch.autograd.grad((o.float() ** 2).sum() + 0.01 * a,
                                        [xx, *leaves.values()])

                times[form] = (time_ms(fwd, reps=3, rounds=3),
                               time_ms(fwd_bwd, reps=3, rounds=3))
                del xx, leaves
            phase("moe", "bf16 times, forward / forward+backward: "
                  + ", ".join(f"{f} {a:.3f} / {b:.3f} ms"
                              for f, (a, b) in times.items())
                  + f" ({torch.cuda.get_device_name(0)})")
        del params, x
        torch.cuda.empty_cache()
    return times


def moe_memory_reckoning(cfg, n_params, B, S):
    """Bytes the llama_moe_1b train step should need at its peak, from
    the shapes, the larger of two moments.  The backward: the state (f32
    params, gradients and two AdamW moments, 16 B a param), the layer
    weights' per-layer gradients, which the backward of ``_layers``'
    unbind holds until it stacks them (4 B a layer param), the layer
    inputs that remat="full" keeps (bf16), one layer's recompute at a
    time (its MoE buffers dominate: the (E, C, H) products h, u,
    silu(h), silu(h)*u and their gradients in bf16, the (E, C, D)
    buffers and the (T, K, D) rows) and the head (bf16 logits, their f32
    copy, the f32 and bf16 gradients).  The fused AdamW update: the state
    and three f32 temporaries of the params' size (the clipped
    gradients, the denominator and the direction), 28 B a param.
    Returns (state bytes, backward bytes, update bytes)."""
    T, D, E = B * S, cfg.hidden_size, cfg.moe_experts
    C = round(T * cfg.moe_top_k / E * cfg.moe_capacity_factor)
    layer_params = n_params - cfg.vocab_size * D - D
    state = 16 * n_params
    saved = 2 * cfg.n_layers * T * D
    one_layer = (2 * 8 * E * C * cfg.intermediate_size
                 + 2 * 4 * E * C * D + 6 * T * cfg.moe_top_k * D)
    head = T * cfg.vocab_size * (2 + 4 + 4 + 2)
    backward = state + 4 * layer_params + saved + one_layer + head
    return state, backward, state + 12 * n_params


def moe_train_phase(fa, torch, llama, profile_dir=None):
    """llama_moe_1b trained on one card at full width and depth:
    init_train_state / make_train_step(fused=True), bf16 compute with f32
    params and moments, B=8 x S=2048, the preset's remat ("full").  2
    warm-up and 5 timed steps, the launch counts set to 0 before each
    timed step: finite and falling loss, each flash kernel's launches
    per step (forward twice a layer under "full": the forward and the
    recompute), the aux of a forward in the reference's band (0.5 to 3
    times n_layers), step time, tok/s, the 6 N_active share of the bf16
    peak, peak memory against :func:`moe_memory_reckoning`; then 2 steps
    of the optax-chain counterpart from the same state, whose losses must
    match.  Returns the launches of one timed step."""
    cfg = llama.LlamaConfig.llama_moe_1b()
    g = torch.Generator(device="cuda")
    g.manual_seed(92)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                                     generator=g, device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    state = llama.init_train_state(cfg, seed=0, fused=True)
    n_params = llama.param_count(state["params"])
    with torch.no_grad():
        _, aux = llama.forward(state["params"], batch["tokens"][:2], cfg,
                               return_aux=True)
    aux = aux.item()
    step = llama.make_train_step(cfg, fused=True)
    metrics, per_step = [], []
    for _ in range(MOE_WARM):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MOE_TIMED):
        fa.reset_launch_counts()
        state, m = step(state, batch)
        per_step.append(launched(fa))
        metrics.append(m)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / MOE_TIMED
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"].item() for m in metrics]
    gnorms = [m["grad_norm"].item() for m in metrics]
    tok_s = TRAIN_B * (TRAIN_S - 1) / step_s
    state_b, bwd_b, update_b = moe_memory_reckoning(cfg, n_params,
                                                     TRAIN_B, TRAIN_S)
    phase("moe", f"llama_moe_1b ({n_params} params, {MOE_ACTIVE_PARAMS} "
          f"active a token) fused AdamW remat_policy={cfg.remat_policy!r} "
          f"B={TRAIN_B} S={TRAIN_S}: step {step_s * 1e3:.1f} ms (mean of "
          f"{MOE_TIMED} after {MOE_WARM} warm-up), {tok_s:.0f} tok/s "
          f"(B*(S-1) per step), 6*N_active*tok/s = "
          f"{6 * MOE_ACTIVE_PARAMS * tok_s / 1e12:.1f} TFLOP/s = "
          f"{100 * 6 * MOE_ACTIVE_PARAMS * tok_s / PEAK_BF16_FLOPS:.1f}% of "
          f"the 989 TFLOP/s bf16 peak (not counting attention, remat or "
          f"capacity padding), peak memory {peak / 1e9:.2f} GB against "
          f"the reckoning {max(bwd_b, update_b) / 1e9:.2f} GB (backward "
          f"{bwd_b / 1e9:.2f} GB, fused update {update_b / 1e9:.2f} GB; "
          f"{state_b / 1e9:.2f} GB of f32 params, gradients and moments)")
    phase("moe", "losses " + " ".join(f"{x:.4f}" for x in losses)
          + "; grad norms " + " ".join(f"{x:.3f}" for x in gnorms)
          + f"; aux of a B=2 forward {aux:.4f} (band {0.5 * cfg.n_layers}"
          f" to {3.0 * cfg.n_layers})")
    fwd_per_layer = 1 if cfg.remat_policy in ("attn", "attn_ffn") else 2
    want = {"flash_fwd": fwd_per_layer * cfg.n_layers,
            "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers}
    phase("moe", f"launches per timed step: {per_step[0]} (expected "
          f"{want}; all {MOE_TIMED} steps equal: "
          f"{all(p == per_step[0] for p in per_step)})")
    if not all(math.isfinite(x) for x in losses + gnorms + [aux]):
        fail("llama_moe_1b training produced a non-finite loss or norm")
    if not losses[-1] < losses[0]:
        fail(f"llama_moe_1b loss did not fall: {losses}")
    if not 0.5 * cfg.n_layers < aux < 3.0 * cfg.n_layers:
        fail(f"llama_moe_1b aux {aux} outside the reference's band")
    if any(p != want for p in per_step):
        fail(f"flash kernels launched {per_step} per step, expected {want}")
    if profile_dir:
        profile_run(lambda: step(state, batch), "train_step_moe",
                    profile_dir)
    del state, step, metrics
    torch.cuda.empty_cache()
    state = llama.init_train_state(cfg, seed=0)
    step = llama.make_train_step(cfg)
    chain = []
    for _ in range(CHAIN_STEPS):
        state, m = step(state, batch)
        chain.append(m["loss"].item())
    diffs = [abs(a / b - 1) for a, b in zip(chain, losses)]
    ok = max(diffs) <= TOL_CHAIN_LOSS_REL
    phase("moe", f"optax-chain counterpart, {CHAIN_STEPS} steps from the "
          f"same state: losses {chain} vs fused {losses[:CHAIN_STEPS]} "
          f"(rel diff {max(diffs):.2e}, tol {TOL_CHAIN_LOSS_REL}) "
          + ("ok" if ok else "MISMATCH"))
    if not ok:
        fail("the chain and fused AdamW steps disagree on llama_moe_1b")
    del state, step, batch
    torch.cuda.empty_cache()
    return per_step[-1]


SERVE_LENGTHS = [24, 48, 77, 100, 128, 150, 180, 200]
# Phase 17: bytes of the CUDA tensor put through the object plane, its
# timed repetitions, the handle-hop probes, and the device-trace window
# with the new tokens of the round it traces.  A decode chunk's range
# (16 eager steps, ~0.8 s at llama_440m) is recorded only if it begins
# and ends inside the window, so the window holds two chunks' time and
# the round runs four chunks.
PUT_BYTES, PUT_REPS, HOP_CALLS = 256 << 20, 10, 50
TRACE_S, TRACE_NEW = 2.0, 64
# The card's memory once a deployment is deleted, against before it.
TOL_SERVE_LEAK_BYTES = 64 << 20


def serve_prompts(torch):
    """PERF.md's serve traffic: 8 prompts of 24-200 tokens, seed 11."""
    rng = torch.Generator().manual_seed(11)
    return [torch.randint(1, 32000, (n,), generator=rng).tolist()
            for n in SERVE_LENGTHS]


def register_f32_preset(torch, llama):
    """``llama_440m_f32``: llama_440m in f32, for the token-identity
    gates (an engine reads its config from a preset)."""
    llama.LlamaConfig.llama_440m_f32 = classmethod(
        lambda cls, **kw: cls.llama_440m(dtype=torch.float32, **kw))


def handle_round(handle, prompts, max_new):
    """One round of requests through a Serve handle: (outs, wall s)."""
    t0 = time.perf_counter()
    responses = [handle.generate.remote(
        {"prompt": p, "max_new_tokens": max_new}) for p in prompts]
    outs = [r.result(timeout=600) for r in responses]
    return outs, time.perf_counter() - t0


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


def traced_round(devplane, run):
    """Run one round of requests (``run()``) while the device plane
    captures a trace of the process, begun once the prefills are under
    way; returns (outs, busy share of the window, the number of
    ``serve.decode_chunk`` ranges it holds)."""
    import io
    import threading
    import zipfile

    done = {}
    th = threading.Thread(target=lambda: done.update(outs=run()[0]))
    th.start()
    time.sleep(0.3)
    trace = devplane.capture_device_trace(TRACE_S)
    th.join()
    if "outs" not in done:
        fail("the traced round of requests did not finish")
    with zipfile.ZipFile(io.BytesIO(trace["data"])) as zf:
        events = json.loads(zf.read("trace.json"))["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "ts" in e)
    chunks = sum(1 for e in events
                 if str(e.get("name", "")).split("#")[0]
                 == "serve.decode_chunk")
    busy, end = 0.0, None
    for a, b in spans:  # the union of the device's busy intervals
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return done["outs"], busy / (TRACE_S * 1e6), chunks


def runtime_phase(fa, torch, llama, LLMServer):
    """17. The local runtime and the Serve plane on the card, in a fresh
    runtime shut down at the end: a. ``init()`` advertises the card as
    ``GPU``; b. a 256 MiB bf16 CUDA tensor through ``put``/``get``, same
    bytes back on cuda:0, no aliasing, with the times; c. a
    ``num_gpus=1`` task runs the llama_440m forward on B1 (24 launches)
    and returns last-position logits bit-equal to the direct call; d. f32
    tokens equal between a direct engine, a deployment's handle and its
    HTTP proxy, the card held while deployed, the series tagged with the
    deployment, the card's memory back after ``serve.delete``; e. bf16
    TTFT and decode tok/s, direct and deployed in turns, the handle hop,
    the device busy share; f. the device plane's gauges against
    ``torch.cuda.memory_stats`` and a trace with ``serve.decode_chunk``.
    Returns the launches of c."""
    import gc
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.observability import device as devplane
    from ray_tpu_torch.observability import metrics as rt_metrics

    register_f32_preset(torch, llama)
    prompts = serve_prompts(torch)
    t_phase = time.perf_counter()
    serve.shutdown()
    rt.shutdown()
    rt.init()
    try:
        # a. The card as the scheduled resource.
        total = rt.cluster_resources()
        n_gpu = torch.cuda.device_count()
        phase("runtime", f"init(): cluster_resources GPU "
              f"{total.get('GPU')} (device_count {n_gpu}), CPU "
              f"{total.get('CPU')}")
        if total.get("GPU") != n_gpu:
            fail(f"init() advertised {total.get('GPU')} GPUs, the card "
                 f"has {n_gpu}")

        # b. The object plane with a CUDA tensor.
        g = torch.Generator(device="cuda")
        g.manual_seed(17)
        x = torch.randn(PUT_BYTES // 2, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        keep = x.clone()

        def same(t):
            return (t.device == torch.device("cuda", 0)
                    and t.dtype == keep.dtype
                    and torch.equal(t.view(torch.int16),
                                    keep.view(torch.int16)))

        # Warm the caching allocator: the store frees a copy on its
        # reference reaper's thread, some time after ``del``, so without
        # cached blocks a repetition could wait on cudaMalloc.
        spare = [torch.empty_like(x) for _ in range(4)]
        del spare
        put_ms, get_ms = [], []
        for _ in range(PUT_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = rt.put(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            a = rt.get(ref)
            torch.cuda.synchronize()
            put_ms.append((t1 - t0) * 1e3)
            get_ms.append((time.perf_counter() - t1) * 1e3)
            # Free both copies before the next repetition, so that each
            # one reuses the allocator's blocks rather than growing it.
            del a, ref
        ref = rt.put(x)
        a = rt.get(ref)
        ok = same(a)
        a.fill_(0)  # one consumer writes
        b = rt.get(ref)
        ok = ok and same(b) and same(x)
        x.add_(1)  # the producer writes after its put
        ok = ok and same(rt.get(ref))
        copy_ms = 2 * PUT_BYTES / PEAK_HBM_BYTES_S * 1e3
        phase("runtime", f"put/get of a {PUT_BYTES >> 20} MiB bf16 CUDA "
              f"tensor ({PUT_REPS} each): put median "
              f"{statistics.median(put_ms):.3f} ms (min {min(put_ms):.3f}), "
              f"get median {statistics.median(get_ms):.3f} ms (min "
              f"{min(get_ms):.3f}); each makes one on-device copy, bound "
              f"{copy_ms:.3f} ms (read + write at "
              f"{PEAK_HBM_BYTES_S / 1e12:.2f} TB/s); same bytes on cuda:0,"
              f" a consumer's and the producer's writes reach neither the "
              f"store nor another get: {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail("a CUDA tensor through put/get came back changed or "
                 "aliased")
        del x, keep, a, b, ref
        torch.cuda.empty_cache()

        # c. A GPU task runs the forward on B1.
        cfg = llama.LlamaConfig.llama_440m(dtype=torch.bfloat16,
                                           attention_impl="flash")

        def tokens_for(seed):
            tg = torch.Generator(device="cuda")
            tg.manual_seed(seed)
            return torch.randint(0, cfg.vocab_size, (4, 2048),
                                 generator=tg, device="cuda")

        @rt.remote(num_gpus=1)
        def forward_task(seed):
            params = llama.init_params(cfg, seed=seed, dtype=torch.bfloat16)
            tokens = tokens_for(7)
            fa.reset_launch_counts()
            logits = llama.forward(params, tokens, cfg)
            torch.cuda.synchronize()
            inside = launched(fa)
            return (logits[:, -1].clone(), inside,
                    rt.available_resources().get("GPU"))

        fa.reset_launch_counts()
        last, inside, gpu_held = rt.get(forward_task.remote(0), timeout=600)
        task_launches = launched(fa)
        params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16)
        direct = llama.forward(params, tokens_for(7), cfg)[:, -1]
        equal = (last.shape == direct.shape and last.device == direct.device
                 and torch.equal(last.view(torch.int16),
                                 direct.view(torch.int16)))
        phase("runtime", f"@remote(num_gpus=1) llama_440m flash forward "
              f"B=4 S=2048 bf16: last-position logits {tuple(last.shape)} "
              f"bit-equal to the direct call: {equal}; launches inside the "
              f"task {inside}, around it {task_launches}; GPU available "
              f"while it ran {gpu_held}")
        want = {"flash_fwd": cfg.n_layers}
        if not equal:
            fail("the GPU task's logits differ from the direct call's")
        if inside != want or task_launches != want:
            fail(f"the GPU task launched {inside} / {task_launches}, "
                 f"expected {want}")
        if gpu_held != n_gpu - 1:
            fail(f"the GPU task ran with {gpu_held} GPUs still free")
        del last, direct, params
        torch.cuda.empty_cache()

        # d. Serve, token identity (f32): direct engine, handle, HTTP.
        engine = dict(model_preset="llama_440m_f32", max_slots=8,
                      max_len=512, seed=0)
        server = LLMServer(**engine)
        try:
            outs, _ = run_requests(server, prompts, 32)
        finally:
            server.shutdown()
        direct_tokens = [o["tokens"] for o in outs]
        del server
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        handle = serve.run(serve.deployment(
            LLMServer, ray_actor_options={"num_gpus": 1}, name="llama")
            .bind(**engine), http_port=0)
        deploy_s = time.perf_counter() - t0
        gpu_deployed = rt.available_resources().get("GPU")
        outs, _ = handle_round(handle, prompts, 32)
        handle_tokens = [o["tokens"] for o in outs]
        req = urllib.request.Request(
            f"http://127.0.0.1:{handle.http_port}/llama",
            data=json.dumps({"prompt": prompts[0],
                             "max_new_tokens": 32}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            http_tokens = json.loads(resp.read())["result"]["tokens"]
        emas = sorted(rt_metrics.metrics_summary().get(
            "ray_tpu_serve_program_seconds", {}))
        ok = (handle_tokens == direct_tokens
              and http_tokens == handle_tokens[0])
        phase("runtime", f"llama_440m f32, 8 requests x 32 tokens: "
              f"deployment up in {deploy_s:.1f}s; handle tokens == direct "
              f"engine's: {handle_tokens == direct_tokens}, HTTP tokens == "
              f"handle's: {http_tokens == handle_tokens[0]}; GPU available "
              f"while deployed {gpu_deployed}; program-time series {emas}")
        if not ok:
            where = first_diff(handle_tokens, direct_tokens)
            fail(f"Serve tokens differ from the direct engine's (first at "
                 f"{where}) or HTTP from the handle's")
        if gpu_deployed != n_gpu - 1:
            fail(f"{gpu_deployed} GPUs free while the deployment holds one")
        if not {"llama,prefill", "llama,decode_chunk"} <= set(emas):
            fail(f"the engine's series are not tagged with its "
                 f"deployment: {emas}")
        serve.delete("llama")
        deadline = time.time() + 60
        while rt.available_resources().get("GPU") != n_gpu:
            if time.time() > deadline:
                fail("the deleted deployment still holds the GPU")
            time.sleep(0.05)
        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        phase("runtime", f"after serve.delete: GPU available "
              f"{rt.available_resources().get('GPU')}; memory_allocated "
              f"{mem0 / 2**20:.1f} MiB before the deployment, "
              f"{mem1 / 2**20:.1f} MiB after (tol "
              f"{TOL_SERVE_LEAK_BYTES >> 20} MiB)")
        if mem1 - mem0 > TOL_SERVE_LEAK_BYTES:
            fail(f"{(mem1 - mem0) / 2**20:.1f} MiB still held after "
                 f"serve.delete")

        # e. Serve, numbers (bf16): direct and deployed, in turns.
        engine = dict(model_preset="llama_440m", max_slots=8, max_len=512,
                      seed=0)
        server = LLMServer(**engine)
        handle = serve.run(serve.deployment(
            LLMServer, ray_actor_options={"num_gpus": 1}, name="llama")
            .bind(**engine))
        try:
            rows = {"direct": [], "deployed": []}
            for _ in range(SERVE_ROUNDS):
                rows["direct"].append(run_requests(server, prompts, 32))
                rows["deployed"].append(handle_round(handle, prompts, 32))
            for name, rounds in rows.items():
                ttft = [o["ttft_ms"] for outs, _ in rounds for o in outs]
                rates = [serve_numbers(outs, wall)[2]
                         for outs, wall in rounds]
                walls = [wall for _, wall in rounds]
                phase("runtime", f"llama_440m bf16 {name}, {SERVE_ROUNDS} "
                      f"rounds of 8 x 32 tokens: TTFT min "
                      f"{min(ttft):.1f} ms p50 "
                      f"{percentile(ttft, 0.5):.1f} ms p99 "
                      f"{percentile(ttft, 0.99):.1f} ms, decode tok/s "
                      + " ".join(f"{r:.1f}" for r in rates)
                      + ", round wall s " + " ".join(f"{w:.3f}"
                                                     for w in walls))
            hop, base = [], []
            for _ in range(HOP_CALLS):
                t0 = time.perf_counter()
                handle.check_health.remote().result(timeout=60)
                hop.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                server.check_health()
                base.append((time.perf_counter() - t0) * 1e3)
            phase("runtime", f"handle hop (check_health through the "
                  f"handle, {HOP_CALLS} calls): median "
                  f"{statistics.median(hop):.3f} ms, p99 "
                  f"{percentile(hop, 0.99):.3f} ms; the direct call "
                  f"{statistics.median(base) * 1e3:.1f} us")

            # f. The device plane.
            samples = devplane.sample_once()
            stats = torch.cuda.memory_stats(0)
            s0 = samples[0] if samples else {}
            gauges = rt_metrics.metrics_summary()
            ok = (s0.get("used") == stats["allocated_bytes.all.current"]
                  and s0.get("peak") == stats["allocated_bytes.all.peak"]
                  and gauges["ray_tpu_device_hbm_bytes_used"]["cuda:0"]
                  == s0.get("used"))
            phase("runtime", f"device plane sample_once: used "
                  f"{s0.get('used')} peak {s0.get('peak')} limit "
                  f"{s0.get('limit')} buffers {s0.get('live_buffers')} vs "
                  f"memory_stats allocated current "
                  f"{stats['allocated_bytes.all.current']} peak "
                  f"{stats['allocated_bytes.all.peak']}: "
                  f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail("the device plane's gauges differ from "
                     "torch.cuda.memory_stats")
            busy, chunks = {}, {}
            for name, run in (
                    ("direct", lambda: run_requests(server, prompts,
                                                    TRACE_NEW)),
                    ("deployed", lambda: handle_round(handle, prompts,
                                                      TRACE_NEW))):
                _, busy[name], chunks[name] = traced_round(devplane, run)
            phase("runtime", f"device busy share of a {TRACE_S:.1f} s "
                  f"trace during decode (capture_device_trace, kernels + "
                  f"copies): direct {100 * busy['direct']:.1f}%, deployed "
                  f"{100 * busy['deployed']:.1f}%; serve.decode_chunk "
                  f"ranges in the traces: direct {chunks['direct']}, "
                  f"deployed {chunks['deployed']}")
            if not chunks["deployed"]:
                fail("the device trace taken during decode holds no "
                     "serve.decode_chunk range")
        finally:
            server.shutdown()
            serve.delete("llama")
    finally:
        serve.shutdown()
        rt.shutdown()
    phase("runtime", f"phase 17 took {time.perf_counter() - t_phase:.1f}s")
    return task_launches


def main() -> None:
    import torch

    profile_dir = None
    if "--profile" in sys.argv[1:]:
        i = sys.argv.index("--profile")
        if i + 1 >= len(sys.argv):
            fail("--profile needs an output directory")
        profile_dir = os.path.abspath(sys.argv[i + 1])

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
    sys.path.insert(0, HERE)
    try:
        import ray_tpu_torch
    except ImportError as e:
        fail(f"ray_tpu_torch is not beside chip_smoke.py ({e})")
    if not os.path.abspath(ray_tpu_torch.__file__).startswith(HERE + os.sep):
        fail(f"ray_tpu_torch imported from {ray_tpu_torch.__file__}, "
             f"not from this checkout")
    from ray_tpu_torch.core.device import resolve_device
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.serve.llm import LLMServer

    resolve_device(None)  # TF32 off, f32-accumulated bf16 matmuls
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # 1. The card.
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = ""
    card = smi.splitlines()[0] if smi else f"{kind}, power limit not read"
    print(card, flush=True)
    phase("card", f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} x{count}")

    # 2. Build.
    t0 = time.perf_counter()
    fa.build_kernels()
    phase("build", f"flash_fwd, flash_bwd and flash_simple built in "
          f"{time.perf_counter() - t0:.1f}s (one nvcc each, in parallel; "
          f"each nvcc's own wall time: " + ", ".join(
              f"{n} {sec:.1f}s" for n, sec in _build.build_seconds.items())
          + ")")
    for lib in ("flash_fwd", "flash_bwd", "flash_simple"):
        # One line per kernel instance: its name and template arguments
        # (the head dimension it pads to, the element type), registers,
        # spills, static shared memory.  ptxas names a function whose
        # setmaxnreg it ignored (warning C7508).
        entry, spill = None, ""
        for line in _build.build_logs.get(lib, "").splitlines():
            if "setmaxnreg" in line and "ignored" in line:
                fail(f"ptxas ignored setmaxnreg: {line.strip()}")
            m = re.search(r"\d(flash_[a-z_]+?)(?:I|E)", line)
            if "Compiling entry" in line and m:
                dp = re.search(r"Li(\d+)E", line)
                elem = ("bf16" if "bfloat16" in line else
                        "f16" if "__half" in line else
                        "f32" if re.search(r"kernelIf", line) else "")
                entry = m.group(1) + "<" + ",".join(
                    x for x in (dp.group(1) if dp else "", elem) if x) + ">"
            elif "spill" in line:
                spill = line.split(",", 1)[-1].strip()
                if re.search(r"[1-9]\d* bytes spill", spill):
                    fail(f"ptxas spilled registers in {entry}: {spill}")
            elif "registers" in line and entry:
                phase("build", f"ptxas {entry}: "
                      f"{line.split(':', 1)[-1].strip()}; {spill}")
    # The simple family is a true f32 computation: its machine code holds
    # FFMA and no tensor-core instruction (HMMA, HGMMA and kin).
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    lib = _build.library_path("flash_simple", fa._LIBS["flash_simple"][0])
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        ffma = len(re.findall(r"\bFFMA\b", sass))
        tensor = len(re.findall(r"\b[HIDQB]G?MMA\b", sass))
        phase("build", f"flash_simple SASS: {ffma} FFMA, {tensor} "
              f"tensor-core instructions")
        if tensor or not ffma:
            fail("flash_simple is not a CUDA-core f32 computation")
    else:
        phase("build", "flash_simple SASS not read (no cuobjdump)")

    # 3. Kernel vs plain version.
    # (B, Hq, Hkv, Sq, Sk, D).  The first case is the main path's shape
    # and layout: (B, H, S, D) views of the model's (B, S, H, D) tensors.
    cases = [
        ("causal", (4, 8, 8, 2048, 2048, 128), True, "bshd", False),
        ("gqa", (2, 8, 2, 1024, 1024, 128), True, "bhsd", False),
        ("noncausal", (2, 8, 4, 1000, 1500, 128), False, "bhsd", False),
        ("padded", (2, 8, 8, 2047, 2047, 128), True, "bshd", True),
    ]
    worst = 0.0
    for i, (name, shape, causal, layout, padded) in enumerate(cases):
        do, dlse = check_kernel(fa, torch, shape, causal, seed=i,
                                layout=layout, padded=padded)
        ok = do <= TOL_O and dlse <= TOL_LSE
        phase("check", f"flash_fwd {name} {shape} {layout} "
              f"causal={causal}: max|do|={do:.3e} (tol {TOL_O}) "
              f"max|dlse|={dlse:.3e} (tol {TOL_LSE}) "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"flash_fwd disagrees with its plain version at {name}")
        worst = max(worst, do)

    # 4. Time at the forward's shape and layout (B=4), then at the train
    # step's (B=8, where its 24 launches a step run).
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for B in (TRAIN_B, 4):
        H, S, D = 8, 2048, 128
        q, k, v = attention_inputs(torch, (B, H, H, S, S, D), 7, "bshd")
        ms = time_ms(lambda: fa._fwd(q, k, v, True))
        plain_ms = time_ms(lambda: fa._fwd_reference(q, k, v, True),
                           reps=3, rounds=3)
        library_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                          scale=1.0))
        flops, nbytes, bound_ms, bound_by = attention_cost(B, H, S, S, D,
                                                           True)
        phase("time", f"flash_fwd ({B},{H},{S},{D}) causal bf16 (B,S,H,D) "
              f"views: {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.4f} ms "
              f"({bound_by}; {flops:.3e} FLOP, {nbytes:.3e} B; "
              f"{100 * bound_ms / ms:.1f}% of it), plain {plain_ms:.4f} ms, "
              f"sdpa {library_ms:.4f} ms")
        del q, k, v
    # The kernels line keeps the forward's shape (B=4), the last timed.

    # 5. llama_440m forward through the kernel.
    cfg = llama.LlamaConfig.llama_440m(dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16)
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=g,
                           device="cuda")
    llama.forward(params, tokens, cfg)  # warm (cuBLAS handles, allocator)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    logits = llama.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_launches = launched(fa)
    phase("forward", f"llama_440m flash B=4 S=2048: {fwd_s * 1e3:.1f} ms, "
          f"{4 * 2048 / fwd_s:.0f} tok/s, launches {fwd_launches}")
    if fwd_launches != {"flash_fwd": cfg.n_layers}:
        fail(f"the forward launched {fwd_launches}, expected flash_fwd "
             f"{cfg.n_layers} times")
    if logits.shape != (4, 2048, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        fail("llama_440m flash logits not finite / wrong shape")
    # Both bf16 paths against one f32 reference (same weights, dot
    # attention in f32): the kernel path must be as accurate as the
    # plain path, whose error is bf16 rounding through 24 layers.
    dot = llama.forward(params, tokens, llama.LlamaConfig.llama_440m(
        dtype=torch.bfloat16, attention_impl="dot"))
    ref = llama.forward({k: v.float() if torch.is_tensor(v) else
                         {kk: vv.float() for kk, vv in v.items()}
                         for k, v in params.items()}, tokens,
                        llama.LlamaConfig.llama_440m(
                            dtype=torch.float32, attention_impl="dot"))
    errs = {}
    for name, out in (("flash", logits), ("dot", dot)):
        d = (out.float() - ref).abs()
        errs[name] = (d.max().item(), d.mean().item(),
                      (out.argmax(-1) == ref.argmax(-1)).float().mean()
                      .item())
    ratio = max(errs["flash"][0] / errs["dot"][0],
                errs["flash"][1] / errs["dot"][1])
    ok = ratio <= TOL_ERR_RATIO
    phase("forward", "vs f32 dot reference: " + ", ".join(
        f"{n} max|d|={e[0]:.3e} mean|d|={e[1]:.3e} argmax agree "
        f"{e[2]:.4f}" for n, e in errs.items())
        + f"; flash/dot error ratio {ratio:.3f} (tol {TOL_ERR_RATIO}) "
        + ("ok" if ok else "MISMATCH"))
    if not ok:
        fail("llama_440m flash forward is less accurate than dot attention")
    if profile_dir:
        profile_run(lambda: llama.forward(params, tokens, cfg),
                    "forward_flash", profile_dir)
    del logits, dot, ref, params, tokens
    torch.cuda.empty_cache()

    # 6. The dense LLMServer at llama_440m.
    prompts = serve_prompts(torch)
    fa.reset_launch_counts()
    server = LLMServer(model_preset="llama_440m", max_slots=8, max_len=512,
                       seed=0)
    try:
        outs, wall = run_requests(server, prompts, 32)
        serve_launches = launched(fa)
        if profile_dir:
            profile_run(lambda: run_requests(server, prompts, 32),
                        "serve_bf16", profile_dir)
    finally:
        server.shutdown()
    if any(len(o["tokens"]) != 32 for o in outs):
        fail(f"LLMServer returned {[len(o['tokens']) for o in outs]} tokens")
    ttft = sorted(o["ttft_ms"] for o in outs)
    # Decode rate once every request has its first token.
    decode_s = wall - ttft[-1] / 1e3
    phase("serve", f"llama_440m bf16: 8 requests x 32 tokens in {wall:.3f}s"
          f" ({8 * 32 / wall:.1f} tok/s end to end), decode "
          f"{8 * 31 / decode_s:.1f} tok/s, TTFT median "
          f"{statistics.median(ttft):.1f} ms max {ttft[-1]:.1f} ms, "
          f"launches {serve_launches} (prefill uses dot attention)")

    register_f32_preset(torch, llama)
    f32_cfg = llama.LlamaConfig.llama_440m_f32()  # flash: the simple family
    server = LLMServer(model_preset="llama_440m_f32", max_slots=8,
                       max_len=512, seed=0)
    try:
        outs, _ = run_requests(server, prompts, 4)
        params = server.params
        firsts = [o["tokens"][0] for o in outs]
        expect = []
        for p in prompts:
            lg = llama.forward(params, torch.tensor([p], device="cuda"),
                               f32_cfg)
            expect.append(int(lg[0, -1].argmax()))
    finally:
        server.shutdown()
    phase("serve", f"llama_440m f32 first tokens {firsts} vs forward "
          f"argmax {expect}: {'ok' if firsts == expect else 'MISMATCH'}")
    if firsts != expect:
        fail("LLMServer first tokens differ from the forward's argmax")

    del server, params, outs
    torch.cuda.empty_cache()

    # 6b. The paged serving plane.
    paged_phase(torch, llama, fa, LLMServer, prompts, profile_dir)

    # 17. The local runtime and the Serve plane on the card.
    runtime_launches = runtime_phase(fa, torch, llama, LLMServer)

    # 7. Backward kernels vs their plain version.
    # (B, Hq, Hkv, Sq, Sk, D).  The first case is the train path's shape
    # and layout: (B, H, S, D) views of the model's (B, S, H, D) tensors.
    cases = [
        ("causal", (8, 8, 8, 2048, 2048, 128), True, "bshd", "impl"),
        ("gqa", (2, 8, 2, 1024, 1024, 128), True, "bhsd", "core"),
        ("noncausal", (2, 8, 4, 1000, 1500, 128), False, "bhsd", "impl"),
        ("padded", (2, 8, 8, 2047, 2047, 128), True, "bshd", "padded"),
    ]
    worst_bwd = {"dq": 0.0, "dkdv": 0.0}
    for i, (name, shape, causal, layout, how) in enumerate(cases):
        errs = check_bwd(fa, torch, shape, causal, seed=20 + i,
                         layout=layout, how=how)
        ok = all(rel <= TOL_GRAD_REL for _, rel in errs.values())
        phase("check", f"flash_bwd {name} {shape} {layout} causal={causal} "
              f"via {how}: " + " ".join(
                  f"{g}: max|d|={a:.3e} |d|/|ref|={rel:.3e}"
                  for g, (a, rel) in errs.items())
              + f" (tol |d|/|ref| <= {TOL_GRAD_REL}) "
              + ("ok" if ok else "MISMATCH"))
        if not ok:
            fail(f"flash_bwd disagrees with its plain version at {name}")
        worst_bwd["dq"] = max(worst_bwd["dq"], errs["dq"][0])
        worst_bwd["dkdv"] = max(worst_bwd["dkdv"], errs["dk"][0],
                                errs["dv"][0])
        torch.cuda.empty_cache()

    # 8. Backward times at the train path's shape and layout.
    B, H, S, D = TRAIN_B, 8, TRAIN_S, 128
    q, k, v = attention_inputs(torch, (B, H, H, S, S, D), 30, "bshd")
    do = attention_inputs(torch, (B, H, H, S, S, D), 31, "bshd",
                          scaled=False)[0]
    o, lse = fa._fwd(q, k, v, True)
    args = fa._BwdArgs(q, k, v, o, lse, do, True)
    _, delta = fa._bwd_dq(args)
    bwd_ms = {"flash_bwd_dq": time_ms(lambda: fa._bwd_dq(args)),
              "flash_bwd_dkdv": time_ms(lambda: fa._bwd_dkdv(args, delta))}
    impl_ms = time_ms(lambda: fa._bwd_impl(q, k, v, o, lse, do, True))
    bwd_plain_ms = time_ms(
        lambda: fa._bwd_reference(q, k, v, o, lse, do, True), reps=3,
        rounds=3)
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    out = sdpa(qq, kk, vv, is_causal=True, scale=1.0)
    bwd_library_ms = time_ms(lambda: torch.autograd.grad(
        out, (qq, kk, vv), do, retain_graph=True))
    bwd_cost = attention_bwd_cost(B, H, S, S, D, True)
    for name, (flops, nbytes, b_ms, b_by) in bwd_cost.items():
        k_ms = bwd_ms[name]
        phase("time", f"{name} ({B},{H},{S},{D}) causal bf16 (B,S,H,D) "
              f"views: {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s), "
              f"bound {b_ms:.4f} ms ({b_by}; {flops:.3e} FLOP, "
              f"{nbytes:.3e} B; {100 * b_ms / k_ms:.1f}% of it)")
    phase("time", f"flash backward (both kernels, _bwd_impl) "
          f"{impl_ms:.4f} ms; plain backward {bwd_plain_ms:.4f} ms; sdpa "
          f"backward {bwd_library_ms:.4f} ms (dq, dk, dv of one call)")
    del q, k, v, do, o, lse, args, delta, qq, kk, vv, out
    torch.cuda.empty_cache()

    # 9. llama_440m loss gradients: both bf16 paths against one f32
    # reference (same f32 weights and tokens, dot attention in f32).
    from ray_tpu_torch.train.optim import tree_leaves

    cfg = llama.LlamaConfig.llama_440m()
    params = llama.init_params(cfg, seed=0, dtype=torch.float32)
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 2048),
                                     generator=g, device="cuda")}
    grads, losses = {}, {}
    for name, c in (("ref", llama.LlamaConfig.llama_440m(
            dtype=torch.float32, attention_impl="dot")),
            ("flash", cfg),
            ("dot", llama.LlamaConfig.llama_440m(attention_impl="dot"))):
        loss, gr = llama.value_and_grad(params, batch, c)
        losses[name] = loss.item()
        grads[name] = torch.cat([t.flatten() for t in tree_leaves(gr)])
        del gr
    errs = {}
    for name in ("flash", "dot"):
        if not torch.isfinite(grads[name]).all():
            fail(f"llama_440m {name} gradients not finite")
        d = (grads[name] - grads["ref"]).abs()
        errs[name] = (d.max().item(), d.mean().item())
        del d
    ratio = max(errs["flash"][0] / errs["dot"][0],
                errs["flash"][1] / errs["dot"][1])
    ok = ratio <= TOL_ERR_RATIO
    phase("grads", f"llama_440m B=2 S=2048 loss ref {losses['ref']:.6f} "
          f"flash {losses['flash']:.6f} dot {losses['dot']:.6f}; grads vs "
          f"f32 dot reference (max |g| {grads['ref'].abs().max().item():.3e}"
          "): " + ", ".join(f"{n} max|d|={e[0]:.3e} mean|d|={e[1]:.3e}"
                            for n, e in errs.items())
          + f"; flash/dot error ratio {ratio:.3f} (tol {TOL_ERR_RATIO}) "
          + ("ok" if ok else "MISMATCH"))
    if not ok:
        fail("llama_440m flash gradients are less accurate than dot "
             "attention's")
    del grads, params, batch
    torch.cuda.empty_cache()

    # 10. Train llama_440m through the entry points.
    torch.cuda.reset_peak_memory_stats()
    state = llama.init_train_state(cfg, seed=0, fused=True)
    n_params = llama.param_count(state["params"])
    step = llama.make_train_step(cfg, fused=True)
    g.manual_seed(13)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                                     generator=g, device="cuda")}
    metrics, per_step = [], []
    for _ in range(TRAIN_WARM):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        fa.reset_launch_counts()
        state, m = step(state, batch)
        per_step.append(launched(fa))
        metrics.append(m)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_TIMED
    peak = torch.cuda.max_memory_allocated()
    train_losses = [m["loss"].item() for m in metrics]
    train_gnorms = [m["grad_norm"].item() for m in metrics]
    tok_s = TRAIN_B * (TRAIN_S - 1) / step_s
    phase("train", f"llama_440m ({n_params} params) fused AdamW "
          f"remat_policy={cfg.remat_policy!r} B={TRAIN_B} S={TRAIN_S}: "
          f"step {step_s * 1e3:.1f} ms (mean of {TRAIN_TIMED} after "
          f"{TRAIN_WARM} warm-up), {tok_s:.0f} tok/s (B*(S-1) per step), "
          f"6*N*tok/s = {6 * n_params * tok_s / 1e12:.1f} TFLOP/s = "
          f"{100 * 6 * n_params * tok_s / PEAK_BF16_FLOPS:.1f}% of the "
          f"989 TFLOP/s bf16 peak (6N model FLOP share, not counting "
          f"attention or remat), peak memory {peak / 2**30:.2f} GiB")
    phase("train", "losses " + " ".join(f"{x:.4f}" for x in train_losses)
          + "; grad norms " + " ".join(f"{x:.3f}" for x in train_gnorms))
    phase("train", f"launches per timed step: {per_step[0]} (all "
          f"{TRAIN_TIMED} steps equal: "
          f"{all(p == per_step[0] for p in per_step)})")
    if not all(math.isfinite(x) for x in train_losses + train_gnorms):
        fail("llama_440m training produced a non-finite loss or grad norm")
    if not train_losses[-1] < train_losses[0]:
        fail(f"llama_440m loss did not fall: {train_losses}")
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkdv": cfg.n_layers}
    if any(p != want for p in per_step):
        fail(f"flash kernels launched {per_step} per step, expected {want}")
    train_launches = per_step[-1]
    if profile_dir:
        profile_run(lambda: step(state, batch), "train_step", profile_dir)
    del state, step, metrics
    torch.cuda.empty_cache()
    state = llama.init_train_state(cfg, seed=0)
    step = llama.make_train_step(cfg)
    chain = []
    for _ in range(CHAIN_STEPS):
        state, m = step(state, batch)
        chain.append(m["loss"].item())
    diffs = [abs(a / b - 1) for a, b in zip(chain, train_losses)]
    ok = max(diffs) <= TOL_CHAIN_LOSS_REL
    phase("train", f"optax-chain counterpart, {CHAIN_STEPS} steps from the "
          f"same state: losses {chain} vs fused {train_losses[:CHAIN_STEPS]}"
          f" (rel diff {max(diffs):.2e}, tol {TOL_CHAIN_LOSS_REL}) "
          + ("ok" if ok else "MISMATCH"))
    if not ok:
        fail("the chain and fused AdamW steps disagree")
    del state, step, batch
    torch.cuda.empty_cache()

    # 11-14. Fault C1's kernels (f16 wgmma, the simple family), the
    # model on them, ring attention's chunk schedule and the one-device
    # mesh.
    c1_times = c1_kernel_phase(fa, torch, sdpa)
    c1_launches = c1_model_phase(fa, torch, llama)
    ring_launches = ring_phase(fa, torch, profile_dir)
    mesh_launches = mesh_phase(fa, torch, llama)
    want = {n: 2 * cfg.n_layers for n in ("flash_fwd", "flash_bwd_dq",
                                          "flash_bwd_dkdv")}
    if mesh_launches != want:
        fail(f"the mesh train steps launched {mesh_launches}, "
             f"expected {want}")
    # 16. The MoE family: the Switch FFN against its one-hot form, then
    # llama_moe_1b trained on the card.
    from ray_tpu_torch.models import moe

    moe_ffn_phase(torch, moe)
    moe_launches = moe_train_phase(fa, torch, llama, profile_dir)
    phase("launches", f"ring (bf16 chunk schedule) {ring_launches['bfloat16']}"
          f", ring f32 {ring_launches['float32']}, f32 model path "
          f"{c1_launches['float32']}, f16 model path "
          f"{c1_launches['float16']}, mesh {mesh_launches}, llama_moe_1b "
          f"train step {moe_launches}")

    # 15. Kernels, then the result.
    kernels = [{
        "name": "flash_fwd", "route": "cuda", "design": DESIGN,
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:96",
        "launches": (train_launches["flash_fwd"]
                     + runtime_launches.get("flash_fwd", 0)),
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}]
    for name, line, err in (("flash_bwd_dq", 216, worst_bwd["dq"]),
                            ("flash_bwd_dkdv", 264, worst_bwd["dkdv"])):
        kernels.append({
            "name": name, "route": "cuda", "design": DESIGN,
            "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
            "launches": train_launches[name], "max_abs_err": err,
            "ms": bwd_ms[name], "plain_ms": bwd_plain_ms,
            "bound_ms": bwd_cost[name][2], "bound_by": bwd_cost[name][3],
            "library_ms": bwd_library_ms})
    for name, line in (("flash_fwd", 96), ("flash_bwd_dq", 216),
                       ("flash_bwd_dkdv", 264)):
        for suffix, path, source, design in (
                ("_f16", "float16", "flash_fwd.cu" if name == "flash_fwd"
                 else "flash_bwd.cu", DESIGN),
                ("_simple", "float32", "flash_simple.cu", DESIGN_SIMPLE)):
            t = c1_times[name + suffix]
            kernels.append({
                "name": name + suffix, "route": "cuda", "design": design,
                "source": f"ray_tpu_torch/ops/csrc/{source}",
                "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
                "launches": c1_launches[path].get(name + suffix, 0),
                "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]})
    for k in kernels:
        if not k["launches"]:
            fail(f"{k['name']} was not launched on its main path")
    # The card line again, so that the output's last lines hold it too.
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 (or
another sm_90a card), nvcc and a CUDA build of PyTorch.  It builds every
kernel of the port's main path from the sources in the checkout, holds
each against its plain PyTorch version, times it, drives the main path
through the entry points a user would call, and checks the results:

1. card name and power limit (nvidia-smi);
2. kernel build (one nvcc per source, all started together), with its
   time and ptxas register report; it fails if ptxas ignored a kernel's
   setmaxnreg or spilled its registers;
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
11. one JSON line per kernel, then the result line.

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

# Published dense peaks of one H100 SXM (NVIDIA data sheet): bf16 tensor
# cores and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
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
# What every kernel is built from, for the kernels line.
DESIGN = "wgmma+tma, warp-specialised"


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


def bound(flops, nbytes):
    """The least time (ms) the card could take for this work, and which
    of its peaks bounds it."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def visible_pairs(Sq, Sk, causal):
    """(row, key) pairs the kernels compute (causal: key j <= row i)."""
    return sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk


def attention_cost(B, Hq, Sq, Sk, D, causal):
    """FLOP and bytes one flash forward call needs at these shapes, and
    its bound in ms."""
    flops = 4.0 * B * Hq * D * visible_pairs(Sq, Sk, causal)  # QK^T, PV
    # q, k, v read once (k/v at Hq heads here: MHA shapes), o and lse
    # written once.
    nbytes = 2.0 * B * Hq * D * (Sq + 2 * Sk + Sq) + 4.0 * B * Hq * Sq
    return (flops, nbytes) + bound(flops, nbytes)


def attention_bwd_cost(B, H, Sq, Sk, D, causal):
    """FLOP and bytes of the dq kernel (with its delta pre-pass) and of
    the dk/dv kernel at these shapes (k/v at q's heads).  Returns
    {name: (flops, bytes, ms, bound_by)}."""
    pairs = visible_pairs(Sq, Sk, causal)
    out = {}
    # dq: S = QK^T, dP = dO V^T, dQ = dS K; delta = rowsum(dO * O).
    # Reads q, o, do (Sq rows) and k, v (Sk rows) in bf16 and lse; writes
    # delta and dq in f32.
    flops = 6.0 * B * H * D * pairs + 2.0 * B * H * Sq * D
    nbytes = (2.0 * B * H * D * (3 * Sq + 2 * Sk) + 4.0 * B * H * Sq * 2
              + 4.0 * B * H * Sq * D)
    out["flash_bwd_dq"] = (flops, nbytes) + bound(flops, nbytes)
    # dk/dv: S^T, dP^T, dV = P^T dO, dK = dS^T Q.  Reads q, do, k, v in
    # bf16 and lse, delta; writes dk, dv in f32.
    flops = 8.0 * B * H * D * pairs
    nbytes = (2.0 * B * H * D * (2 * Sq + 2 * Sk) + 4.0 * B * H * Sq * 2
              + 8.0 * B * H * Sk * D)
    out["flash_bwd_dkdv"] = (flops, nbytes) + bound(flops, nbytes)
    return out


def attention_inputs(torch, shape, seed, layout, scaled=True):
    """q (scaled by D**-0.5 unless ``scaled`` is False), k, v in bf16 on
    the card as (B, H, S, D) tensors: contiguous (``"bhsd"``) or views of
    (B, S, H, D) tensors (``"bshd"``, the layout the model hands the
    kernel)."""
    B, Hq, Hkv, Sq, Sk, D = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(b, h, s, d):
        if layout == "bhsd":
            return torch.randn(b, h, s, d, generator=g, device="cuda"
                               ).to(torch.bfloat16)
        return torch.randn(b, s, h, d, generator=g, device="cuda"
                           ).to(torch.bfloat16).transpose(1, 2)

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
    phase("build", f"flash_fwd and flash_bwd built in "
          f"{time.perf_counter() - t0:.1f}s (one nvcc each, in parallel; "
          f"each nvcc's own wall time: " + ", ".join(
              f"{n} {sec:.1f}s" for n, sec in _build.build_seconds.items())
          + ")")
    for lib in ("flash_fwd", "flash_bwd"):
        # One line per kernel instance: its name and template argument (D,
        # or the head dimension it pads to), registers, spills, static
        # shared memory.  ptxas names a function whose setmaxnreg it
        # ignored (warning C7508).
        entry, spill = None, ""
        for line in _build.build_logs.get(lib, "").splitlines():
            if "setmaxnreg" in line and "ignored" in line:
                fail(f"ptxas ignored setmaxnreg: {line.strip()}")
            m = re.search(r"\d(flash_[a-z_]+?)(?:ILi(\d+)E|E)", line)
            if "Compiling entry" in line and m:
                entry = m.group(1) + (f"<{m.group(2)}>" if m.group(2)
                                      else "")
            elif "spill" in line:
                spill = line.split(",", 1)[-1].strip()
                if re.search(r"[1-9]\d* bytes spill", spill):
                    fail(f"ptxas spilled registers in {entry}: {spill}")
            elif "registers" in line and entry:
                phase("build", f"ptxas {entry}: "
                      f"{line.split(':', 1)[-1].strip()}; {spill}")

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
    fwd_launches = dict(fa.launch_counts)
    phase("forward", f"llama_440m flash B=4 S=2048: {fwd_s * 1e3:.1f} ms, "
          f"{4 * 2048 / fwd_s:.0f} tok/s, launches {fwd_launches}")
    if fwd_launches["flash_fwd"] != cfg.n_layers:
        fail(f"flash_fwd launched {fwd_launches['flash_fwd']} times, "
             f"expected {cfg.n_layers}")
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
    rng = torch.Generator().manual_seed(11)
    lengths = [24, 48, 77, 100, 128, 150, 180, 200]
    prompts = [torch.randint(1, 32000, (n,), generator=rng).tolist()
               for n in lengths]
    fa.reset_launch_counts()
    server = LLMServer(model_preset="llama_440m", max_slots=8, max_len=512,
                       seed=0)
    try:
        outs, wall = run_requests(server, prompts, 32)
        serve_launches = dict(fa.launch_counts)
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

    llama.LlamaConfig.llama_440m_f32 = classmethod(
        lambda cls, **kw: cls.llama_440m(dtype=torch.float32, **kw))
    f32_cfg = llama.LlamaConfig.llama_440m_f32(attention_impl="dot")
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
        per_step.append(dict(fa.launch_counts))
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

    # 11. Kernels, then the result.
    kernels = [{
        "name": "flash_fwd", "route": "cuda", "design": DESIGN,
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:96",
        "launches": train_launches["flash_fwd"],
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()

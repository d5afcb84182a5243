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
6c. the paged decode kernel (:func:`paged_decode_phase`) against its
   plain version and timed at the serve cell's shapes (14 of 32 slots at
   ~1,700 positions, all 32 at 4,096; Mistral-7B's 8 kv heads of 128, 4
   query heads each, bf16) beside its bound, the plain version and SDPA
   over the gathered layout; then a paged llama_440m engine whose
   launches equal its decode steps times its layers;
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
18. (run after 17) prefill/decode disaggregation on one host
    (:func:`disagg_phase`): one prefill and one decode replica of
    llama_440m, paged, block size 16, each on a quarter of the card; f32
    tokens equal the unified paged deployment's and every handoff is
    counted on shm at the decode replica with its bytes; bf16 TTFT and
    decode tok/s in turns with the unified paged deployment, the ring's
    object-plane fallbacks, the extract and inject times against their
    bytes over the host link; the card's memory back after
    ``serve.delete``.
19. (run after 18) cluster mode (:func:`cluster_phase`): a head, two
    worker node processes that see the card, this process joined with
    ``init(address=...)``; a ``num_gpus=1`` task on a worker runs the
    llama_440m flash forward on B1 (24 launches, added to the kernels
    line) bit-equal to the direct call; a 256 MiB bf16 CUDA tensor made
    on a worker got on the card; a replica on a worker node (f32 tokens
    equal a direct engine's; bf16 TTFT, decode tok/s and hop in turns
    with a replica in this process); prefill and decode replicas on the
    two workers (every handoff on ``dcn``, tokens equal the paged
    engine's); after ``shutdown()`` every worker exited and the card's
    free memory back.
20. (run after 19) the DAG API, Ray Client, isolated workers, the CLI
    and the dashboard's device trace (:func:`dag_client_phase`), in
    cluster mode with this process as the one node: a compiled DAG of
    two llama_440m stage actors (12 layers each, bf16, flash on B1,
    ``max_in_flight=4``) whose stage edge is planned onto a shm ring and
    whose last pass equals the one-piece forward, with its pass latency,
    tokens/s in turns with the one-piece forward, the edge's bytes a pass
    and its object-plane fallbacks; an ``isolate=True`` task with no
    CUDA context; ``python -m ray_tpu_torch status`` listing the GPU and
    ``profile --device`` tracing ``flash_fwd``; a thin client in a
    subprocess with CUDA hidden whose ``num_gpus=1`` forward task
    returns the direct call's logits; the card's memory back after
    ``teardown()`` and ``shutdown()``.

21. (run after 20) the train runtime (:func:`trainer_phase`), in a fresh
    ``ray_tpu_torch.init()``: llama_440m trained through
    ``TorchTrainer.fit()`` (one worker on the card, fused AdamW, bf16
    compute, flash attention) from a ``Dataset`` of 104 rows of 2048
    tokens in 4 blocks, B=8, 13 steps: run U's losses finite and
    falling, its step ms (p50, min) and tok/s over steps 4-13, 24
    launches of each flash kernel a step (added to the kernels line); in
    turns with it (U, bare, bare, U) the same batches through
    ``make_train_step`` with no runtime, the same losses, the ratio of
    step times; run F saves the full state at step 5 (save and drain
    times against its bytes), fails at step 8, restarts from the
    checkpoint (``FailureConfig(max_failures=1)``): the restored params
    equal the saved ones, its losses at steps 6-13 equal U's; the card's
    memory back after ``fit()`` and ``shutdown()``, the checkpoint
    directories removed.

22. (run after 21) the cross-process pipeline trainer
    (:func:`pipeline_phase`): ``CrossSlicePipeline`` over llama_440m with
    an untied head, 2 stages of 12 layers, B=8 x S=2048, M=4.  a. f32,
    two stage actors in this process on the simple family: 3 steps
    whose losses equal the one-piece optax-chain step's (rtol 1e-4),
    the launches a step against the schedule's count; b. bf16 across two
    worker node processes labelled as two slices, placed SLICE_SPREAD,
    both boundaries on shm rings: 2 warm-up and 5 timed steps in turns
    with the one-piece bf16 step (step p50, tok/s, the ratio), ring bytes
    a step and fallbacks, the flash launches a step in the stage
    processes against the schedule's count, falling losses, the card's
    free memory back after ``shutdown()``.
23. (run after 22) RLlib and Tune (:func:`rllib_phase`) with learners
    and env runners on the card, on a numpy CartPole-v1
    (:class:`CartPole`): PPO at tests/test_rllib.py's settings reaches a
    best mean return >= 130 (learner and env-stepping ms per
    iteration), IMPALA 5 async iterations, DQN 5 iterations, a 2-trial
    Tune run of ``PPO.as_trainable``.
24. (run after 23) a. a durable workflow of llama_440m
    (:func:`workflow_phase`): step ``train`` takes 3 fused-AdamW steps at
    B=8 x S=2048 on the card and saves the state, step ``evaluate``
    loads it and runs the flash forward at B=4, a host step summarises;
    ``evaluate`` fails once, ``workflow.resume`` restores ``train``
    without re-running it and re-runs ``evaluate``: restored tensors on
    the card, logits bit-equal to an uninterrupted workflow over the
    same checkpoint, 120/72/72 B1/B2/B3 launches (added to the kernels
    line), each step's time, the bytes persisted per step, the resume's
    time, the card's memory back; b. the autoscaler
    (:func:`autoscaler_phase`): a driver with no GPU submits a
    ``num_gpus=1`` llama_440m flash forward, the autoscaler launches a
    ``{"CPU": 2, "GPU": 1}`` node for the pending demand, the task's
    logits equal the direct call's bit for bit (24 B1 launches, added to
    the kernels line), the idle node is terminated down to 0 nodes and
    the card's memory comes back (submit -> registered, submit ->
    result, idle -> terminated); c. raylint (:func:`lint_phase`):
    ``python -m ray_tpu_torch lint`` exits 0 clean without importing jax
    or the JAX package, the cold and warm wall clock and the parse-cache
    hit rate, ``--list-rules`` naming all 21 rules.
25. (run after 24) the recovery paths (:func:`chaos_phase`), driven by
    ``experimental.chaos`` schedules at llama_440m's full width: a.
    the bf16 pipeline (22's shape, both stages in this process) with a
    boundary ring severed in step 1 of 3, whose losses equal a clean
    run's; b. a stage killed mid-step, which raises a typed error naming
    the edge, the card's memory back after ``shutdown()``; c. a DAG
    producer (20's stages) killed mid-pass, ``ActorDiedError`` within
    twice the channel timeout, the recompiled DAG's logits bit-equal to
    the one-piece forward; d. one of two f32 ``LLMServer`` replicas
    killed, every request answered through the handle with the direct
    engine's tokens, memory back after ``serve.delete``; e. two worker
    node processes training on the card, their memory series on the
    head TSDB, the dashboard and ``render_top`` within 64 MiB of their
    own ``memory_stats``.  The phase's flash launches join the kernels
    line.
26. (run after 16, before 15, since it needs phase 10's tok/s) the
    drivers of ``ray_tpu_torch/tools/`` (:func:`drivers_phase`): a.
    ``dryrun.entry()``'s llama_125m logits bit-equal to a direct forward;
    b. ``dryrun.dryrun_multichip`` over the machine's cards (one card: n
    = 1, in this process), both losses in (0, 20); c. ``profile_mfu`` at
    llama_440m B=8 x S=2048 with both optimizers, one subprocess a
    phase: the forward / backward / optimizer / attention / head split,
    each child's flash launches equal to its calls times the launches a
    call (added to the kernels line), the optimizer update timed alone,
    the fused tok/s within 0.7-1.3 of phase 10's, and one attn_dot
    gradient's peak memory; d. ``perf_sweep``'s bf16-moment case, with
    its tok/s and MFU.
27. (run after 26, before 15) llama3_8b, the JAX package's GQA preset
    (:func:`llama3_phase`; 32 q heads over 8 kv heads, an untied head
    over 128,256 tokens, rope theta 500,000), each part freeing the one
    before it: a. B1s in f32 at 27c's shapes (1, 32/8, S, 128) causal
    for two ragged prompt lengths and the lengths the model pads them
    to, then B1, and B2 and B3 through
    ``_FlashCore`` (the expand and group-sum at group 4), against their
    plain versions at (1, 32/8, 8192, 128) bf16, with their times,
    bounds, the plain versions' and SDPA's with ``enable_gqa``; b. the 32-layer forward at B=1 x S=8192
    in bf16 on flash (32 B1 launches) and on dot against an f32
    reference (phase 5's gate); c. ``LLMServer(model_preset=
    "llama3_8b", max_slots=8, max_len=2048)``: 8 requests, TTFT
    min/p50/p99, decode tok/s, the card's busy share; an f32 engine's
    first tokens equal the f32 flash forward's argmax (B1s launches,
    added to the kernels line); d. the bf16 paged, int8, fp8 and spec
    planes answering the same requests (token agreement, pool bytes,
    prefix hits), then f32 dense == paged == paged+spec tokens and a
    warm paged run == the cold one; e. 3 fused train steps at full
    width, B=1 x S=8192, at the largest depth whose reckoned peak fits
    (7 of 32 layers on an 80 GB card): finite, falling losses, B1-B3
    each launched once a layer a step (added to the kernels line), peak
    memory against the reckoning, tok/s and the 6N share of the peak.
28. (run after 27, before 15) the bench twin (:func:`bench_phase`):
    ``python -m ray_tpu_torch.tools.bench --small-host`` in a subprocess
    at ``bench.py``'s sizes on the card (the host planes at its smaller
    ones), every phase (the llama_440m train
    phase through the Data plane, the llama_125m serve phases at 112
    slots on dense, paged, spec and spec+int8, kv-quant, prefix cache,
    disaggregation, then the host planes): each phase's keys on a line
    of its own, present and finite, no phase's error key, the MFU in
    (0, 1), B1-B3 launched 24 times each a train step (added to the
    kernels line), the object-plane, broadcast and all-reduce tensors on
    the card, raylint clean.

``--profile DIR`` adds a torch.profiler pass over the forward, over one
more round of requests, over one train step and over one step through
the trainer (run U's third, with every thread's host ops), and writes
op tables under ``DIR``; and the card's busy share over one step of
22b's pipeline, from both stage processes' device traces.

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
DESIGN_PAGED = ("in-place reads through the block tables, 16-byte loads, "
                "the G query heads of a kv head in registers, split-K with "
                "a log-sum-exp combine")


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
                   peak=PEAK_BF16_FLOPS, kv_heads=None):
    """FLOP and bytes one flash forward call needs at these shapes
    (``elem`` bytes an element; k/v at ``kv_heads``, Hq unless given),
    and its bound in ms at ``peak``."""
    Hkv = kv_heads or Hq
    flops = 4.0 * B * Hq * D * visible_pairs(Sq, Sk, causal)  # QK^T, PV
    # q, k, v read once, o and lse written once.
    nbytes = (elem * B * D * (2 * Hq * Sq + 2 * Hkv * Sk)
              + 4.0 * B * Hq * Sq)
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


def pool_reckoning(cfg, n_blocks, block_size=16):
    """The paged pool reckoned from the config: K and V, every layer,
    bf16 values, or 8-bit values plus one f32 scale per row.  Returns
    (rows a block, {kv_quant: pool bytes})."""
    rows = 2 * cfg.n_layers * block_size * cfg.n_kv_heads
    return rows, {None: n_blocks * rows * cfg.head_dim * 2,
                  "int8": n_blocks * rows * (cfg.head_dim + 4),
                  "fp8": n_blocks * rows * (cfg.head_dim + 4)}


# Phase 6c: the paged decode kernel at the serve cell's shapes (Mistral-7B:
# 8 kv heads of 128 with 4 query heads each, bf16, 16-token blocks, 32
# slots, the cell's pool of 8,193 blocks x 32 layers): (label, active
# slots, median length, table blocks).  Lengths are drawn from the seed
# around the median, clipped to the table.
PAGED_DECODE_CASES = (("14 of 32 slots at ~1,700", 14, 1700, 128),
                      ("32 of 32 slots at 4,096", 32, 4096, 256))
PAGED_DECODE_POOL = (8193, 32, 16, 8, 4, 128)  # N, L, bs, Hkv, G, D
# Kernel against its plain version at these shapes, bf16, the output as a
# whole (tests/test_torch_paged_decode.py TOL_REL): the plain version
# rounds the probabilities to bf16 before the product, the kernel keeps
# them in f32, and both round the output to bf16.
TOL_PAGED_DECODE_REL = 1e-2


def paged_decode_cost(lens, active, nb, bs, Hkv, G, D, elem=2):
    """(FLOP, bytes, bound ms, bound by) of one paged decode call: each
    active slot's keys 0..p inside its table (q.k and p v, 2 FLOP each a
    key, query head and dim), those keys' K and V rows read once, the
    active queries read and every slot's output written once."""
    keys = sum(min(int(p) + 1, nb * bs) for p, a in zip(lens, active) if a)
    n_active = sum(bool(a) for a in active)
    flops = 4 * keys * Hkv * G * D
    nbytes = (2 * keys * Hkv * D + (n_active + len(lens)) * Hkv * G * D) * elem
    return (flops, nbytes) + bound(flops, nbytes)


def paged_decode_case(np, rng, B, N, bs, nb, n_active, median):
    """(lens, active, tables) of B slots over a pool of N blocks: n_active
    slots at lengths drawn around ``median`` (15% spread; all at the
    table's last position where ``median`` reaches its width), each with
    its own blocks, the rest of every table the null block."""
    width = nb * bs
    lens = np.clip(rng.normal(median, 0.15 * median, B).astype(int), bs,
                   width - 1)
    if median >= width:
        lens[:] = width - 1
    active = np.zeros(B, bool)
    active[rng.choice(B, n_active, replace=False)] = True
    table = np.zeros((B, nb), np.int64)
    blocks = rng.permutation(np.arange(1, N))
    for b in range(B):
        used = -(-(int(lens[b]) + 1) // bs)
        table[b, :used] = blocks[b * nb:b * nb + used]
    return lens, active, table


def paged_decode_phase(torch, llama, LLMServer, prompts):
    """The paged decode kernel against its plain version and timed at the
    serve cell's shapes (bound, plain version, SDPA over the gathered
    layout as a yardstick: the port never calls it), then a paged bf16
    llama_440m engine whose every decode layer of every step launches it.
    Returns its kernels-line numbers."""
    import numpy as np

    from ray_tpu_torch.observability import timeline
    from ray_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    pa.build_kernels()
    phase("paged_decode", f"built in {time.perf_counter() - t0:.1f}s")
    for line in _build_log("paged_decode"):
        phase("paged_decode", line)
    N, L, bs, Hkv, G, D = PAGED_DECODE_POOL
    B, layer, scale = 32, L // 2, D ** -0.5
    dt, dev = torch.bfloat16, "cuda"
    pool_k = torch.randn((N, L, bs, Hkv, D), dtype=dt, device=dev)
    pool_v = torch.randn((N, L, bs, Hkv, D), dtype=dt, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(23)
    out = {}
    for label, n_active, median, nb in PAGED_DECODE_CASES:
        width = nb * bs
        lens, active, table = paged_decode_case(np, rng, B, N, bs, nb,
                                                n_active, median)
        q = torch.randn((B, 1, Hkv * G, D), dtype=dt, device=dev)
        bt, lens_t, active_t = (torch.from_numpy(x).to(dev)
                                for x in (table, lens, active))
        args = (q, pool_k, pool_v, layer, bt, lens_t, active_t, scale)
        attend = pa.PagedDecode(pool_k, pool_v, bt, active_t, Hkv * G, scale)
        pa.reset_launch_counts()
        got = attend(q, layer, lens_t)
        ref = pa.paged_decode_reference(*args)
        torch.cuda.synchronize()
        on = active_t
        err = ((got[on].float() - ref[on].float()).norm()
               / ref[on].float().norm()).item()
        zeros = not got[~on].any().item()
        launches = dict(pa.launch_counts)
        splits, split_len = attend.splits, attend.split_len
        ms = time_ms(lambda: attend(q, layer, lens_t))
        plain_ms = time_ms(lambda: pa.paged_decode_reference(*args),
                           reps=3, rounds=3)
        # The yardstick: SDPA on the layout already gathered (the gather
        # not timed), each slot's keys 0..p by a mask, GQA by enable_gqa.
        k = pool_k[:, layer].index_select(0, bt.reshape(-1)).view(
            B, width, Hkv, D).transpose(1, 2)
        v = pool_v[:, layer].index_select(0, bt.reshape(-1)).view(
            B, width, Hkv, D).transpose(1, 2)
        mask = (torch.arange(width, device=dev)[None, :]
                <= lens_t[:, None])[:, None, None, :]
        qh = q.transpose(1, 2)
        library_ms = time_ms(lambda: sdpa(qh, k, v, attn_mask=mask,
                                          scale=scale, enable_gqa=True))
        flops, nbytes, b_ms, b_by = paged_decode_cost(
            lens, active, nb, bs, Hkv, G, D)
        phase("paged_decode", f"{label} (B={B}, nb={nb}, bs={bs}, Hkv={Hkv},"
              f" G={G}, D={D}, bf16; {splits} splits of {split_len} keys): "
              f"{ms:.4f} ms ({nbytes / ms / 1e9:.2f} TB/s), bound "
              f"{b_ms:.4f} ms ({b_by}; {nbytes:.4e} B, {flops:.4e} FLOP; "
              f"{100 * b_ms / ms:.1f}% of it), plain {plain_ms:.4f} ms, "
              f"sdpa on the gathered layout {library_ms:.4f} ms; rel err "
              f"{err:.3e} (tol {TOL_PAGED_DECODE_REL}), inactive zero "
              f"{zeros}, launches {launches}")
        if err > TOL_PAGED_DECODE_REL or not zeros:
            fail(f"paged_decode disagrees with its plain version at {label}")
        if launches != {"paged_decode": 1,
                        "paged_decode_combine": int(splits > 1)}:
            fail(f"paged_decode launched {launches} for one call")
        out[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=library_ms, err=err)
        del q, got, ref, k, v, mask, qh, args, attend
    del pool_k, pool_v
    torch.cuda.empty_cache()

    # The engine: every layer of every decode step goes through it.
    server = LLMServer(model_preset="llama_440m", max_slots=8, max_len=512,
                       seed=0, paged=True, block_size=16)
    try:
        pa.reset_launch_counts()
        t_mark = time.time() * 1e6
        outs, wall = run_requests(server, prompts, 32)
        chunks = [e for e in timeline.export_timeline(None)
                  if e["name"] == "serve.decode_chunk" and e.get("ph") == "X"
                  and e["ts"] >= t_mark]
        steps = sum(e["args"]["k"] for e in chunks)
        kinds = sorted({e["args"]["kv"] for e in chunks})
        n_layers = server.cfg.n_layers
        launches = dict(pa.launch_counts)
    finally:
        server.shutdown()
    phase("paged_decode", f"llama_440m paged bf16, 8 requests x 32 tokens in "
          f"{wall:.3f}s: {len(chunks)} chunks, {steps} steps x {n_layers} "
          f"layers, kv {kinds}, launches {launches}")
    if any(len(o["tokens"]) != 32 for o in outs) or kinds != ["pool"] \
            or launches["paged_decode"] != steps * n_layers:
        fail(f"the paged engine's decode launched {launches} for {steps} "
             f"steps x {n_layers} layers (kv {kinds})")
    best = out[PAGED_DECODE_CASES[0][0]]
    return dict(best, launches=launches["paged_decode"])


def _build_log(lib):
    """The ptxas lines of ``lib``'s last build: each kernel instance's
    registers and spills."""
    from ray_tpu_torch.ops import _build

    return [line.strip() for line in
            _build.build_logs.get(lib, "").splitlines()
            if "registers" in line or "spill" in line
            or "Compiling entry" in line]


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
    rows, want_bytes = pool_reckoning(cfg, n_blocks)
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


def profile_run(fn, label: str, out_dir: str,
                all_threads: bool = False) -> None:
    """Run ``fn`` once under torch.profiler; print and return the device
    busy share of the wall time and write the op tables (by device time and by host
    time) to ``out_dir/profile_<label>.txt``.  ``all_threads`` records
    the host ops of every thread (actors run on their own)."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=all_threads)) as prof:
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
    return device_s / wall


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
# and ends inside the window, so the window holds two chunks' time.
# Rounds of four chunks run back to back until the capture returns: the
# window opens only once the profiler has started, and its first start
# in a process can outlast a whole round.
PUT_BYTES, PUT_REPS, HOP_CALLS = 256 << 20, 10, 50
TRACE_S, TRACE_NEW = 2.0, 64
# The card's memory once a deployment is deleted, against before it.
TOL_SERVE_LEAK_BYTES = 64 << 20


def serve_prompts(torch):
    """PERF.md's serve traffic: 8 prompts of 24-200 tokens, seed 11."""
    rng = torch.Generator().manual_seed(11)
    return [torch.randint(1, 32000, (n,), generator=rng).tolist()
            for n in SERVE_LENGTHS]


def register_f32_preset(torch, llama, preset="llama_440m"):
    """``<preset>_f32``: the preset in f32, for the token-identity gates
    (an engine reads its config from a preset)."""
    setattr(llama.LlamaConfig, preset + "_f32", classmethod(
        lambda cls, **kw: getattr(cls, preset)(dtype=torch.float32, **kw)))


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
    """Run rounds of requests (``run()``) back to back while the device
    plane captures a trace of the process, begun once the first round's
    prefills are under way; the rounds go on until the capture has
    returned.  Returns the first round's outs, the busy share of the
    window, the ``serve.decode_chunk`` ranges and device events it holds,
    the capture's wall time (the profiler's start, the window, its stop
    and export) and the rounds begun meanwhile."""
    import io
    import threading
    import zipfile

    rounds, errors = [], []
    captured = threading.Event()

    def go():
        try:
            while True:
                rounds.append(run()[0])
                if captured.is_set():
                    return
        except Exception as e:  # reported once the capture returns
            errors.append(e)

    th = threading.Thread(target=go)
    th.start()
    time.sleep(0.3)
    t0 = time.perf_counter()
    try:
        trace = devplane.capture_device_trace(TRACE_S)
    finally:
        captured.set()
        capture_s = time.perf_counter() - t0
        th.join()
    if errors or not rounds:
        fail(f"the traced rounds of requests did not finish: {errors!r}")
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
    return {"outs": rounds[0], "busy": busy / (TRACE_S * 1e6),
            "chunks": chunks, "events": len(spans), "capture_s": capture_s,
            "rounds": len(rounds)}


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
            tr = {name: traced_round(devplane, run) for name, run in (
                ("direct", lambda: run_requests(server, prompts,
                                                TRACE_NEW)),
                ("deployed", lambda: handle_round(handle, prompts,
                                                  TRACE_NEW)))}
            phase("runtime", f"device busy share of a {TRACE_S:.1f} s "
                  f"trace during decode (capture_device_trace, kernels + "
                  f"copies): " + ", ".join(
                      f"{n} {100 * t['busy']:.1f}% ({t['events']} device "
                      f"events; the capture took {t['capture_s']:.3f} s "
                      f"over {t['rounds']} round(s) of {TRACE_NEW} "
                      f"tokens)" for n, t in tr.items())
                  + "; serve.decode_chunk ranges in the traces: direct "
                  f"{tr['direct']['chunks']}, deployed "
                  f"{tr['deployed']['chunks']}")
            if not tr["deployed"]["chunks"]:
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


# Phases 18 and 19: the host link's nominal rate (PCIe 5.0 x16, one
# direction, the H100's link to its host), the bound of every host copy
# of a handoff or an object; the replicas' share of the card when two or
# three engines serve from it at once; the card's free memory after
# phase 19 against before it.
PEAK_PCIE_BYTES_S = 64e9
DISAGG_GPU_SHARE = 0.25
TOL_CLUSTER_FREE_BYTES = 64 << 20
CLUSTER_PUT_REPS = 3


def handoff_counts(summary):
    """The KV handoff counters and the KV rings' object-plane fallbacks
    of a metrics summary (a process's, or a replica's ``kv_stats()``):
    {(transport, "total"|"bytes"): n, ("ring", "fallback"): n}."""
    out = {(t, what): summary.get(f"ray_tpu_kv_handoff_{what}", {}).get(t, 0)
           for t in ("shm", "dcn") for what in ("total", "bytes")}
    out[("ring", "fallback")] = sum(
        v for k, v in summary.get("ray_tpu_channel_fallback_total",
                                  {}).items() if "kv-" in str(k))
    return out


def held_bytes(torch):
    """Bytes of live tensors on the card, without cuBLAS's workspaces:
    cuBLAS keeps one (32 MiB on Hopper) for every thread that ran a
    matmul, out of the caching allocator, for the life of the process,
    and every engine's scheduler thread is a new one."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    with_ws = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    return with_ws, torch.cuda.memory_allocated()


def delta(after, before):
    return {k: after[k] - before.get(k, 0) for k in after}


def block_bytes(cfg, block_size, elem):
    """Bytes of one KV block of one tensor (K or V)."""
    return cfg.n_layers * block_size * cfg.n_kv_heads * cfg.head_dim * elem


def f32_server_class(LLMServer):
    """LLMServer at llama_440m in f32 in any process: a replica on a
    worker node has no ``llama_440m_f32`` preset until its constructor
    registers one (the class travels by value)."""

    class F32Server(LLMServer):
        def __init__(self, role="both", serve_deployment=None, **kw):
            import torch as _torch

            from ray_tpu_torch.models import llama as _llama

            _llama.LlamaConfig.llama_440m_f32 = classmethod(
                lambda cls, **k: cls.llama_440m(dtype=_torch.float32, **k))
            super().__init__(role=role, serve_deployment=serve_deployment,
                             **kw)

    return F32Server


def disagg_phase(torch, llama, LLMServer):
    """18. Prefill/decode disaggregation on one host, in a fresh local
    runtime: a deployment of one prefill and one decode replica
    (``replica_roles``, each holding a quarter of the card) at
    llama_440m, paged, block size 16.  a. f32 tokens of the serve/dense
    traffic equal the unified paged deployment's, every handoff counted
    on shm at the decode replica; b. bf16 TTFT and decode tok/s in turns
    with the unified paged deployment, the handoff bytes against
    sum(ceil(P/16)) x 2 blocks, the ring's object-plane fallbacks; c.
    the extract and the inject of 2 and 13 blocks against their bytes
    over the host link; d. the card's memory back after
    ``serve.delete``."""
    import types

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.experimental.channel import channel_path
    from ray_tpu_torch.observability import metrics as rt_metrics
    from ray_tpu_torch.serve.kv_transfer import KVReceiver, KVSender
    from ray_tpu_torch.serve.llm import _Request

    register_f32_preset(torch, llama)
    prompts = serve_prompts(torch)
    cfg = llama.LlamaConfig.llama_440m()
    bs = 16
    n_blocks = sum(-(-len(p) // bs) for p in prompts)
    t_phase = time.perf_counter()
    serve.shutdown()
    rt.shutdown()
    rt.init()
    share = {"num_gpus": DISAGG_GPU_SHARE}
    roles = {"prefill": 1, "decode": 1}

    def unified(preset, name):
        return serve.run(serve.deployment(
            LLMServer, name=name, ray_actor_options=dict(share)).bind(
                model_preset=preset, max_slots=8, max_len=512, seed=0,
                paged=True, block_size=bs))

    def disagg(preset, name):
        return serve.run(serve.deployment(
            LLMServer, name=name, ray_actor_options=dict(share),
            replica_roles=roles).bind(
                model_preset=preset, max_slots=8, max_len=512, seed=0,
                paged=True, block_size=bs))

    def decode_counts(handle):
        # The decode replica's kv_stats, read through its handle (its
        # counters are this process's: the replicas are in-process).
        handle.options(role="decode").kv_stats.remote().result(timeout=60)
        return handoff_counts(rt_metrics.metrics_summary())

    try:
        # a. f32 token identity and the shm transport.
        _, mem0 = held_bytes(torch)
        h_uni = unified("llama_440m_f32", "paged_f32")
        want, _ = handle_round(h_uni, prompts, 32)
        serve.delete("paged_f32")
        h_dis = disagg("llama_440m_f32", "disagg_f32")
        c0 = decode_counts(h_dis)
        got, wall = handle_round(h_dis, prompts, 32)
        d = delta(decode_counts(h_dis), c0)
        want_tokens = [o["tokens"] for o in want]
        got_tokens = [o["tokens"] for o in got]
        f32_bytes = 2 * n_blocks * block_bytes(cfg, bs, 4)
        phase("disagg", f"llama_440m f32 prefill + decode replicas, 8 "
              f"requests x 32 tokens in {wall:.3f}s: tokens == the unified "
              f"paged "
              f"deployment's: {got_tokens == want_tokens}; handoffs at the "
              f"decode replica shm {d[('shm', 'total')]} dcn "
              f"{d[('dcn', 'total')]}, bytes {d[('shm', 'bytes')]} (expect "
              f"{f32_bytes}: {n_blocks} blocks x K and V in f32), ring "
              f"fallbacks {d[('ring', 'fallback')]}")
        if got_tokens != want_tokens:
            fail(f"disaggregated f32 tokens differ from the unified paged "
                 f"deployment's (first at "
                 f"{first_diff(got_tokens, want_tokens)})")
        if (d[("shm", "total")], d[("dcn", "total")]) != (len(prompts), 0) \
                or d[("shm", "bytes")] != f32_bytes:
            fail(f"handoffs not all on shm with their bytes: {d}")
        serve.delete("disagg_f32")

        # b. bf16 numbers, in turns with the unified paged deployment.
        h_uni = unified("llama_440m", "paged")
        h_dis = disagg("llama_440m", "disagg")
        rows = {"unified paged": [], "disaggregated": []}
        c0 = decode_counts(h_dis)
        for _ in range(SERVE_ROUNDS):
            rows["unified paged"].append(handle_round(h_uni, prompts, 32))
            rows["disaggregated"].append(handle_round(h_dis, prompts, 32))
        d = delta(decode_counts(h_dis), c0)
        for name, rounds in rows.items():
            ttft = [o["ttft_ms"] for outs, _ in rounds for o in outs]
            rates = [serve_numbers(outs, wall)[2] for outs, wall in rounds]
            phase("disagg", f"llama_440m bf16 {name}, {SERVE_ROUNDS} rounds "
                  f"of 8 x 32 tokens: TTFT min {min(ttft):.1f} ms p50 "
                  f"{percentile(ttft, 0.5):.1f} ms p99 "
                  f"{percentile(ttft, 0.99):.1f} ms, decode tok/s "
                  + " ".join(f"{r:.1f}" for r in rates)
                  + ", round wall s "
                  + " ".join(f"{w:.3f}" for _, w in rounds))
        bf16_bytes = SERVE_ROUNDS * 2 * n_blocks * block_bytes(cfg, bs, 2)
        phase("disagg", f"bf16 handoffs at the decode replica: shm "
              f"{d[('shm', 'total')]} dcn {d[('dcn', 'total')]}, bytes "
              f"{d[('shm', 'bytes')]} (expect {bf16_bytes} = "
              f"{SERVE_ROUNDS} x {n_blocks} blocks x 2 x "
              f"{block_bytes(cfg, bs, 2)} B); frames that took the ring's "
              f"object-plane fallback {d[('ring', 'fallback')]} of "
              f"{d[('shm', 'total')]}")
        if (d[("shm", "total")], d[("dcn", "total")]) != \
                (SERVE_ROUNDS * len(prompts), 0) \
                or d[("shm", "bytes")] != bf16_bytes:
            fail(f"bf16 handoffs not all on shm with their bytes: {d}")
        serve.delete("paged")
        serve.delete("disagg")

        # c. The extract and the inject on an idle bf16 engine.
        probe = LLMServer(model_preset="llama_440m", max_slots=8,
                          max_len=512, seed=0, paged=True, block_size=bs,
                          warmup=False)
        try:
            def extract(n):
                req = _Request([1] * (n * bs), 1)
                probe._extract_kv(
                    req, types.SimpleNamespace(blocks=list(range(1, n + 1))))
                return req.kv[0].tensor(), req.kv[1].tensor()

            for n in (2, 13):
                nbytes = 2 * n * block_bytes(cfg, bs, 2)
                dest = torch.arange(1, n + 1, device="cuda")
                ex, inj = [], []
                for i in range(12):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    kb, vb = extract(n)
                    t1 = time.perf_counter()
                    # The ingest receives pageable host memory (a ring
                    # frame), so inject from a pageable copy.
                    kb, vb = kb.clone(), vb.clone()
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    probe._inject(kb, vb, dest)
                    torch.cuda.synchronize()
                    t3 = time.perf_counter()
                    if i >= 2:
                        ex.append((t1 - t0) * 1e3)
                        inj.append((t3 - t2) * 1e3)
                link_ms = nbytes / PEAK_PCIE_BYTES_S * 1e3
                phase("disagg", f"bf16 handoff of {n} blocks ({nbytes} B, K "
                      f"and V): extract (gather on the card + pinned copy "
                      f"to the host) median {statistics.median(ex):.3f} ms "
                      f"(min {min(ex):.3f}), inject (pinned staging + copy "
                      f"to the card + index_copy) median "
                      f"{statistics.median(inj):.3f} ms (min "
                      f"{min(inj):.3f}); the bytes over the host link "
                      f"{link_ms:.3f} ms at {PEAK_PCIE_BYTES_S / 1e9:.0f} "
                      f"GB/s")
            # A handoff of 13 blocks over the shm ring, sent and received
            # in this process (the slot sized for it: no fallback).
            kb, vb = extract(13)
            sender, receiver = KVSender(), KVReceiver()
            ep = {"node": None, "ring": channel_path("kv-probe")}
            shm_ms = []
            try:
                for i in range(12):
                    t0 = time.perf_counter()
                    h = sender.send(ep, f"probe{i}", kb, vb, list(range(13)))
                    k, v = receiver.recv(h)
                    if i >= 2:
                        shm_ms.append((time.perf_counter() - t0) * 1e3)
                ok = torch.equal(k, kb) and torch.equal(v, vb)
            finally:
                sender.close()
                receiver.close()
            phase("disagg", f"bf16 handoff of 13 blocks over the shm ring "
                  f"(send + receive, one process): median "
                  f"{statistics.median(shm_ms):.3f} ms (min "
                  f"{min(shm_ms):.3f}); same bytes: "
                  f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail("the shm handoff changed the blocks")
        finally:
            probe.shutdown()
        del probe, extract
        with_ws, mem1 = held_bytes(torch)
        phase("disagg", f"after serve.delete: memory_allocated "
              f"{mem0 / 2**20:.1f} MiB before the deployments, "
              f"{mem1 / 2**20:.1f} MiB after (tol "
              f"{TOL_SERVE_LEAK_BYTES >> 20} MiB; "
              f"{with_ws / 2**20:.1f} MiB with the engine threads' cuBLAS "
              f"workspaces)")
        if mem1 - mem0 > TOL_SERVE_LEAK_BYTES:
            fail(f"{(mem1 - mem0) / 2**20:.1f} MiB still held after "
                 f"serve.delete of the disaggregated deployments")
    finally:
        serve.shutdown()
        rt.shutdown()
    phase("disagg", f"phase 18 took {time.perf_counter() - t_phase:.1f}s")


def cluster_phase(fa, torch, llama, LLMServer):
    """19. Cluster mode on the card: a head in this process, two worker
    node processes that see the card, and this process joined as a
    node of its own (``init(address=...)``).  a. a ``num_gpus=1`` task on a
    worker runs the llama_440m flash forward on B1 (the kernels loaded
    from this checkout's build directory) and its last-position logits
    equal this process's direct call bit for bit; b. a 256 MiB bf16
    CUDA tensor made on a worker comes to this process on the card, its time
    against its host copies' bound; c. the serve/dense traffic through a
    replica on a worker node: f32 tokens equal a direct engine's, bf16
    TTFT, decode tok/s and the hop in turns with a replica in this
    process; d. prefill and decode replicas on the two workers: every
    handoff counted ``dcn`` at the decode replica, tokens equal the
    paged engine's; e. after ``shutdown()`` every worker has exited and
    the card's free memory is back.  Returns the launches of a."""
    import gc

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    from ray_tpu_torch.core.node import wait_for_nodes

    register_f32_preset(torch, llama)
    F32Server = f32_server_class(LLMServer)
    prompts = serve_prompts(torch)
    t_phase = time.perf_counter()
    serve.shutdown()
    rt.shutdown()
    held_bytes(torch)
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    c = Cluster()
    procs = []
    try:
        t0 = time.perf_counter()
        procs = [c.add_node(num_cpus=4, resources={f"node{i}": 8},
                            name=f"node{i}", wait=False) for i in range(2)]
        c.connect(resources={"here": 8})
        wait_for_nodes(c.head_address, 3, timeout=120)
        # The resource view reaches this process with the heartbeats.
        deadline = time.monotonic() + 60
        while rt.cluster_resources().get("GPU") != 3 \
                and time.monotonic() < deadline:
            time.sleep(0.2)
        total = rt.cluster_resources()
        phase("cluster", f"head + 2 worker node processes + this process "
              f"up in {time.perf_counter() - t0:.1f}s; cluster_resources "
              f"GPU {total.get('GPU')}, CPU {total.get('CPU')}")
        if total.get("GPU") != 3:
            fail(f"the cluster advertises {total.get('GPU')} GPUs, "
                 f"expected one per node (3)")

        # a. A GPU task on a worker node runs the forward on B1.
        cfg = llama.LlamaConfig.llama_440m(dtype=torch.bfloat16,
                                           attention_impl="flash")

        @rt.remote(num_gpus=1, resources={"node0": 1})
        def forward_task(seed):
            import os

            import torch as _torch

            from ray_tpu_torch.models import llama as _llama
            from ray_tpu_torch.ops import flash_attention as _fa

            params = _llama.init_params(cfg, seed=seed,
                                        dtype=_torch.bfloat16)
            tg = _torch.Generator(device="cuda")
            tg.manual_seed(7)
            tokens = _torch.randint(0, cfg.vocab_size, (4, 2048),
                                    generator=tg, device="cuda")
            _fa.reset_launch_counts()
            logits = _llama.forward(params, tokens, cfg)
            _torch.cuda.synchronize()
            counts = {n: k for n, k in _fa.launch_counts.items() if k}
            return logits[:, -1].clone(), counts, os.getpid()

        last, task_launches, pid = rt.get(forward_task.remote(0),
                                          timeout=600)
        params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16)
        tg = torch.Generator(device="cuda")
        tg.manual_seed(7)
        direct = llama.forward(params, torch.randint(
            0, cfg.vocab_size, (4, 2048), generator=tg, device="cuda"),
            cfg)[:, -1]
        equal = (last.device == direct.device and last.shape == direct.shape
                 and torch.equal(last.view(torch.int16),
                                 direct.view(torch.int16)))
        phase("cluster", f"@remote(num_gpus=1) on worker pid {pid} (not "
              f"{os.getpid()}): llama_440m flash forward B=4 S=2048 bf16, "
              f"last-position logits {tuple(last.shape)} back on "
              f"{last.device}, bit-equal to this process's direct call: "
              f"{equal}; launches in the task {task_launches}")
        if pid == os.getpid() or pid not in {p.pid for p in procs}:
            fail("the GPU task did not run in a worker node process")
        if not equal:
            fail("the worker's logits differ from this process's direct "
                 "call")
        if task_launches != {"flash_fwd": cfg.n_layers}:
            fail(f"the worker's forward launched {task_launches}")
        del last, direct, params
        torch.cuda.empty_cache()

        # b. A CUDA tensor made on a worker, got by this process.
        @rt.remote(num_gpus=0.5, resources={"node1": 1})
        def make_big(seed):
            import torch as _torch

            g = _torch.Generator(device="cuda")
            g.manual_seed(seed)
            return _torch.randn(PUT_BYTES // 2, generator=g, device="cuda",
                                dtype=_torch.bfloat16)

        get_ms, ok = [], True
        for i in range(CLUSTER_PUT_REPS):
            ref = make_big.remote(100 + i)
            rt.wait([ref], timeout=120, fetch_local=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = rt.get(ref, timeout=120)
            torch.cuda.synchronize()
            get_ms.append((time.perf_counter() - t0) * 1e3)
            g = torch.Generator(device="cuda")
            g.manual_seed(100 + i)
            want = torch.randn(PUT_BYTES // 2, generator=g, device="cuda",
                               dtype=torch.bfloat16)
            ok = ok and (x.device == torch.device("cuda", 0)
                         and torch.equal(x.view(torch.int16),
                                         want.view(torch.int16)))
            del x, want, ref
        link_ms = 2 * PUT_BYTES / PEAK_PCIE_BYTES_S * 1e3
        phase("cluster", f"get of a {PUT_BYTES >> 20} MiB bf16 CUDA tensor "
              f"made on a worker ({CLUSTER_PUT_REPS} objects): median "
              f"{statistics.median(get_ms):.1f} ms (min {min(get_ms):.1f}); "
              f"bound of its card-to-host and host-to-card copies "
              f"{link_ms:.3f} ms at {PEAK_PCIE_BYTES_S / 1e9:.0f} GB/s each; "
              f"same bytes on cuda:0: {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail("a CUDA tensor from a worker came back changed or off "
                 "the card")
        torch.cuda.empty_cache()

        # b2. A handoff of 13 bf16 blocks over the object plane, from
        # one worker node to the other (the dcn transport).
        shape = (13, cfg.n_layers, 16, cfg.n_kv_heads, cfg.head_dim)

        @rt.remote(resources={"node0": 1})
        class DcnSender:
            """Holds each handoff until its receive is done, as a
            prefill replica does (a ref put in a finished task and
            returned nested in its result can be freed before the
            borrower pulls it: ROADMAP C7)."""

            def __init__(self):
                self.held = {}

            def send(self, i):
                import torch as _torch

                from ray_tpu_torch.serve.kv_transfer import KVSender as _S

                g = _torch.Generator().manual_seed(i)
                kb = _torch.randn(shape, generator=g).to(_torch.bfloat16)
                t0 = time.perf_counter()
                h = _S().send({"node": None, "ring": ""}, f"dcn{i}", kb,
                              kb, list(range(shape[0])))
                self.held[i] = h
                return h, (time.perf_counter() - t0) * 1e3

            def drop(self, i):
                self.held.pop(i, None)

        @rt.remote(resources={"node1": 1})
        def dcn_recv(h, i):
            import torch as _torch

            from ray_tpu_torch.serve.kv_transfer import KVReceiver as _Recv

            t0 = time.perf_counter()
            k, v = _Recv().recv(h)
            ms = (time.perf_counter() - t0) * 1e3
            g = _torch.Generator().manual_seed(i)
            want = _torch.randn(shape, generator=g).to(_torch.bfloat16)
            return ms, bool(_torch.equal(k, want) and _torch.equal(v, want))

        dcn = DcnSender.remote()
        send_ms, recv_ms, ok = [], [], True
        for i in range(8):
            h, ms = rt.get(dcn.send.remote(i), timeout=120)
            r_ms, same = rt.get(dcn_recv.remote(h, i), timeout=120)
            rt.get(dcn.drop.remote(i), timeout=60)
            ok = ok and same and h["transport"] == "dcn"
            if i >= 2:
                send_ms.append(ms)
                recv_ms.append(r_ms)
        phase("cluster", f"bf16 handoff of 13 blocks over the object plane "
              f"(node0 -> node1): send (put) median "
              f"{statistics.median(send_ms):.3f} ms, receive (pull) median "
              f"{statistics.median(recv_ms):.3f} ms (min {min(recv_ms):.3f});"
              f" same bytes: {'ok' if ok else 'MISMATCH'}")
        rt.kill(dcn)
        if not ok:
            fail("the dcn handoff changed the blocks")

        # c. A replica on a worker node: f32 tokens, then bf16 numbers in
        # turns with a replica in this process.
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
        torch.cuda.empty_cache()
        handle = serve.run(serve.deployment(
            F32Server, name="remote_f32",
            ray_actor_options={"num_gpus": 0.5,
                               "resources": {"node0": 1}}).bind(**engine))
        outs, _ = handle_round(handle, prompts, 32)
        remote_tokens = [o["tokens"] for o in outs]
        phase("cluster", f"llama_440m f32 replica on a worker node, 8 "
              f"requests x 32 tokens: tokens == a direct engine's: "
              f"{remote_tokens == direct_tokens}")
        if remote_tokens != direct_tokens:
            fail(f"the worker replica's f32 tokens differ (first at "
                 f"{first_diff(remote_tokens, direct_tokens)})")
        serve.delete("remote_f32")
        engine = dict(model_preset="llama_440m", max_slots=8, max_len=512,
                      seed=0)
        handles = {
            where: serve.run(serve.deployment(
                LLMServer, name=name, ray_actor_options={
                    "num_gpus": 0.5, "resources": {res: 1}}).bind(**engine))
            for where, name, res in (("this process", "local", "here"),
                                     ("worker node", "remote", "node0"))}
        rows = {where: [] for where in handles}
        for _ in range(SERVE_ROUNDS):
            for where, h in handles.items():
                rows[where].append(handle_round(h, prompts, 32))
        for where, rounds in rows.items():
            ttft = [o["ttft_ms"] for outs, _ in rounds for o in outs]
            rates = [serve_numbers(outs, wall)[2] for outs, wall in rounds]
            hop = []
            for _ in range(HOP_CALLS):
                t0 = time.perf_counter()
                handles[where].check_health.remote().result(timeout=60)
                hop.append((time.perf_counter() - t0) * 1e3)
            phase("cluster", f"llama_440m bf16 replica in {where}, "
                  f"{SERVE_ROUNDS} rounds of 8 x 32 tokens: TTFT min "
                  f"{min(ttft):.1f} ms p50 {percentile(ttft, 0.5):.1f} ms "
                  f"p99 {percentile(ttft, 0.99):.1f} ms, decode tok/s "
                  + " ".join(f"{r:.1f}" for r in rates)
                  + f"; hop (check_health, {HOP_CALLS} calls) median "
                  f"{statistics.median(hop):.3f} ms p99 "
                  f"{percentile(hop, 0.99):.3f} ms")
        serve.delete("local")
        serve.delete("remote")

        # d. Prefill and decode replicas on the two worker nodes.
        engine = dict(model_preset="llama_440m_f32", max_slots=8,
                      max_len=512, seed=0, paged=True, block_size=16)
        server = LLMServer(**engine)
        try:
            outs, _ = run_requests(server, prompts, 32)
        finally:
            server.shutdown()
        paged_tokens = [o["tokens"] for o in outs]
        del server
        gc.collect()
        torch.cuda.empty_cache()
        handle = serve.run(serve.deployment(
            F32Server, name="disagg_nodes",
            ray_actor_options={"num_gpus": DISAGG_GPU_SHARE},
            replica_roles={
                "prefill": {"num": 1, "ray_actor_options": {
                    "resources": {"node0": 1}}},
                "decode": {"num": 1, "ray_actor_options": {
                    "resources": {"node1": 1}}}}).bind(**engine))
        def node_counts():
            # The decode node's process counters (b2's receives ran
            # there too, so read the round's difference).
            return handoff_counts(handle.options(
                role="decode").kv_stats.remote().result(timeout=60))

        c0 = node_counts()
        outs, wall = handle_round(handle, prompts, 32)
        d = delta(node_counts(), c0)
        got = [o["tokens"] for o in outs]
        counts = {t: d[(t, "total")] for t in ("shm", "dcn")}
        nbytes = {t: d[(t, "bytes")] for t in ("shm", "dcn")}
        ttft = [o["ttft_ms"] for o in outs]
        phase("cluster", f"llama_440m f32 prefill replica on node0, decode "
              f"replica on node1, 8 requests x 32 tokens in {wall:.3f}s "
              f"(TTFT min {min(ttft):.1f} ms p50 "
              f"{percentile(ttft, 0.5):.1f} ms): tokens == the paged "
              f"engine's: {got == paged_tokens}; handoffs at the decode "
              f"replica {counts}, bytes {nbytes}")
        if got != paged_tokens:
            fail(f"cross-node disaggregated tokens differ (first at "
                 f"{first_diff(got, paged_tokens)})")
        f32_bytes = 2 * sum(-(-len(p) // 16) for p in prompts) \
            * block_bytes(cfg, 16, 4)
        if counts != {"shm": 0, "dcn": len(prompts)} \
                or nbytes["dcn"] != f32_bytes:
            fail(f"cross-node handoffs not all on dcn with their bytes: "
                 f"{counts} {nbytes} (expect {f32_bytes} B)")
        serve.delete("disagg_nodes")
    finally:
        serve.shutdown()
        rt.shutdown()
        c.shutdown()
    exited = [p.poll() is not None for p in procs]
    held_bytes(torch)
    torch.cuda.empty_cache()
    free1 = torch.cuda.mem_get_info()[0]
    phase("cluster", f"after shutdown(): worker processes exited "
          f"{sum(exited)} of {len(procs)}; free card memory "
          f"{free0 / 2**20:.1f} MiB before the phase, {free1 / 2**20:.1f} "
          f"MiB after (tol {TOL_CLUSTER_FREE_BYTES >> 20} MiB)")
    if not all(exited):
        fail("a worker node process outlived shutdown()")
    if free0 - free1 > TOL_CLUSTER_FREE_BYTES:
        fail(f"{(free0 - free1) / 2**20:.1f} MiB of the card not back "
             f"after the cluster's shutdown")
    phase("cluster", f"phase 19 took {time.perf_counter() - t_phase:.1f}s")
    return task_launches


# Phase 20: the compiled DAG of two llama_440m stages (B x S tokens a
# pass), its passes, rounds in turns with the one-piece forward, and the
# tolerance of the port's pipeline-stage tests (tests/test_torch_dag_
# llama.py, tests/test_torch_parallel.py): the stages run the same ops
# on the same weights as the one-piece forward.
DAG_B, DAG_S, DAG_PASSES, DAG_ROUNDS = 2, 1024, 16, 2
TOL_DAG_REL = 1e-5
# The client subprocess's script: a thin driver with CUDA hidden from it
# submits a num_gpus=1 task through the proxy (the function ships by
# value) and saves the last-position logits it gets back.
CLIENT_SCRIPT = '''
import json, os, sys, time
sys.path.insert(0, {here!r})
import torch
from ray_tpu_torch.util import client as rc


def forward_last(seed, B, S):
    import torch as _t
    from ray_tpu_torch.models import llama as _l

    cfg = _l.LlamaConfig.llama_440m(dtype=_t.bfloat16,
                                    attention_impl="flash")
    params = _l.init_params(cfg, seed=seed, dtype=_t.bfloat16)
    g = _t.Generator(device="cuda")
    g.manual_seed(7)
    tokens = _t.randint(0, cfg.vocab_size, (B, S), generator=g,
                        device="cuda")
    with _t.no_grad():
        logits = _l.forward(params, tokens, cfg)
    return logits[:, -1].clone()


ctx = rc.connect({address!r})
try:
    f = ctx.remote(forward_last).options(num_gpus=1)
    t0 = time.perf_counter()
    last = ctx.get(f.remote(0, 4, 2048), timeout=600)
    round_trip = time.perf_counter() - t0
finally:
    ctx.disconnect()
torch.save(last, {out!r})
print(json.dumps({{"round_trip_s": round_trip, "device": str(last.device),
                  "cuda_initialized": torch.cuda.is_initialized(),
                  "pid": os.getpid()}}))
'''


def dag_client_phase(fa, torch, llama, profile_dir=None):
    """20. The DAG API, Ray Client, isolated workers, the CLI and the
    dashboard's device trace, in cluster mode (a head in this process,
    this process its one node, the card advertised as ``GPU``).
    a. ``InputNode -> stage0.forward -> stage1.forward`` on two actors,
    each holding half of llama_440m's layers on the card
    (``models/llama_pipeline.py``), compiled with ``max_in_flight=4``:
    its stage edge planned onto a shm ring, the hidden states reaching
    stage 1 on the card in bf16, the last pass's logits equal to the
    one-piece ``forward`` on the same weights and tokens; pass latency
    p50/p99, tokens/s in turns with the one-piece forward, the edge's
    bytes per pass and its object-plane fallbacks; b. a thin client in a
    subprocess that sees no card submits a ``num_gpus=1`` task through
    ``ClientProxyServer`` that runs the llama_440m flash forward, and
    its last-position logits equal a direct call's; c. an
    ``isolate=True`` task while (a)'s actors hold the card makes no CUDA
    context, sees CUDA hidden, gets a CUDA argument on its CPU and hands
    its result back on this process's card; d. ``python -m
    ray_tpu_torch status`` lists the GPU, and ``profile --device``
    captures a torch.profiler trace of DAG passes that names
    ``flash_fwd``; then (a)'s ``teardown()`` frees the GPU its actors
    claim, b runs, and after ``shutdown()`` the card's memory is back.
    Returns the B1 launches of the DAG passes and the client's task."""
    import shutil
    import tempfile
    import threading
    import zipfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models import llama_pipeline as lp
    from ray_tpu_torch.observability import metrics as rt_metrics
    from ray_tpu_torch.util.client import ClientProxyServer

    t_phase = time.perf_counter()
    rt.shutdown()
    cfg = llama.LlamaConfig.llama_440m(dtype=torch.bfloat16,
                                       attention_impl="flash")
    _, mem0 = held_bytes(torch)
    launches = {}

    def count(run):
        fa.reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        for n, k in fa.launch_counts.items():
            if k:
                launches[n] = launches.get(n, 0) + k
        return out

    @rt.remote(num_gpus=0.5)
    class Stage:
        def __init__(self, stage):
            params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16)
            sl = lp.stage_slice(params, stage, 2)
            # Own copies of the stage's slice: the slices are views of
            # the whole model's stacked tensors.
            self.sl = {k: ({n: w.clone() for n, w in v.items()}
                           if isinstance(v, dict) else v.clone())
                       for k, v in sl.items()}
            del params, sl
            self.fwd = (lp.make_stage_fwd(cfg, first=True) if stage == 0
                        else lp.make_stage_logits(cfg))
            self.seen = None

        def forward(self, x):
            self.seen = (str(x.device), str(x.dtype), tuple(x.shape))
            with torch.no_grad():
                return self.fwd(self.sl, x)

        def last_input(self):
            return self.seen

    tmp = tempfile.mkdtemp(prefix="phase20_")
    c = Cluster()
    compiled = srv = status_proc = None
    try:
        t0 = time.perf_counter()
        runtime = c.connect(num_cpus=8)
        node_id = runtime.cluster.node_id
        total = rt.cluster_resources()
        phase("dag", f"head + this process as its node up in "
              f"{time.perf_counter() - t0:.1f}s; cluster_resources GPU "
              f"{total.get('GPU')}")
        if total.get("GPU") != 1:
            fail(f"the node advertises {total.get('GPU')} GPUs, not 1")

        # a. The compiled DAG.
        t0 = time.perf_counter()
        with InputNode() as inp:
            s0, s1 = Stage.bind(0), Stage.bind(1)
            dag = s1.forward.bind(s0.forward.bind(inp))
        compiled = dag.experimental_compile(max_in_flight=4)
        edges = dict(compiled._channel_edges)
        if list(edges) != [(0, 1)]:
            fail(f"the stage edge is not planned onto a shm ring: {edges}")
        ring = os.path.basename(edges[(0, 1)])
        tg = torch.Generator(device="cuda")
        tg.manual_seed(11)
        tokens = torch.randint(0, cfg.vocab_size, (DAG_B, DAG_S),
                               generator=tg, device="cuda")
        params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16)
        with torch.no_grad():
            ref = llama.forward(params, tokens, cfg)
        count(lambda: rt.get(compiled.execute(tokens), timeout=300))
        phase("dag", f"compiled on actors holding {cfg.n_layers // 2} "
              f"layers each "
              f"(ring {edges[(0, 1)]}), first pass in "
              f"{time.perf_counter() - t0:.1f}s")

        def dag_round():
            done = {}
            subs = []
            t_start = time.perf_counter()
            for i in range(DAG_PASSES):
                # execute() blocks while max_in_flight passes are in
                # flight; a pass's latency runs from its admission.
                r = compiled.execute(tokens)
                subs.append(time.perf_counter())
                r._on_completed(lambda _o, i=i: done.__setitem__(
                    i, time.perf_counter()))
                last = r
            out = rt.get(last, timeout=300)
            deadline = time.monotonic() + 60
            while len(done) < DAG_PASSES:
                if time.monotonic() > deadline:
                    fail(f"{DAG_PASSES - len(done)} DAG passes never "
                         f"completed")
                time.sleep(0.001)
            wall = max(done.values()) - t_start
            return out, [done[i] - subs[i] for i in range(DAG_PASSES)], wall

        def one_piece_round():
            t_start = time.perf_counter()
            with torch.no_grad():
                for _ in range(DAG_PASSES):
                    llama.forward(params, tokens, cfg)
            torch.cuda.synchronize()
            return time.perf_counter() - t_start

        lat, dag_tps, one_tps = [], [], []
        for _ in range(DAG_ROUNDS):
            out, lats, wall = count(dag_round)
            lat += lats
            dag_tps.append(DAG_PASSES * DAG_B * DAG_S / wall)
            one_tps.append(DAG_PASSES * DAG_B * DAG_S / one_piece_round())
        if profile_dir:
            profile_run(dag_round, "dag_round", profile_dir,
                        all_threads=True)
            profile_run(one_piece_round, "dag_one_piece", profile_dir)
        err = rel_err(out, ref)
        bitwise = torch.equal(out.view(torch.int16), ref.view(torch.int16))
        seen = rt.get(s1._handle.last_input.remote(), timeout=60)
        stats = rt_metrics.metrics_summary()
        frames = stats.get("ray_tpu_channel_frames_total", {}).get(
            f"{ring},write", 0)
        nbytes = stats.get("ray_tpu_channel_bytes_total", {}).get(
            f"{ring},write", 0)
        fallbacks = stats.get("ray_tpu_channel_fallback_total", {}).get(
            ring, 0)
        lat_ms = sorted(x * 1e3 for x in lat)
        phase("dag", f"llama_440m bf16 in 2 stages, {DAG_ROUNDS} rounds of "
              f"{DAG_PASSES} passes of B={DAG_B} S={DAG_S}: pass latency "
              f"p50 {percentile(lat_ms, 0.5):.2f} ms p99 "
              f"{percentile(lat_ms, 0.99):.2f} ms; tokens/s "
              + ", ".join(f"{a:.0f}" for a in dag_tps) + " (one-piece "
              "forward in turns: " + ", ".join(f"{a:.0f}" for a in one_tps)
              + f"); ring edge {nbytes / max(frames, 1):.0f} B a pass over "
              f"{frames:.0f} frames ({DAG_B * DAG_S * cfg.hidden_size * 2} "
              f"B of hidden states), object-plane fallbacks "
              f"{fallbacks:.0f}; stage 1 got its input on {seen[0]} as "
              f"{seen[1]} {seen[2]}; last pass against the one-piece forward: "
              f"rel err {err:.2e} (tol {TOL_DAG_REL:g}), bit-equal "
              f"{bitwise}; B1 launches {launches}")
        if not (err <= TOL_DAG_REL):
            fail(f"the DAG's logits differ from the one-piece forward: "
                 f"{err:.3e}")
        if seen != ("cuda:0", "torch.bfloat16",
                    (DAG_B, DAG_S, cfg.hidden_size)):
            fail(f"the hidden states crossed the ring as {seen}, not as "
                 f"bf16 on the card")
        if frames < DAG_ROUNDS * DAG_PASSES:
            fail(f"the stage edge moved {frames} ring frames for "
                 f"{DAG_ROUNDS * DAG_PASSES + 1} passes")
        want = (DAG_ROUNDS * DAG_PASSES + 1) * cfg.n_layers
        if launches != {"flash_fwd": want}:
            fail(f"the DAG passes launched {launches}, expected "
                 f"{{'flash_fwd': {want}}}")
        del out, ref

        # d (first half), started now to overlap the isolated task: the
        # CLI's status, from a process that sees no card.
        cli_env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        status_proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "status", "--address",
             c.head_address], env=cli_env, cwd=HERE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        # c. An isolated task while the stage actors hold the card.
        @rt.remote(isolate=True)
        def isolated_probe(t):
            import os as _os

            import torch as _t

            return {"cuda_initialized": _t.cuda.is_initialized(),
                    "cuda_visible": _os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "cuda_available": _t.cuda.is_available(),
                    "arg_device": str(t.device), "pid": _os.getpid(),
                    "out": t * 2}

        x = torch.arange(8, dtype=torch.bfloat16, device="cuda")
        t0 = time.perf_counter()
        got = rt.get(isolated_probe.remote(x), timeout=300)
        phase("isolate", f"isolate=True task in child pid {got['pid']} "
              f"in {time.perf_counter() - t0:.2f}s while the stage actors "
              f"hold the card: CUDA_VISIBLE_DEVICES={got['cuda_visible']!r}"
              f", cuda available {got['cuda_available']}, CUDA context "
              f"{got['cuda_initialized']}; a CUDA argument arrived on "
              f"{got['arg_device']}, its result came back on "
              f"{got['out'].device}")
        if got["cuda_initialized"] or got["cuda_available"] \
                or got["cuda_visible"] != "":
            fail("the isolated child sees the card")
        if got["arg_device"] != "cpu" or got["out"].device.type != "cuda" \
                or not torch.equal(got["out"], x * 2):
            fail("the isolated task's tensors are not where the reference "
                 "puts them (the child's CPU, then this process's card)")

        # d. The CLI: status lists the GPU; a device trace of DAG passes.
        st_out, st_err = status_proc.communicate(timeout=300)
        gpu_line = [ln.strip() for ln in st_out.splitlines()
                    if ln.strip().startswith("GPU:")]
        phase("cli", f"python -m ray_tpu_torch status: rc "
              f"{status_proc.returncode}, {gpu_line}")
        if status_proc.returncode != 0 or not gpu_line \
                or not re.fullmatch(r"GPU: [0-9.]+/1 available",
                                    gpu_line[0]):
            fail(f"status does not list the GPU: {st_out[-2000:]} "
                 f"{st_err[-2000:]}")
        stop = threading.Event()

        def drive():
            while not stop.is_set():
                rt.get(compiled.execute(tokens), timeout=300)

        passes = threading.Thread(target=drive, daemon=True)
        zip_path = os.path.join(tmp, "device_trace.zip")
        fa.reset_launch_counts()
        passes.start()
        try:
            pr = subprocess.run(
                [sys.executable, "-m", "ray_tpu_torch", "profile",
                 "--device", "--address", c.head_address, "--node",
                 node_id, "--duration", "2", "-o", zip_path],
                env=cli_env, cwd=HERE, capture_output=True, text=True,
                timeout=300)
        finally:
            stop.set()
            passes.join(timeout=300)
        torch.cuda.synchronize()
        traced_passes = fa.launch_counts.get("flash_fwd", 0)
        names = set()
        if pr.returncode == 0 and os.path.exists(zip_path):
            with zipfile.ZipFile(zip_path) as z:
                for member in z.namelist():
                    if member.endswith(".json"):
                        doc = json.loads(z.read(member))
                        events = doc.get("traceEvents", doc) \
                            if isinstance(doc, dict) else doc
                        for ev in events:
                            if isinstance(ev, dict) \
                                    and ev.get("cat") == "kernel":
                                names.add(ev.get("name", ""))
        launches["flash_fwd"] += traced_passes
        flash = sorted(n for n in names if "flash_fwd" in n)
        phase("cli", f"python -m ray_tpu_torch profile --device: rc "
              f"{pr.returncode}, {os.path.getsize(zip_path) if os.path.exists(zip_path) else 0} B "
              f"zip, {len(names)} kernel names, {traced_passes} B1 launches "
              f"while tracing; flash kernels seen: "
              f"{[n[:60] for n in flash][:3]}")
        if pr.returncode != 0 or not flash:
            fail(f"the device trace names no flash_fwd kernel: "
                 f"{pr.stdout[-1000:]} {pr.stderr[-2000:]}")
        del x, got, tokens
        # The stage actors go (and with them their half-GPU claims, so
        # that the client's num_gpus=1 task fits).
        compiled.teardown()
        compiled = None

        # b. A thin client in a subprocess that sees no card.
        srv = ClientProxyServer(port=0)
        out_path = os.path.join(tmp, "client_logits.pt")
        script = CLIENT_SCRIPT.format(here=HERE, address=srv.address,
                                      out=out_path)
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}

        def run_client():
            return subprocess.run([sys.executable, "-c", script], env=env,
                                  cwd=HERE, capture_output=True, text=True,
                                  timeout=600)

        t0 = time.perf_counter()
        proc = count(run_client)
        if proc.returncode != 0:
            fail(f"the client subprocess failed: {proc.stderr[-2000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        last = torch.load(out_path)
        g = torch.Generator(device="cuda")
        g.manual_seed(7)
        ctoks = torch.randint(0, cfg.vocab_size, (4, 2048), generator=g,
                              device="cuda")
        with torch.no_grad():
            direct = llama.forward(params, ctoks, cfg)[:, -1].float().cpu()
        cerr = rel_err(last.float(), direct)
        phase("client", f"thin client pid {report['pid']} (CUDA hidden, "
              f"CUDA context {report['cuda_initialized']}): num_gpus=1 "
              f"llama_440m flash forward B=4 S=2048 through the proxy, "
              f"round trip {report['round_trip_s'] * 1e3:.1f} ms "
              f"(subprocess {time.perf_counter() - t0:.1f}s), last-position "
              f"logits {tuple(last.shape)} on {report['device']} against "
              f"the direct call: rel err {cerr:.2e} (tol {TOL_DAG_REL:g})")
        if report["cuda_initialized"] or report["device"] != "cpu":
            fail("the thin client touched CUDA")
        if not (cerr <= TOL_DAG_REL):
            fail(f"the client's logits differ from a direct call: "
                 f"{cerr:.3e}")
        del direct, ctoks

        del params, last
    finally:
        if status_proc is not None and status_proc.poll() is None:
            status_proc.kill()
            status_proc.wait(timeout=60)
        if srv is not None:
            srv.shutdown()
        if compiled is not None:
            compiled.teardown()
        rt.shutdown()
        c.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    with_ws, mem1 = held_bytes(torch)
    phase("dag", f"after teardown() and shutdown(): memory_allocated "
          f"{mem0 / 2**20:.1f} MiB before the phase, {mem1 / 2**20:.1f} "
          f"MiB after (tol {TOL_SERVE_LEAK_BYTES >> 20} MiB; "
          f"{with_ws / 2**20:.1f} MiB with cuBLAS workspaces)")
    if mem1 - mem0 > TOL_SERVE_LEAK_BYTES:
        fail(f"{(mem1 - mem0) / 2**20:.1f} MiB still held after the "
             f"compiled DAG's teardown")
    phase("dag", f"phase 20 took {time.perf_counter() - t_phase:.1f}s")
    return launches


# Phase 21: the train runtime.  104 rows of 2048 tokens (13 batches of
# 8) in 4 blocks; the step that saves the full state and the step whose
# start raises once in run F; the warm-up steps left out of the step
# times; F's losses after the restart against U's (and the bare step's
# against the trainer's), relative: the same state, batches, kernels
# and order give the same bits.
TRAINER_STEPS, TRAINER_SAVE_AT, TRAINER_CRASH_AT = 13, 5, 8
TRAINER_BLOCKS, TRAINER_WARM = 4, 3
TOL_RESUME_LOSS_REL = 1e-5


class _Stash:
    """Phase 21's holder of the params as the loop saved them, read back
    by the restarted loop (an actor: both attempts reach it by name)."""

    def __init__(self):
        self.params = None

    def put(self, params):
        self.params = params
        return True

    def get(self):
        return self.params


def trainer_loop(config):
    """Phase 21's ``train_loop_per_worker``: llama_440m (fused AdamW,
    bf16 compute, flash attention) on the worker's device, from its shard
    of the Dataset, one ``.item()`` a step, every step reported with the
    losses and step times so far.  With ``save_at`` it saves the full
    state there through ``report(checkpoint=...)`` and stashes the
    params; with ``crash_at`` it raises once at that step's start (armed
    by a flag file); restarted, it loads the latest checkpoint onto its
    device, checks the params against the stash and skips the batches
    the state has consumed.  With ``profile_dir`` its third step runs
    under the profiler."""
    import os
    import tempfile
    import time

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.optim import tree_leaves, tree_map

    device = train.get_context().device
    cfg = llama.LlamaConfig.llama_440m()
    ckpt = train.get_checkpoint()
    info = {}
    if ckpt is None:
        state = llama.init_train_state(cfg, seed=0, fused=True,
                                       device=device)
    else:
        t0 = time.perf_counter()
        state = ckpt.load_state(device=device)
        torch.cuda.synchronize()
        info["load_s"] = time.perf_counter() - t0
        saved = rt.get(rt.get_actor(config["stash"]).get.remote())
        info["params_equal"] = all(
            torch.equal(a, b) for a, b in zip(tree_leaves(state["params"]),
                                              tree_leaves(saved)))
        info["restored_device"] = str(state["params"]["embed_tokens"]
                                      .device)
        del saved
    start = int(state["step"].item())
    step = llama.make_train_step(cfg, fused=True, device=device)
    batches = iter(train.get_dataset_shard("train").iter_batches(
        batch_size=config["B"], device_put=True))
    for _ in range(start):  # the batches the saved state has consumed
        next(batches)
    losses, step_ms = [], []

    def one_step():
        nonlocal state
        state, m = step(state, next(batches))
        losses.append(m["loss"].item())

    t_prev = time.perf_counter()
    for n in range(start + 1, config["steps"] + 1):
        if n == config.get("crash_at") and os.path.exists(
                config["crash_flag"]):
            os.unlink(config["crash_flag"])
            raise RuntimeError(f"injected worker failure at step {n}")
        if n == 3 and config.get("profile_dir"):
            profile_run(one_step, "trainer_step", config["profile_dir"],
                        all_threads=True)
        else:
            one_step()
        out = None
        if n == config.get("save_at"):
            t0 = time.perf_counter()
            out = train.Checkpoint(tempfile.mkdtemp(prefix="state_",
                                                    dir=config["tmp"]))
            out.save_state(state)
            info["save_s"] = time.perf_counter() - t0
            info["state_bytes"] = sum(
                t.numel() * t.element_size() for t in tree_leaves(state))
            # A copy: an in-process actor call passes its arguments by
            # reference, as the reference's does, and the next steps
            # update the params in place.
            rt.get(rt.get_actor(config["stash"]).put.remote(
                tree_map(torch.clone, state["params"])))
        train.report({"step": n, "first_step": start + 1,
                      "losses": list(losses), "step_ms": list(step_ms),
                      **info}, checkpoint=out)
        now = time.perf_counter()
        step_ms.append((now - t_prev) * 1e3)
        t_prev = now
    # The last step's time, which its own report could not carry.
    train.report({"step": config["steps"], "first_step": start + 1,
                  "losses": list(losses), "step_ms": list(step_ms), **info})


def trainer_phase(fa, torch, llama, profile_dir=None):
    """21. The train runtime on the card, in a fresh runtime shut down at
    the end: llama_440m trained through ``TorchTrainer.fit()`` (one
    worker on the card) from a ``Dataset`` of 104 token rows in 4
    blocks, B=8 x S=2048, 13 steps.  Run U uninterrupted: falling
    losses, step ms and tok/s over steps 4-13, 24 launches of each
    flash kernel a step.  In turns with it (U, bare, bare, U), the same
    13 batches through ``make_train_step`` in this process with no
    runtime: the same losses, and the ratio of the step times.  Run F:
    the full state saved at step 5 (its save and drain times against its
    bytes), a failure at step 8, ``FailureConfig(max_failures=1)``
    restarts the gang from the checkpoint: the restored params equal the
    saved ones, F's losses at steps 6-13 equal U's, the last step is 13.
    The card's memory back after ``fit()`` and after ``shutdown()``; the
    checkpoint directories removed.  Returns U's launches."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig,
                                     RunConfig, ScalingConfig,
                                     TorchTrainer)
    from ray_tpu_torch.train import checkpoint as ckmod

    t_phase = time.perf_counter()
    _, mem0 = held_bytes(torch)
    B, S, n = TRAIN_B, TRAIN_S, TRAINER_STEPS
    cfg = llama.LlamaConfig.llama_440m()
    rows = np.random.default_rng(21).integers(
        0, cfg.vocab_size, (B * n, S), dtype=np.int32)
    tmp = tempfile.mkdtemp(prefix="phase21_")
    tok = B * (S - 1)

    def timed(ms):
        """p50 and min of the steps after the warm-up."""
        t = ms[TRAINER_WARM:]
        return statistics.median(t), min(t)

    def fit(name, **extra):
        res = TorchTrainer(
            trainer_loop,
            train_loop_config={"B": B, "steps": n, "tmp": tmp,
                               "stash": "phase21-stash", **extra},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(
                name=name, storage_path=os.path.join(tmp, name),
                checkpoint_config=CheckpointConfig(num_to_keep=2),
                failure_config=FailureConfig(max_failures=1)),
            datasets={"train": ds}).fit()
        if res.error is not None or res.metrics.get("step") != n:
            fail(f"phase 21 run {name}: error {res.error!r}, last step "
                 f"{res.metrics.get('step')}")
        return res

    def bare():
        state = llama.init_train_state(cfg, seed=0, fused=True)
        step = llama.make_train_step(cfg, fused=True)
        batches = [{"tokens": torch.from_numpy(rows[i * B:(i + 1) * B])
                    .cuda()} for i in range(n)]
        torch.cuda.synchronize()
        losses, ms = [], []
        t_prev = time.perf_counter()
        for batch in batches:
            state, m = step(state, batch)
            losses.append(m["loss"].item())
            now = time.perf_counter()
            ms.append((now - t_prev) * 1e3)
            t_prev = now
        del state, step, batches
        gc.collect()
        torch.cuda.empty_cache()
        return losses, ms

    rt.shutdown()
    rt.init()
    try:
        ds = rdata.from_numpy({"tokens": rows}).repartition(TRAINER_BLOCKS)
        stash = rt.remote(_Stash).options(name="phase21-stash").remote()
        rt.get(stash.get.remote())

        # U and the bare step in turns: U, bare, bare, U.
        runs = {"U": [], "bare": []}
        u_launches = None
        for kind in ("U", "bare", "bare", "U"):
            if kind == "bare":
                runs["bare"].append(bare())
                continue
            first = u_launches is None
            fa.reset_launch_counts()
            res = fit(f"U{len(runs['U'])}",
                      profile_dir=profile_dir if first else None)
            counts = launched(fa)
            if first:
                u_launches = counts
            runs["U"].append((res.metrics["losses"], res.metrics["step_ms"]))
            del res
            _, mem = held_bytes(torch)
            if mem - mem0 > TOL_SERVE_LEAK_BYTES:
                fail(f"{(mem - mem0) / 2**20:.1f} MiB still held after "
                     f"fit() returned")
        want = {k: n * cfg.n_layers for k in ("flash_fwd", "flash_bwd_dq",
                                              "flash_bwd_dkdv")}
        if u_launches != want:
            fail(f"run U launched {u_launches}, expected {want} ("
                 f"{cfg.n_layers} of each flash kernel a step)")
        u_losses = runs["U"][0][0]
        phase("trainer", f"llama_440m through TorchTrainer.fit(), 1 worker "
              f"on {torch.cuda.get_device_name(0)}, B={B} S={S}, "
              f"{n} steps from a Dataset of {TRAINER_BLOCKS} blocks: "
              f"losses " + " ".join(f"{x:.4f}" for x in u_losses)
              + f"; launches per step "
              + ", ".join(f"{k} {v // n}" for k, v in u_launches.items()))
        if not (all(math.isfinite(x) for x in u_losses)
                and u_losses[-1] < u_losses[0]):
            fail(f"phase 21 losses not finite and falling: {u_losses}")
        worst = 0.0
        for losses, _ in runs["U"][1:] + runs["bare"]:
            worst = max(worst, max(abs(a / b - 1)
                                   for a, b in zip(losses, u_losses)))
        phase("trainer", f"every U and bare run's losses against the first "
              f"U's: largest relative difference {worst:.3e} (tol "
              f"{TOL_RESUME_LOSS_REL})")
        if worst > TOL_RESUME_LOSS_REL:
            fail("the trainer and the bare step disagree on the losses")
        for r, ((_, u_ms), (_, b_ms)) in enumerate(zip(
                (runs["U"][0], runs["U"][1]),
                (runs["bare"][0], runs["bare"][1]))):
            up50, umin = timed(u_ms)
            bp50, bmin = timed(b_ms)
            phase("trainer", f"round {r + 1}, steps {TRAINER_WARM + 1}-{n}: "
                  f"TorchTrainer p50 {up50:.2f} ms (min {umin:.2f}), "
                  f"{tok / up50 * 1e3:.0f} tok/s; bare make_train_step "
                  f"p50 {bp50:.2f} ms (min {bmin:.2f}), "
                  f"{tok / bp50 * 1e3:.0f} tok/s; trainer/bare p50 "
                  f"{up50 / bp50:.4f}")

        # Run F: save at step 5, fail at step 8, resume from step 5.
        free = shutil.disk_usage(tmp).free
        phase("trainer", f"free disk under {tmp}: {free / 1e9:.1f} GB")
        flag = os.path.join(tmp, "crash_once")
        with open(flag, "w") as f:
            f.write("armed")
        drains = []
        register = ckmod.CheckpointManager.register

        def timed_register(self, *args, **kw):
            t0 = time.perf_counter()
            out = register(self, *args, **kw)
            drains.append(time.perf_counter() - t0)
            return out

        ckmod.CheckpointManager.register = timed_register
        try:
            res = fit("F", save_at=TRAINER_SAVE_AT,
                      crash_at=TRAINER_CRASH_AT, crash_flag=flag)
        finally:
            ckmod.CheckpointManager.register = register
        meta = res.checkpoint.get_metadata()["metrics"]
        m = res.metrics
        f_losses = m["losses"]
        if os.path.exists(flag) or m["first_step"] != TRAINER_SAVE_AT + 1:
            fail(f"run F did not fail and resume: flag left "
                 f"{os.path.exists(flag)}, resumed at step "
                 f"{m['first_step']}")
        nbytes = meta["state_bytes"]
        phase("trainer", f"run F: state at step {TRAINER_SAVE_AT} "
              f"({nbytes} B) saved in {meta['save_s']:.2f} s "
              f"({nbytes / meta['save_s'] / 1e9:.2f} GB/s, one copy to "
              f"the host per leaf + the write), drained into storage in "
              + " + ".join(f"{d:.2f}" for d in drains) + " s ("
              + ", ".join(f"{nbytes / d / 1e9:.2f}" for d in drains)
              + " GB/s); failed at step "
              f"{TRAINER_CRASH_AT}, restarted, loaded onto "
              f"{m['restored_device']} in {m['load_s']:.2f} s "
              f"({nbytes / m['load_s'] / 1e9:.2f} GB/s)")
        if not m["params_equal"] or not m["restored_device"].startswith(
                "cuda"):
            fail("the restored params differ from the saved ones (or are "
                 "not on the card)")
        diff = max(abs(a / b - 1) for a, b in
                   zip(f_losses, u_losses[TRAINER_SAVE_AT:]))
        phase("trainer", f"run F steps {TRAINER_SAVE_AT + 1}-{n} losses "
              + " ".join(f"{x:.4f}" for x in f_losses)
              + f"; against U's: largest relative difference {diff:.3e} "
              f"(tol {TOL_RESUME_LOSS_REL}); params restored equal to "
              f"saved (torch.equal, leaf by leaf): {m['params_equal']}; "
              f"last step {m['step']}")
        if len(f_losses) != n - TRAINER_SAVE_AT or \
                diff > TOL_RESUME_LOSS_REL:
            fail("run F's losses after the restart differ from run U's")
        del res, m, meta
        rt.kill(stash)
        del stash, ds
        _, mem = held_bytes(torch)
        if mem - mem0 > TOL_SERVE_LEAK_BYTES:
            fail(f"{(mem - mem0) / 2**20:.1f} MiB still held after the "
                 f"restarted fit() returned")
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    with_ws, mem1 = held_bytes(torch)
    phase("trainer", f"after shutdown(): memory_allocated "
          f"{mem0 / 2**20:.1f} MiB before the phase, {mem1 / 2**20:.1f} "
          f"MiB after (tol {TOL_SERVE_LEAK_BYTES >> 20} MiB; "
          f"{with_ws / 2**20:.1f} MiB with cuBLAS workspaces); checkpoint "
          f"directories removed: {not os.path.exists(tmp)}")
    if mem1 - mem0 > TOL_SERVE_LEAK_BYTES:
        fail(f"{(mem1 - mem0) / 2**20:.1f} MiB still held after the "
             f"phase's shutdown()")
    if os.path.exists(tmp):
        fail(f"the checkpoint directories under {tmp} were not removed")
    phase("trainer", f"phase 21 took {time.perf_counter() - t_phase:.1f}s")
    return u_launches


# Phase 22: the cross-process pipeline trainer.  llama_440m with an
# untied head (the pipeline refuses a tied one), 2 stages of 12 layers,
# B=8 x S=2048 in M=4 microbatches.  22a: f32, 3 steps against the
# one-piece optax-chain step at the reference test's rtol.  22b: bf16,
# in turns with the one-piece bf16 step (pipe, bare, bare, pipe), 2
# warm-up and 5 timed steps a turn.
PIPE_M, PIPE_F32_STEPS, PIPE_WARM, PIPE_TIMED = 4, 3, 2, 5
TOL_PIPE_F32_REL = 1e-4
PIPE_TRACE_S = 4.0


def pipe_launches_per_step(cfg, m):
    """The flash launches a pipeline step makes, from the code's
    schedule (``train/cross_pipeline.py``, 2 stages of L/2 layers, M
    microbatches): per microbatch and layer, the forward runs three times
    (stage 0's forward without autograd, the last stage's forward under
    autograd in ``fwd_bwd_last``, stage 0's recomputation in
    ``backward_first``) and the backward pair twice (once a stage).
    ``remat_policy="attn"`` keeps the flash residuals, so no backward
    re-runs the attention forward.  Returns (forward launches, launches
    of each backward kernel, the reckoning as text)."""
    per = cfg.n_layers // 2
    fwd, bwd = m * per * 3, m * per * 2
    return fwd, bwd, (f"fwd = M {m} x {per} layers x 3 (stage-0 forward, "
                      f"last-stage forward, stage-0 recomputation) = {fwd}; "
                      f"dq = dk/dv = M {m} x {per} layers x 2 stages = "
                      f"{bwd}")


def _pipe_batches(vocab, n, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (TRAIN_B, TRAIN_S), dtype=np.int32)
            for _ in range(n)]


def _one_piece(torch, llama, cfg, batches, fused=False):
    """The one-piece train step (the optax-chain counterpart) from
    ``init_train_state(seed=0)`` over ``batches``: losses and step ms."""
    import gc

    state = llama.init_train_state(cfg, seed=0, fused=fused)
    step = llama.make_train_step(cfg, fused=fused)
    losses, ms = [], []
    for b in batches:
        tokens = torch.from_numpy(b).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": tokens})
        losses.append(m["loss"].item())
        ms.append((time.perf_counter() - t0) * 1e3)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return losses, ms


def _trace_union(traces, t0, t1):
    """Busy share of the card in the wall window [t0, t1] (seconds of
    the epoch) over the kernels and copies of several processes'
    device traces: the union of their busy intervals."""
    import io
    import zipfile

    spans = []
    for data in traces:
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            doc = json.loads(zf.read("trace.json"))
        base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
        for e in doc.get("traceEvents", []):
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") \
                    and "ts" in e:
                a = base_us + float(e["ts"])
                spans.append((a, a + float(e.get("dur", 0))))
    lo, hi = t0 * 1e6, t1 * 1e6
    spans = sorted((max(a, lo), min(b, hi)) for a, b in spans
                   if b > lo and a < hi)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / (hi - lo), len(spans)


def pipeline_phase(fa, torch, llama, profile_dir=None):
    """22. ``CrossSlicePipeline`` at llama_440m's full width, untied head
    (468,239,360 params), 2 stages of 12 layers, B=8 x S=2048, M=4.
    a. f32: two stage actors in this process on the card (the simple
    family B1s/B2s/B3s); 3 steps whose losses equal the one-piece
    optax-chain step's from ``init_train_state`` with the same seed and
    batches (rtol 1e-4), with the launches of the schedule; the card's
    memory back after ``shutdown()``.  b. bf16: two worker node
    processes that see the card, labelled as two slices, the stages
    placed SLICE_SPREAD with ``resources_per_stage`` (a GPU each), both
    boundaries on shm rings with no object-plane fallback; 2 warm-up and
    5 timed steps in turns with the one-piece bf16 step (pipe, bare,
    bare, pipe): step p50, tok/s, the pipe/bare ratio, ring bytes a step
    against 2 x M x (2 x 2048 x 1024 x 2 B), the flash launches a step
    in the stage processes against the schedule's count, losses finite
    and falling; under ``--profile`` the card's busy share over one
    step, from both stage processes' device traces; the card's free
    memory back after ``shutdown()``.  Returns ({"a": launches of
    22a's first step, "b": launches of one 22b step})."""
    import gc

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    from ray_tpu_torch.core.node import wait_for_nodes
    from ray_tpu_torch.core.tpu_topology import (SLICE_LABEL,
                                                 WORKER_INDEX_LABEL)
    from ray_tpu_torch.train.cross_pipeline import CrossSlicePipeline

    t_phase = time.perf_counter()
    out = {}
    rt.shutdown()

    # a. f32 in this process.
    cfg = llama.LlamaConfig.llama_440m(tie_embeddings=False,
                                       dtype=torch.float32)
    n_params = llama.param_count(llama.param_shapes(cfg))
    batches = _pipe_batches(cfg.vocab_size, PIPE_F32_STEPS, 22)
    _, mem0 = held_bytes(torch)
    want_fwd, want_bwd, reckoning = pipe_launches_per_step(cfg, PIPE_M)
    rt.init()
    try:
        t0 = time.perf_counter()
        pipe = CrossSlicePipeline(cfg, n_stages=2,
                                  num_microbatches=PIPE_M, seed=0)
        build_s = time.perf_counter() - t0
        got, per_step, ms = [], [], []
        try:
            for b in batches:
                fa.reset_launch_counts()
                t0 = time.perf_counter()
                got.append(pipe.train_step(b)["loss"])
                ms.append((time.perf_counter() - t0) * 1e3)
                per_step.append(launched(fa))
            rings = (all(pipe._fwd_ch), all(pipe._bwd_ch))
        finally:
            pipe.shutdown()
            del pipe
    finally:
        rt.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    _, mem1 = held_bytes(torch)
    ref, ref_ms = _one_piece(torch, llama, cfg, batches)
    diff = max(abs(a / b - 1) for a, b in zip(got, ref))
    want = {"flash_fwd_simple": want_fwd, "flash_bwd_dq_simple": want_bwd,
            "flash_bwd_dkdv_simple": want_bwd}
    phase("pipe", f"22a llama_440m untied ({n_params} params) f32, 2 "
          f"in-process stages on the card (built in {build_s:.1f} s), "
          f"B={TRAIN_B} S={TRAIN_S} M={PIPE_M}, rings fwd/bwd {rings}: "
          f"losses " + " ".join(f"{x:.6f}" for x in got) + "; one-piece "
          "optax-chain step " + " ".join(f"{x:.6f}" for x in ref)
          + f"; largest relative difference {diff:.2e} (tol "
          f"{TOL_PIPE_F32_REL:g}); step ms " + " ".join(f"{x:.0f}"
                                                       for x in ms)
          + " (one-piece " + " ".join(f"{x:.0f}" for x in ref_ms)
          + f"); launches a step {per_step[0]} ({reckoning})")
    if diff > TOL_PIPE_F32_REL or not all(math.isfinite(x) for x in got):
        fail("the f32 pipeline's losses differ from the one-piece step's")
    if any(p != want for p in per_step):
        fail(f"22a launched {per_step}, expected {want} a step")
    if mem1 - mem0 > TOL_SERVE_LEAK_BYTES:
        fail(f"{(mem1 - mem0) / 2**20:.1f} MiB still held after the f32 "
             f"pipeline's shutdown()")
    out["a"] = per_step[0]

    # b. bf16 across two worker node processes.
    cfg = llama.LlamaConfig.llama_440m(tie_embeddings=False)
    n_warm = PIPE_WARM + PIPE_TIMED
    batches = _pipe_batches(cfg.vocab_size, n_warm, 23)
    tok = TRAIN_B * (TRAIN_S - 1)
    want_fwd, want_bwd, reckoning = pipe_launches_per_step(cfg, PIPE_M)
    ring_want = 2 * PIPE_M * (TRAIN_B // PIPE_M * TRAIN_S
                              * cfg.hidden_size * 2)
    held_bytes(torch)
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    c = Cluster()
    procs = []
    runs = {"pipe": [], "bare": []}
    try:
        t0 = time.perf_counter()
        procs = [c.add_node(num_cpus=4,
                            resources={"stage_slot": 1, f"pnode{i}": 4},
                            labels={SLICE_LABEL: f"slice{i}",
                                    WORKER_INDEX_LABEL: "0"},
                            name=f"stage{i}", wait=False)
                 for i in range(2)]
        c.connect(num_cpus=2)
        wait_for_nodes(c.head_address, 3, timeout=120)
        deadline = time.monotonic() + 60
        while rt.cluster_resources().get("stage_slot") != 2 \
                and time.monotonic() < deadline:
            time.sleep(0.2)

        @rt.remote(num_cpus=0)
        def probe(reset):
            import os

            from ray_tpu_torch.observability import metrics as _metrics
            from ray_tpu_torch.ops import flash_attention as _fa

            counts = {n: k for n, k in _fa.launch_counts.items() if k}
            if reset:
                _fa.reset_launch_counts()
            summ = _metrics.metrics_summary()
            ring = {name: sum(v for k, v in summ.get(name, {}).items()
                              if "pp-" in str(k) and (
                                  name.endswith("fallback_total")
                                  or str(k).endswith("write")))
                    for name in ("ray_tpu_channel_bytes_total",
                                 "ray_tpu_channel_frames_total",
                                 "ray_tpu_channel_fallback_total")}
            return os.getpid(), counts, ring

        @rt.remote(num_cpus=0)
        def trace(seconds):
            from ray_tpu_torch.observability.device import \
                capture_device_trace

            return capture_device_trace(seconds)["data"]

        def on_nodes(fn, *args):
            return rt.get([fn.options(resources={f"pnode{i}": 1}).remote(
                *args) for i in range(2)], timeout=300)

        pipe = CrossSlicePipeline(
            cfg, n_stages=2, num_microbatches=PIPE_M, seed=0,
            resources_per_stage={"CPU": 1, "GPU": 1, "stage_slot": 1},
            placement_strategy="SLICE_SPREAD")
        up_s = time.perf_counter() - t0
        nodes = pipe._pg._cluster_assignment["nodes"]
        rings = (all(pipe._fwd_ch), all(pipe._bwd_ch))
        pids = [p[0] for p in on_nodes(probe, True)]
        phase("pipe", f"22b head + 2 worker node processes (pids {pids}, "
              f"slices slice0/slice1) + this process up and the bf16 "
              f"stages built in {up_s:.1f} s; stages on distinct nodes "
              f"{len(set(nodes)) == 2}; boundaries on shm rings fwd/bwd "
              f"{rings}")
        if len(set(nodes)) != 2 or not all(rings) or \
                any(pid not in {p.pid for p in procs} for pid in pids):
            fail("22b's stages are not one per worker node with both "
                 "boundaries on shm rings")
        launches = None
        try:
            for kind in ("pipe", "bare", "bare", "pipe"):
                if kind == "bare":
                    runs["bare"].append(_one_piece(torch, llama, cfg,
                                                   batches))
                    continue
                losses, ms = [], []
                for i, b in enumerate(batches):
                    if i == PIPE_WARM and launches is None:
                        before = on_nodes(probe, True)
                    t0 = time.perf_counter()
                    losses.append(pipe.train_step(b)["loss"])
                    ms.append((time.perf_counter() - t0) * 1e3)
                    if i == PIPE_WARM and launches is None:
                        after = on_nodes(probe, False)
                        launches = {}
                        for _, counts, _ in after:
                            for k, v in counts.items():
                                launches[k] = launches.get(k, 0) + v
                        ring = {k: sum(a[2][k] - b_[2][k] for a, b_ in
                                       zip(after, before))
                                for k in after[0][2]}
                runs["pipe"].append((losses, ms))
            if profile_dir:
                traces = [trace.options(resources={f"pnode{i}": 1}).remote(
                    PIPE_TRACE_S) for i in range(2)]
                time.sleep(1.0)
                t0 = time.time()
                pipe.train_step(batches[0])
                t1 = time.time()
                busy, n_spans = _trace_union(
                    rt.get(traces, timeout=120), t0, t1)
                phase("profile", f"pipe_step: wall {(t1 - t0) * 1e3:.1f} "
                      f"ms, the card busy {100 * busy:.1f}% of it (union "
                      f"of {n_spans} kernels and copies of both stage "
                      f"processes' device traces)")
        finally:
            pipe.shutdown()
            del pipe
        want = {"flash_fwd": want_fwd, "flash_bwd_dq": want_bwd,
                "flash_bwd_dkdv": want_bwd}
        for r, ((pl, pms), (bl, bms)) in enumerate(zip(runs["pipe"],
                                                       runs["bare"])):
            p50 = statistics.median(pms[PIPE_WARM:])
            b50 = statistics.median(bms[PIPE_WARM:])
            phase("pipe", f"22b round {r + 1}, steps {PIPE_WARM + 1}-"
                  f"{n_warm}: pipeline p50 {p50:.1f} ms (min "
                  f"{min(pms[PIPE_WARM:]):.1f}), {tok / p50 * 1e3:.0f} "
                  f"tok/s; one-piece bf16 p50 {b50:.1f} ms (min "
                  f"{min(bms[PIPE_WARM:]):.1f}), {tok / b50 * 1e3:.0f} "
                  f"tok/s; pipe/bare p50 {p50 / b50:.3f}")
        losses = runs["pipe"][0][0] + runs["pipe"][1][0]
        bare = runs["bare"][0][0]
        drift = max(abs(a / b - 1) for a, b in zip(losses, bare))
        phase("pipe", "22b pipeline losses " + " ".join(
            f"{x:.4f}" for x in losses) + "; one-piece bf16 losses "
            + " ".join(f"{x:.4f}" for x in bare) + " (largest relative "
            f"difference over the first turn {drift:.2e})")
        phase("pipe", f"22b one step in the stage processes: flash "
              f"launches {launches} ({reckoning}); ring bytes written "
              f"{ring['ray_tpu_channel_bytes_total']:.0f} B in "
              f"{ring['ray_tpu_channel_frames_total']:.0f} frames against "
              f"{ring_want} B of activations and cotangents (2 x M x "
              f"{TRAIN_B // PIPE_M} x {TRAIN_S} x {cfg.hidden_size} x 2 "
              f"B), object-plane fallbacks "
              f"{ring['ray_tpu_channel_fallback_total']:.0f}")
        if launches != want:
            fail(f"22b launched {launches} a step, expected {want}")
        if ring["ray_tpu_channel_fallback_total"] or \
                ring["ray_tpu_channel_frames_total"] != 2 * PIPE_M or \
                ring["ray_tpu_channel_bytes_total"] < ring_want:
            fail(f"22b's boundaries did not carry the step on the rings: "
                 f"{ring}")
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            fail(f"22b losses not finite and falling: {losses}")
        out["b"] = launches
    finally:
        rt.shutdown()
        c.shutdown()
    exited = [p.poll() is not None for p in procs]
    gc.collect()
    held_bytes(torch)
    torch.cuda.empty_cache()
    free1 = torch.cuda.mem_get_info()[0]
    phase("pipe", f"after shutdown(): worker processes exited "
          f"{sum(exited)} of {len(procs)}; free card memory "
          f"{free0 / 2**20:.1f} MiB before 22b, {free1 / 2**20:.1f} MiB "
          f"after (tol {TOL_CLUSTER_FREE_BYTES >> 20} MiB)")
    if not all(exited):
        fail("a stage's worker node process outlived shutdown()")
    if free0 - free1 > TOL_CLUSTER_FREE_BYTES:
        fail(f"{(free0 - free1) / 2**20:.1f} MiB of the card not back "
             f"after the pipeline's shutdown")
    phase("pipe", f"phase 22 took {time.perf_counter() - t_phase:.1f}s")
    return out


# Phase 23: RLlib and Tune on the card, on chip_smoke's numpy CartPole.
# PPO at tests/test_rllib.py's settings (up to 40 iterations, best >=
# 130); IMPALA 5 async iterations and DQN 5 iterations at that file's
# settings; a 2-trial Tune run of PPO.as_trainable.
RL_PPO_ITERS, RL_PPO_BAR, RL_ITERS, RL_TUNE_ITERS = 40, 130.0, 5, 2


def rllib_phase(torch):
    """23. RLlib and Tune with their learners and env runners on the
    card (configs with ``device=None``), in a fresh runtime shut down at
    the end, on :class:`CartPole` passed as a creator to
    ``.environment(...)``: PPO at tests/test_rllib.py's settings reaches
    a best mean return >= 130 within 40 iterations, with the learner
    update's ms against the env-stepping ms per iteration; IMPALA 5 async
    iterations with finite losses; DQN 5 iterations; a 2-trial Tune run
    of ``PPO.as_trainable`` whose trials both finish; the phase's time."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.rllib import DQNConfig, IMPALAConfig, PPOConfig
    from ray_tpu_torch.rllib.env_runner import EnvRunner

    t_phase = time.perf_counter()
    rt.shutdown()
    rt.init()
    try:
        # The runners resolve their device as this one does.
        probe = EnvRunner(CartPole, 1, 8, 0.99, 0.95, 0)
        runner_dev = probe.device
        del probe

        algo = (PPOConfig()
                .environment(CartPole)
                .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                             rollout_fragment_length=128)
                .training(lr=1e-3, num_epochs=6, minibatch_size=256,
                          entropy_coeff=0.01, seed=0)
                .build())
        learner_dev = algo.params["pi"]["w"].device
        sample_s = []
        sample_all = algo.runners.sample_all

        def timed_sample_all(params):
            t0 = time.perf_counter()
            try:
                return sample_all(params)
            finally:
                sample_s.append(time.perf_counter() - t0)

        algo.runners.sample_all = timed_sample_all
        best, iter_s = 0.0, []
        try:
            for i in range(RL_PPO_ITERS):
                t0 = time.perf_counter()
                result = algo.train()
                iter_s.append(time.perf_counter() - t0)
                if np.isfinite(result["episode_return_mean"]):
                    best = max(best, result["episode_return_mean"])
                if best >= RL_PPO_BAR:
                    break
        finally:
            algo.stop()
        n = len(iter_s)
        env_ms = 1e3 * sum(sample_s) / n
        learn_ms = 1e3 * (sum(iter_s) - sum(sample_s)) / n
        phase("rllib", f"PPO on CartPole (learner on {learner_dev}, env "
              f"runners' policy on {runner_dev}): best mean return "
              f"{best:.1f} after {n} iterations (bar {RL_PPO_BAR:g}); per "
              f"iteration {1e3 * sum(iter_s) / n:.1f} ms: env stepping "
              f"(2 runners x 4 envs x 128 steps, the policy on the card "
              f"once a step) {env_ms:.1f} ms, learner update (6 epochs x "
              f"4 minibatches of 256) {learn_ms:.1f} ms; host-bound: the "
              f"card runs a 64-64 MLP on 4 to 256 rows at a time")
        if learner_dev.type != "cuda" or runner_dev.type != "cuda":
            fail("the PPO learner or its runners are not on the card")
        if best < RL_PPO_BAR:
            fail(f"PPO failed to learn CartPole on the card (best={best})")

        algo = (IMPALAConfig()
                .environment(CartPole)
                .env_runners(num_env_runners=3, num_envs_per_env_runner=4,
                             rollout_fragment_length=64)
                .training(lr=1e-3, fragments_per_iteration=8,
                          entropy_coeff=0.005, seed=0)
                .build())
        try:
            t0 = time.perf_counter()
            res = [algo.train() for _ in range(RL_ITERS)]
            imp_s = time.perf_counter() - t0
            imp_dev = algo.params["pi"]["w"].device
            stale = algo.num_stale_fragments
        finally:
            algo.stop()
        losses = [r["total_loss"] for r in res]
        phase("rllib", f"IMPALA {RL_ITERS} async iterations (learner on "
              f"{imp_dev}) in {imp_s:.2f} s: total losses "
              + " ".join(f"{x:.4f}" for x in losses) + "; mean return "
              f"{res[-1]['episode_return_mean']:.1f}; stale fragments "
              f"{stale} of {RL_ITERS * 8}")
        if imp_dev.type != "cuda" or not all(map(math.isfinite, losses)):
            fail("IMPALA's learner is not on the card or a loss is not "
                 "finite")

        algo = (DQNConfig()
                .environment(CartPole)
                .env_runners(num_env_runners=2, num_envs_per_env_runner=4)
                .training(steps_per_round=128, updates_per_iteration=128,
                          learn_starts=500, epsilon_decay_iters=8,
                          target_update_freq=2, lr=1e-3, seed=0)
                .build())
        try:
            t0 = time.perf_counter()
            res = [algo.train() for _ in range(RL_ITERS)]
            dqn_s = time.perf_counter() - t0
            dqn_dev = algo.params[0]["w"].device
        finally:
            algo.stop()
        td = [r["td_loss"] for r in res]
        phase("rllib", f"DQN {RL_ITERS} iterations (learner on {dqn_dev}) "
              f"in {dqn_s:.2f} s: td losses " + " ".join(
                  f"{x:.4f}" for x in td) + f"; mean return "
              f"{res[-1]['episode_return_mean']:.1f}")
        if dqn_dev.type != "cuda" or not math.isfinite(td[-1]):
            fail("DQN's learner is not on the card or its TD loss is not "
                 "finite")

        algos = {}
        for lr in (1e-3, 3e-4):
            algos[lr] = (PPOConfig()
                         .environment(CartPole)
                         .env_runners(num_env_runners=1,
                                      num_envs_per_env_runner=4,
                                      rollout_fragment_length=128)
                         .training(lr=lr, num_epochs=2, minibatch_size=256,
                                   seed=0)
                         .build())

        def trainable(config):
            algos[config["lr"]].as_trainable(RL_TUNE_ITERS)(config)

        try:
            t0 = time.perf_counter()
            grid = tune.Tuner(
                trainable,
                param_space={"lr": tune.grid_search(sorted(algos))},
                tune_config=tune.TuneConfig(
                    metric="episode_return_mean", mode="max",
                    max_concurrent_trials=2)).fit()
            tune_s = time.perf_counter() - t0
        finally:
            for a in algos.values():
                a.stop()
        trials = sorted(((r.config["lr"], r.status, len(r.metrics_history))
                         for r in grid), key=lambda t: t[0])
        phase("rllib", f"Tune: 2 trials of PPO.as_trainable({RL_TUNE_ITERS})"
              f" on the card in {tune_s:.2f} s: (lr, status, reports) "
              f"{trials}; best lr {grid.get_best_result().config['lr']:g}")
        if [t[1:] for t in trials] != [("TERMINATED", RL_TUNE_ITERS)] * 2:
            fail(f"the Tune run's trials did not both finish: {trials}")
    finally:
        rt.shutdown()
    phase("rllib", f"phase 23 took {time.perf_counter() - t_phase:.1f}s")


# Phase 24: a durable workflow at llama_440m (3 train steps at the train
# path's B x S, an evaluate forward at B=4), the autoscaler's node type
# and its idle timeout and poll, the card's memory after each half (as
# phase 19's), and the number of raylint's rules.
WF_STEPS, WF_EVAL_B = 3, 4
AUTO_NODE = {"CPU": 2, "GPU": 1}
AUTO_IDLE_S, AUTO_POLL_S = 2.0, 0.25
LINT_RULES = 21


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def workflow_phase(fa, torch, llama):
    """24a. A durable workflow of llama_440m on the card, in a fresh
    runtime shut down at the end: step ``train`` (``num_gpus=1``) builds
    the state (f32 params and moments, bf16 compute, flash attention),
    takes 3 fused-AdamW steps at B=8 x S=2048 (B1, B2, B3), saves the
    state with ``train/checkpoint.save_pytree`` and returns the path and
    its losses as a CUDA tensor; step ``evaluate`` loads the checkpoint
    on the card and runs the flash forward at B=4 x S=2048 (B1), its
    last-position logits a CUDA tensor; a host step summarises.
    ``evaluate`` fails once through a flag file; ``workflow.resume``
    restores ``train`` (a counter file shows it never re-ran) and re-runs
    ``evaluate``: the restored tensors are on the card, and the logits
    are bit-equal to a second, uninterrupted workflow's over the same
    checkpoint.  Prints each step's time, the bytes persisted for each
    step, the resume's time, the live tensor bytes on the card before
    and after (back within 64 MiB) and the card's free memory before and
    after.  Returns the launches of the phase (3 train steps and 2
    forwards)."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.train.checkpoint import load_pytree, save_pytree

    t_phase = time.perf_counter()
    rt.shutdown()
    _, mem0 = held_bytes(torch)
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    cfg = llama.LlamaConfig.llama_440m()
    tmp = tempfile.mkdtemp(prefix="phase24_")

    @rt.remote(num_gpus=1)
    def train(args):
        with open(args["counter"], "a") as f:
            f.write("x")
        t0 = time.perf_counter()
        state = llama.init_train_state(cfg, seed=0, fused=True)
        step = llama.make_train_step(cfg, fused=True)
        g = torch.Generator(device="cuda")
        g.manual_seed(24)
        losses = []
        for _ in range(WF_STEPS):
            batch = {"tokens": torch.randint(
                0, cfg.vocab_size, (TRAIN_B, TRAIN_S), generator=g,
                device="cuda")}
            state, m = step(state, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        save_pytree(state, args["ckpt"])
        return {"ckpt": args["ckpt"], "losses": torch.stack(losses),
                "steps_s": t1 - t0, "save_s": time.perf_counter() - t1}

    @rt.remote(num_gpus=1)
    def evaluate(trained, args):
        if os.path.exists(args["flag"]):
            os.remove(args["flag"])
            raise RuntimeError("evaluate fails once (the planted failure)")
        t0 = time.perf_counter()
        params = load_pytree(trained["ckpt"])["params"]
        g = torch.Generator(device="cuda")
        g.manual_seed(25)
        tokens = torch.randint(0, cfg.vocab_size, (WF_EVAL_B, TRAIN_S),
                               generator=g, device="cuda")
        logits = llama.forward(params, tokens, cfg)[:, -1].clone()
        torch.cuda.synchronize()
        return {"logits": logits, "s": time.perf_counter() - t0}

    @rt.remote
    def summarise(trained, evaluated):
        logits = evaluated["logits"]
        return {"losses": [float(x) for x in trained["losses"].cpu()],
                "losses_device": str(trained["losses"].device),
                "logits": logits, "logits_device": str(logits.device),
                "finite": bool(torch.isfinite(logits).all()),
                "train_s": trained["steps_s"] + trained["save_s"],
                "save_s": trained["save_s"], "evaluate_s": evaluated["s"]}

    @rt.remote
    def stored(args):
        """The train step's value, for a workflow over a checkpoint
        that is already there."""
        return {"ckpt": args["ckpt"], "losses": torch.tensor(
            args["losses"], device="cuda"), "steps_s": 0.0, "save_s": 0.0}

    def dag_over(first):
        with InputNode() as inp:
            trained = first.bind(inp)
            evaluated = evaluate.bind(trained, inp)
            return summarise.bind(trained, evaluated), trained, evaluated

    try:
        rt.init(num_cpus=4)
        workflow.init(os.path.join(tmp, "workflows"))
        args = {"ckpt": os.path.join(tmp, "ckpt"),
                "flag": os.path.join(tmp, "flag"),
                "counter": os.path.join(tmp, "train_runs")}
        with open(args["flag"], "w") as f:
            f.write("fail once")
        dag, trained_node, evaluated_node = dag_over(train)
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            workflow.run(dag, workflow_id="llama", args=args)
            fail("phase 24a's evaluate step did not fail")
        except Exception as e:  # the planted failure, through the task
            if "evaluate fails once" not in str(e):
                raise
        failed_s = time.perf_counter() - t0
        status = workflow.get_status("llama")
        t0 = time.perf_counter()
        out = workflow.resume("llama")
        resume_s = time.perf_counter() - t0
        meta = workflow.get_metadata("llama")
        with open(args["counter"]) as f:
            train_runs = len(f.read())
        ids = workflow._step_ids(dag)
        steps_dir = os.path.join(workflow.init(), "llama", "steps")
        persisted = {name: os.path.getsize(os.path.join(
            steps_dir, ids[id(node)] + ".pkl"))
            for name, node in (("train", trained_node),
                               ("evaluate", evaluated_node),
                               ("summarise", dag))}
        ckpt_bytes = _dir_bytes(args["ckpt"])
        straight_dag = dag_over(stored)[0]
        straight = workflow.run(straight_dag, workflow_id="straight",
                                args={**args, "losses": out["losses"]})
        launches = launched(fa)
        equal = (out["logits"].shape == straight["logits"].shape
                 and torch.equal(out["logits"].view(torch.int16),
                                 straight["logits"].view(torch.int16)))
        phase("workflow", f"llama_440m workflow train -> evaluate -> "
              f"summarise: the first run FAILED at evaluate as planted "
              f"({failed_s:.2f}s, status {status}); resume() took "
              f"{resume_s:.2f}s: steps_restored {meta['steps_restored']}, "
              f"steps_run {meta['steps_run']}, train ran {train_runs} "
              f"time(s), status {meta['status']}")
        phase("workflow", f"train {out['train_s']:.2f}s ({WF_STEPS} fused "
              f"AdamW steps B={TRAIN_B} S={TRAIN_S} and the save; save "
              f"{out['save_s']:.2f}s = {ckpt_bytes / out['save_s'] / 1e9:.2f}"
              f" GB/s of {ckpt_bytes} B), evaluate {out['evaluate_s']:.2f}s "
              f"(load + forward B={WF_EVAL_B}); losses "
              + " ".join(f"{x:.4f}" for x in out["losses"])
              + f"; bytes persisted per step {persisted}; restored "
              f"tensors on {out['losses_device']}, logits on "
              f"{out['logits_device']} {tuple(out['logits'].shape)}; "
              f"bit-equal to an uninterrupted workflow over the same "
              f"checkpoint: {equal}; launches {launches}")
        if status != "FAILED" or meta["status"] != "SUCCEEDED":
            fail(f"the workflow's statuses were {status} then "
                 f"{meta['status']}")
        if meta["steps_restored"] < 1 or train_runs != 1:
            fail(f"resume re-ran train ({train_runs} runs, "
                 f"{meta['steps_restored']} steps restored)")
        if not out["losses_device"].startswith("cuda") or \
                not out["logits_device"].startswith("cuda"):
            fail("a restored tensor is not on the card")
        if not out["finite"] or not all(math.isfinite(x)
                                        for x in out["losses"]):
            fail("the workflow's losses or logits are not finite")
        if not equal:
            fail("the resumed workflow's logits differ from the "
                 "uninterrupted run's")
        want = {"flash_fwd": (WF_STEPS + 2) * cfg.n_layers,
                "flash_bwd_dq": WF_STEPS * cfg.n_layers,
                "flash_bwd_dkdv": WF_STEPS * cfg.n_layers}
        if launches != want:
            fail(f"phase 24a launched {launches}, expected {want}")
        del out, straight
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    _, mem1 = held_bytes(torch)
    torch.cuda.empty_cache()
    free1 = torch.cuda.mem_get_info()[0]
    # The gate is the live tensors: free memory also drops by the code of
    # kernels that this process runs for the first time (CUDA loads
    # modules lazily), which stays for the life of the process.
    phase("workflow", f"live tensor bytes on the card {mem0} before, "
          f"{mem1} after (tol {TOL_SERVE_LEAK_BYTES >> 20} MiB); free card "
          f"memory {free0 / 2**20:.1f} MiB before, {free1 / 2**20:.1f} MiB "
          f"after; phase 24a took {time.perf_counter() - t_phase:.1f}s")
    if mem1 - mem0 > TOL_SERVE_LEAK_BYTES:
        fail(f"{(mem1 - mem0) / 2**20:.1f} MiB of tensors still on the "
             f"card after the workflow")
    return launches


def autoscaler_phase(fa, torch, llama):
    """24b. The autoscaler launches a GPU node for pending demand: a head
    in this process, this process joined advertising ``num_gpus=0``, an
    ``Autoscaler`` over a ``LocalNodeProvider`` with node type
    ``{"CPU": 2, "GPU": 1}``, 0 to 1 nodes and a 2 s idle timeout.  A
    ``num_gpus=1`` task running the llama_440m bf16 flash forward at B=4
    x S=2048 is submitted until a node can place it (each refused
    placement is the head's pending demand); the node it runs on was
    launched by the autoscaler, its GPU count is 1, and its last-position
    logits equal this process's direct call bit for bit.  Idle, the node
    is terminated down to 0 nodes, and the card's free memory comes back.
    Prints submit -> node registered, submit -> result and idle ->
    terminated.  Returns the task's launches."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    from ray_tpu_torch.exceptions import TaskError

    t_phase = time.perf_counter()
    rt.shutdown()
    held_bytes(torch)
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    cfg = llama.LlamaConfig.llama_440m(dtype=torch.bfloat16,
                                       attention_impl="flash")

    @rt.remote(num_gpus=1)
    def forward_task(seed):
        import torch as _torch

        import ray_tpu_torch as _rt
        from ray_tpu_torch.models import llama as _llama
        from ray_tpu_torch.ops import flash_attention as _fa

        params = _llama.init_params(cfg, seed=seed, dtype=_torch.bfloat16)
        tg = _torch.Generator(device="cuda")
        tg.manual_seed(7)
        tokens = _torch.randint(0, cfg.vocab_size, (4, 2048),
                                generator=tg, device="cuda")
        _fa.reset_launch_counts()
        logits = _llama.forward(params, tokens, cfg)
        _torch.cuda.synchronize()
        counts = {n: k for n, k in _fa.launch_counts.items() if k}
        return (logits[:, -1].clone(), counts,
                _rt.get_runtime_context().get_node_id())

    c = Cluster()
    provider = scaler = None
    try:
        me = c.connect(num_cpus=2, num_gpus=0)
        provider = LocalNodeProvider(c.head_address)
        scaler = Autoscaler(c.head_address, provider,
                            node_resources=AUTO_NODE, min_nodes=0,
                            max_nodes=1, idle_timeout_s=AUTO_IDLE_S,
                            poll_interval_s=AUTO_POLL_S)
        t0 = time.perf_counter()
        registered_s = result = None
        refused = 0
        while result is None:
            if time.perf_counter() - t0 > 300:
                fail("no node placed the GPU task within 300 s")
            try:
                result = rt.get(forward_task.remote(0), timeout=600)
            except TaskError as e:
                if "no node can fit" not in str(e):
                    raise
                refused += 1
                time.sleep(AUTO_POLL_S)
            if registered_s is None and any(
                    n["alive"] and n.get("name") in provider.live_nodes()
                    for n in me.cluster.list_nodes()):
                registered_s = time.perf_counter() - t0
        t_idle = time.perf_counter()  # the node's only task is done
        result_s = t_idle - t0
        last, task_launches, node_id = result
        tags = provider.live_nodes()
        node = [n for n in me.cluster.list_nodes()
                if n["alive"] and n.get("name") in tags]
        params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16)
        tg = torch.Generator(device="cuda")
        tg.manual_seed(7)
        direct = llama.forward(params, torch.randint(
            0, cfg.vocab_size, (4, 2048), generator=tg, device="cuda"),
            cfg)[:, -1]
        equal = (last.device == direct.device and last.shape == direct.shape
                 and torch.equal(last.view(torch.int16),
                                 direct.view(torch.int16)))
        del params, direct, last
        # Terminated: the provider has stopped the node's process and the
        # autoscaler has counted it.
        while (provider.live_nodes() or scaler.num_terminated < 1) \
                and time.perf_counter() - t_idle < 60:
            time.sleep(0.1)
        idle_s = time.perf_counter() - t_idle
        phase("autoscale", f"num_gpus=1 llama_440m flash forward B=4 "
              f"S=2048 bf16 from a driver with no GPU: {refused} refused "
              f"placement(s), submit -> node {tags} registered "
              f"{registered_s:.2f}s, submit -> result {result_s:.2f}s "
              f"(on node {node_id[:12]}; the node's GPU "
              f"{[n['total'].get('GPU') for n in node]}); logits bit-equal "
              f"to this process's direct call: {equal}; launches in the "
              f"task {task_launches}; idle -> terminated {idle_s:.2f}s "
              f"(idle timeout {AUTO_IDLE_S}s, poll {AUTO_POLL_S}s); "
              f"launched {scaler.num_launched}, terminated "
              f"{scaler.num_terminated}, live nodes {provider.live_nodes()}")
        if [n["node_id"] for n in node] != [node_id]:
            fail("the GPU task did not run on the autoscaled node")
        if [n["total"].get("GPU") for n in node] != [1.0]:
            fail(f"the autoscaled node advertises {node}, expected one "
                 f"node with 1 GPU")
        if not equal:
            fail("the autoscaled node's logits differ from this "
                 "process's direct call")
        if task_launches != {"flash_fwd": cfg.n_layers}:
            fail(f"the autoscaled node's forward launched {task_launches}")
        if provider.live_nodes() or scaler.num_launched != 1 \
                or scaler.num_terminated != 1:
            fail("the idle node was not terminated down to 0 nodes")
    finally:
        if scaler is not None:
            scaler.shutdown()
        if provider is not None:
            provider.shutdown()
        rt.shutdown()
        c.shutdown()
    held_bytes(torch)
    torch.cuda.empty_cache()
    free1 = torch.cuda.mem_get_info()[0]
    phase("autoscale", f"free card memory {free0 / 2**20:.1f} MiB before, "
          f"{free1 / 2**20:.1f} MiB after (tol "
          f"{TOL_CLUSTER_FREE_BYTES >> 20} MiB); phase 24b took "
          f"{time.perf_counter() - t_phase:.1f}s")
    if free0 - free1 > TOL_CLUSTER_FREE_BYTES:
        fail(f"{(free0 - free1) / 2**20:.1f} MiB of the card not back "
             f"after the autoscaled node went away")
    return task_launches


def lint_phase():
    """24c. raylint on the card's machine: ``python -m ray_tpu_torch
    lint`` over the port exits 0 with no finding, importing neither jax
    nor the JAX package; then in this process the cold and warm wall
    clock of a whole-package lint and the parse cache's hit rate (the
    three numbers ``bench.py``'s ``_raylint_bench`` reports for the
    reference), and ``--list-rules`` naming all 21 rules."""
    import contextlib
    import io

    from ray_tpu_torch.tools import raylint
    from ray_tpu_torch.tools.raylint import cli as lint_cli
    from ray_tpu_torch.tools.raylint.model import _ParseCache

    probe = ("import runpy, sys\n"
             "sys.argv = ['ray_tpu_torch', 'lint']\n"
             "try:\n"
             "    runpy.run_module('ray_tpu_torch', run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    print('EXIT', e.code)\n"
             "print('JAX', 'jax' in sys.modules, 'ray_tpu' in sys.modules)\n")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", probe], cwd=HERE,
                       capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    out = r.stdout.strip().splitlines()
    phase("lint", f"python -m ray_tpu_torch lint: {cli_s:.2f}s in a fresh "
          f"process; " + " | ".join(out[-3:]))
    if r.returncode != 0 or out[-2:] != ["EXIT 0", "JAX False False"] or \
            not any(line.startswith("raylint: 0 finding(s)")
                    for line in out):
        fail(f"the port's lint did not exit 0 clean without jax: "
             f"{r.stdout[-2000:]} {r.stderr[-2000:]}")
    root = raylint.default_package_root()
    _ParseCache._memo.clear()
    _ParseCache.reset_stats()
    t0 = time.perf_counter()
    findings = raylint.run_lint(root, use_baseline=False)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    raylint.run_lint(root, use_baseline=False)
    warm = time.perf_counter() - t0
    stats = _ParseCache.stats()
    rate = stats["hits"] / max(1, stats["hits"] + stats["misses"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lint_cli.main(["--list-rules"])
    listed = [rule for rule in raylint.RULES if rule in buf.getvalue()]
    phase("lint", f"whole-package raylint in this process: cold "
          f"{cold:.3f}s, warm {warm:.3f}s, parse-cache hit rate "
          f"{rate:.3f} ({stats}); {len(findings)} finding(s) with no "
          f"baseline; --list-rules exit {rc}, {len(listed)} rules; jax "
          f"imported: {'jax' in sys.modules}, ray_tpu: "
          f"{'ray_tpu' in sys.modules}")
    if findings or rc != 0 or len(listed) != LINT_RULES or \
            len(raylint.RULES) != LINT_RULES:
        fail("the port's raylint has findings or lacks a rule")
    if "jax" in sys.modules or "ray_tpu" in sys.modules:
        fail("jax or the JAX package was imported")


class _Space:
    """The two attributes RLlib reads of a gymnasium space."""

    def __init__(self, shape=(), n=None):
        self.shape, self.n = shape, n


class CartPole:
    """CartPole-v1 in numpy, for phase 23 (the card's machine has no
    gymnasium): gymnasium's dynamics (Euler steps of 0.02 s, force 10 N,
    cart 1 kg, pole 0.1 kg and half-length 0.5 m), its termination
    bounds (|x| > 2.4 or |theta| > 12 degrees), reward 1 a step up to and
    including the step that terminates, and the 500-step truncation of
    ``gymnasium.make("CartPole-v1")``.  ``reset(seed=s)`` draws the start
    state as gymnasium does, uniform in [-0.05, 0.05) from
    ``default_rng(s)``; a reset without a seed keeps drawing from the
    same generator.  tests/test_torch_rllib_parity.py holds it to
    gymnasium step for step."""

    observation_space = _Space(shape=(4,))
    action_space = _Space(n=2)
    MAX_STEPS = 500

    def __init__(self):
        import numpy as np

        self._np = np
        self._rng = np.random.default_rng()
        self.state = None

    def reset(self, *, seed=None, options=None):
        np = self._np
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform(low=-0.05, high=0.05, size=(4,))
        self._steps = 0
        self._done = False
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        np = self._np
        x, x_dot, theta, theta_dot = self.state
        force = 10.0 if action == 1 else -10.0
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass, polemass_length = 1.1, 0.05
        temp = (force + polemass_length * np.square(theta_dot) * sintheta
                ) / total_mass
        thetaacc = (9.8 * sintheta - costheta * temp) / (
            0.5 * (4.0 / 3.0 - 0.1 * np.square(costheta) / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + 0.02 * x_dot
        x_dot = x_dot + 0.02 * xacc
        theta = theta + 0.02 * theta_dot
        theta_dot = theta_dot + 0.02 * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(x < -2.4 or x > 2.4
                          or theta < -12 * 2 * math.pi / 360
                          or theta > 12 * 2 * math.pi / 360)
        reward = 0.0 if self._done else 1.0
        self._done = self._done or terminated
        self._steps += 1
        truncated = self._steps >= self.MAX_STEPS
        return (np.array(self.state, dtype=np.float32), reward, terminated,
                truncated, {})


CHAOS_STEPS, CHAOS_SEVERED_STEP = 3, 1
TOL_CHAOS_LOSS_REL = 1e-3
DAG_CHAOS_TIMEOUT_S = 5.0
CHAOS_SERVE_TOKENS = 16
GANG_B = 2
GANG_SERIES = "last(ray_tpu_device_hbm_bytes_used)[60s] by (node_id)"
RELEASE_WAIT_S = 30.0


def released_bytes(torch, mem0, timeout_s=RELEASE_WAIT_S):
    """``held_bytes`` once what killed actors held has been let go: their
    threads finish the calls in flight and the object-ref reaper
    releases the calls' refs a moment after ``shutdown()`` returns.
    Polls until the card holds at most ``mem0`` plus the leak tolerance,
    or the wait runs out.  Returns (bytes held, seconds waited)."""
    t0 = time.perf_counter()
    while True:
        _, held = held_bytes(torch)
        waited = time.perf_counter() - t0
        if held - mem0 <= TOL_SERVE_LEAK_BYTES or waited > timeout_s:
            return held, waited
        time.sleep(0.1)


def _count_into(total, counts):
    for n, k in counts.items():
        total[n] = total.get(n, 0) + k


def chaos_phase(fa, torch, llama):
    """25. The recovery paths on the card, at llama_440m's full width,
    driven by ``experimental.chaos`` schedules.  A typed error that a
    schedule provokes is asserted; any other exception fails the phase.
    a. ``CrossSlicePipeline`` of llama_440m in bf16, untied head, 2
    stages of 12 layers in this process, B=8 x S=2048, M=4: 3 steps with
    step 1 under ``sever_ring("pp-fwd0", at_frame=7)`` (its third
    microbatch: the rule counts the ring's writes, M a step); the sever
    fires once, the ring is rebuilt, and the 3 losses equal those of a
    clean run from the same seed and batches (rtol 1e-3; the gap
    printed); the severed step's time against a clean step's, the flash
    launches of every step.  b. A pipeline of the same configuration
    under ``kill_at_ring_write("pp-fwd0", nth=3)`` (its first step's
    third microbatch): the step raises ``ActorDiedError`` or
    ``ChannelError`` within the ring's read timeout, the error names the
    edge, and after ``shutdown()`` the card's memory is back within 64 MiB
    of what it was before the pipeline was built.  c. Phase 20's two
    llama_440m stage actors in a compiled DAG (B=2 x S=1024):
    ``kill_at_ring_write("dag0-1", nth=2)`` raises ``ActorDiedError``
    within twice the channel timeout; the DAG compiled again (new actors,
    replanned rings) gives logits bit-equal to the one-piece forward;
    memory back after ``teardown()``.  d. Two ``LLMServer`` replicas of
    llama_440m in f32 behind one handle (17d's engine settings): one is
    killed through the controller, then 8 requests are all answered
    through the handle's retry with the direct f32 engine's tokens;
    memory back after ``serve.delete``.  e. Two worker node processes on
    the card, one llama_440m train worker each (B=2 x S=2048, one fused
    step): their ``ray_tpu_device_hbm_bytes_used`` series reach the head
    TSDB, the dashboard and ``render_top``, each within 64 MiB of the
    worker's own ``memory_stats``.  Returns the flash launches of the
    phase's main path: 25a-b's steps, 25c's passes, 25e's workers."""
    import urllib.parse
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    from ray_tpu_torch.core.node import wait_for_nodes
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
    from ray_tpu_torch.exceptions import ActorDiedError, ChannelError
    from ray_tpu_torch.experimental import channel as chx
    from ray_tpu_torch.experimental import chaos
    from ray_tpu_torch.models import llama_pipeline as lp
    from ray_tpu_torch.observability import tsdb
    from ray_tpu_torch.scripts.cli import _fmt_gb, _top_snapshot, render_top
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.train.cross_pipeline import CrossSlicePipeline

    t_phase = time.perf_counter()
    launches = {}
    rt.shutdown()

    # a. A severed boundary.
    cfg = llama.LlamaConfig.llama_440m(tie_embeddings=False)
    batches = _pipe_batches(cfg.vocab_size, CHAOS_STEPS, 25)
    want_fwd, want_bwd, _ = pipe_launches_per_step(cfg, PIPE_M)
    want = {"flash_fwd": want_fwd, "flash_bwd_dq": want_bwd,
            "flash_bwd_dkdv": want_bwd}

    def pipeline():
        pipe = CrossSlicePipeline(cfg, n_stages=2,
                                  num_microbatches=PIPE_M, seed=0)
        if not all(pipe._fwd_ch):
            pipe.shutdown()
            fail(f"25a: no boundary ring planned: {pipe._fwd_ch}")
        return pipe

    def step(pipe, b, per_step, ms):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss = pipe.train_step(b)["loss"]
        ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(launched(fa))
        _count_into(launches, per_step[-1])
        return loss

    rt.init()
    try:
        clean, clean_steps, clean_ms = [], [], []
        pipe = pipeline()
        try:
            for b in batches:
                clean.append(step(pipe, b, clean_steps, clean_ms))
        finally:
            pipe.shutdown()
            del pipe
        # The rule counts the ring's writes from its first: M a step, so
        # the third write of step 1 is frame M + 3.
        sever_at = PIPE_M * CHAOS_SEVERED_STEP + 3
        got, per_step, ms = [], [], []
        pipe = pipeline()
        try:
            old_ring = pipe._fwd_ch[0]
            for i, b in enumerate(batches):
                if i != CHAOS_SEVERED_STEP:
                    got.append(step(pipe, b, per_step, ms))
                    continue
                sched = chaos.schedule().sever_ring("pp-fwd0",
                                                    at_frame=sever_at)
                with sched:
                    got.append(step(pipe, b, per_step, ms))
            fired = sched.fired("ring_sever")
            rebuilt = pipe._fwd_ch[0] not in (None, old_ring)
            gap = max(abs(a / r - 1) for a, r in zip(got, clean))
            cut_ms = ms[CHAOS_SEVERED_STEP]
            ok_ms = clean_ms[CHAOS_SEVERED_STEP]
            phase("chaos", f"25a llama_440m untied bf16, 2 in-process "
                  f"stages, B={TRAIN_B} S={TRAIN_S} M={PIPE_M}: step "
                  f"{CHAOS_SEVERED_STEP} under sever_ring('pp-fwd0', "
                  f"at_frame={sever_at}): fired {fired}, ring rebuilt "
                  f"{rebuilt}; "
                  f"losses " + " ".join(f"{x:.6f}" for x in got)
                  + "; clean run " + " ".join(f"{x:.6f}" for x in clean)
                  + f"; largest relative gap {gap:.3e} (tol "
                  f"{TOL_CHAOS_LOSS_REL:g}); step ms " + " ".join(
                      f"{x:.1f}" for x in ms) + " (clean " + " ".join(
                      f"{x:.1f}" for x in clean_ms) + "); severed step "
                  f"{cut_ms:.1f} ms against the clean run's {ok_ms:.1f} "
                  f"ms ({cut_ms / ok_ms:.2f}x); launches a step "
                  f"{per_step} (clean {clean_steps})")
            if fired != 1 or not rebuilt:
                fail(f"25a: the sever fired {fired} times, ring rebuilt "
                     f"{rebuilt}")
            if not (gap <= TOL_CHAOS_LOSS_REL) or \
                    not all(math.isfinite(x) for x in got):
                fail(f"25a: the severed run's losses {got} differ from "
                     f"the clean run's {clean}")
            for i, p in enumerate(clean_steps + per_step):
                severed = i == CHAOS_STEPS + CHAOS_SEVERED_STEP
                if any(p.get(n, 0) < k if severed else p.get(n, 0) != k
                       for n, k in want.items()):
                    fail(f"25a: a step launched {p}, expected {want}")

        finally:
            pipe.shutdown()
            del pipe

        # b. A stage killed mid-step, on a pipeline of its own (the rule
        # counts its ring's writes from the ring's first).
        _, mem0 = held_bytes(torch)
        pipe = pipeline()
        try:
            sched = chaos.schedule().kill_at_ring_write("pp-fwd0", nth=3)
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            err = None
            with sched:
                try:
                    pipe.train_step(batches[0])
                except (ActorDiedError, ChannelError) as e:
                    err = f"{type(e).__name__}: {e}"
            secs = time.perf_counter() - t0
            _count_into(launches, launched(fa))
            fired = sched.fired("ring_kill")
        finally:
            pipe.shutdown()
            del pipe
    finally:
        rt.shutdown()
    mem1, wait_s = released_bytes(torch, mem0)
    phase("chaos", f"25b kill_at_ring_write('pp-fwd0', nth=3): fired "
          f"{fired}, the step raised in {secs:.3f} s (the ring's read "
          f"timeout {chx.DEFAULT_TIMEOUT_S:g} s): {err}; memory "
          f"{mem0 / 2**20:.1f} MiB before the pipeline, "
          f"{mem1 / 2**20:.1f} MiB {wait_s:.2f} s after shutdown() (tol "
          f"{TOL_SERVE_LEAK_BYTES >> 20} MiB)")
    if err is None or fired != 1:
        fail(f"25b: the step did not raise a typed error (fired {fired})")
    if secs > chx.DEFAULT_TIMEOUT_S:
        fail(f"25b: the typed error took {secs:.1f} s")
    if "pp-fwd0" not in err:
        fail(f"25b: the error does not name the edge: {err}")
    if mem1 - mem0 > TOL_SERVE_LEAK_BYTES:
        fail(f"25b: {(mem1 - mem0) / 2**20:.1f} MiB still held after the "
             f"killed pipeline's shutdown()")

    # c. A DAG producer killed mid-pass.
    cfg = llama.LlamaConfig.llama_440m(dtype=torch.bfloat16,
                                       attention_impl="flash")

    @rt.remote(num_gpus=0.5)
    class Stage:
        def __init__(self, stage):
            params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16)
            sl = lp.stage_slice(params, stage, 2)
            # Own copies: the slices are views of the whole model.
            self.sl = {k: ({n: w.clone() for n, w in v.items()}
                           if isinstance(v, dict) else v.clone())
                       for k, v in sl.items()}
            del params, sl
            self.fwd = (lp.make_stage_fwd(cfg, first=True) if stage == 0
                        else lp.make_stage_logits(cfg))

        def forward(self, x):
            with torch.no_grad():
                return self.fwd(self.sl, x)

    _, mem0 = held_bytes(torch)
    tg = torch.Generator(device="cuda")
    tg.manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (DAG_B, DAG_S), generator=tg,
                           device="cuda")
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16)
    with torch.no_grad():
        ref = llama.forward(params, tokens, cfg)
    del params
    rt.init()
    compiled = None
    try:
        with InputNode() as inp:
            dag = Stage.bind(1).forward.bind(Stage.bind(0).forward.bind(inp))
        compiled = dag.experimental_compile(
            channel_timeout=DAG_CHAOS_TIMEOUT_S)
        if list(compiled._channel_edges) != [(0, 1)]:
            fail(f"25c: the stage edge is not on a ring: "
                 f"{compiled._channel_edges}")
        old_paths = set(compiled._channel_edges.values())
        fa.reset_launch_counts()
        rt.get(compiled.execute(tokens), timeout=300)
        sched = chaos.schedule().kill_at_ring_write("dag0-1", nth=2)
        err = None
        with sched:
            t0 = time.perf_counter()
            try:
                rt.get(compiled.execute(tokens),
                       timeout=4 * DAG_CHAOS_TIMEOUT_S)
            except ActorDiedError as e:
                err = f"{type(e).__name__}: {e}"
            secs = time.perf_counter() - t0
        fired = sched.fired("ring_kill")
        compiled.teardown()
        compiled = dag.experimental_compile(
            channel_timeout=DAG_CHAOS_TIMEOUT_S)
        new_paths = set(compiled._channel_edges.values())
        out = rt.get(compiled.execute(tokens), timeout=300)
        torch.cuda.synchronize()
        _count_into(launches, launched(fa))
        dag_launches = launched(fa)
        bitwise = torch.equal(out.view(torch.int16), ref.view(torch.int16))
        err_rel = rel_err(out, ref)
        del out
        compiled.teardown()
        compiled = None
    finally:
        if compiled is not None:
            compiled.teardown()
        rt.shutdown()
    del ref, tokens
    mem1, wait_s = released_bytes(torch, mem0)
    phase("chaos", f"25c DAG of two llama_440m stages, B={DAG_B} "
          f"S={DAG_S}, channel_timeout {DAG_CHAOS_TIMEOUT_S:g} s: "
          f"kill_at_ring_write('dag0-1', nth=2) fired {fired}, raised in "
          f"{secs:.3f} s (bound {2 * DAG_CHAOS_TIMEOUT_S:g} s): {err}; "
          f"compiled again on new rings {new_paths != old_paths}: logits "
          f"against the one-piece forward bit-equal {bitwise} (rel err "
          f"{err_rel:.2e}); launches {dag_launches}; memory "
          f"{mem0 / 2**20:.1f} MiB before, {mem1 / 2**20:.1f} MiB "
          f"{wait_s:.2f} s after teardown()")
    if err is None or fired != 1 or secs > 2 * DAG_CHAOS_TIMEOUT_S:
        fail(f"25c: no ActorDiedError within {2 * DAG_CHAOS_TIMEOUT_S:g} s "
             f"(fired {fired}, {secs:.1f} s)")
    if not bitwise or new_paths == old_paths:
        fail("25c: the recompiled DAG's logits differ from the one-piece "
             "forward, or its rings were not replanned")
    if mem1 - mem0 > TOL_SERVE_LEAK_BYTES:
        fail(f"25c: {(mem1 - mem0) / 2**20:.1f} MiB still held after "
             f"teardown()")

    # d. A Serve replica killed.
    register_f32_preset(torch, llama)
    prompts = serve_prompts(torch)
    engine = dict(model_preset="llama_440m_f32", max_slots=8, max_len=512,
                  seed=0)
    server = LLMServer(**engine)
    try:
        outs, _ = run_requests(server, prompts, CHAOS_SERVE_TOKENS)
    finally:
        server.shutdown()
    direct = [o["tokens"] for o in outs]
    del server, outs
    _, mem0 = held_bytes(torch)
    rt.init()
    try:
        handle = serve.run(serve.deployment(
            LLMServer, num_replicas=2, name="chaos",
            ray_actor_options={"num_gpus": 0.5}).bind(**engine))
        controller = serve._get_controller(create=False)
        replicas = rt.get(controller.get_replicas.remote("chaos"),
                          timeout=60)
        rt.kill(replicas[0])
        outs, wall = handle_round(handle, prompts, CHAOS_SERVE_TOKENS)
        got = [o["tokens"] for o in outs]
        serve.delete("chaos")
        del handle, replicas, outs
    finally:
        serve.shutdown()
        rt.shutdown()
    mem1, wait_s = released_bytes(torch, mem0)
    phase("chaos", f"25d two llama_440m f32 replicas, one killed through "
          f"the controller: {len(got)} of 8 requests answered in "
          f"{wall:.2f} s, tokens == the direct engine's {got == direct}; "
          f"memory {mem0 / 2**20:.1f} MiB before, {mem1 / 2**20:.1f} MiB "
          f"{wait_s:.2f} s after serve.delete")
    if got != direct:
        fail(f"25d: tokens through the handle differ from the direct "
             f"engine's (first at {first_diff(got, direct)})")
    if mem1 - mem0 > TOL_SERVE_LEAK_BYTES:
        fail(f"25d: {(mem1 - mem0) / 2**20:.1f} MiB still held after "
             f"serve.delete (the killed replica's engine)")

    # e. The gang's memory series on the card.
    env = {"RAY_TPU_EVENT_FLUSH_S": "0.2", "RAY_TPU_DEVICE_SAMPLE_S": "0.1"}
    c = Cluster()
    try:
        for i in range(2):
            c.add_node(num_cpus=2, resources={f"gang{i}": 1}, env=env,
                       wait=False)
        runtime = c.connect(num_cpus=2)
        wait_for_nodes(c.head_address, 3, timeout=120)

        @rt.remote(num_gpus=1)
        class TrainWorker:
            def __init__(self):
                import torch as _t

                from ray_tpu_torch.models import llama as _l
                from ray_tpu_torch.ops import flash_attention as _fa

                self.cfg = _l.LlamaConfig.llama_440m()
                self.state = _l.init_train_state(self.cfg, seed=0,
                                                 fused=True)
                self.step_fn = _l.make_train_step(self.cfg, fused=True)
                self._t, self._fa = _t, _fa

            def step(self, seed, B, S):
                import ray_tpu_torch as _rt

                g = self._t.Generator(device="cuda")
                g.manual_seed(seed)
                batch = {"tokens": self._t.randint(
                    0, self.cfg.vocab_size, (B, S), generator=g,
                    device="cuda")}
                self._fa.reset_launch_counts()
                self.state, m = self.step_fn(self.state, batch)
                loss = m["loss"].item()
                return (_rt.get_runtime_context().get_node_id(), loss,
                        {n: k for n, k in self._fa.launch_counts.items()
                         if k})

            def used(self):
                self._t.cuda.synchronize()
                return self._t.cuda.memory_stats(0)[
                    "allocated_bytes.all.current"]

        workers = [TrainWorker.options(resources={f"gang{i}": 1}).remote()
                   for i in range(2)]
        steps = rt.get([w.step.remote(30 + i, GANG_B, TRAIN_S)
                        for i, w in enumerate(workers)], timeout=600)
        for _nid, loss, counts in steps:
            _count_into(launches, counts)
            if not math.isfinite(loss):
                fail(f"25e: a worker's loss is {loss}")
        used = dict(zip((s[0] for s in steps),
                        rt.get([w.used.remote() for w in workers],
                               timeout=60)))
        if len(used) != 2 or runtime.cluster.node_id in used:
            fail(f"25e: the workers did not run on two worker nodes: "
                 f"{list(used)}")

        def close(rows):
            return all(nid in rows and abs(rows[nid] - u)
                       <= TOL_SERVE_LEAK_BYTES for nid, u in used.items())

        t0 = time.perf_counter()
        deadline = time.monotonic() + 60
        while True:
            out = tsdb.query_cluster(runtime.cluster, GANG_SERIES)
            head_rows = {r["labels"].get("node_id"): r["value"]
                         for r in out["rows"]}
            if close(head_rows):
                break
            if time.monotonic() > deadline:
                fail(f"25e: the head TSDB's rows {head_rows} never came "
                     f"within 64 MiB of the workers' {used}")
            time.sleep(0.3)
        tsdb_s = time.perf_counter() - t0
        dash = start_dashboard(port=0)
        try:
            url = (dash.url + "/api/metrics/query?q="
                   + urllib.parse.quote(GANG_SERIES))
            body = json.loads(urllib.request.urlopen(
                url, timeout=15).read().decode())
        finally:
            stop_dashboard()
        dash_rows = {r["labels"].get("node_id"): r["value"]
                     for r in body["rows"]}
        snap = _top_snapshot(runtime)
        frame = render_top(snap)
        in_top = all(_fmt_gb(snap["hbm_used"].get(nid)) in frame
                     for nid in used)
    finally:
        rt.shutdown()
        c.shutdown()
    def mib(rows):
        return sorted(round(rows[k] / 2**20, 1) for k in used if k in rows)

    phase("chaos", f"25e two llama_440m train workers (B={GANG_B} "
          f"S={TRAIN_S}, one fused step each, launches "
          f"{[s[2] for s in steps]}) on two worker node processes: "
          f"memory_stats {mib(used)} MiB; head TSDB in {tsdb_s:.2f} s "
          f"{mib(head_rows)} MiB, dashboard {mib(dash_rows)} MiB, "
          f"render_top {mib(snap['hbm_used'])} MiB, shown in its frame "
          f"{in_top}")
    if not close(dash_rows) or not close(snap["hbm_used"]) or not in_top:
        fail("25e: the dashboard or render_top disagrees with the workers' "
             "memory_stats")
    phase("chaos", f"phase 25 in {time.perf_counter() - t_phase:.1f}s; "
          f"flash launches {launches}")
    return launches


# Phase 26: the drivers of ray_tpu_torch/tools/ (the counterparts of the
# repository's profile_mfu.py, perf_sweep.py and __graft_entry__.py).
PROFILE_ARGS = ("--preset", "llama_440m", "--batch", str(TRAIN_B), "--seq",
                str(TRAIN_S), "--optimizer", "both")
# The one case whose code phases 10 and 26c do not run: the bf16 first
# moment (ClipAdamW's mu_dtype).
SWEEP_CASES = ("bf16mu-full-b8",)
# The profiler's fused tok/s over phase 10's for the same configuration.
# Its step phase allocates a new state a call (donate=False) where phase
# 10 updates in place; outside this band the profiler would be timing
# something other than the step (a missing sync, the first use counted).
TOL_PROFILE_TOKS = (0.7, 1.3)


def _profile_per_call(cfg):
    """Flash launches per call of each profiler phase at ``cfg`` (remat
    "attn": the backward never re-runs the flash forward)."""
    n = cfg.n_layers
    every = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkdv": n}
    return {"fwd": {"flash_fwd": n}, "grad": every, "step": every,
            "attn_flash": {k: 1 for k in every}, "attn_dot": {},
            "head": {}}


def drivers_phase(fa, torch, llama, train_tok_s):
    """26. The drivers: a. ``dryrun.entry()`` on the card, its logits
    finite, (4, 512, 32000) and bit-equal to a direct ``llama.forward``;
    b. ``dryrun.dryrun_multichip(device_count())`` (one card: n = 1, in
    this process), both losses in (0, 20); c. ``python -m
    ray_tpu_torch.tools.profile_mfu`` at llama_440m B=8 x S=2048 with
    both optimizers, every phase timed, the launches of each child equal
    to its calls times the launches a call, the backward and the
    optimizer update (timed alone) above 0, the fused tok/s against
    phase 10's within :data:`TOL_PROFILE_TOKS`, and the peak memory of
    one attn_dot call; d. ``python -m ray_tpu_torch.tools.perf_sweep``
    over :data:`SWEEP_CASES`.  Returns the flash launches of c's
    children."""
    from ray_tpu_torch.tools import dryrun, profile_mfu

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()

    # a. entry().
    fn, (params, tokens) = dryrun.entry()
    cfg = llama.LlamaConfig.llama_125m(max_seq_len=512, remat=False)
    logits = fn(params, tokens)
    direct = llama.forward(params, tokens, cfg)
    same = torch.equal(logits, direct)
    phase("drivers", f"26a dryrun.entry(): llama_125m logits "
          f"{tuple(logits.shape)} {logits.dtype}, finite "
          f"{bool(torch.isfinite(logits).all())}, bit-equal to "
          f"llama.forward: {same}")
    if logits.shape != (4, 512, cfg.vocab_size) or \
            not torch.isfinite(logits).all() or not same:
        fail("26a: entry()'s logits are not the forward's")
    del fn, params, tokens, logits, direct
    torch.cuda.empty_cache()

    # b. dryrun_multichip over every card of this machine.
    n = torch.cuda.device_count()
    res = dryrun.dryrun_multichip(n)
    losses = [res["dense"]["loss"], res["moe"]["loss"]]
    phase("drivers", f"26b dryrun_multichip({n}): dense loss "
          f"{losses[0]:.4f}, moe loss {losses[1]:.4f}, device "
          f"{res['device']}, in this process on "
          f"cuda:{torch.cuda.current_device()}"
          + ("" if n > 1 else "; one card: the NCCL path of n > 1 ranks, "
             "one card each, is not run on this machine (its gloo form is "
             "tests/test_torch_dryrun.py's)"))
    if res["device"] != "cuda":
        fail(f"26b: dryrun_multichip ran on {res['device']}, not the card")
    if not all(0.0 < x < 20.0 for x in losses):
        fail(f"26b: dryrun_multichip losses {losses} outside (0, 20)")

    # c. The profiler, one subprocess a phase.
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "ray_tpu_torch.tools.profile_mfu", *PROFILE_ARGS],
                       cwd=HERE, capture_output=True, text=True, timeout=900)
    profile_s = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    results = [x for x in lines if "model_params" in x]
    if r.returncode != 0 or len(results) != 2:
        fail(f"26c: profile_mfu rc {r.returncode}, {len(results)} results: "
             f"{r.stdout[-2000:]} {r.stderr[-3000:]}")
    phase("drivers", f"26c profile_mfu {' '.join(PROFILE_ARGS)}: "
          f"{profile_s:.1f}s; {json.dumps(lines[0])}")
    per_call = _profile_per_call(llama.LlamaConfig.llama_440m())
    kw = profile_mfu.timeit.__kwdefaults__
    calls = kw["warmup"] + kw["steps"]
    launches = {}
    for i, got in enumerate(results):
        opt = got["optimizer"]
        phase("drivers", f"26c {opt}: " + json.dumps(got))
        errs = [k for k in got if k.endswith("_err")]
        missing = [p for p in profile_mfu.PHASES if p + "_s" not in got]
        if errs or missing:
            fail(f"26c: {opt} phases failed {errs} or missing {missing}")
        # opt_update_s is the update timed alone; the derived opt_s
        # (step_s - grad_s) is printed, not gated: it is a difference of
        # two processes' means, within their noise of 0.
        if not got["bwd_s"] > 0 or not got.get("opt_update_s", 0) > 0:
            fail(f"26c: {opt} bwd_s {got['bwd_s']} or opt_update_s "
                 f"{got.get('opt_update_s')} out of range")
        for p in profile_mfu.PHASES:
            want = {name: k * calls for name, k in per_call[p].items()}
            if got[p + "_launches"] != want:
                fail(f"26c: {opt} {p} launched {got[p + '_launches']}, "
                     f"expected {want} ({calls} calls)")
            if i == 0 or p == "step":  # the fused run reuses the rest
                _count_into(launches, got[p + "_launches"])
    ratio = results[1]["tok_per_s"] / train_tok_s
    ok = TOL_PROFILE_TOKS[0] <= ratio <= TOL_PROFILE_TOKS[1]
    phase("drivers", f"26c fused tok/s {results[1]['tok_per_s']:.1f} / "
          f"phase 10's {train_tok_s:.1f} = {ratio:.3f} (band "
          f"{TOL_PROFILE_TOKS}) {'ok' if ok else 'OUT OF BAND'}; launches "
          f"{launches} ({calls} calls a child, as expected)")
    if not ok:
        fail("26c: the profiler's step time is not phase 10's")
    B, S = TRAIN_B, TRAIN_S
    c = llama.LlamaConfig.llama_440m()
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    q, k, v = (torch.randn((B, S, h, c.head_dim), generator=g,
                           device="cuda").to(torch.bfloat16)
               .requires_grad_() for h in (c.n_heads, c.n_kv_heads,
                                           c.n_kv_heads))
    pos = torch.arange(S, device="cuda").expand(B, S)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = torch.autograd.grad(
        llama.dot_attention(q, k, v, pos).float().sum(), (q, k, v))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    phase("drivers", f"26c one attn_dot gradient at ({B},{S},{c.n_heads},"
          f"{c.head_dim}) bf16: peak {peak / 2**30:.2f} GiB above its "
          f"inputs (scores {B * c.n_heads * S * S * 4 / 2**30:.2f} GiB in "
          f"f32)")
    del q, k, v, pos, grads
    torch.cuda.empty_cache()

    # d. The sweep.
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "ray_tpu_torch.tools.perf_sweep", *SWEEP_CASES],
                       cwd=HERE, capture_output=True, text=True, timeout=600)
    sweep = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    phase("drivers", f"26d perf_sweep {' '.join(SWEEP_CASES)}: "
          f"{time.perf_counter() - t0:.1f}s; "
          + "; ".join(json.dumps(x) for x in sweep))
    if r.returncode != 0 or [x.get("tag") for x in sweep] != \
            list(SWEEP_CASES) or any(
                "error" in x or not x.get("tps") or not x.get("mfu")
                for x in sweep):
        fail(f"26d: perf_sweep failed: {r.stdout[-2000:]} "
             f"{r.stderr[-2000:]}")
    phase("drivers", f"phase 26 in {time.perf_counter() - t_phase:.1f}s; "
          f"flash launches {launches}")
    return launches


# Phase 27: llama3_8b, the JAX package's GQA preset (32 q heads over 8 kv
# heads, an untied head over 128,256 tokens, rope theta 500,000), at full
# width.  One flash call at the preset's full length.
L3_B, L3_S = 1, 8192
L3_SHAPE = (L3_B, 32, 8, L3_S, L3_S, 128)
# The plain versions of 27a run over this many slices of the heads (each
# slice whole kv groups): the plain backward holds five (Hq, S, S) f32
# tensors at once, 43 GB at all 32 heads.
L3_PLAIN_SLICES = 4
# The engine of 27c and 27d: 8 slots of 2048 positions (bf16 K/V: 32
# layers x 2 x 8 heads x 128 x 2 B = 128 KiB a position, 2.15 GB in all);
# new tokens a request on the timed bf16 dense round and on every other.
L3_SLOTS, L3_LEN = 8, 2048
L3_SERVE_TOKENS, L3_PLANE_TOKENS = 32, 16
L3_TRAIN_STEPS = 3
# 27e's depth: the largest whose reckoned peak (l3_train_reckoning) is at
# most this share of the card's memory.  The reckoning of the fused
# AdamW's update, 28 B a param, read 71.46 GB against 71.39 reckoned at
# llama_moe_1b's train step on an H100; the share leaves room for the
# allocator's fragments and the CUDA context.
L3_MEMORY_SHARE = 0.9


def l3_train_reckoning(cfg, n_params, B, S):
    """Bytes the dense train step (fused AdamW, remat "attn", bf16
    compute, f32 params and moments) should need at its peak, the larger
    of two moments.  The backward: the state (f32 params, gradients and
    two moments, 16 B a param), the per-layer gradients that the unbind
    of ``_layers`` holds until it stacks them (4 B a layer param), what
    remat "attn" keeps a layer (its f32 input and the flash residuals q,
    k, v, o in bf16 and the f32 lse), one layer's FFN recompute and its
    gradients (h, u, silu(h), silu(h)*u in bf16, twice) and the head
    (bf16 logits, their f32 copy, the f32 and bf16 gradients).  The
    update: the state and three f32 temporaries of the params' size, 28 B
    a param.  Returns (state bytes, backward bytes, update bytes).

    At llama3_8b's width (embed, head and final norm 1,050,677,248
    params, 218,112,000 a layer) and B=1 x S=8192: the head's four
    tensors are 12.61 GB; 7 layers give 2,577,461,248 params, the
    backward 63.95 GB and the update 72.17 GB; 8 layers 78.27 GB, above
    0.9 of an 85.0 GB card.  So 27e runs 7 of the 32 layers."""
    T, H = B * S, cfg.hidden_size
    layer_params = n_params - 2 * cfg.vocab_size * H - H
    state = 16 * n_params
    kept = cfg.n_layers * T * (4 * H + 2 * (2 * cfg.q_dim + 2 * cfg.kv_dim)
                               + 4 * cfg.n_heads)
    ffn = 2 * 4 * 2 * T * cfg.intermediate_size
    head = T * cfg.vocab_size * (2 + 4 + 4 + 2)
    backward = state + 4 * layer_params + kept + ffn + head
    return state, backward, state + 12 * n_params


def by_head_slices(torch, fn, tensors, n):
    """``fn`` over ``n`` slices of the heads (dim 1) of every tensor, the
    outputs concatenated on dim 1: the plain versions compute each head
    apart, so this is the same computation in less memory."""
    outs = [fn(*(t.chunk(n, dim=1)[i] for t in tensors)) for i in range(n)]
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


# The prompt lengths of 27a's f32 check (from SERVE_LENGTHS, ragged
# against every tile).
L3_F32_LENGTHS = (77, 200)


def l3_f32_fwd_check(fa, torch):
    """27a. B1s, the f32 forward that 27c's first-token gate runs, at
    that gate's shapes: (1, 32 q heads over 8 kv heads, S, S, 128)
    causal, on (B, H, S, D) views of the model's layout, for ragged
    prompt lengths L and for the lengths the model pads them to before
    the call, against the plain forward (o and lse |d|_2/|ref|_2 <=
    TOL_F32_REL)."""
    pad = fa._PAD_MULTIPLE
    lengths = [S for L in L3_F32_LENGTHS for S in (L, -(-L // pad) * pad)]
    for i, L in enumerate(lengths):
        shape = (1, 32, 8, L, L, 128)
        q, k, v = attention_inputs(torch, shape, 272 + i, "bshd",
                                   dtype=torch.float32)
        before = dict(fa.launch_counts)
        o, lse = fa._fwd(q, k, v, True)
        ro, rl = fa._fwd_reference(q, k, v, True)
        torch.cuda.synchronize()
        counted = {n: c - before.get(n, 0)
                   for n, c in fa.launch_counts.items()
                   if c != before.get(n, 0)}
        errs = {"o": rel_err(o, ro), "lse": rel_err(lse, rl)}
        ok = (counted == {"flash_fwd_simple": 1}
              and torch.isfinite(o).all().item()
              and all(e <= TOL_F32_REL for e in errs.values()))
        phase("llama3_8b", f"27a flash_fwd_simple {shape} bshd causal f32 "
              f"(GQA group 4): o={errs['o']:.3e} lse={errs['lse']:.3e} "
              f"(|d|/|ref| <= {TOL_F32_REL}); launches {counted} "
              + ("ok" if ok else "MISMATCH"))
        if not ok:
            fail(f"27a: flash_fwd_simple disagrees with its plain version "
                 f"at {shape} f32, or launched {counted}")


def l3_kernel_phase(fa, torch):
    """27a. B1s in f32 at 27c's shapes (:func:`l3_f32_fwd_check`), then
    B1, B2 and B3 at llama3_8b's attention shape (bf16, B=1, Hq
    32 over Hkv 8, S 8192, D 128, causal; (B, H, S, D) views of the
    model's layout): B1 against its plain version (|do| <= TOL_O, |dlse|
    <= TOL_LSE), the backward through ``_FlashCore`` (k/v expanded to the
    q heads, B2, B3, dk/dv group-summed) against the plain backward on
    the expanded heads group-summed alike (each gradient's |d|_2/|ref|_2
    <= TOL_GRAD_REL); then each kernel's time against its bound, the
    plain versions' and SDPA's with ``enable_gqa=True`` (a yardstick
    only), and the whole ``_FlashCore`` backward's."""
    l3_f32_fwd_check(fa, torch)
    B, Hq, Hkv, S, _, D = L3_SHAPE
    group = Hq // Hkv
    n = L3_PLAIN_SLICES
    torch.cuda.empty_cache()
    q, k, v = attention_inputs(torch, L3_SHAPE, 270, "bshd")
    do = attention_inputs(torch, L3_SHAPE, 271, "bshd", scaled=False)[0]
    o, lse = fa._fwd(q, k, v, True)

    def plain_fwd(q, k, v):
        return fa._fwd_reference(q, k, v, True)

    o_ref, lse_ref = by_head_slices(torch, plain_fwd, (q, k, v), n)
    torch.cuda.synchronize()
    d_o = (o.float() - o_ref.float()).abs().max().item()
    d_lse = (lse - lse_ref).abs().max().item()
    ok = (torch.isfinite(o).all().item() and d_o <= TOL_O
          and d_lse <= TOL_LSE)
    phase("llama3_8b", f"27a flash_fwd {L3_SHAPE} bshd causal (GQA group "
          f"{group}): max|do|={d_o:.3e} (tol {TOL_O}) max|dlse|="
          f"{d_lse:.3e} (tol {TOL_LSE}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("27a: flash_fwd disagrees with its plain version at GQA "
             "group 4, S 8192")
    del o_ref, lse_ref

    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fa._FlashCore.apply(*ins, True), ins, do)
    ke, ve = (t.repeat_interleave(group, dim=1) for t in (k, v))

    def plain_bwd(q, k, v, o, lse, do):
        return fa._bwd_reference(q, k, v, o, lse, do, True)

    dq, dk, dv = by_head_slices(torch, plain_bwd, (q, ke, ve, o, lse, do),
                                n)
    dk, dv = (t.reshape(B, Hkv, group, S, D).sum(dim=2) for t in (dk, dv))
    torch.cuda.synchronize()
    errs = {}
    for name, g_, r in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        if g_.shape != r.shape or not torch.isfinite(g_).all():
            fail(f"27a: {name} not finite / wrong shape")
        errs[name] = grad_err(g_, r)
    ok = all(rel <= TOL_GRAD_REL for _, rel in errs.values())
    phase("llama3_8b", f"27a flash_bwd {L3_SHAPE} bshd causal via core "
          f"(expand to {Hq} heads, B2, B3, group-sum): " + " ".join(
              f"{g_}: max|d|={a:.3e} |d|/|ref|={rel:.3e}"
              for g_, (a, rel) in errs.items())
          + f" (tol |d|/|ref| <= {TOL_GRAD_REL}) "
          + ("ok" if ok else "MISMATCH"))
    if not ok:
        fail("27a: flash_bwd disagrees with its plain version at GQA "
             "group 4, S 8192")
    del got, dq, dk, dv, ins
    torch.cuda.empty_cache()

    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {"flash_fwd": time_ms(lambda: fa._fwd(q, k, v, True), reps=10)}
    plain = {"flash_fwd": time_ms(
        lambda: by_head_slices(torch, plain_fwd, (q, k, v), n), reps=2,
        rounds=3)}
    args = fa._BwdArgs(q, ke, ve, o, lse, do, True)
    _, delta = fa._bwd_dq(args)
    times["flash_bwd_dq"] = time_ms(lambda: fa._bwd_dq(args), reps=10)
    times["flash_bwd_dkdv"] = time_ms(lambda: fa._bwd_dkdv(args, delta),
                                      reps=10)
    plain["bwd"] = time_ms(lambda: by_head_slices(
        torch, plain_bwd, (q, ke, ve, o, lse, do), n), reps=2, rounds=3)
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa._FlashCore.apply(*ins, True)
    core_ms = time_ms(lambda: torch.autograd.grad(out, ins, do,
                                                  retain_graph=True),
                      reps=10)
    lib_fwd = time_ms(lambda: sdpa(q, k, v, is_causal=True, scale=1.0,
                                   enable_gqa=True), reps=10)
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    sd = sdpa(qq, kk, vv, is_causal=True, scale=1.0, enable_gqa=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        sd, (qq, kk, vv), do, retain_graph=True), reps=10)
    # B2 and B3 run on k/v expanded to the q heads: their own inputs.
    costs = {"flash_fwd": attention_cost(B, Hq, S, S, D, True,
                                         kv_heads=Hkv),
             **attention_bwd_cost(B, Hq, S, S, D, True)}
    for name, ms in times.items():
        flops, nbytes, b_ms, b_by = costs[name]
        heads = f"{Hq}/{Hkv}" if name == "flash_fwd" else f"{Hq}"
        phase("llama3_8b", f"27a {name} ({B},{heads},{S},{D}) "
              f"causal bf16: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
              f"bound {b_ms:.4f} ms ({b_by}; {flops:.3e} FLOP, "
              f"{nbytes:.3e} B; {100 * b_ms / ms:.1f}% of it)")
    phase("llama3_8b", f"27a plain forward {plain['flash_fwd']:.4f} ms, "
          f"plain backward {plain['bwd']:.4f} ms (each over {n} head "
          f"slices); _FlashCore backward (expand, B2, B3, group-sum) "
          f"{core_ms:.4f} ms against B2 + B3 "
          f"{times['flash_bwd_dq'] + times['flash_bwd_dkdv']:.4f} ms; sdpa "
          f"enable_gqa forward {lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms "
          f"(a yardstick: the port never calls it)")
    del q, k, v, do, o, lse, ke, ve, args, delta, ins, out, qq, kk, vv, sd
    torch.cuda.empty_cache()


def l3_forward_phase(fa, torch, llama):
    """27b. The full-depth forward: llama3_8b, 32 layers, bf16, B=1 x
    S=8192 on flash (32 B1 launches, finite logits) and on dot, both
    against one f32 dot reference from the same weights (f32 init, then
    freed; ``init_params`` in bf16 draws the same numbers and rounds
    them): the flash path's error may exceed dot's by TOL_ERR_RATIO at
    most (phase 5's gate).  Returns the flash forward's launches."""
    cfg = llama.LlamaConfig.llama3_8b(attention_impl="flash")
    g = torch.Generator(device="cuda")
    g.manual_seed(27)
    tokens = torch.randint(0, cfg.vocab_size, (L3_B, L3_S), generator=g,
                           device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        p32 = llama.init_params(cfg, seed=0)
        n_params = llama.param_count(p32)
        ref = llama.forward(p32, tokens, llama.LlamaConfig.llama3_8b(
            dtype=torch.float32))
        del p32
        p16 = llama.init_params(cfg, seed=0, dtype=torch.bfloat16)
        llama.forward(p16, tokens, cfg)  # warm
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        logits = llama.forward(p16, tokens, cfg)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        launches = launched(fa)
        t0 = time.perf_counter()
        dot = llama.forward(p16, tokens, llama.LlamaConfig.llama3_8b())
        torch.cuda.synchronize()
        dot_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if logits.shape != (L3_B, L3_S, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        fail("27b: llama3_8b flash logits not finite / wrong shape")
    if launches != {"flash_fwd": cfg.n_layers}:
        fail(f"27b: the forward launched {launches}, expected flash_fwd "
             f"{cfg.n_layers} times")
    errs = {}
    for name, out in (("flash", logits), ("dot", dot)):
        d = (out.float() - ref).abs()
        errs[name] = (d.max().item(), d.mean().item(),
                      (out.argmax(-1) == ref.argmax(-1)).float().mean()
                      .item())
        del d
    ratio = max(errs["flash"][0] / errs["dot"][0],
                errs["flash"][1] / errs["dot"][1])
    ok = ratio <= TOL_ERR_RATIO
    tok = L3_B * L3_S
    phase("llama3_8b", f"27b llama3_8b ({n_params} params, {cfg.n_layers} "
          f"layers) bf16 "
          f"B={L3_B} S={L3_S}: flash {fwd_s * 1e3:.1f} ms ({tok / fwd_s:.0f}"
          f" tok/s, 2N share {100 * 2 * n_params * tok / fwd_s / PEAK_BF16_FLOPS:.1f}"
          f"% of the bf16 peak), dot {dot_s * 1e3:.1f} ms, launches "
          f"{launches}, peak memory {peak / 1e9:.2f} GB (the f32 reference "
          f"included); vs the f32 dot reference: " + ", ".join(
              f"{n} max|d|={e[0]:.3e} mean|d|={e[1]:.3e} argmax agree "
              f"{e[2]:.4f}" for n, e in errs.items())
          + f"; flash/dot error ratio {ratio:.3f} (tol {TOL_ERR_RATIO}) "
          + ("ok" if ok else "MISMATCH"))
    if not ok:
        fail("27b: the llama3_8b flash forward is less accurate than dot "
             "attention")
    del logits, dot, ref, p16, tokens
    torch.cuda.empty_cache()
    return launches


def agreement(got, ref):
    """The share of positions where two runs' tokens agree."""
    pairs = [(a, b) for x, y in zip(got, ref) for a, b in zip(x, y)]
    return sum(a == b for a, b in pairs) / max(1, len(pairs))


def l3_serve_phase(fa, torch, llama, LLMServer, prompts, profile_dir):
    """27c-d. ``LLMServer(model_preset="llama3_8b", max_slots=8,
    max_len=2048)`` at full width and depth (its own f32 init, cast to
    bf16): 8 concurrent requests, TTFT min/p50/p99, decode tok/s and the
    card's busy share over a second round.  The bf16 paged planes (block
    16, the default 1025 blocks; paged, int8, fp8, spec_k=4 with the
    default 8-layer self-draft) on its weights answer the same requests:
    token agreement with the dense engine, pool bytes against the
    reckoning, prefix hits.  Then in f32: an engine whose first tokens
    equal the argmax of the f32 flash forward (B1s), and dense == paged
    == paged+spec tokens, a warm paged run == the cold one with prefix
    hits.  Returns the f32 forwards' launches."""
    from tempfile import TemporaryDirectory

    cfg = llama.LlamaConfig.llama3_8b()
    base = dict(max_slots=L3_SLOTS, max_len=L3_LEN, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = LLMServer(model_preset="llama3_8b", **base)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    try:
        outs, wall = run_requests(server, prompts, L3_SERVE_TOKENS)
        with TemporaryDirectory() as tmp:
            share = profile_run(
                lambda: run_requests(server, prompts, L3_SERVE_TOKENS),
                "llama3_8b_serve_bf16", profile_dir or tmp)
        p16 = server.params
    finally:
        server.shutdown()
    del server
    if any(len(o["tokens"]) != L3_SERVE_TOKENS for o in outs):
        fail(f"27c: LLMServer returned {[len(o['tokens']) for o in outs]} "
             f"tokens")
    ttft = [o["ttft_ms"] for o in outs]
    new = sum(len(o["tokens"]) - 1 for o in outs)
    decode = new / (wall - max(ttft) / 1e3)
    kv_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    phase("llama3_8b", f"27c LLMServer(llama3_8b, max_slots={L3_SLOTS}, "
          f"max_len={L3_LEN}) bf16: built in {init_s:.1f}s (f32 init + "
          f"cast + warm-up), peak memory {init_peak / 1e9:.2f} GB; 8 "
          f"requests x {L3_SERVE_TOKENS} tokens in {wall:.3f}s: TTFT min/"
          f"p50/p99 {min(ttft):.1f}/{percentile(ttft, 0.5):.1f}/"
          f"{percentile(ttft, 0.99):.1f} ms, decode {decode:.1f} tok/s; "
          f"card busy {100 * share:.1f}% over a second round; K/V "
          f"{kv_bytes} B a position")
    dense16 = [o["tokens"][:L3_PLANE_TOKENS] for o in outs]

    # 27d, bf16: the paged planes on the same weights.
    _, want_bytes = pool_reckoning(cfg, 1 + L3_SLOTS * (L3_LEN // 16))
    planes = {"paged": {}, "paged+int8": dict(kv_quant="int8"),
              "paged+fp8": dict(kv_quant="fp8"),
              "paged+spec": dict(spec_k=4)}
    for name, kw in planes.items():
        server = LLMServer(model_preset="llama3_8b", params=p16,
                           paged=True, block_size=16, warmup=False,
                           **base, **kw)
        # The hit counter is the process's (labelled by deployment):
        # this plane's hits are its rise over the plane's requests.
        hits0 = server.kv_stats()["ray_tpu_prefix_cache_hits"].get("llm", 0)
        try:
            outs, wall = run_requests(server, prompts, L3_PLANE_TOKENS)
            if name == "paged":
                run_requests(server, prompts[:1], L3_PLANE_TOKENS)
            stats = server.kv_stats()
        finally:
            server.shutdown()
        del server
        hits = stats["ray_tpu_prefix_cache_hits"].get("llm", 0) - hits0
        got = [o["tokens"] for o in outs]
        if any(len(t) != L3_PLANE_TOKENS for t in got):
            fail(f"27d: {name} returned {[len(t) for t in got]} tokens")
        line = (f"27d bf16 {name}: 8 requests x {L3_PLANE_TOKENS} tokens "
                f"(cold, no warm-up) in {wall:.3f}s, token agreement with "
                f"the dense engine {agreement(got, dense16):.4f}, pool "
                f"{stats['pool_bytes']} B (reckoned "
                f"{want_bytes[kw.get('kv_quant')]}), prefix hits {hits}"
                + (" (a prompt repeated)" if name == "paged" else ""))
        if "spec" in stats:
            sp = stats["spec"]
            line += (f", spec accept rate {sp['accept_rate']} "
                     f"({sp['accepted']} of {sp['proposed']})")
        phase("llama3_8b", line)
        if stats["pool_bytes"] != want_bytes[kw.get("kv_quant")]:
            fail(f"27d: {name} pool holds {stats['pool_bytes']} B, "
                 f"reckoned {want_bytes[kw.get('kv_quant')]}")
        if name == "paged" and hits < 1:
            fail("27d: a repeated prompt never hit the prefix cache")
    del p16
    torch.cuda.empty_cache()

    # 27c-d, f32: the first tokens against the forward's argmax, then
    # dense == paged == paged+spec.
    register_f32_preset(torch, llama, "llama3_8b")
    f32_cfg = llama.LlamaConfig.llama3_8b(dtype=torch.float32,
                                          attention_impl="flash")
    f32 = dict(base, model_preset="llama3_8b_f32", warmup=False)

    def tokens(server, ps):
        outs, _ = run_requests(server, ps, L3_PLANE_TOKENS)
        if any(len(o["tokens"]) != L3_PLANE_TOKENS for o in outs):
            fail(f"27d: returned {[len(o['tokens']) for o in outs]} tokens")
        return [o["tokens"] for o in outs]

    server = LLMServer(**f32)
    try:
        dense = tokens(server, prompts)
        p32 = server.params
    finally:
        server.shutdown()
    del server
    firsts = [t[0] for t in dense]
    fa.reset_launch_counts()
    with torch.no_grad():
        expect = [int(llama.forward(p32, torch.tensor([p], device="cuda"),
                                    f32_cfg)[0, -1].argmax())
                  for p in prompts]
    launches = launched(fa)
    phase("llama3_8b", f"27c llama3_8b f32 first tokens {firsts} vs the f32 "
          f"flash forward's argmax {expect}: "
          f"{'ok' if firsts == expect else 'MISMATCH'}; launches {launches}")
    if firsts != expect:
        fail("27c: LLMServer's first tokens differ from the forward's argmax")
    if launches != {"flash_fwd_simple": cfg.n_layers * len(prompts)}:
        fail(f"27c: the f32 forwards launched {launches}")
    server = LLMServer(params=p32, paged=True, block_size=16, **f32)
    try:
        cold = tokens(server, prompts)
        hits0 = server.kv_stats()["ray_tpu_prefix_cache_hits"].get("llm", 0)
        warm = tokens(server, prompts)
        hits = server.kv_stats()["ray_tpu_prefix_cache_hits"]["llm"] - hits0
    finally:
        server.shutdown()
    del server
    phase("llama3_8b", f"27d f32 paged: prefix hits on the warm run {hits}")
    gate_same("27d f32 paged == dense", cold, dense, prompts, p32, f32_cfg)
    gate_same("27d f32 paged warm == cold", warm, cold)
    if hits < 1:
        fail("27d: the warm run never hit the prefix cache")
    server = LLMServer(params=p32, paged=True, block_size=16, spec_k=4,
                       **f32)
    try:
        got = tokens(server, prompts)
        sp = server.kv_stats()["spec"]
    finally:
        server.shutdown()
    del server
    phase("llama3_8b", f"27d f32 paged+spec (self-draft, "
          f"{cfg.n_layers // 4} layers): accept rate {sp['accept_rate']} "
          f"({sp['accepted']} of {sp['proposed']})")
    gate_same("27d f32 paged+spec == dense", got, dense, prompts, p32,
              f32_cfg)
    del p32
    torch.cuda.empty_cache()
    return launches


def l3_train_phase(fa, torch, llama, kind):
    """27e. llama3_8b trained at full width through init_train_state /
    make_train_step (fused AdamW, remat "attn", flash, bf16 compute with
    f32 params and moments) at B=1 x S=8192, with the depth cut to the
    largest whose :func:`l3_train_reckoning` fits (L3_MEMORY_SHARE of
    the card): L3_TRAIN_STEPS steps, finite and falling loss, B1, B2 and
    B3 each launched n_layers times a step, peak memory against the
    reckoning, tok/s and the 6N share of the card's bf16 peak.  Returns
    the steps' launches."""
    from ray_tpu_torch.observability.device import peak_bf16_flops

    total = torch.cuda.get_device_properties(0).total_memory

    def cfg_at(n):
        return llama.LlamaConfig.llama3_8b(
            n_layers=n, attention_impl="flash", remat_policy="attn")

    def reckon(n):
        c = cfg_at(n)
        return l3_train_reckoning(c, llama.param_count(
            llama.param_shapes(c)), L3_B, L3_S)

    depth = max(n for n in range(1, 33)
                if max(reckon(n)[1:]) <= L3_MEMORY_SHARE * total)
    cfg = cfg_at(depth)
    state_b, bwd_b, update_b = reckon(depth)
    g = torch.Generator(device="cuda")
    g.manual_seed(28)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (L3_B, L3_S),
                                     generator=g, device="cuda")}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = llama.init_train_state(cfg, seed=0, fused=True)
    n_params = llama.param_count(state["params"])
    step = llama.make_train_step(cfg, fused=True)
    metrics, per_step, times = [], [], []
    for _ in range(L3_TRAIN_STEPS):
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append(launched(fa))
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"].item() for m in metrics]
    gnorms = [m["grad_norm"].item() for m in metrics]
    step_s = min(times[1:])
    tok_s = L3_B * (L3_S - 1) / step_s
    peak_flops = peak_bf16_flops(kind) or PEAK_BF16_FLOPS
    phase("llama3_8b", f"27e llama3_8b cut to {depth} of 32 layers "
          f"({n_params} params; full width) fused AdamW remat "
          f"{cfg.remat_policy!r} B={L3_B} S={L3_S}: steps "
          + "/".join(f"{t * 1e3:.1f}" for t in times)
          + f" ms, {tok_s:.0f} tok/s (best of steps 2-{L3_TRAIN_STEPS}), "
          f"mfu_6n {6 * n_params * tok_s / peak_flops:.4f} of "
          f"{peak_flops / 1e12:.0f} TFLOP/s; peak memory {peak / 1e9:.2f} "
          f"GB against the reckoning {max(bwd_b, update_b) / 1e9:.2f} GB "
          f"(backward {bwd_b / 1e9:.2f}, fused update {update_b / 1e9:.2f}"
          f", state {state_b / 1e9:.2f}; {L3_MEMORY_SHARE} of the card's "
          f"{total / 1e9:.2f} GB admits {depth} layers)")
    phase("llama3_8b", "27e losses " + " ".join(f"{x:.4f}" for x in losses)
          + "; grad norms " + " ".join(f"{x:.3f}" for x in gnorms)
          + f"; launches per step {per_step}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail("27e: llama3_8b training produced a non-finite loss or norm")
    if not losses[-1] < losses[0]:
        fail(f"27e: llama3_8b loss did not fall: {losses}")
    want = {"flash_fwd": depth, "flash_bwd_dq": depth,
            "flash_bwd_dkdv": depth}
    if any(p != want for p in per_step):
        fail(f"27e: flash kernels launched {per_step} per step, expected "
             f"{want}")
    del state, step, metrics, batch
    torch.cuda.empty_cache()
    total_launches = {}
    for p in per_step:
        _count_into(total_launches, p)
    return total_launches


def llama3_phase(fa, torch, llama, LLMServer, prompts, kind,
                 profile_dir=None):
    """27. llama3_8b (:func:`l3_kernel_phase`, :func:`l3_forward_phase`,
    :func:`l3_serve_phase`, :func:`l3_train_phase`), each part freeing
    the one before it.  Returns the main path's flash launches."""
    t_phase = time.perf_counter()
    l3_kernel_phase(fa, torch)
    launches = {}
    _count_into(launches, l3_forward_phase(fa, torch, llama))
    _count_into(launches, l3_serve_phase(fa, torch, llama, LLMServer,
                                         prompts, profile_dir))
    _count_into(launches, l3_train_phase(fa, torch, llama, kind))
    phase("llama3_8b", f"phase 27 in {time.perf_counter() - t_phase:.1f}s; "
          f"flash launches {launches}")
    return launches


# Phase 28: the bench twin (ray_tpu_torch/tools/bench.py, the counterpart
# of the repository's bench.py) as a user runs it, at bench.py's sizes on
# the card: llama_440m trained at B=8 x S=2048 (3 + 10 fused steps),
# llama_125m served at 112 slots.  The host planes run at bench.py's
# smaller sizes (--small-host: 64 MiB pulled, a 32 x 8192 x 128 shuffle,
# 32 MiB broadcast and all-reduced), so that the script stays inside its
# time limit; at the large sizes phase 28 alone took 488.5 s, most of it
# node processes' start, which the sizes do not move.
BENCH_ARGS = ("--small-host",)
BENCH_TIMEOUT_S = 600
# Keys of the bench's line that name where a phase ran, and what they
# must start with on the card.
BENCH_DEVICES = {"object_pull_tensor_device": "cuda->cuda",
                 "device_broadcast_device": "cuda",
                 "dcn_allreduce_device": "cuda"}


def _finite(v):
    return (isinstance(v, (int, float)) and not isinstance(v, bool)
            and math.isfinite(v))


def bench_phase(llama):
    """28. ``python -m ray_tpu_torch.tools.bench`` in a subprocess on the
    card, every phase: each phase's keys printed on a line of its own and
    gated present and finite (``bench.PHASE_KEYS``), no ``*_error`` key,
    the MFU in (0, 1), the train phase's flash launches 24 a step of each
    kernel (n_layers), the tensor phases on the card and raylint clean.
    Returns the train phase's flash launches."""
    from ray_tpu_torch.tools import bench

    t_phase = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "ray_tpu_torch.tools.bench",
                        *BENCH_ARGS], cwd=HERE, capture_output=True,
                       text=True, timeout=BENCH_TIMEOUT_S)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    if r.returncode != 0 or not lines:
        fail(f"28: the bench exited {r.returncode}: {r.stdout[-2000:]} "
             f"{r.stderr[-3000:]}")
    out = json.loads(lines[-1])
    seen = {"phase_s"}
    bad = []
    for name in bench.PHASES:
        keys = bench.PHASE_KEYS[name]
        seen.update(keys)
        phase("bench", f"28 {name} ({out['phase_s'].get(name)} s): "
              + ", ".join(f"{k}={out.get(k)}" for k in keys))
        bad += [k for k in keys if not _finite(out.get(k))]
    rest = {k: v for k, v in out.items() if k not in seen}
    phase("bench", "28 other keys: " + json.dumps(rest))
    errors = {k: v for k, v in out.items()
              if k == "error" or k.endswith("_error")}
    if errors or bad:
        fail(f"28: phases failed {errors} or keys missing / not finite "
             f"{bad}")
    n = llama.LlamaConfig.llama_440m().n_layers
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")
    per_step = out["train_launches_per_step"]
    serve = {k: out[k] for k in out if k.startswith("serve_flash_launches")}
    phase("bench", f"28 train launches {out['train_launches']} over "
          f"{len(out['train_losses'])} steps ({per_step} a step); serve "
          f"phases' flash launches {serve} (llama_125m's engine runs the "
          f"plain dot attention, as the reference's)")
    if per_step != {k: float(n) for k in names}:
        fail(f"28: the train phase launched {per_step} a step, expected "
             f"{n} of each of {names}")
    if not 0.0 < out["mfu"] < 1.0:
        fail(f"28: mfu {out['mfu']} outside (0, 1)")
    wrong = {k: out.get(k) for k, want in BENCH_DEVICES.items()
             if not str(out.get(k, "")).startswith(want)}
    if wrong:
        fail(f"28: tensor phases not on the card: {wrong}")
    if out["raylint_findings"] != 0:
        fail(f"28: raylint found {out['raylint_findings']}")
    phase("bench", f"phase 28 in {time.perf_counter() - t_phase:.1f}s "
          f"(the bench's own phases {sum(out['phase_s'].values()):.1f}s); "
          f"train {out['value']} tok/s, mfu {out['mfu']}")
    return out["train_launches"]


def main() -> None:
    t_script = time.perf_counter()
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
    # 6c. The paged decode kernel at the serve cell's shapes, and the paged
    # engine's decode through it.
    paged_decode = paged_decode_phase(torch, llama, LLMServer, prompts)

    # 17. The local runtime and the Serve plane on the card.
    runtime_launches = runtime_phase(fa, torch, llama, LLMServer)

    # 18. Prefill/decode disaggregation on one host.
    disagg_phase(torch, llama, LLMServer)

    # 19. Cluster mode: worker node processes on the card (the task's
    # launches are counted inside its worker process).
    cluster_launches = cluster_phase(fa, torch, llama, LLMServer)

    # 20. The DAG API, Ray Client, isolated workers, the CLI and the
    # dashboard's device trace (the DAG's stage actors and the client's
    # task run in this process).
    dag_launches = dag_client_phase(fa, torch, llama, profile_dir)

    # 21. The train runtime: TorchTrainer.fit() from a Dataset, a failure
    # and the resume from its checkpoint, in turns with the bare step.
    trainer_launches = trainer_phase(fa, torch, llama, profile_dir)

    # 22. The cross-process pipeline trainer: f32 in this process against
    # the one-piece step, bf16 across two worker node processes.
    pipe_launches = pipeline_phase(fa, torch, llama, profile_dir)

    # 23. RLlib and Tune with their learners on the card.
    rllib_phase(torch)

    # 24. A durable workflow of llama_440m resumed after a failure, the
    # autoscaler launching a GPU node for a pending task, raylint.
    wf_launches = workflow_phase(fa, torch, llama)
    auto_launches = autoscaler_phase(fa, torch, llama)
    lint_phase()

    # 25. The recovery paths: a severed pipeline boundary, a stage killed
    # mid-step, a DAG producer killed mid-pass, a Serve replica killed,
    # and the gang's memory series on every surface.
    chaos_launches = chaos_phase(fa, torch, llama)

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
    # 26. The drivers of ray_tpu_torch/tools/, against phase 10's tok/s.
    drivers_launches = drivers_phase(fa, torch, llama, tok_s)
    # 27. llama3_8b: its kernels' shape, the full-depth forward, the
    # engine on every plane, training at full width.
    l3_launches = llama3_phase(fa, torch, llama, LLMServer, prompts, kind,
                               profile_dir)
    # 28. The bench twin, bench.py's phases on the port.
    torch.cuda.empty_cache()
    bench_launches = bench_phase(llama)
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
                     + runtime_launches.get("flash_fwd", 0)
                     + cluster_launches.get("flash_fwd", 0)
                     + dag_launches.get("flash_fwd", 0)
                     + trainer_launches["flash_fwd"]
                     + pipe_launches["b"]["flash_fwd"]
                     + wf_launches["flash_fwd"]
                     + auto_launches["flash_fwd"]
                     + chaos_launches.get("flash_fwd", 0)
                     + drivers_launches["flash_fwd"]
                     + l3_launches["flash_fwd"]
                     + bench_launches["flash_fwd"]),
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}]
    for name, line, err in (("flash_bwd_dq", 216, worst_bwd["dq"]),
                            ("flash_bwd_dkdv", 264, worst_bwd["dkdv"])):
        kernels.append({
            "name": name, "route": "cuda", "design": DESIGN,
            "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
            "launches": (train_launches[name] + trainer_launches[name]
                         + pipe_launches["b"][name] + wf_launches[name]
                         + chaos_launches.get(name, 0)
                         + drivers_launches[name] + l3_launches[name]
                         + bench_launches[name]),
            "max_abs_err": err,
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
                "launches": (c1_launches[path].get(name + suffix, 0)
                             + pipe_launches["a"].get(name + suffix, 0)
                             + l3_launches.get(name + suffix, 0)),
                "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]})
    kernels.append({
        "name": "paged_decode", "route": "cuda", "design": DESIGN_PAGED,
        "source": "ray_tpu_torch/ops/csrc/paged_decode.cu",
        "replaces": "none (the JAX package's paged decode gathers in jnp)",
        "launches": paged_decode["launches"],
        "rel_err": paged_decode["err"], "ms": paged_decode["ms"],
        "plain_ms": paged_decode["plain_ms"],
        "bound_ms": paged_decode["bound_ms"],
        "bound_by": paged_decode["bound_by"],
        "library_ms": paged_decode["library_ms"]})
    for k in kernels:
        if not k["launches"]:
            fail(f"{k['name']} was not launched on its main path")
    phase("total", f"every phase passed in "
          f"{time.perf_counter() - t_script:.1f}s of the script's time")
    # The card line again, so that the output's last lines hold it too.
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()

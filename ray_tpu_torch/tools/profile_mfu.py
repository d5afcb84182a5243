"""MFU decomposition and sweep of the llama train step on the card
(counterpart of the repository's ``profile_mfu.py``).

Times the pieces of the train step separately so the gap between the
measured MFU and the peak can be attributed (forward, backward,
optimizer, the attention kernels, the head), and sweeps the knobs that
move it (remat policy, fused or chain optimizer), so the winning
configuration is reproducible from the command line.  Each phase runs
in its own subprocess: device memory held by one phase would otherwise
pile up into the next.  The parent process never touches the card
(``torch.cuda.is_initialized()`` stays False in it); ``--device-info``
reads the card's name and peak in a child.

Usage:
  python -m ray_tpu_torch.tools.profile_mfu          # preset defaults
  python -m ray_tpu_torch.tools.profile_mfu --batch 8 \\
      --remat-policy attn --remat-policy full --optimizer both  # 2x2
  python -m ray_tpu_torch.tools.profile_mfu --phases fwd,grad,step
  python -m ray_tpu_torch.tools.profile_mfu --one '<json>'   # one phase

Per configuration it prints ONE JSON line with the per-phase breakdown:
forward, backward and optimizer seconds, achieved TFLOP/s against the
card's bf16 peak for the flop-bearing phases, tok/s and the 6N MFU;
after a sweep a ``winner`` line (highest tok/s).

Phases: ``fwd`` (``loss_fn`` without grad), ``grad``
(``value_and_grad``), ``step`` (``make_train_step(donate=False)``, so
every call allocates a new state), ``attn_flash`` / ``attn_dot`` (the
gradient of one attention call at the preset's shapes, scaled by
``n_layers``) and ``head`` (the tied head's loss and its gradient).
Each phase is timed over 5 calls after 2 warm-up calls, ended by
``torch.cuda.synchronize()``.

Differences from the reference:
- each ``--one`` child line also carries ``launches``, the flash
  kernels it launched over its 7 calls (``ops/flash_attention.
  launch_counts``), which ``run_config`` keeps as ``<phase>_launches``:
  it shows that the kernels ran and not their plain versions;
- the ``step`` child also times the optimizer update alone
  (:func:`optimizer_update` on one set of gradients, 2 + ``OPT_STEPS``
  calls), kept as ``opt_update_s`` beside the reference's derived
  ``opt_s`` (``step_s - grad_s``, a difference of two processes'
  5-call means that the update's few percent of the step drown in);
- the peak is the card's (``observability/device.peak_bf16_flops``);
- ``--attn-block`` is refused: it set the TPU flash tile sizes
  (``LlamaConfig.attn_block_q/k``), which the port's config does not
  have (the kernels' tiles are fixed per kernel family);
- ``attn_flash`` calls ``flash_attention_causal`` without positions, as
  ``models.llama.forward`` does in the default layout (positions on the
  card would be checked with one host sync a call).

A spec with ``"device": "cpu"`` runs a phase on the CPU (the tests do);
otherwise a child that finds no card fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from . import checkout_env

PHASES = ["fwd", "grad", "step", "attn_flash", "attn_dot", "head"]
_MODULE = "ray_tpu_torch.tools.profile_mfu"
# Timed calls of the optimizer update alone (a few ms each on the card).
OPT_STEPS = 20


def _child(*args) -> list:
    return [sys.executable, "-m", _MODULE, *args]


def _peak_flops():
    """The card's bf16 peak for the roofline denominator and its name,
    read in a SUBPROCESS so that this process never creates a CUDA
    context; without a card (None, "cpu") and no roofline shares."""
    proc = subprocess.run(_child("--device-info"), capture_output=True,
                          text=True, timeout=600, env=checkout_env())
    for ln in proc.stdout.splitlines():
        if ln.startswith("{"):
            info = json.loads(ln)
            return info["peak"], info["kind"]
    return None, "unknown"


def _device_info():
    import torch

    from ray_tpu_torch.observability.device import peak_bf16_flops

    if not torch.cuda.is_available():
        print(json.dumps({"peak": None, "kind": "cpu"}))
        return
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"peak": peak_bf16_flops(kind), "kind": kind}))


def _sync():
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn, *args, warmup=2, steps=5):
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / steps


def _build_cfg(spec: dict):
    from ray_tpu_torch.models import llama

    preset = getattr(llama.LlamaConfig, spec.get("preset", "llama_440m"))
    return preset(**spec.get("cfg", {}))


def run_one(spec: dict):
    """Child-process entry: time one phase, print one JSON line."""
    import torch

    from ray_tpu_torch.core.device import resolve_device
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import flash_attention as fa

    phase = spec["phase"]
    batch = spec["batch"]
    seq = spec.get("seq", 2048)
    cfg = _build_cfg(spec)
    fused = spec.get("fused", False)
    dev = resolve_device(spec.get("device"))

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def normal(seed, shape):
        return torch.randn(shape, generator=gen(seed), device=dev
                           ).to(torch.bfloat16)

    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=gen(1), device=dev)
    b = {"tokens": tokens}
    before = dict(fa.launch_counts)
    extra = {}

    if phase in ("fwd", "grad", "step"):
        if phase == "step":
            state = llama.init_train_state(cfg, seed=0, fused=fused,
                                           device=dev)
            step = llama.make_train_step(cfg, donate=False, fused=fused,
                                         device=dev)
            t = timeit(lambda: step(state, b)[1]["loss"])
        else:
            params = llama.init_params(cfg, seed=0, device=dev)
            if phase == "fwd":
                def f(p):
                    with torch.no_grad():
                        return llama.loss_fn(p, b, cfg, device=dev)
            else:
                def f(p):
                    return llama.value_and_grad(p, b, cfg, device=dev)
            t = timeit(f, params)
    elif phase in ("attn_flash", "attn_dot"):
        B, S = batch, seq
        Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = normal(2, (B, S, Hq, D)).requires_grad_()
        k = normal(3, (B, S, Hkv, D)).requires_grad_()
        v = normal(4, (B, S, Hkv, D)).requires_grad_()
        if phase == "attn_flash":
            pos = None
            attn = fa.flash_attention_causal
        else:
            pos = torch.arange(S, device=dev).expand(B, S)
            attn = llama.dot_attention

        def g(q, k, v):
            return torch.autograd.grad(attn(q, k, v, pos).float().sum(),
                                       (q, k, v))

        t = timeit(g, q, k, v) * cfg.n_layers  # full depth
    elif phase == "head":
        params = llama.init_params(cfg, seed=0, device=dev)
        x = normal(5, (batch, seq, cfg.hidden_size)).requires_grad_()
        emb = params["embed_tokens"].requires_grad_()

        def head_loss(x, emb):
            logits = llama.matmul(x, emb.to(cfg.dtype).T)[:, :-1]
            logits = logits.float()
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                tokens[:, 1:][..., None]).squeeze(-1)
            return torch.mean(logz - gold)

        def g(x, emb):
            return torch.autograd.grad(head_loss(x, emb), (x, emb))

        t = timeit(g, x, emb)
    else:
        raise SystemExit(f"unknown phase {phase}")
    launches = {name: n - before[name] for name, n in
                fa.launch_counts.items() if n != before[name]}
    if phase == "step":
        # The update alone, on one set of gradients (their backward is
        # not among the launches above): step_s - grad_s is a difference
        # of two processes' 5-call means, too noisy to read an update of
        # a few percent of the step from.
        _loss, grads = llama.value_and_grad(state["params"], b, cfg,
                                            device=dev)
        extra["opt_update_s"] = round(timeit(
            optimizer_update(fused), grads, state["opt_state"],
            state["params"], steps=OPT_STEPS), 4)
    print(json.dumps({"phase": phase, "s": round(t, 4),
                      "launches": launches, **extra}))


def optimizer_update(fused: bool):
    """The optimizer part of ``make_train_step(donate=False,
    fused=fused)`` on one process's unsharded params: ``update(grads,
    opt_state, params) -> (params, opt_state, grad_norm)``."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.optim import (apply_updates,
                                           fused_adamw_update,
                                           fused_hyperparams, global_norm)

    if fused:
        hp = fused_hyperparams(3e-4)

        def update(grads, opt_state, params):
            return fused_adamw_update(grads, opt_state, params,
                                      inplace=False, **hp)
        return update
    chain = llama.default_optimizer(3e-4)

    def update(grads, opt_state, params):
        gnorm = global_norm(grads)
        updates, opt_state = chain.update(grads, opt_state, params,
                                          inplace=False)
        return apply_updates(params, updates, inplace=False), opt_state, gnorm
    return update


def _n_params(spec: dict) -> int:
    from ray_tpu_torch.models import llama

    return llama.param_count(llama.param_shapes(_build_cfg(spec)))


def run_config(spec: dict, phases, peak, seed_timings=None) -> dict:
    """All phases for one configuration (each in a subprocess), plus
    the derived breakdown: bwd/opt slices, achieved TFLOP/s and
    roofline fraction per flop-bearing phase, 6N MFU.
    ``seed_timings`` carries phase results already measured for this
    remat policy under another optimizer variant: only the step phase
    depends on the optimizer, so the sweep reuses the rest."""
    res = {"batch": spec["batch"], "preset": spec.get("preset"),
           "cfg": spec.get("cfg", {}),
           "optimizer": "fused" if spec.get("fused") else "optax"}
    for p in PHASES:
        if p != "step" and p + "_s" in (seed_timings or {}):
            res[p + "_s"] = seed_timings[p + "_s"]
            res[p + "_launches"] = seed_timings[p + "_launches"]
    phases = [p for p in phases if p + "_s" not in res]
    for phase in phases:
        proc = subprocess.run(
            _child("--one", json.dumps({**spec, "phase": phase})),
            capture_output=True, text=True, timeout=1200, env=checkout_env())
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("{")]
        if proc.returncode == 0 and lines:
            line = json.loads(lines[-1])
            res[phase + "_s"] = line["s"]
            res[phase + "_launches"] = line["launches"]
            if "opt_update_s" in line:
                res["opt_update_s"] = line["opt_update_s"]
        else:
            err = (proc.stderr or "").strip().splitlines()
            res[phase + "_err"] = err[-1][:120] if err else proc.returncode
        print(json.dumps(res), flush=True)

    n = _n_params(spec)
    toks = spec["batch"] * (spec.get("seq", 2048) - 1)
    res["model_params"] = n

    def tfs(flops_per_tok, seconds):
        return round(toks * flops_per_tok / seconds / 1e12, 1)

    # 2N fwd / 4N bwd / 6N whole-step flops per token (dense-LM
    # approximation: attention and recomputation are not counted).
    if "fwd_s" in res:
        res["fwd_tflops_per_s"] = tfs(2 * n, res["fwd_s"])
    if "fwd_s" in res and "grad_s" in res:
        res["bwd_s"] = round(res["grad_s"] - res["fwd_s"], 4)
        if res["bwd_s"] > 0:
            res["bwd_tflops_per_s"] = tfs(4 * n, res["bwd_s"])
        res["bwd_ratio"] = round(res["grad_s"] / res["fwd_s"], 2)
    if "step_s" in res:
        res["tok_per_s"] = round(toks / res["step_s"], 1)
        res["step_tflops_per_s"] = tfs(6 * n, res["step_s"])
        if "grad_s" in res:
            res["opt_s"] = round(res["step_s"] - res["grad_s"], 4)
            res["opt_pct_of_step"] = round(
                100.0 * res["opt_s"] / res["step_s"], 1)
    if peak:
        res["peak_tflops_per_s"] = round(peak / 1e12, 1)
        for key in ("fwd", "bwd", "step"):
            if key + "_tflops_per_s" in res:
                res[key + "_roofline_pct"] = round(
                    100.0 * res[key + "_tflops_per_s"] * 1e12 / peak, 1)
        if "step_s" in res:
            res["mfu_6n"] = round(toks / res["step_s"] * 6 * n / peak, 4)
    print(json.dumps(res), flush=True)
    return res


def build_parser() -> argparse.ArgumentParser:
    from ray_tpu_torch.models.llama import REMAT_POLICIES

    ap = argparse.ArgumentParser(prog=f"python -m {_MODULE}",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--preset", default="llama_440m")
    ap.add_argument("--cfg", default="{}",
                    help="extra LlamaConfig overrides (JSON)")
    ap.add_argument("--remat-policy", action="append", default=[],
                    choices=REMAT_POLICIES,
                    help="sweep value (repeatable)")
    ap.add_argument("--attn-block", action="append", default=[],
                    help="refused: TPU flash tile sizes (BQ or BQ,BK)")
    ap.add_argument("--optimizer", choices=("optax", "fused", "both"),
                    default="fused",
                    help="optimizer variant for the step phase (optax: "
                         "the optax chain's counterpart)")
    ap.add_argument("--phases", default=",".join(PHASES))
    # Legacy positional form: profile_mfu [batch] [cfg].
    ap.add_argument("legacy", nargs="*", help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.attn_block:
        ap.error("--attn-block set the TPU flash kernels' tile sizes "
                 "(LlamaConfig.attn_block_q/k); the port's LlamaConfig "
                 "has no such field: its kernels fix their tiles per "
                 "kernel family")
    if args.legacy:
        args.batch = int(args.legacy[0])
        if len(args.legacy) > 1:
            args.cfg = args.legacy[1]

    base_cfg = json.loads(args.cfg)
    phases = [p for p in args.phases.split(",") if p]
    peak, kind = _peak_flops()
    print(json.dumps({"device_kind": kind,
                      "peak_tflops_per_s":
                      round(peak / 1e12, 1) if peak else None}),
          flush=True)

    policies = args.remat_policy or [None]
    opts = {"optax": [False], "fused": [True],
            "both": [False, True]}[args.optimizer]
    results = []
    for policy in policies:
        cfg = dict(base_cfg)
        if policy is not None:
            cfg["remat_policy"] = policy
        # Only the step phase depends on the optimizer variant: the
        # first variant measures everything, the rest reuse its
        # optimizer-independent timings and re-run just "step".
        seed = None
        for fused in opts:
            spec = {"batch": args.batch, "seq": args.seq,
                    "preset": args.preset, "cfg": cfg, "fused": fused}
            res = run_config(spec, phases, peak, seed_timings=seed)
            results.append(res)
            seed = res

    done = [r for r in results if "tok_per_s" in r]
    if len(done) > 1:
        win = max(done, key=lambda r: r["tok_per_s"])
        print(json.dumps({
            "winner": {"cfg": win["cfg"], "optimizer": win["optimizer"],
                       "tok_per_s": win["tok_per_s"],
                       "mfu_6n": win.get("mfu_6n")},
            "note": "record this configuration as the preset default",
        }), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        run_one(json.loads(sys.argv[2]))
    elif len(sys.argv) > 1 and sys.argv[1] == "--device-info":
        _device_info()
    else:
        main()

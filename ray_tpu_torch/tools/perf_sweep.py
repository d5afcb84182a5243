"""Throughput sweep of the llama_440m train step on the card
(counterpart of the repository's ``perf_sweep.py``).

    python -m ray_tpu_torch.tools.perf_sweep [CASE ...]   # default: all

Each case runs in its own subprocess (device memory from one case
would otherwise be held into the next, and one failure must not poison
the rest of the sweep): 2 warm-up and 6 timed train steps at S = 2048,
ended by ``torch.cuda.synchronize()``, then ONE JSON line ``{"tag",
"tps", "mfu"}`` (``mfu`` is 6N tok/s over the card's bf16 peak,
``observability/device.peak_bf16_flops``), or ``{"tag", "error"}``.

``CASES`` is the reference's table without its three ``scan_unroll``
cases (``attn-unroll2-b8``, ``attn-unroll4-b8``, ``full-unroll2-b8``):
the port's layer stack is a Python loop, not ``lax.scan``, and its
``LlamaConfig`` has no ``scan_unroll``.  The ``bf16mu-*`` cases keep
AdamW's first moment in bf16 (``ClipAdamW(mu_dtype=torch.bfloat16)``,
optax's ``adamw(..., mu_dtype=bfloat16)`` behind
``clip_by_global_norm(1.0)``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

from . import checkout_env

SEQ = 2048
_MODULE = "ray_tpu_torch.tools.perf_sweep"

_HD128 = {"n_heads": 8, "n_kv_heads": 8, "head_dim": 128}
CASES = {
    "flash-full-b16": dict(kw={}, batch=16),
    "flash-dots-b16": dict(kw={"remat_policy": "dots"}, batch=16),
    "flash-dotssave-b16": dict(kw={"remat_policy": "dots_saveable"},
                               batch=16),
    "flash-noremat-b8": dict(kw={"remat": False}, batch=8),
    "flash-noremat-b16": dict(kw={"remat": False}, batch=16),
    "flash-full-b32": dict(kw={}, batch=32),
    "flash-full-b8": dict(kw={}, batch=8),
    "flash-full-b24": dict(kw={}, batch=24),
    "dot-full-b16": dict(kw={"attention_impl": "dot"}, batch=16),
    "bf16mu-full-b8": dict(kw={}, batch=8, bf16_mu=True),
    "bf16mu-noremat-b8": dict(kw={"remat": False}, batch=8, bf16_mu=True),
    "bf16mu-noremat-b12": dict(kw={"remat": False}, batch=12,
                               bf16_mu=True),
    "bf16mu-dotssave-b8": dict(kw={"remat_policy": "dots_saveable"},
                               batch=8, bf16_mu=True),
    "bf16mu-dotssave-b16": dict(kw={"remat_policy": "dots_saveable"},
                                batch=16, bf16_mu=True),
    "flash-dots-b8": dict(kw={"remat_policy": "dots"}, batch=8),
    "flash-dotssave-b8": dict(kw={"remat_policy": "dots_saveable"},
                              batch=8),
    "bf16mu-dots-b8": dict(kw={"remat_policy": "dots"}, batch=8,
                           bf16_mu=True),
    "bf16mu-dots-b16": dict(kw={"remat_policy": "dots"}, batch=16,
                            bf16_mu=True),
    "flash-attn-b8": dict(kw={"remat_policy": "attn"}, batch=8),
    "flash-attn-b16": dict(kw={"remat_policy": "attn"}, batch=16),
    "flash-attn-b12": dict(kw={"remat_policy": "attn"}, batch=12),
    # head_dim 128 with 8 heads (same param count as 16 x 64).
    "attn-hd128-b8": dict(kw={"remat_policy": "attn", **_HD128}, batch=8),
    "full-hd128-b8": dict(kw=dict(_HD128), batch=8),
    "attn-hd128-b12": dict(kw={"remat_policy": "attn", **_HD128},
                           batch=12),
    "attn-hd128-b16": dict(kw={"remat_policy": "attn", **_HD128},
                           batch=16),
    "bf16mu-attn-hd128-b16": dict(kw={"remat_policy": "attn", **_HD128},
                                  batch=16, bf16_mu=True),
    "bf16mu-attn-hd128-b12": dict(kw={"remat_policy": "attn", **_HD128},
                                  batch=12, bf16_mu=True),
    "attn-hd128-b10": dict(kw={"remat_policy": "attn", **_HD128},
                           batch=10),
}


def _optimizer(case):
    if not case.get("bf16_mu"):
        return None
    import torch

    from ray_tpu_torch.train.optim import ClipAdamW

    return ClipAdamW(3e-4, weight_decay=0.1, clip_norm=1.0,
                     mu_dtype=torch.bfloat16)


def run_one(tag: str, device=None) -> float:
    """Child-process entry: run one case, print one JSON line.  On the
    card unless ``device="cpu"``."""
    import torch

    from ray_tpu_torch.core.device import resolve_device
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.observability.device import peak_bf16_flops

    dev = resolve_device(device)
    case = CASES[tag]
    cfg = llama.LlamaConfig.llama_440m(**case["kw"])
    batch, seq, steps, warmup = case["batch"], SEQ, 6, 2
    opt = _optimizer(case)
    state = llama.init_train_state(cfg, optimizer=opt, device=dev)
    step = llama.make_train_step(cfg, optimizer=opt, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    b = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                 generator=g, device=dev)}
    for _ in range(warmup):
        state, m = step(state, b)
    float(m["loss"])  # host readback: the device is done
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, b)
    float(m["loss"])
    dt = time.perf_counter() - t0
    tps = batch * (seq - 1) * steps / dt
    n = llama.param_count(llama.param_shapes(cfg))
    peak = (peak_bf16_flops(torch.cuda.get_device_name(dev))
            if dev.type == "cuda" else None)
    print(json.dumps({"tag": tag, "tps": round(tps, 1),
                      "mfu": round(tps * 6 * n / peak, 4) if peak
                      else None}))
    return tps


def main(tags=None):
    tags = tags or list(CASES)
    env = checkout_env()
    for tag in tags:
        try:
            proc = subprocess.run(
                [sys.executable, "-m", _MODULE, "--one", tag],
                capture_output=True, text=True, timeout=1200, env=env)
        except subprocess.TimeoutExpired:
            print(json.dumps({"tag": tag, "error": "timeout (1200s)"}),
                  flush=True)
            continue
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("{")]
        if proc.returncode == 0 and line:
            print(line[-1], flush=True)
        else:
            err = (proc.stderr or "").strip().splitlines()
            msg = err[-1][:140] if err else f"rc={proc.returncode}"
            print(json.dumps({"tag": tag, "error": msg}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        run_one(sys.argv[2])
    else:
        main(sys.argv[1:])

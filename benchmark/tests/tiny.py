"""A cell tree at a size the CPU runs in seconds, built under a
temporary directory from the benchmark's own readers and mixes with a
tiny configuration: the tests drive whole runs through it."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

TINY = {"source": "tiny", "vocab_size": 256, "hidden_size": 64,
        "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
        "intermediate_size": 128, "max_seq_len": 512, "rope_theta": 10000.0,
        "norm_eps": 1e-5, "tie_embeddings": False, "dtype": "float32",
        "attention_impl": "flash", "remat_policy": "attn"}

TRAIN_MIX = {"driver": "train", "batch": 2, "seq": 64, "check_steps": 3,
             "optimizer": {"learning_rate": 3e-4, "b1": 0.9, "b2": 0.999,
                           "eps": 1e-8, "weight_decay": 0.1,
                           "clip_norm": 1.0},
             "prefetch_batches": 2, "min_step_s": 0.001,
             "trace": {"start_frac": 0.3, "steps": 2}}

SERVE_MIX = {"driver": "serve",
             "engine": {"paged": True, "block_size": 16, "num_blocks": None,
                        "max_slots": 4, "max_len": 128,
                        "prefill_buckets": [32, 64], "prefill_groups": [1, 4],
                        "decode_chunk": 4},
             "arrivals": {"kind": "poisson", "rate_per_s": 4.0},
             "prompt_tokens": {"kind": "lognormal", "median": 24,
                               "sigma": 0.5, "min": 8, "max": 64},
             "output_tokens": {"kind": "lognormal", "median": 8,
                               "sigma": 0.5, "min": 4, "max": 16},
             "order_seed": 0, "token_min": 3, "check_requests": 3, "drain_s": 30,
             "trace": {"start_frac": 0.2, "seconds": 0.5, "tail_s": 0.2}}

LIMITS = {"train.tiny.t": {"loss_gap": 1e-4, "grad_norm_gap": 1e-3,
                           "first_grad_gap": 1e-3, "change_gap": 1e-3},
          "serve.tiny.s": {"failed_requests": 0, "served_logit_gap": 1e-3}}


def make_tree(root: Path) -> Path:
    """BENCHMARK.json and benchmark/ under ``root`` with the tiny cells
    ``train.tiny.t`` and ``serve.tiny.s``; returns ``root``."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    b = root / "benchmark"
    shutil.copytree(HERE / "metrics", b / "metrics")
    (b / "configs").mkdir()
    (b / "traffic").mkdir()
    (b / "cells").mkdir()
    (b / "configs" / "tiny.json").write_text(json.dumps(TINY))
    (b / "traffic" / "t.json").write_text(json.dumps(TRAIN_MIX))
    (b / "traffic" / "s.json").write_text(json.dumps(SERVE_MIX))
    for cell, lim in LIMITS.items():
        (b / "cells" / f"{cell}.json").write_text(json.dumps(
            {"limits": {k: {"limit": v} for k, v in lim.items()}}))
    bench["configs"].append({"name": "tiny", "source": "tiny",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "tests"})
    for name, traffic in (("train.tiny.t", "t"), ("serve.tiny.s", "s")):
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": traffic, "chips": 1,
                                   "why": "tests"})
        kind = name.split(".")[0]
        for m in bench["end_to_end"] + bench["per_layer"]:
            ws = m.get("workloads")
            if ws and any(w.startswith(kind + ".") for w in ws):
                ws.append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root

"""Readings that set a cell's limits (``benchmark/cells/<cell>.json``):
the program's numbers over many seeds (the lower readings), and on a few
seeds those of the control, the reference computed in float8 in the
program's place (the upper readings), and of the faults that the cell
can have, planted in the reference put in the program's place.

    python3 -m benchmark.controls --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 15] [--out FILE]

Each seed is one run of the cell's driver with a short window (long
enough, at the cell's own load, to finish the mix's longest requests),
all in one process.  Prints one JSON line a seed, and all of them to
``--out``.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import cells, check, run, weights


def _train_controls(cell, seed, rec, torch, dev) -> dict:
    from .drivers.train import check_rows
    from .reference import train as ref_train

    cfg, mix = cell.config, cell.mix
    rows = check_rows(torch, rec["rows"], mix, dev)
    ref = rec["reference"]
    out = {}
    init = weights.make_params(cfg, seed, torch.float32, dev)
    low = ref_train.follow(init, rows, cfg, mix["optimizer"], fp8=True)
    out["control"] = {n.name: n.value for n in
                      check.train_numbers(low, ref, cell)}
    # Half of the batch left out, the mean taken over the rest: with one
    # row, the second half of its targets.
    B, S = mix["batch"], mix["seq"]
    mask = torch.zeros(B, S - 1, device=dev)
    mask[:, :(S - 1) // 2] = 1
    half = ref_train.follow(init, rows, cfg, mix["optimizer"], mask=mask)
    out["half_batch"] = {n.name: n.value for n in
                         check.train_numbers(half, ref, cell)}
    # A step that returns its state unchanged: no change at all.
    still = dict(ref, change={k: 0.0 for k in ref["change"]})
    out["state_unchanged"] = {n.name: n.value for n in
                              check.train_numbers(still, ref, cell)}
    del init
    return out


def _serve_controls(cell, seed, rec, torch, dev) -> dict:
    from .reference import serve as ref_serve

    cfg = cell.config
    params = weights.make_params(cfg, seed, getattr(torch, cfg["dtype"]),
                                 dev)
    low = ref_serve.control_gaps(params, rec["sample"], cfg, dev)
    # A token altered where it is produced: each sampled request's
    # served tokens with one replaced by the reference's worst.
    altered = []
    for r in rec["sample"]:
        lg = ref_serve.served_logits(params, r["prompt"], r["tokens"], cfg,
                                     dev)
        j = len(r["tokens"]) // 2
        toks = list(r["tokens"])
        toks[j] = int(lg[j].argmin())
        altered.append(ref_serve.served_gap(params, r["prompt"], toks, cfg,
                                            dev))
    del params
    return {"control": {"served_logit_gap": max(low)},
            "token_altered": {"served_logit_gap": max(altered)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    run.set_environment()
    import torch

    cell = cells.load(args.workload)
    dev = torch.device("cuda")
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    lines = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.time()
        ctx = check.Context(cell, seed, args.seconds, False, "cuda", t0)
        outcome = cells.driver(cell).run(ctx)
        line = {"seed": seed, "program": {n.name: n.value
                                          for n in outcome.numbers},
                "end_to_end": outcome.end_to_end,
                "memory_peak_bytes": outcome.memory_peak_bytes}
        if seed in control_seeds:
            kind = {"train": _train_controls,
                    "serve": _serve_controls}[cell.driver]
            line.update(kind(cell, seed, outcome.record, torch, dev))
        line["seconds"] = time.time() - t0
        del outcome
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        print(json.dumps(line), flush=True)
        lines.append(line)
        if args.out:
            with open(args.out, "w") as f:
                f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

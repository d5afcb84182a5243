"""The rate sweep that fixes a serve cell's rate: one engine, built once,
under the cell's mix at each rate in turn (a window, then its drain).

    python3 -m benchmark.sweep --workload <cell> --seed <n> \
        --rates 0.5,0.7,0.9 [--seconds 51]

For each rate it prints one JSON line: requests, failed, TTFT p50/p90,
TPOT p90, output tokens/s, and the backlog's trend: the median TTFT of
the requests due in the window's last third over that of its middle
third (the first third, which starts on an empty engine, is left out).
The trend stays near 1 while the engine keeps up and grows with a
backlog.  The knee is the highest rate of the ascending sweep up to
which every rate has a trend of at most ``TREND_MAX`` and nothing
failed; the sweep stops at the first rate past it and prints the knee
and the cell's rate, ``CELL_SHARE`` of it, as its last line.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import sys
import time

from . import cells, check, run, stats, traffic
from .drivers import serve

TREND_MAX = 1.5
CELL_SHARE = 0.8


def backlog_trend(stream, ttft, seconds: float):
    """Median TTFT of the requests due in the last third of the window
    over that of the middle third; None where a third has none."""
    third = seconds / 3
    mid = [t for r, t in zip(stream, ttft)
           if t is not None and third <= r.due_s < 2 * third]
    late = [t for r, t in zip(stream, ttft)
            if t is not None and r.due_s >= 2 * third]
    if not mid or not late:
        return None
    return statistics.median(late) / statistics.median(mid)


def knee(lines) -> float:
    """The highest rate up to which every line of the ascending sweep
    kept up (trend at most ``TREND_MAX``, nothing failed); 0 if none."""
    best = 0.0
    for line in sorted(lines, key=lambda x: x["rate_per_s"]):
        trend = line["backlog_trend"]
        if line["failed"] or trend is None or trend > TREND_MAX:
            break
        best = line["rate_per_s"]
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    args = p.parse_args(argv)
    run.set_environment()
    cell = cells.load(args.workload)
    ctx = check.Context(cell, args.seed, args.seconds, False, "cuda",
                        time.time())
    server = serve.build_server(ctx)
    mix = cell.mix
    lines = []
    try:
        rates = sorted(float(r) for r in args.rates.split(","))
        for i, rate in enumerate(rates):
            stream = traffic.serve_stream(mix, args.seed + i, args.seconds,
                                          cell.config["vocab_size"], rate)
            t_open = time.perf_counter()
            results, lateness = asyncio.run(serve._drive(
                server, stream, t_open, args.seconds, mix["drain_s"]))
            s = serve.summarize(stream, results, t_open, args.seconds,
                                mix["drain_s"])
            errors = [r["error"] for r in results if r and "error" in r]
            if errors:
                print(f"sweep: first of {len(errors)} errors: {errors[0]}",
                      file=sys.stderr, flush=True)
            line = {
                "rate_per_s": rate, "requests": len(stream),
                "failed": s["failed"],
                "ttft_p50_ms": 1e3 * stats.tail(s["ttft"], 0.5,
                                                args.seconds + mix["drain_s"]),
                "serve_ttft_p90_ms": s["serve_ttft_p90_ms"],
                "serve_tpot_p90_ms": s["serve_tpot_p90_ms"],
                "serve_output_tokens_per_s": s["serve_output_tokens_per_s"],
                "backlog_trend": backlog_trend(stream, s["ttft"],
                                               args.seconds),
                "late_max_ms": 1e3 * max((x for x in lateness if x is not None),
                                         default=0.0),
                "drain_s": time.perf_counter() - t_open - args.seconds}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if knee(lines) < rate:
                break
        k = knee(lines)
        print(json.dumps({"knee_per_s": k, "trend_max": TREND_MAX,
                          "cell_rate_per_s": CELL_SHARE * k}), flush=True)
    finally:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

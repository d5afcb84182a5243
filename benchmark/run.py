"""Run one cell of the benchmark and print its result as the last line
of standard output.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is found by name in ``BENCHMARK.json`` (``cells.py``).  The
run needs as many CUDA cards as the cell asks for; without them it
prints no result and exits 3.  With ``--trace 0`` the result's metrics
are the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from one profiler capture of a steady slice.  The numbers
that decide ``correct`` are printed beside their limits as the last
lines of standard error and under ``check``, the result's last key.  If
JAX, its libraries or the JAX package are loaded in this process once
the window has closed, the run prints no result and exits 4.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# Top-level module names that may not be loaded: JAX, its libraries and
# the JAX package (compared whole: the port's name begins with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def set_environment() -> None:
    """Every cache a run may write, at fixed paths inside the checkout;
    no shared-memory files; no JAX behind a library's back."""
    cache = CHECKOUT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "cuda"))
    os.environ["RAY_TPU_OBJECT_SHM_DIRECTORY"] = ""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float) -> dict:
    """Run ``cell`` once and return the result object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
    ``breakdown``, and ``check`` last)."""
    import torch

    from . import cells
    from .check import Context

    ctx = Context(cell, seed, seconds, trace, device, t_start)
    out = cells.driver(cell).run(ctx)
    metrics = {}
    units = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] in out.end_to_end:
                metrics[m["name"]] = out.end_to_end[m["name"]]
                units[m["name"]] = m["unit"]
    else:
        for m in cell.per_layer:
            value = cells.reader(cell, m["name"])(out.record)
            if value is not None:
                metrics[m["name"]] = value
                units[m["name"]] = m["unit"]
    on_card = device == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": all(n.ok for n in out.numbers) and not out.failed,
              "attempted": out.attempted, "failed": out.failed,
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in metrics.items()},
              "device": dev}
    captured = out.record.get("trace")
    if trace and captured is not None:
        lo, hi = captured.window()
        dev["busy_s"] = captured.busy_s(lo, hi)
        dev["window_s"] = hi - lo
        result["breakdown"] = captured.breakdown(lo, hi)
    result["check"] = {n.name: {"value": n.value, "limit": n.limit}
                       for n in out.numbers}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_environment()
    from . import cells

    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process: {bad}", file=sys.stderr)
        return 4
    for name, n in result["check"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

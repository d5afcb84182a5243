"""Time this checkout's flash-attention kernels against another
checkout's, in turns, on one card.

    python -m ray_tpu_torch.tools.kernel_ab --parent DIR

``DIR`` is the root of another checkout of this repository (for example
an earlier commit unpacked with ``git archive``).  Its ``flash_fwd.cu``
and ``flash_bwd.cu`` are built with nvcc into ``DIR/ray_tpu_torch/ops/
_build/`` beside this checkout's, and loaded with the C signatures of
this checkout's wrappers, which both must share.  At the main path's
shapes, causal bf16 on (B, H, S, D) views of (B, S, H, D) tensors, it
holds each version of B1 (forward), B2 (dq, with its delta pre-pass), B3
(dk/dv) and the B2 + B3 pair as ``_bwd_impl`` runs it against the plain
versions (the backward by |got - ref|_2 / |ref|_2 of each gradient),
then times them in the order parent, change, change, parent (each
reading the median of 5 rounds of 20 launches by CUDA events), prints
one line per kernel and shape, and a JSON object last.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops import _build
from ..ops import flash_attention as fa

SHAPE_FWD = ((4, 8, 2048, 128), (8, 8, 2048, 128))
SHAPE_BWD = (8, 8, 2048, 128)


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
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


def build_parent(parent: Path) -> dict:
    """Build the other checkout's two kernel libraries (one nvcc each, in
    parallel) and load them with this checkout's signatures."""
    csrc = parent / "ray_tpu_torch" / "ops" / "csrc"
    out_dir = parent / "ray_tpu_torch" / "ops" / "_build"
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(name):
        so = out_dir / f"lib{name}_parent.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{csrc}", "-o",
               str(so), str(csrc / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n"
                               f"{proc.stderr}")
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in fa._LIBS[name][1].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        return name, lib

    with ThreadPoolExecutor(len(fa._LIBS)) as pool:
        return dict(pool.map(one, fa._LIBS))


@contextlib.contextmanager
def using(libs):
    """Route the wrappers to ``libs`` ({name: CDLL}); None: this
    checkout's own."""
    real = fa._lib
    if libs is not None:
        fa._lib = lambda name: libs[name]
    try:
        yield
    finally:
        fa._lib = real


def inputs(shape, seed):
    B, H, S, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn():
        return torch.randn(B, S, H, D, generator=g, device="cuda"
                           ).to(torch.bfloat16).transpose(1, 2)

    return randn() * D ** -0.5, randn(), randn(), randn()


def in_turns(fn_for):
    """Readings in the order parent, change, change, parent."""
    return [(v, time_ms(fn_for(v)))
            for v in ("parent", "change", "change", "parent")]


def report(r):
    """Add the parent/change ratio of the mean times to result ``r`` and
    print its line."""
    ms = {v: [t for n, t in r["ms"] if n == v] for v in ("parent", "change")}
    r["speedup"] = statistics.mean(ms["parent"]) / statistics.mean(
        ms["change"])
    print(f"[ab] {r['kernel']} {r['shape']} causal bf16 (B,S,H,D) views: "
          + ", ".join(f"{n} {t:.4f}" for n, t in r["ms"])
          + f" ms (parent, change, change, parent); parent/change "
          f"{r['speedup']:.3f}; check vs plain {r['check']}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the checkout to compare against")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(smi[0] if smi else torch.cuda.get_device_name(0), flush=True)
    fa.build_kernels()
    versions = {"parent": build_parent(args.parent.resolve()),
                "change": None}
    results = []

    for shape in SHAPE_FWD:
        q, k, v, _ = inputs(shape, 7)
        ro, rl = fa._fwd_reference(q, k, v, True)
        errs = {}
        for name, libs in versions.items():
            with using(libs):
                o, lse = fa._fwd(q, k, v, True)
            errs[name] = ((o.float() - ro.float()).abs().max().item(),
                          (lse - rl).abs().max().item())

        def fn_for(name):
            libs = versions[name]

            def run():
                with using(libs):
                    fa._fwd(q, k, v, True)
            return run

        results.append({"kernel": "flash_fwd", "shape": shape,
                        "check": errs, "ms": in_turns(fn_for)})
        report(results[-1])
        del q, k, v, ro, rl

    q, k, v, do = inputs(SHAPE_BWD, 8)
    o, lse = fa._fwd(q, k, v, True)
    bargs = fa._BwdArgs(q, k, v, o, lse, do, True)
    _, delta = fa._bwd_dq(bargs)
    refs = fa._bwd_reference(q, k, v, o, lse, do, True)
    # B2 (with its delta pre-pass), B3 on this checkout's delta, and the
    # pair as _bwd_impl runs it; each checked against the plain version.
    bwd = {"flash_bwd_dq": (lambda: fa._bwd_dq(bargs)[:1], refs[:1]),
           "flash_bwd_dkdv": (lambda: fa._bwd_dkdv(bargs, delta), refs[1:]),
           "flash_bwd_impl": (
               lambda: fa._bwd_impl(q, k, v, o, lse, do, True), refs)}
    for kernel, (call, ref) in bwd.items():
        errs = {}
        for name, libs in versions.items():
            with using(libs):
                got = call()
            errs[name] = tuple(((g - r).norm() / r.norm()).item()
                               for g, r in zip(got, ref))

        def fn_for_bwd(name, call=call):
            libs = versions[name]

            def run():
                with using(libs):
                    call()
            return run

        results.append({"kernel": kernel, "shape": SHAPE_BWD,
                        "check": errs, "ms": in_turns(fn_for_bwd)})
        report(results[-1])

    print(json.dumps({"card": smi[0] if smi else None, "results": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time this checkout's flash-attention kernels against another
checkout's, in turns, on one card.

    python -m ray_tpu_torch.tools.kernel_ab --parent DIR [--family simple]

``DIR`` is the root of another checkout of this repository (for example
an earlier commit unpacked with ``git archive``).  Its kernel sources
(``flash_fwd.cu``, ``flash_bwd.cu`` and, where it has one,
``flash_simple.cu``) are built with nvcc into ``DIR/ray_tpu_torch/ops/
_build/`` beside this checkout's, and loaded with the C signatures of
this checkout's wrappers, which both must share.

``--family wgmma`` (the default): at the main path's shapes, causal bf16
on (B, H, S, D) views of (B, S, H, D) tensors, it holds each version of
B1 (forward), B2 (dq, with its delta pre-pass), B3 (dk/dv) and the B2 +
B3 pair as ``_bwd_impl`` runs it against the plain versions (the
backward by |got - ref|_2 / |ref|_2 of each gradient).

``--family simple``: the simple CUDA-core family in f32 at (4, 8, 2048,
128) on the same views, causal and not: each version of B1s, B2s and
B3s against the plain versions (every output |got - ref|_2 / |ref|_2 <=
1e-5), then, as the yardstick, PyTorch's SDPA in f32 on the same inputs
(forward, and its backward for dq, dk and dv together), with the device
kernels the profiler saw it launch and its own error against the plain
f32 forward, so that the yardstick is known to be f32 and not TF32.

Each kernel is then timed in the order parent, change, change, parent
(each reading the median of 5 rounds of 20 launches by CUDA events); the
tool prints one line per kernel and shape, and a JSON object last.
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
SHAPE_SIMPLE = (4, 8, 2048, 128)
# The simple family against the plain versions in f32: both sum f32
# products of the same inputs in another order.
TOL_F32_REL = 1e-5
PEAK_F32_FLOPS = 67e12  # one H100 SXM outside the tensor cores


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
    """Build the other checkout's kernel libraries, those whose source it
    has (one nvcc each, in parallel), and load them with this checkout's
    signatures of the functions they export."""
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
            if hasattr(lib, fn):  # an older parent lacks later variants
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
        return name, lib

    names = [n for n in fa._LIBS if (csrc / f"{n}.cu").exists()]
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(pool.map(one, names))


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


def inputs(shape, seed, dtype=torch.bfloat16):
    B, H, S, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn():
        return torch.randn(B, S, H, D, generator=g, device="cuda"
                           ).to(dtype).transpose(1, 2)

    return randn() * D ** -0.5, randn(), randn(), randn()


def in_turns(fn_for):
    """Readings in the order parent, change, change, parent."""
    return [(v, time_ms(fn_for(v)))
            for v in ("parent", "change", "change", "parent")]


@contextlib.contextmanager
def sm_clocks(out: list):
    """Samples the card's SM clock (MHz) every 100 ms while the block
    runs (nvidia-smi), into ``out``; nothing if nvidia-smi is missing."""
    try:
        proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-lms", "100"], stdout=subprocess.PIPE, text=True)
    except OSError:
        yield
        return
    try:
        yield
    finally:
        proc.terminate()
        text = proc.communicate()[0]
        out.extend(int(x) for x in text.split() if x.isdigit())


def report(r, what="causal bf16"):
    """Add the parent/change ratio of the mean times to result ``r`` and
    print its line."""
    ms = {v: [t for n, t in r["ms"] if n == v] for v in ("parent", "change")}
    r["speedup"] = statistics.mean(ms["parent"]) / statistics.mean(
        ms["change"])
    extra = "".join(f"; {key} {r[key]}" for key in ("bound_ms", "sdpa_ms",
                                                     "sm_mhz") if key in r)
    print(f"[ab] {r['kernel']} {r['shape']} {what} (B,S,H,D) views: "
          + ", ".join(f"{n} {t:.4f}" for n, t in r["ms"])
          + f" ms (parent, change, change, parent); parent/change "
          f"{r['speedup']:.3f}; check vs plain {r['check']}{extra}",
          flush=True)


def sdpa_backend(fn):
    """The device kernels one call of ``fn`` launches, as torch.profiler
    sees them (their names say which SDPA backend ran and whether it used
    the tensor cores), or a note that it saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if getattr(e, "self_device_time_total", 0) > 0})
    except Exception as e:  # the profiler is a reading, not a gate
        return [f"profiler failed: {type(e).__name__}: {e}"]
    return names or ["the profiler saw no device kernel"]


def f32_bound_ms(kernel, B, H, S, D, causal):
    """The least time (ms) of ``kernel``'s FLOP at the f32 peak (its
    bytes take ~0.03 ms at this shape): 4, 6 (+ the delta pre-pass) and 8
    D pairs for B1s, B2s and B3s."""
    pairs = S * (S + 1) // 2 if causal else S * S
    units = {"flash_fwd_simple": 4, "flash_bwd_dq_simple": 6,
             "flash_bwd_dkdv_simple": 8}[kernel]
    flops = units * B * H * D * pairs + (
        2 * B * H * S * D if kernel == "flash_bwd_dq_simple" else 0)
    return flops / PEAK_F32_FLOPS * 1e3


def run_simple(versions):
    """B1s, B2s and B3s in f32 at SHAPE_SIMPLE, causal and not: checked,
    then timed in turns beside SDPA in f32.  Returns the results."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 oracle
    torch.backends.cudnn.allow_tf32 = False
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, H, S, D = SHAPE_SIMPLE
    results = []
    for causal in (True, False):
        q, k, v, do = inputs(SHAPE_SIMPLE, 9, torch.float32)
        ro, rl = fa._fwd_reference(q, k, v, causal)
        o, lse = fa._fwd(q, k, v, causal)
        bargs = fa._BwdArgs(q, k, v, o, lse, do, causal)
        _, delta = fa._bwd_dq(bargs)
        refs = fa._bwd_reference(q, k, v, o, lse, do, causal)
        calls = {
            "flash_fwd_simple": (lambda: fa._fwd(q, k, v, causal),
                                 (ro, rl)),
            "flash_bwd_dq_simple": (lambda: fa._bwd_dq(bargs)[:1],
                                    refs[:1]),
            "flash_bwd_dkdv_simple": (lambda: fa._bwd_dkdv(bargs, delta),
                                      refs[1:])}
        # The yardstick: SDPA in f32 on the same views, forward and its
        # backward (dq, dk, dv together).
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        sd = sdpa(qq, kk, vv, is_causal=causal, scale=1.0)
        sdpa_err = ((sd.detach() - ro).norm() / ro.norm()).item()
        fwd_names = sdpa_backend(lambda: sdpa(q, k, v, is_causal=causal,
                                              scale=1.0))
        bwd_names = sdpa_backend(lambda: torch.autograd.grad(
            sd, (qq, kk, vv), do, retain_graph=True))
        sdpa_ms = {"forward": time_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                                   scale=1.0)),
                   "backward": time_ms(lambda: torch.autograd.grad(
                       sd, (qq, kk, vv), do, retain_graph=True))}
        print(f"[ab] sdpa f32 {SHAPE_SIMPLE} causal={causal}: forward "
              f"{sdpa_ms['forward']:.4f} ms, backward (dq, dk, dv) "
              f"{sdpa_ms['backward']:.4f} ms; o |d|/|ref| vs the plain f32 "
              f"forward {sdpa_err:.3e}; forward kernels {fwd_names}; "
              f"backward kernels {bwd_names}", flush=True)
        results.append({"kernel": "sdpa_f32", "shape": SHAPE_SIMPLE,
                        "causal": causal, "ms": sdpa_ms,
                        "o_rel_err": sdpa_err, "forward_kernels": fwd_names,
                        "backward_kernels": bwd_names})
        for kernel, (call, ref) in calls.items():
            errs = {}
            for name, libs in versions.items():
                with using(libs):
                    got = call()
                errs[name] = tuple(((g - r).norm() / r.norm()).item()
                                   for g, r in zip(got, ref))
                if max(errs[name]) > TOL_F32_REL:
                    raise SystemExit(f"FAIL: {name}'s {kernel} causal="
                                     f"{causal} disagrees with its plain "
                                     f"version: {errs[name]}")

            def fn_for(name, call=call):
                libs = versions[name]

                def run():
                    with using(libs):
                        call()
                return run

            clocks = []
            with sm_clocks(clocks):
                ms = in_turns(fn_for)
            r = {"kernel": kernel, "shape": SHAPE_SIMPLE, "causal": causal,
                 "check": errs, "ms": ms,
                 "sm_mhz": (min(clocks), statistics.median(clocks),
                            max(clocks)) if clocks else None,
                 "bound_ms": f32_bound_ms(kernel, B, H, S, D, causal),
                 "sdpa_ms": sdpa_ms["forward" if kernel == "flash_fwd_simple"
                                    else "backward"]}
            results.append(r)
            report(r, f"causal={causal} f32")
        del q, k, v, do, o, lse, bargs, delta, refs, qq, kk, vv, sd
        torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the checkout to compare against")
    ap.add_argument("--family", choices=("wgmma", "simple"),
                    default="wgmma", help="which kernel family to time")
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
    if args.family == "simple":
        results = run_simple(versions)
        print(json.dumps({"card": smi[0] if smi else None,
                          "results": results}), flush=True)
        return 0
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

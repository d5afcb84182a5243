"""The ``train`` driver: the port's fused train step on one card, fed
through the Data plane, for a fixed window.

Set-up builds one train state from the seed's weights
(``llama.init_train_state(fused=True)`` with the harness's params put
in, as ``tools/bench.py`` ``_train_phase`` does) and one step
(``llama.make_train_step(fused=True)``), starts the runtime and the feed
(``iter_batches(device_put=True)``, one batch ahead), and drives the
step through its first ``check_steps`` steps: those are the warm-up and
the steps the reference follows.  The window then runs the same step on
the same feed.  After the window the state is freed and the reference
follows the first steps from the same weights and rows.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

from .. import check, trace as tr, traffic, weights
from . import config_fields

# Captures a traced run may take before it gives up on its slice.
TRACE_TRIES = 3


def _leaf_norms(torch, cfg: Dict, tree: Dict, scale: float = 1.0) -> Dict:
    """Each leaf's norm as a device scalar (no host sync)."""
    return {path: torch.linalg.vector_norm(
        weights.leaf(tree, path).float()) * scale
        for path, _shape, _fan in weights.leaf_specs(cfg)}


def _read(ctx: check.Context, capture, n: int, start_s: float,
          misses: list):
    """Stop capture ``n`` and read it; the trace, or None (the reason
    appended to ``misses``) where it holds no slice with work in it."""
    t0 = time.perf_counter()
    try:
        capture.stop()
        stop_s = time.perf_counter() - t0
        trace = tr.read_capture(capture)
        lo, hi = trace.window()
        if not trace.busy_s(lo, hi) > 0.0:
            raise tr.CaptureError("no device operation in the slice")
    except Exception as e:  # noqa: BLE001 - the run tries again
        tr.quiet_stop(capture)
        misses.append(f"capture {n} read nothing: {e!r}")
        ctx.log(f"trace: {misses[-1]}")
        return None
    ctx.log(f"trace: capture {n}: recording started in {start_s * 1e3:.3f}"
            f" ms and stopped in {stop_s:.3f} s; slice {hi - lo:.4f} s")
    return trace


def check_rows(torch, rows, mix: Dict, dev):
    """The rows of the first steps, (steps, B, S) on the device."""
    B, S, n = mix["batch"], mix["seq"], mix["check_steps"]
    return torch.as_tensor(rows[:n * B], device=dev).view(n, B, S)


def run(ctx: check.Context) -> check.Outcome:
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.models import llama

    from ..reference import train as ref_train

    cfg, mix = ctx.cell.config, ctx.cell.mix
    opt = mix["optimizer"]
    dev = torch.device(ctx.device)
    on_card = dev.type == "cuda"
    B, S, n_check = mix["batch"], mix["seq"], mix["check_steps"]
    lcfg = llama.LlamaConfig(**config_fields(llama, torch, cfg))

    state = llama.init_train_state(lcfg, fused=True, device=dev)
    state["params"] = weights.make_params(cfg, ctx.seed, torch.float32, dev)
    step = llama.make_train_step(lcfg, fused=True,
                                 learning_rate=opt["learning_rate"],
                                 device=dev)
    max_steps = n_check + int(ctx.seconds / mix["min_step_s"]) + 2
    rows = traffic.train_rows(ctx.seed, max_steps * B, S, cfg["vocab_size"])

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def mark():
        """A bound of the traced slice on the card's timeline."""
        if on_card:
            torch.cuda._sleep(1)

    ray_tpu_torch.init(num_gpus=0)
    capture, start_s, trace = None, None, None
    try:
        ds = rd.from_blocks([{"tokens": rows[i:i + B]}
                             for i in range(0, len(rows), B)])
        it = ds.iter_batches(batch_size=B, drop_last=True,
                             prefetch_batches=mix["prefetch_batches"],
                             device_put=True, device=dev)
        # The first steps: warm-up, and what the reference follows.
        losses, gnorms, first = [], [], None
        for i in range(n_check):
            state, m = step(state, next(it))
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
            if i == 0:
                # mu after one step is (1 - b1) x the clipped gradient.
                first = _leaf_norms(torch, cfg, state["opt_state"].mu,
                                    1.0 / (1.0 - opt["b1"]))
        sync()
        t_book = time.perf_counter()
        change = {}
        for path, p0 in weights.iter_leaves(cfg, ctx.seed, torch.float32,
                                            dev):
            change[path] = float(torch.linalg.vector_norm(
                weights.leaf(state["params"], path) - p0))
            del p0
        losses = [float(x) for x in losses]
        gnorms = [float(x) for x in gnorms]
        first = {k: float(v) for k, v in first.items()}
        book_s = time.perf_counter() - t_book

        # The window.  A traced run reads its rate from the steps before
        # its first capture.  From then on it takes up to TRACE_TRIES
        # captures of the mix's slice, each read as soon as it stops,
        # until one holds its slice (CUPTI has been seen to record
        # nothing in a capture); a capture under way runs to its end
        # past the window's close.
        sync()
        t_open = time.perf_counter()
        setup_s = time.time() - ctx.t_start - book_s
        waits, inflight = [], []
        steps = 0
        tcfg = mix["trace"]
        cap_at = t_open + ctx.seconds * tcfg["start_frac"]
        cap_left, tries, misses = None, 0, []
        pre_steps, pre_s = None, None
        while time.perf_counter() - t_open < ctx.seconds \
                or cap_left is not None:
            if ctx.trace and trace is None and cap_left is None \
                    and tries < TRACE_TRIES \
                    and time.perf_counter() >= cap_at:
                sync()
                if pre_steps is None:
                    pre_steps, pre_s = steps, time.perf_counter() - t_open
                tries += 1
                t0 = time.perf_counter()
                try:
                    capture = tr.start_capture(cpu=False)
                except Exception as e:  # noqa: BLE001 - tried again
                    misses.append(f"capture {tries} did not start: {e!r}")
                    ctx.log(f"trace: {misses[-1]}")
                else:
                    start_s = time.perf_counter() - t0
                    # The slice opens one step after the profiler starts.
                    cap_left = tcfg["steps"] + 1
            if cap_left == tcfg["steps"]:
                mark()
            t0 = time.perf_counter()
            batch = next(it)
            waits.append(time.perf_counter() - t0)
            state, m = step(state, batch)
            steps += 1
            if on_card:
                # At most two steps in flight, so that the window's end
                # is the device's and not only the host's.
                ev = torch.cuda.Event()
                ev.record()
                inflight.append(ev)
                if len(inflight) > 2:
                    inflight.pop(0).synchronize()
            if cap_left is not None:
                cap_left -= 1
                if cap_left == 0:
                    mark()
                    sync()
                    cap_left = None
                    trace = _read(ctx, capture, tries, start_s, misses)
                    capture = None
        sync()
        window_s = time.perf_counter() - t_open
        last_loss = float(m["loss"])
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    finally:
        ray_tpu_torch.shutdown()
    del state, step, it, ds, m, batch
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    if ctx.trace and trace is None:
        raise tr.CaptureError("no capture of the traced slice could be "
                              "read: " + "; ".join(misses or ["none began"]))

    # The reference follows the first steps from the same weights.
    init = weights.make_params(cfg, ctx.seed, torch.float32, dev)
    ref = ref_train.follow(init, check_rows(torch, rows, mix, dev), cfg, opt)
    del init
    prog = {"losses": losses, "grad_norms": gnorms, "first_grad": first,
            "change": change}
    numbers = check.train_numbers(prog, ref, ctx.cell)
    # The cell's file decides what is compared: a number with no limit
    # there (one with no upper reading) is logged as a reading only.
    for n in numbers:
        if n.name not in ctx.cell.limits:
            ctx.log(f"train: {n.name} {n.value!r} (a reading, not compared)")
    numbers = [n for n in numbers if n.name in ctx.cell.limits]
    ctx.log(f"train: {n_check} checked steps, losses {losses} (reference "
            f"{ref['losses']}), pre-clip norms {gnorms} (reference "
            f"{ref['grad_norms']}); window {steps} steps in {window_s:.3f} s;"
            f" last loss {last_loss}")
    tokens = B * (S - 1) * steps
    record = {"cfg": cfg, "batch": B, "seq": S, "data_wait_s": waits,
              "trace": trace, "readings": prog, "reference": ref,
              "rows": rows}
    if pre_steps is not None:
        # The traced run's rate is read before the capture began.
        record.update(steps=pre_steps, window_s=pre_s)
    else:
        record.update(steps=steps, window_s=window_s)
    failed = sum(1 for x in losses + [last_loss] if not math.isfinite(x))
    return check.Outcome(
        end_to_end={"train_tokens_per_s": tokens / window_s,
                    "setup_s": setup_s},
        record=record, numbers=numbers, attempted=n_check + steps,
        failed=failed, memory_peak_bytes=int(peak))

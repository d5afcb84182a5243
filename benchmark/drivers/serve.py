"""The ``serve`` driver: the port's ``LLMServer`` on one card under an
open-loop stream of requests.

Set-up makes the seed's weights on the card in the served dtype,
registers the configuration as a preset on the program's config class
(``LLMServer`` reads its config from a preset name) and builds the
engine with the mix's settings; the engine warms up its own shapes.
The window sends each request when it is due, from one asyncio loop,
through ``LLMServer.generate``; arrivals stop when the window closes and
the requests in flight are drained.  Each request is timed from when it
was due.  After the drain a sample of the finished requests, drawn from
the seed and holding the longest, is judged by the plain reference.
"""

from __future__ import annotations

import asyncio
import gc
import re
import time
from typing import Dict, List

from .. import check, stats, trace as tr, traffic, weights
from . import config_fields


def register_preset(llama, torch, name: str, cfg: Dict) -> str:
    """``LlamaConfig.<preset>`` returning the configuration file's sizes
    (extra keywords, as ``max_seq_len``, on top); returns the name."""
    preset = "bench_" + re.sub(r"\W", "_", name)
    fields = config_fields(llama, torch, cfg)
    setattr(llama.LlamaConfig, preset, classmethod(
        lambda cls, **kw: cls(**{**fields, **kw})))
    return preset


class _Ranges:
    """Host ranges around the engine's prefill-group and decode-chunk
    launches (a traced run only), numbered so that the trace reader can
    pair each with what it computed."""

    def __init__(self, server, record_function):
        self.prefills: Dict[str, List[int]] = {}
        self.chunks: Dict[str, tuple] = {}
        self._n = 0
        launch_prefill, launch_chunk = (server._launch_prefill_group,
                                        server._launch_chunk)

        def prefill_group(g, bucket, warm, group):
            name = f"bench.prefill#{len(self.prefills)}"
            self.prefills[name] = [len(req.prompt) - pos0
                                   for _slot, req, pos0 in group]
            with record_function(name):
                return launch_prefill(g, bucket, warm, group)

        def chunk():
            self._n += 1
            name = f"bench.chunk#{self._n}"
            with record_function(name):
                out = launch_chunk()
            if out is not None:
                _toks, snapshot, k, _t0 = out
                self.chunks[name] = (k, [(len0, req)
                                         for _s, req, len0 in snapshot])
            return out

        server._launch_prefill_group = prefill_group
        server._launch_chunk = chunk

    def chunk_slots(self) -> Dict[str, tuple]:
        """Each chunk's (k, [(len0, prompt length, tokens served)])."""
        return {name: (k, [(len0, len(req.prompt), len(req.tokens))
                           for len0, req in slots])
                for name, (k, slots) in self.chunks.items()}


async def _capture(plan: Dict, t_open: float, seconds: float, prof,
                   out: Dict, record_function) -> None:
    """Record a steady slice of the window with ``prof``, prepared in
    set-up: recording starts at the slice and stops after its tail.
    ``out`` gets the profiler, the slice (seconds after the window
    opened) and how long the start and the stop held the loop."""
    await asyncio.sleep(max(0.0, t_open + seconds * plan["start_frac"]
                            - time.perf_counter()))
    t0 = time.perf_counter()
    prof.start_trace()
    t1 = time.perf_counter()
    window = record_function(tr.WINDOW)
    window.__enter__()
    await asyncio.sleep(plan["seconds"])
    window.__exit__(None, None, None)
    t2 = time.perf_counter()
    # The launches of the slice's last ranges run on the card after it.
    await asyncio.sleep(plan["tail_s"])
    t3 = time.perf_counter()
    prof.stop_trace()
    out.update(prof=prof, slice=(t1 - t_open, t2 - t_open),
               start_s=t1 - t0, stop_s=time.perf_counter() - t3)


async def _drive(server, stream, t_open: float, seconds: float,
                 drain_s: float, capture=None) -> tuple:
    """Send each request when due; wait for all of them, at most
    ``drain_s`` past the window.  ``capture``: a coroutine run beside the
    sends.  Returns (results, lateness), one of each a request (lateness:
    seconds from when it was due to when it was sent)."""
    results: List[dict] = [None] * len(stream)
    lateness: List[float] = [None] * len(stream)
    cap = asyncio.create_task(capture) if capture is not None else None

    async def one(i, r):
        t_call = time.perf_counter()
        lateness[i] = t_call - (t_open + r.due_s)
        try:
            out = await server.generate({"prompt": r.prompt,
                                         "max_new_tokens": r.max_new_tokens})
        except Exception as e:  # a failed request is recorded, not raised
            results[i] = {"error": repr(e)}
            return
        results[i] = {"first": t_call + out["ttft_ms"] * 1e-3,
                      "done": time.perf_counter(), "tokens": out["tokens"]}

    tasks = []
    for i, r in enumerate(stream):
        delay = t_open + r.due_s - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.create_task(one(i, r)))
    if tasks:
        _done, pending = await asyncio.wait(
            tasks, timeout=max(0.0, t_open + seconds + drain_s
                               - time.perf_counter()))
        for t in pending:
            t.cancel()
        await asyncio.gather(*pending, return_exceptions=True)
    if cap is not None:
        await cap
    return results, lateness


def build_server(ctx: check.Context):
    """The engine with the seed's weights, warmed up by its own warm-up."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMServer

    cfg, eng = ctx.cell.config, ctx.cell.mix["engine"]
    dev = torch.device(ctx.device)
    preset = register_preset(llama, torch, ctx.cell.name, cfg)
    return LLMServer(
        model_preset=preset, device=dev,
        params=weights.make_params(cfg, ctx.seed,
                                   getattr(torch, cfg["dtype"]), dev),
        max_slots=eng["max_slots"], max_len=eng["max_len"],
        prefill_buckets=tuple(eng["prefill_buckets"]),
        prefill_groups=tuple(eng["prefill_groups"]),
        decode_chunk=eng["decode_chunk"], paged=eng["paged"],
        block_size=eng["block_size"], num_blocks=eng.get("num_blocks"))


def summarize(stream, results, t_open: float, seconds: float,
              drain_s: float) -> Dict:
    """Tails over every request that arrived (a failed or unfinished one
    counted as missing), and the output tokens finished in the window."""
    t_close = t_open + seconds
    missing = seconds + drain_s
    ttft, tpot, out_tokens, failed = [], [], 0, 0
    for r, res in zip(stream, results):
        ok = (res is not None and "error" not in res
              and len(res["tokens"]) == r.max_new_tokens)
        if not ok:
            failed += 1
            ttft.append(None)
            tpot.append(None)
            continue
        ttft.append(res["first"] - (t_open + r.due_s))
        tpot.append((res["done"] - res["first"])
                    / max(1, len(res["tokens"]) - 1))
        if res["done"] <= t_close:
            out_tokens += len(res["tokens"])
    return {"ttft": ttft, "tpot": tpot, "failed": failed,
            "serve_ttft_p90_ms": 1e3 * stats.tail(ttft, 0.9, missing),
            "serve_tpot_p90_ms": 1e3 * stats.tail(tpot, 0.9, missing),
            "serve_output_tokens_per_s": out_tokens / seconds}


def run(ctx: check.Context) -> check.Outcome:
    import torch

    from ..reference import serve as ref_serve

    cfg, mix = ctx.cell.config, ctx.cell.mix
    dev = torch.device(ctx.device)
    on_card = dev.type == "cuda"
    dtype = getattr(torch, cfg["dtype"])
    server = build_server(ctx)
    stream = traffic.serve_stream(mix, ctx.seed, ctx.seconds,
                                  cfg["vocab_size"])
    ranges = (_Ranges(server, torch.profiler.record_function)
              if ctx.trace else None)
    captured: Dict = {}
    prof = tr.prepared_capture() if ctx.trace else None
    try:
        if on_card:
            torch.cuda.synchronize(dev)
        t_open = time.perf_counter()
        setup_s = time.time() - ctx.t_start
        cap = (_capture(mix["trace"], t_open, ctx.seconds, prof, captured,
                        torch.profiler.record_function)
               if ctx.trace else None)
        results, lateness = asyncio.run(_drive(
            server, stream, t_open, ctx.seconds, mix["drain_s"], cap))
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    finally:
        server.shutdown()
    summary = summarize(stream, results, t_open, ctx.seconds, mix["drain_s"])
    failed = summary["failed"]
    errors = [res["error"] for res in results if res and "error" in res]
    if errors:
        ctx.log(f"serve: first of {len(errors)} errors: {errors[0]}")
    sent = [x for x in lateness if x is not None]
    ctx.log(f"serve: {len(stream)} requests due in {ctx.seconds} s, "
            f"{failed} failed or unfinished; the generator ran late by at "
            f"most {max(sent, default=0.0) * 1e3:.3f} ms (median "
            f"{(stats.nearest_rank(sent, 0.5) or 0.0) * 1e3:.3f} ms)")
    if "slice" in captured:
        lo, hi = captured["slice"]
        late = [x for r, x in zip(stream, lateness)
                if x is not None and lo <= r.due_s <= hi]
        ctx.log(f"trace: recording started in "
                f"{captured['start_s'] * 1e3:.3f} ms and stopped in "
                f"{captured['stop_s']:.3f} s; the {len(late)} sends due in "
                f"the slice ({lo:.3f}-{hi:.3f} s) ran late by at most "
                f"{max(late, default=0.0) * 1e3:.3f} ms")
    record = {"cfg": cfg, "trace": None}
    if ranges is not None:
        record.update(prefills=ranges.prefills, chunks=ranges.chunk_slots())

    # Sample of finished requests for the reference, the longest in it.
    done = [i for i, res in enumerate(results)
            if res is not None and "error" not in res]
    sample = []
    if done:
        longest = max(done, key=lambda i: len(stream[i].prompt)
                      + len(results[i]["tokens"]))
        picks = traffic.sample(ctx.seed, len(done), mix["check_requests"],
                               must=done.index(longest))
        sample = [{"prompt": stream[done[j]].prompt,
                   "tokens": results[done[j]]["tokens"]} for j in picks]
    del server, results
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    if "prof" in captured:
        record["trace"] = tr.read_capture(captured.pop("prof"))

    params = weights.make_params(cfg, ctx.seed, dtype, dev)
    gaps = ref_serve.gaps(params, sample, cfg, dev)
    del params
    served = sum(len(s["tokens"]) for s in sample)
    ctx.log(f"serve: reference over {len(sample)} requests, {served} served "
            f"tokens; widest gap a request {gaps}")
    record.update(sample=sample, gaps=gaps)
    numbers = [
        check.Number("failed_requests", float(failed),
                     check.limit(ctx.cell, "failed_requests")),
        check.Number("served_logit_gap", max(gaps, default=float("inf")),
                     check.limit(ctx.cell, "served_logit_gap")),
    ]
    return check.Outcome(
        end_to_end={k: summary[k] for k in (
            "serve_ttft_p90_ms", "serve_tpot_p90_ms",
            "serve_output_tokens_per_s")} | {"setup_s": setup_s},
        record=record, numbers=numbers, attempted=len(stream),
        failed=failed, memory_peak_bytes=int(peak))

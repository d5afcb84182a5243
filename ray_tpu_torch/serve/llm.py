"""Continuous-batched decode engine in PyTorch (counterpart of
``ray_tpu/serve/llm.py``), dense KV plane.

- One slot-structured KV cache (``max_slots`` x ``max_len``); requests
  join and leave the running batch at chunk boundaries (iteration-level
  scheduling).  Admission is earliest-deadline-first over the backlog
  (arrival order breaks ties); work whose budget is already blown, or
  provably cannot finish in it at the measured rates, is shed typed
  (``DeadlineExceededError``) before it touches the device; a full
  engine queue rejects typed (``BackPressureError``).
- Prefill runs plain causal attention within the prompt, writes K/V into
  the slot's rows and returns the first token; a decode chunk runs
  ``decode_chunk`` greedy steps over every slot, attending the smallest
  power-of-two prefix bucket that covers the active slots, and feeds the
  argmax back on the device.
- One-deep pipeline: the scheduler enqueues chunk N+1 on the device
  before it reads chunk N's tokens back.  Host data reaches the card
  through pinned, non-blocking copies and tokens come back through
  event-fenced pinned copies, so enqueueing a chunk never waits for the
  one before it.  Each decode step is launched eagerly, op by op, so
  the host's launches, not the card, set the pace.
- Prefill priority: a wave's prefills are enqueued and their first
  tokens harvested before the next decode chunk is enqueued, so newly
  admitted requests join that chunk.
- Device annotations ``serve.prefill`` / ``serve.decode_chunk`` are
  ``torch.profiler.record_function`` ranges with the reference's names.

Not ported yet (raise ``NotImplementedError``): the paged plane, int8/fp8
KV, speculative decoding and prefill/decode disaggregation.
"""

from __future__ import annotations

import asyncio
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..core import deadlines as _deadlines
from ..core.device import DeviceLike, resolve_device, to_device
from ..exceptions import BackPressureError, DeadlineExceededError
from ..models import llama

# Prefill group sizes (prompts per call, padded with slot=-1).  Saturated
# admission batches at the widest size; a light wave takes the smallest
# size that fits (a padded group computes all its rows).
PREFILL_GROUPS = (4, 32)

# Feasibility shed: a request is shed when its remaining budget is under
# this fraction of the estimated time to finish (measured EMAs).
_FEASIBILITY_MARGIN = 0.6
# A request whose budget is within this multiple of its service time is
# latency-sensitive: it is also shed when the estimated queue delay alone
# exceeds about one service time.
_QUEUE_TIGHT_X = 10.0

_NOT_PORTED = ("is not ported yet (ROADMAP queue A, 'Paged serving "
               "plane')")


class _Request:
    __slots__ = ("prompt", "max_new_tokens", "event", "tokens",
                 "t_submit", "t_first_token", "error", "done",
                 "on_done", "deadline", "arrival")

    _arrival_counter = 0
    _arrival_lock = threading.Lock()

    def __init__(self, prompt: List[int], max_new_tokens: int,
                 deadline: Optional[float] = None):
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.event = threading.Event()
        self.tokens: List[int] = []
        self.t_submit = time.perf_counter()
        self.t_first_token: Optional[float] = None
        self.error: Optional[BaseException] = None
        self.done = False
        # Completion callback (asyncio wakeup) fired after event.set.
        self.on_done: Optional[Any] = None
        # Absolute end-to-end deadline (epoch s) or None; EDF admission
        # key, tie-broken by arrival so deadline-free traffic is FIFO.
        self.deadline = deadline
        with _Request._arrival_lock:
            _Request._arrival_counter += 1
            self.arrival = _Request._arrival_counter

    def finish_notify(self):
        self.event.set()
        cb = self.on_done
        if cb is not None:
            try:
                cb()
            except Exception:
                pass


class LLMServer:
    """Greedy continuous-batching engine over one Llama preset, on
    ``device`` (the card unless ``"cpu"`` is passed).

    ``await server.generate({"prompt": [ids], "max_new_tokens": n})``
    returns ``{"tokens": [...], "ttft_ms": float}``."""

    def __init__(self, model_preset: str = "llama_125m",
                 max_slots: int = 64, max_len: int = 512,
                 prefill_buckets=(32, 64, 128, 256), params=None,
                 decode_chunk: int = 16, seed: int = 0,
                 warmup: bool = True, paged: bool = False,
                 role: str = "both",
                 prefill_groups: Optional[Tuple[int, ...]] = None,
                 kv_quant: Optional[str] = None, spec_k: int = 0,
                 device: DeviceLike = None):
        if paged:
            raise NotImplementedError(f"paged=True {_NOT_PORTED}")
        if kv_quant is not None:
            raise NotImplementedError(f"kv_quant {_NOT_PORTED}")
        if spec_k > 0:
            raise NotImplementedError(f"spec_k > 0 {_NOT_PORTED}")
        if role != "both":
            raise NotImplementedError(f"role={role!r} {_NOT_PORTED}")
        self.device = resolve_device(device)
        preset = getattr(llama.LlamaConfig, model_preset)
        self.cfg = preset(max_seq_len=max_len)
        self.max_slots = max_slots
        self.max_len = max_len
        self.buckets = tuple(sorted(b for b in prefill_buckets
                                    if b <= max_len))
        self.decode_chunk = max(1, int(decode_chunk))
        self.prefill_groups = tuple(sorted(
            prefill_groups or PREFILL_GROUPS))
        # Attended-prefix buckets: powers of two from the smallest
        # prefill bucket up to max_len.
        dbs = []
        b = max(64, self.buckets[0])
        while b < max_len:
            dbs.append(b)
            b *= 2
        dbs.append(max_len)
        self.decode_buckets = tuple(dbs)
        if params is None:
            params = llama.init_params(self.cfg, seed=seed,
                                       device=self.device)
        # One-time cast to the compute dtype: half the weight bytes per
        # step, identical numerics to casting at each use.
        self.params = _tree_map(
            lambda t: (t.to(self.device, self.cfg.dtype)
                       if t.dtype == torch.float32 else t.to(self.device)),
            params)

        # Host-authoritative slot state (device carries mirror it
        # between chunk launches).
        self.slot_req: List[Optional[_Request]] = [None] * max_slots
        self.slot_len = np.zeros(max_slots, np.int64)

        # One extra row per slot past max_len: decode steps of inactive
        # slots scatter their K/V there, so a step writes in place with
        # no host sync and no masked pass over the cache.  Attention
        # never reads it (buckets stop at max_len).
        self.cache = llama.init_kv_cache(self.cfg, max_slots, max_len + 1,
                                         device=self.device)
        self._trash_row = max_len

        # Device-resident carries between chunk launches.
        self._tok_dev = torch.zeros(max_slots, dtype=torch.long,
                                    device=self.device)
        self._len_dev = torch.zeros(max_slots, dtype=torch.long,
                                    device=self.device)
        # Host overrides applied at the next chunk launch.
        self._ov_tok = np.zeros(max_slots, np.int64)
        self._ov_len = np.zeros(max_slots, np.int64)
        self._ov_mask = np.zeros(max_slots, bool)
        # Prefill results pending first-token extraction:
        # (first_tokens_device, [(group_index, slot, req)], t0).
        self._pending_prefills: List[tuple] = []
        # Rate estimators feeding the feasibility shed (EMA seconds).
        self._chunk_ema: Optional[float] = None
        self._prefill_ema: Optional[float] = None

        if warmup:
            self._warmup()

        self._queue: "queue.Queue[_Request]" = queue.Queue()
        # Engine ingress bound: reject typed rather than grow unbounded.
        self._queue_cap = max(64, 8 * self.max_slots)
        # EDF backlog, admitted at chunk boundaries in (deadline,
        # arrival) order.
        self._backlog: List[_Request] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------- dense plane
    @torch.no_grad()
    def _prefill(self, tokens, lengths, slots):
        last_logits, ks, vs = llama.prefill_forward(
            self.params, tokens, lengths, self.cfg)
        llama.insert_prefill(self.cache, ks, vs, slots)
        return torch.argmax(last_logits, dim=-1)

    @torch.no_grad()
    def _decode_k(self, ov_tok, ov_len, ov_mask, active, k, s_active):
        """``k`` greedy steps over every slot against the first
        ``s_active`` cache rows; returns the (k, B) tokens on the device
        and leaves the carries in ``_tok_dev``/``_len_dev``."""
        tok = torch.where(ov_mask, ov_tok, self._tok_dev)
        lens = torch.where(ov_mask, ov_len, self._len_dev)
        step = self._make_decode_step(self.params, active, s_active)
        toks = []
        for _ in range(k):
            tok, lens = step(tok, lens)
            toks.append(tok)
        self._tok_dev, self._len_dev = tok, lens
        return torch.stack(toks)

    def _make_decode_step(self, params, active, s_active):
        """The per-token decode step: K/V write at each active slot's
        current position, bucketed cache attention, greedy argmax fed
        back.  Only ACTIVE slots write, as in the reference: a free slot's
        stale carry writes to the trash row, so a slot's cache rows hold
        only what its own prefill and steps put there."""
        cfg = self.cfg
        cache = self.cache
        bidx = torch.arange(self.max_slots, device=self.device)
        trash = torch.full_like(bidx, self._trash_row)
        scale = cfg.head_dim ** -0.5
        head = llama._head(params, cfg)

        def step(tok, lens):
            x = params["embed_tokens"][tok][:, None]
            sin, cos = llama.rope_table(lens[:, None], cfg.head_dim,
                                        cfg.rope_theta)
            # Rows outside the attended prefix are not written either
            # (the reference's write mask only spans [0, s_active)).
            rows = torch.where(active & (lens < s_active), lens, trash)
            for i, layer in enumerate(llama._layers(params)):
                q, kk, vv = llama._qkv_rope(x, layer, sin, cos, cfg)
                ck, cv = cache["k"][i], cache["v"][i]
                ck[bidx, rows] = kk[:, 0].to(ck.dtype)  # in place
                cv[bidx, rows] = vv[:, 0].to(cv.dtype)
                attn = llama._cache_attend(q, ck[:, :s_active],
                                           cv[:, :s_active], lens[:, None],
                                           scale)
                x = llama._attn_out_mlp(x, attn, layer, cfg)
            x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
            logits = llama.matmul(x, head)[:, 0]
            nxt = torch.argmax(logits, dim=-1)
            nxt = torch.where(active, nxt, tok)
            return nxt, lens + active.long()

        return step

    # ------------------------------------------------------------ warmup
    @torch.no_grad()
    def _warmup(self):
        """Run every prefill shape and decode bucket once up front
        (allocator and library handles warm before the first request);
        no slot is written."""
        dev = self.device
        for g in self.prefill_groups:
            lengths = torch.ones(g, dtype=torch.long, device=dev)
            for bucket in self.buckets:
                toks = torch.zeros((g, bucket), dtype=torch.long,
                                   device=dev)
                self._prefill(toks, lengths, np.full(g, -1))
        active = torch.zeros(self.max_slots, dtype=torch.bool, device=dev)
        ov = torch.zeros(self.max_slots, dtype=torch.long, device=dev)
        for sa in self.decode_buckets:
            self._decode_k(ov, ov, active, active, self.decode_chunk,
                           int(sa))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ------------------------------------------------------------ serving
    async def generate(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """{"prompt": [int token ids], "max_new_tokens": n,
        "deadline_s": optional relative budget} ->
        {"tokens": [...], "ttft_ms": float}."""
        if self._stop.is_set():
            raise RuntimeError("LLMServer is stopped (prior device "
                               "failure or shutdown)")
        prompt = request["prompt"]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > max(self.buckets):
            raise ValueError(
                f"prompt of {len(prompt)} exceeds the largest prefill "
                f"bucket {max(self.buckets)}")
        max_new = int(request.get("max_new_tokens", 32))
        req = _Request(prompt, max_new,
                       deadline=self._request_deadline(request))
        await self._submit_and_wait(req)
        return {
            "tokens": req.tokens,
            "ttft_ms": round((req.t_first_token - req.t_submit) * 1e3, 2),
        }

    @staticmethod
    def _request_deadline(request) -> Optional[float]:
        rel = request.get("deadline_s")
        if rel is not None:
            return time.time() + float(rel)
        return _deadlines.current()

    async def _submit_and_wait(self, req: _Request) -> None:
        loop = asyncio.get_running_loop()
        fut = loop.create_future()

        def _wake():
            loop.call_soon_threadsafe(
                lambda: fut.done() or fut.set_result(None))

        req.on_done = _wake
        if self._queue.qsize() + len(self._backlog) >= self._queue_cap:
            raise BackPressureError(
                f"LLM engine queue full ({self._queue_cap})",
                retry_after_s=0.1, context={"where": "llm_queue"})
        self._queue.put(req)
        if self._stop.is_set() and not req.event.is_set():
            # Raced _fatal's queue drain: fail this request ourselves.
            req.error = RuntimeError("LLMServer stopped")
            req.finish_notify()
        if req.event.is_set():
            _wake()  # finished (or failed) before on_done registration
        await fut
        if req.error is not None:
            raise req.error

    def check_health(self):
        return not self._stop.is_set()

    # ---------------------------------------------------------- scheduler
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(n)

    def _decode_bucket(self) -> int:
        """Smallest attended-prefix bucket covering every occupied slot's
        end position after this chunk."""
        high = 0
        for s in range(self.max_slots):
            if self.slot_req[s] is not None:
                high = max(high, int(self.slot_len[s]) + self.decode_chunk)
        for b in self.decode_buckets:
            if high <= b:
                return b
        return self.decode_buckets[-1]

    def _drain_queue(self):
        while True:
            try:
                self._backlog.append(self._queue.get_nowait())
            except queue.Empty:
                return

    def _shed(self, req: _Request, err: BaseException):
        req.error = err
        req.finish_notify()

    def _estimate_need_s(self, req: _Request) -> Optional[float]:
        """Estimated seconds to finish ``req`` from a standing start,
        from the measured prefill/chunk EMAs (None until measured)."""
        if self._chunk_ema is None:
            return None
        prefill = self._prefill_ema or self._chunk_ema
        chunks = -(-req.max_new_tokens // self.decode_chunk)
        return prefill + chunks * self._chunk_ema

    def _admission_pass(self):
        """Shed blown/infeasible work typed, then EDF-order the backlog.
        Feasibility is judged at arrival position: a request ``i`` deep
        must fit the estimated queue delay for ``i`` admissions ahead of
        it plus its own service time inside its budget."""
        if not self._backlog:
            return
        self._backlog.sort(
            key=lambda r: (r.deadline if r.deadline is not None
                           else float("inf"), r.arrival))
        now = time.time()
        keep: List[_Request] = []
        for r in self._backlog:
            if r.deadline is not None and now >= r.deadline:
                self._shed(r, DeadlineExceededError(
                    "shed at LLM admission: deadline exceeded",
                    deadline=r.deadline,
                    context={"where": "llm_admission"}))
                continue
            if r.deadline is not None:
                need = self._estimate_need_s(r)
                if need is not None:
                    # ~max_slots requests run concurrently, so each
                    # admission ahead adds ~need/max_slots of delay.
                    remaining = r.deadline - now
                    queue_est = len(keep) * need / self.max_slots
                    infeasible = remaining < _FEASIBILITY_MARGIN * (
                        need + queue_est)
                    queue_bound = max(need, 2 * (self._chunk_ema or 0.0))
                    overlong_queue = (remaining < _QUEUE_TIGHT_X * need
                                      and queue_est > queue_bound)
                    if infeasible or overlong_queue:
                        self._shed(r, DeadlineExceededError(
                            "shed at LLM admission: cannot finish "
                            f"inside the request budget (needs "
                            f"~{need + queue_est:.2f}s)",
                            deadline=r.deadline,
                            context={"where": "llm_admission_infeasible"}))
                        continue
            keep.append(r)
        self._backlog = keep

    def _admit_wave(self):
        """Move backlog requests into free slots and launch their
        prefills; first tokens are harvested in a later iteration."""
        self._drain_queue()
        self._admission_pass()
        if not self._backlog:
            return
        free = [s for s in range(self.max_slots) if self.slot_req[s] is None]
        wave: List[tuple] = []  # (slot, req, bucket)
        while free and self._backlog:
            req = self._backlog.pop(0)
            slot = free.pop(0)
            P = len(req.prompt)
            self.slot_req[slot] = req
            self.slot_len[slot] = P
            wave.append((slot, req, self._bucket(P)))
        self._launch_prefills(wave)

    def _launch_prefills(self, wave: List[tuple]):
        by_bucket: Dict[int, List[tuple]] = {}
        for slot, req, bucket in wave:
            by_bucket.setdefault(bucket, []).append((slot, req))
        for bucket, entries in by_bucket.items():
            i = 0
            while i < len(entries):
                rest = len(entries) - i
                g = next((gg for gg in self.prefill_groups if gg >= rest),
                         self.prefill_groups[-1])
                self._launch_prefill_group(g, bucket, entries[i:i + g])
                i += g

    def _launch_prefill_group(self, g, bucket, group):
        toks = np.zeros((g, bucket), np.int64)
        lens = np.ones(g, np.int64)
        slots = np.full(g, -1, np.int64)
        members = []
        for j, (slot, req) in enumerate(group):
            P = len(req.prompt)
            toks[j, :P] = req.prompt
            lens[j] = P
            slots[j] = slot
            members.append((j, slot, req))
        t0 = time.perf_counter()
        with record_function("serve.prefill"):
            first = self._prefill(to_device(toks, self.device),
                                  to_device(lens, self.device), slots)
        self._pending_prefills.append((_HostCopy(first), members, t0))

    def _harvest_prefills(self):
        """Materialize queued prefill first tokens into request streams
        and decode overrides."""
        for first, members, t0 in self._pending_prefills:
            first = first.numpy()
            now = time.perf_counter()
            dt = now - t0
            self._prefill_ema = (dt if self._prefill_ema is None
                                 else 0.8 * self._prefill_ema + 0.2 * dt)
            for j, slot, req in members:
                if self.slot_req[slot] is not req:
                    continue
                tok = int(first[j])
                req.t_first_token = now
                req.tokens.append(tok)
                self._ov_tok[slot] = tok
                self._ov_len[slot] = self.slot_len[slot]
                self._ov_mask[slot] = True
                if len(req.tokens) >= req.max_new_tokens:
                    self._finish(slot)
        self._pending_prefills.clear()

    def _finish(self, slot: int):
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self.slot_len[slot] = 0
        self._ov_mask[slot] = False
        if req is not None:
            req.done = True
            req.finish_notify()

    def _fatal(self, e: BaseException):
        """A device call failed, so the cache state is unusable: fail
        every active and queued request, mark the server unhealthy
        (check_health -> False), and stop."""
        self._stop.set()
        for slot in range(self.max_slots):
            req = self.slot_req[slot]
            if req is not None:
                req.error = e
                self._finish(slot)
        for req in self._backlog:
            req.error = e
            req.finish_notify()
        self._backlog = []
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.error = e
            req.finish_notify()

    def _loop(self):
        pending = None  # (_HostCopy of toks, [(slot, req, len0)], k, t0)
        try:
            with torch.no_grad():
                while not self._stop.is_set():
                    # Prefill-priority admission: queued prompts' prefills
                    # enqueue and their first tokens land before the next
                    # decode chunk, which the new slots then join.  (The
                    # reference harvests after the launch: one async
                    # dispatch there, hundreds of ms of eager launches
                    # here, which the new requests' TTFT would wait out.)
                    self._admit_wave()
                    self._harvest_prefills()
                    launched = self._launch_chunk()
                    if pending is not None:
                        self._process(pending)  # overlaps `launched`
                    pending = launched
                    if pending is None and not any(
                            r is not None for r in self.slot_req) \
                            and not self._backlog:
                        # Idle: block for work instead of spinning.
                        try:
                            self._backlog.append(
                                self._queue.get(timeout=0.05))
                        except queue.Empty:
                            pass
        except BaseException as e:  # noqa: BLE001
            self._fatal(e)

    def _active_snapshot(self):
        snapshot = []  # (slot, req, len_at_launch)
        active = np.zeros(self.max_slots, bool)
        for s in range(self.max_slots):
            req = self.slot_req[s]
            if req is not None:
                active[s] = True
                snapshot.append((s, req, int(self.slot_len[s])))
        return snapshot, active

    def _launch_chunk(self):
        """Enqueue the next decode chunk with host overrides for newly
        admitted slots.  Returns the in-flight handle, or None if no slot
        is active."""
        snapshot, active = self._active_snapshot()
        if not snapshot:
            return None
        k = self.decode_chunk
        t0 = time.perf_counter()
        # One non-blocking copy of the overrides and the active mask (a
        # copy: this thread mutates the arrays right after the launch).
        ov = to_device(np.stack([self._ov_tok, self._ov_len,
                                 self._ov_mask, active]), self.device)
        sa = self._decode_bucket()
        with record_function("serve.decode_chunk"):
            toks = _HostCopy(self._decode_k(ov[0], ov[1], ov[2] != 0,
                                            ov[3] != 0, k=k, s_active=sa))
        self._ov_mask[:] = False
        for s, _req, _len0 in snapshot:
            self.slot_len[s] += k
        return (toks, snapshot, k, t0)

    def _process(self, pending):
        """Read a finished chunk's tokens back (the next chunk is already
        enqueued) and route them to their requests."""
        toks_host, snapshot, k, t0 = pending
        toks = toks_host.numpy()  # (k, B); the harvest sync point
        now = time.perf_counter()
        dt = now - t0
        self._chunk_ema = (dt if self._chunk_ema is None
                           else 0.8 * self._chunk_ema + 0.2 * dt)
        for slot, req, len0 in snapshot:
            if req is None or req.done or self.slot_req[slot] is not req:
                continue
            for step in range(k):
                tok = int(toks[step, slot])
                if req.t_first_token is None:
                    req.t_first_token = now
                req.tokens.append(tok)
                if (len(req.tokens) >= req.max_new_tokens
                        or len0 + step + 1 >= self.max_len - 1):
                    self._finish(slot)
                    break

    # ------------------------------------------------------------ teardown
    def shutdown(self):
        """Stop the scheduler thread, fail any waiters, and drain
        in-flight device work."""
        self._fatal(RuntimeError("LLMServer shut down"))
        t = getattr(self, "_thread", None)
        if t is not None and t is not threading.current_thread():
            t.join(timeout=30.0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __del__(self):
        stop = getattr(self, "_stop", None)  # init may have raised
        if stop is not None:
            stop.set()


class _HostCopy:
    """A device tensor's copy to the host, enqueued right behind the
    work that produced it.  ``.numpy()`` waits for that point of the
    stream only: a plain ``.cpu()`` later would also wait for whatever
    was enqueued after (the next chunk), defeating the pipeline."""

    __slots__ = ("_host", "_event")

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = t, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)

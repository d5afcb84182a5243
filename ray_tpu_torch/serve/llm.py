"""Continuous-batched decode engine in PyTorch (counterpart of
``ray_tpu/serve/llm.py``): the dense and the paged KV planes.

- Requests join and leave the running batch at chunk boundaries
  (iteration-level scheduling).  Admission is earliest-deadline-first
  over the backlog (arrival order breaks ties); work whose budget is
  already blown, or provably cannot finish in it at the measured rates,
  is shed typed (``DeadlineExceededError``) before it touches the
  device; a full engine queue rejects typed (``BackPressureError``).
- DENSE plane (``paged=False``): one slot-structured KV cache
  (``max_slots`` x ``max_len``); a decode chunk attends the smallest
  power-of-two prefix bucket that covers the active slots.
- PAGED plane (``paged=True``; Orca OSDI '22 + vLLM SOSP '23): a
  block-major pool of ``block_size``-token blocks (``num_blocks``,
  block 0 reserved), a per-request block table (``serve/kv_cache.py``)
  feeding a block-GATHERING attention read at static block-count
  buckets, free-list allocation with typed ``BackPressureError``
  exhaustion, and copy-on-write prefix sharing through a hash-trie
  prefix cache: a warm prompt prefills only its suffix, attending the
  gathered shared blocks.  The gathered layout equals the dense layout
  position for position, so both planes decode the same tokens.  Pool
  pressure preempts the latest-deadline request (recompute on readmit).
  Block-table padding names the null block 0: a padding gather reads it
  (attention masks it) and a padding scatter writes it (never read
  unmasked), so no out-of-range index is ever launched.
- QUANTIZED KV blocks (``kv_quant="int8"|"fp8"``): the pool stores
  8-bit values with one f32 scale per KV row; the gather dequantizes,
  every write requantizes (amax maps onto +-qmax, so the round trip is
  idempotent).  fp8 blocks move through a ``uint8`` view of their bytes.
- SPECULATIVE decoding (``spec_k > 0``, paged plane): a draft (the
  target's first ``draft_layers`` layers, or ``draft_preset``) proposes
  ``spec_k`` greedy tokens, the target verifies them in one pass over
  the gathered layout, and the host emits the longest verified prefix
  plus the target's correction; rejected blocks go back through
  ``BlockTable.trim``.  Greedy-exact: acceptance changes speed, not
  tokens.
- Prefill runs plain causal attention within the prompt and returns the
  first token; the decode step feeds the argmax back on the device.
- One-deep pipeline: the scheduler enqueues chunk N+1 on the device
  before it reads chunk N's tokens back.  Host data reaches the card
  through pinned, non-blocking copies and tokens come back through
  event-fenced pinned copies, so enqueueing a chunk never waits for the
  one before it.  Each decode step is launched eagerly, op by op, so
  the host's launches, not the card, set the pace.  (A spec round reads
  tokens back twice by design: the verify inputs and the acceptance
  need the draft's tokens on the host.)
- Prefill priority: a wave's prefills are enqueued and their first
  tokens harvested before the next decode chunk is enqueued, so newly
  admitted requests join that chunk.
- Device annotations ``serve.prefill`` / ``serve.decode_chunk`` /
  ``serve.spec_draft`` / ``serve.spec_verify`` are
  ``torch.profiler.record_function`` ranges with the reference's names.

Not ported yet (``NotImplementedError``): prefill/decode
disaggregation (``role="prefill"|"decode"``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..core import deadlines as _deadlines
from ..core.device import DeviceLike, resolve_device, to_device
from ..core.metrics import (kv_cache_counters, metrics_summary,
                            overload_counters, record_program_ema)
from ..exceptions import BackPressureError, DeadlineExceededError
from ..models import llama
from .kv_cache import (NULL_BLOCK, BlockTable, KVBlockAllocator, PrefixCache,
                       kv_quant_info)

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

# The engine's label on its metric series (the reference's default
# deployment name).
_LABEL = "llm"

_NOT_PORTED = ("is not ported yet (ROADMAP queue A, 'Wire + collectives': "
               "prefill/decode disaggregation)")


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
    returns ``{"tokens": [...], "ttft_ms": float}``.

    ``kv_quant``: "int8"/"fp8" stores paged KV blocks reduced-precision
    with per-row (block, layer, position, head) scales.  ``spec_k > 0``
    enables speculative decoding on the paged plane; the draft is
    ``draft_preset`` (its own weights: ``draft_params``, or random ones
    from ``seed + 1``) or, by default, the target's first
    ``draft_layers`` layers (``n_layers // 4``) with its own norm and
    head."""

    def __init__(self, model_preset: str = "llama_125m",
                 max_slots: int = 64, max_len: int = 512,
                 prefill_buckets=(32, 64, 128, 256), params=None,
                 decode_chunk: int = 16, seed: int = 0,
                 warmup: bool = True, paged: bool = False,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 role: str = "both",
                 prefill_groups: Optional[Tuple[int, ...]] = None,
                 kv_quant: Optional[str] = None, spec_k: int = 0,
                 draft_preset: Optional[str] = None,
                 draft_layers: Optional[int] = None, draft_params=None,
                 device: DeviceLike = None):
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"unknown role {role!r}")
        if role != "both" and not paged:
            raise ValueError("prefill/decode disaggregation requires "
                             "the paged KV plane (paged=True)")
        self.spec_k = max(0, int(spec_k))
        if self.spec_k:
            if not paged:
                raise ValueError("speculative decoding rides the paged "
                                 "KV plane (paged=True)")
            if role != "both":
                raise ValueError(
                    "speculative decoding requires role='both' (the "
                    "draft cache cannot be handed off between "
                    "disaggregated replicas)")
        if kv_quant is not None and not paged:
            raise ValueError("kv_quant requires the paged KV plane "
                             "(paged=True)")
        if role != "both":
            raise NotImplementedError(f"role={role!r} {_NOT_PORTED}")
        self.device = resolve_device(device)
        preset = getattr(llama.LlamaConfig, model_preset)
        self.cfg = preset(max_seq_len=max_len)
        llama.check_kv_cache_decode(self.cfg)
        self.max_slots = max_slots
        self.max_len = max_len
        self.buckets = tuple(sorted(b for b in prefill_buckets
                                    if b <= max_len))
        self.decode_chunk = max(1, int(decode_chunk))
        self.paged = bool(paged)
        self.role = role
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
        self.params = _cast_params(params, self.cfg.dtype, self.device)

        # Host-authoritative slot state (device carries mirror it
        # between chunk launches).
        self.slot_req: List[Optional[_Request]] = [None] * max_slots
        self.slot_len = np.zeros(max_slots, np.int64)
        # Admitted but prefill not yet harvested: the slot's device
        # carry is stale, so it sits out decode chunks until its
        # override token lands.
        self.slot_waiting = np.zeros(max_slots, bool)

        self.kv_quant = kv_quant
        if self.paged:
            self._init_paged(block_size, num_blocks)
        else:
            # One extra row per slot past max_len: decode steps of
            # inactive slots scatter their K/V there, so a step writes in
            # place with no host sync and no masked pass over the cache.
            # Attention never reads it (buckets stop at max_len).
            self.cache = llama.init_kv_cache(self.cfg, max_slots,
                                             max_len + 1,
                                             device=self.device)
        if self.spec_k:
            self._init_draft(draft_preset, draft_layers, draft_params,
                             seed)

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
    def _decode_k(self, cache, ov_tok, ov_len, ov_mask, active, k,
                  s_active):
        """``k`` greedy steps over every slot against the first
        ``s_active`` rows of ``cache``; returns the (k, B) tokens on the
        device and leaves the carries in ``_tok_dev``/``_len_dev``."""
        tok = torch.where(ov_mask, ov_tok, self._tok_dev)
        lens = torch.where(ov_mask, ov_len, self._len_dev)
        step = self._make_decode_step(self.params, cache, active, s_active)
        toks = []
        for _ in range(k):
            tok, lens = step(tok, lens)
            toks.append(tok)
        self._tok_dev, self._len_dev = tok, lens
        return torch.stack(toks)

    def _make_decode_step(self, params, cache, active, s_active, cfg=None):
        """The per-token decode step, shared by the dense cache, the
        paged plane's gathered layout and the draft's cache: K/V write
        at each active slot's current position, attention over the first
        ``s_active`` rows, greedy argmax fed back.  ``cache`` tensors are
        (L, B, S, Hkv, D) whose last row is a trash row: only ACTIVE
        slots write, as in the reference, so a free slot's stale carry
        (or a position past ``s_active``) writes there and a slot's rows
        hold only what its own prefill and steps put there.  ``cfg``
        overrides the target config (the draft)."""
        cfg = cfg or self.cfg
        bidx = torch.arange(self.max_slots, device=self.device)
        trash = torch.full_like(bidx, cache["k"].shape[2] - 1)
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

    # ------------------------------------------------------- paged plane
    def _init_paged(self, block_size, num_blocks):
        bs = int(block_size)
        if bs < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = bs
        self._kv_fmt = kv_quant_info(self.kv_quant)
        max_blocks_per_req = -(-self.max_len // bs)
        if num_blocks is None:
            # Capacity parity with the dense plane by default.
            num_blocks = 1 + self.max_slots * max_blocks_per_req
        self.num_blocks = int(num_blocks)
        # Block-table padding: the reference pads with the out-of-range
        # index num_blocks (its gathers clip, its scatters drop).  An
        # out-of-range index is a device-side assert here, so padding
        # names the null block instead: its gathers are masked and its
        # scatters land in a block no table maps.
        self._pad_block = NULL_BLOCK
        self.allocator = KVBlockAllocator(self.num_blocks, bs,
                                          pool_label=_LABEL)
        self.prefix_cache = PrefixCache(self.allocator)
        self.slot_table: List[Optional[BlockTable]] = [None] * self.max_slots
        self._preempted = 0  # requests sent back to the backlog
        self.pool = llama.init_paged_kv_cache(
            self.cfg, self.num_blocks, bs, kv_quant=self.kv_quant,
            device=self.device)
        # What the gathers and scatters index: quantized values through a
        # uint8 view of their bytes (CUDA's indexing kernels are not all
        # built for float8).
        self._raw = {name: (self.pool[name].view(torch.uint8)
                            if self._kv_fmt else self.pool[name])
                     for name in ("k", "v")}
        self._publish_pool_bytes()
        # Block-count buckets: the paged analogue of the dense
        # attended-prefix buckets.
        self._nb_buckets = tuple(sorted(
            {-(-b // bs) for b in self.decode_buckets}))
        # Warm-prefill prefix buckets: one static gather width.
        self._np_max = max(1, (max(self.buckets) - 1) // bs)

    @property
    def pool_bytes(self) -> int:
        """Device bytes of the paged pool, scales included."""
        return sum(t.numel() * t.element_size() for t in self.pool.values())

    def _publish_pool_bytes(self) -> None:
        kv_cache_counters()["pool_bytes"].set(
            self.pool_bytes, tags={"pool": _LABEL,
                                   "dtype": self.kv_quant or "bf16"})

    def _gather(self, name, bt, trash_row=False):
        """Blocks ``bt`` (B, nb) of the pool as the compute-dtype layout
        (L, B, nb*bs, Hkv, D), equal to the dense layout position for
        position; quantized pools dequantize here, so everything
        downstream of the gather is plane-agnostic.  ``trash_row`` adds
        one zeroed row past the blocks for the decode step's writes of
        inactive slots."""
        B, nb = bt.shape
        flat = bt.reshape(-1)
        _N, L, bs, Hkv, D = self.pool[name].shape
        S = nb * bs
        out = torch.empty((L, B, S + int(trash_row), Hkv, D),
                          dtype=self.cfg.dtype, device=self.device)
        if trash_row:
            out[:, :, S:].zero_()
        dst = out[:, :, :S].view(L, B, nb, bs, Hkv, D)
        g = self._raw[name].index_select(0, flat).view(B, nb, L, bs, Hkv, D)
        fmt = self._kv_fmt
        if fmt is not None:
            s = self.pool[name + "_scale"].index_select(0, flat)
            g = llama.dequantize_kv_blocks(g.view(fmt.dtype),
                                           s.view(B, nb, L, bs, Hkv),
                                           self.cfg.dtype)
        dst.copy_(g.permute(2, 0, 1, 3, 4, 5))
        return out

    def _set_blocks(self, name, flat, updates):
        """Store block updates ((M, L, bs, Hkv, D), compute dtype) at
        ``flat``; quantized pools quantize on the way in (scale written
        next to the block).  Duplicate indices (COW blocks two slots
        share, padding) land in an undefined order: their bytes are
        equal (a shared block is never written, and requantization is a
        fixed point), or the block is the null block."""
        fmt = self._kv_fmt
        if fmt is None:
            self.pool[name].index_copy_(
                0, flat, updates.to(self.pool[name].dtype))
            return
        q, sc = llama.quantize_kv_blocks(updates, fmt.qmax, fmt.dtype)
        self._raw[name].index_copy_(0, flat, q.view(torch.uint8))
        self.pool[name + "_scale"].index_copy_(0, flat, sc)

    def _scatter(self, name, bt, g):
        """Write a gathered layout (trash row, if any, left out) back to
        every block it was gathered from."""
        B, nb = bt.shape
        L, _B, _S, Hkv, D = g.shape
        bs = self.block_size
        u = g[:, :, :nb * bs].view(L, B, nb, bs, Hkv, D)
        u = u.permute(1, 2, 0, 3, 4, 5).reshape(B * nb, L, bs, Hkv, D)
        self._set_blocks(name, bt.reshape(-1), u)

    def _write_rows(self, ks, vs, write_bt):
        """Prefill K/V rows (L, G, P, Hkv, D) into blocks ``write_bt``
        (G, nw); rows past P are zero padding."""
        flat = write_bt.reshape(-1)
        nw = write_bt.shape[1]
        self._set_blocks("k", flat, self._rows_to_blocks(ks, nw))
        self._set_blocks("v", flat, self._rows_to_blocks(vs, nw))

    def _rows_to_blocks(self, rows, nw):
        """(L, G, P, Hkv, D) -> (G*nw, L, bs, Hkv, D) block updates."""
        L, G, P, Hkv, D = rows.shape
        bs = self.block_size
        if P != nw * bs:
            rows = F.pad(rows, (0, 0, 0, 0, 0, nw * bs - P))
        u = rows.view(L, G, nw, bs, Hkv, D).permute(1, 2, 0, 3, 4, 5)
        return u.reshape(G * nw, L, bs, Hkv, D)

    @torch.no_grad()
    def _prefill_cold(self, tokens, lengths, write_bt):
        """The dense plane's prefill computation (same first tokens and
        K/V rows); only the insert differs."""
        last_logits, ks, vs = llama.prefill_forward(
            self.params, tokens, lengths, self.cfg)
        self._write_rows(ks, vs, write_bt)
        return torch.argmax(last_logits, dim=-1)

    @torch.no_grad()
    def _prefill_warm(self, tokens, lengths, pos0, prefix_bt, write_bt):
        """Prefix-cache hit: the SUFFIX attends the gathered shared
        blocks plus itself; the shared prefix is never recomputed."""
        cfg, params = self.cfg, self.params
        G, P = tokens.shape
        Sp = prefix_bt.shape[1] * self.block_size
        dev = tokens.device
        positions = pos0[:, None] + torch.arange(P, device=dev)[None, :]
        sin, cos = llama.rope_table(positions, cfg.head_dim, cfg.rope_theta)
        x = params["embed_tokens"][tokens]
        ckp = self._gather("k", prefix_bt)
        cvp = self._gather("v", prefix_bt)
        prefix_pos = torch.arange(Sp, device=dev)
        key_abs = torch.cat([prefix_pos[None, :].expand(G, Sp), positions],
                            dim=1)
        key_valid = torch.cat([prefix_pos[None, :] < pos0[:, None],
                               torch.ones((G, P), dtype=torch.bool,
                                          device=dev)], dim=1)
        scale = cfg.head_dim ** -0.5
        ks, vs = [], []
        for i, layer in enumerate(llama._layers(params)):
            q, k, v = llama._qkv_rope(x, layer, sin, cos, cfg)
            keys = torch.cat([ckp[i], k.to(ckp.dtype)], dim=1)
            vals = torch.cat([cvp[i], v.to(cvp.dtype)], dim=1)
            attn = _masked_attend(q, keys, vals, positions, key_abs,
                                  key_valid, scale)
            x = llama._attn_out_mlp(x, attn, layer, cfg)
            ks.append(k)
            vs.append(v)
        x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
        idx = (lengths - 1).clamp_min(0)
        last = x[torch.arange(G, device=dev), idx][:, None]
        logits = llama.matmul(last, llama._head(params, cfg))[:, 0]
        self._write_rows(torch.stack(ks), torch.stack(vs), write_bt)
        return torch.argmax(logits, dim=-1)

    @torch.no_grad()
    def _decode_paged(self, ov_tok, ov_len, ov_mask, active, bt, k):
        """Gather the tables' blocks, run ``k`` decode steps on the
        gathered layout, scatter every gathered block back."""
        S = bt.shape[1] * self.block_size
        cache = {name: self._gather(name, bt, trash_row=True)
                 for name in ("k", "v")}
        toks = self._decode_k(cache, ov_tok, ov_len, ov_mask, active, k, S)
        for name in ("k", "v"):
            self._scatter(name, bt, cache[name])
        return toks

    @torch.no_grad()
    def _spec_verify(self, tokens, positions, active, bt):
        """Target-model verification of a draft proposal: T tokens per
        slot in ONE pass over the gathered layout.  tokens/positions:
        (B, T), [last accepted, d1..d_{T-1}] at absolute positions;
        returns the target's greedy tokens for positions+1 (B, T) and
        writes the inputs' K/V at their positions (gathered index ==
        absolute position, as in the decode step)."""
        cfg, params = self.cfg, self.params
        B, T = tokens.shape
        S = bt.shape[1] * self.block_size
        ck = self._gather("k", bt, trash_row=True)
        cv = self._gather("v", bt, trash_row=True)
        x = params["embed_tokens"][tokens]
        sin, cos = llama.rope_table(positions, cfg.head_dim, cfg.rope_theta)
        # Rows in place of the reference's one-hot projection (exact
        # there too): inactive slots and positions past the layout write
        # the trash row.
        rows = torch.where(active[:, None] & (positions < S), positions,
                           torch.full_like(positions, S))
        bidx = torch.arange(B, device=self.device)[:, None]
        scale = cfg.head_dim ** -0.5
        for i, layer in enumerate(llama._layers(params)):
            q, kk, vv = llama._qkv_rope(x, layer, sin, cos, cfg)
            ck_l, cv_l = ck[i], cv[i]
            ck_l[bidx, rows] = kk.to(ck_l.dtype)
            cv_l[bidx, rows] = vv.to(cv_l.dtype)
            attn = llama._cache_attend(q, ck_l[:, :S], cv_l[:, :S],
                                       positions, scale)
            x = llama._attn_out_mlp(x, attn, layer, cfg)
        x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
        toks = torch.argmax(llama.matmul(x, llama._head(params, cfg)),
                            dim=-1)
        self._scatter("k", bt, ck)
        self._scatter("v", bt, cv)
        return toks

    # -------------------------------------------------- draft plane (spec)
    def _init_draft(self, draft_preset, draft_layers, draft_params, seed):
        """The speculative draft: its config and params and a DENSE
        per-slot KV cache (the draft is small; paging it buys nothing).
        It rides the dense plane's decode step."""
        cfg = self.cfg
        if draft_preset is not None:
            dcfg = getattr(llama.LlamaConfig, draft_preset)(
                max_seq_len=self.max_len)
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {dcfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}: proposals must share the token "
                    f"space")
            if draft_params is None:
                draft_params = llama.init_params(dcfg, seed=seed + 1,
                                                 device=self.device)
            dparams = _cast_params(draft_params, dcfg.dtype, self.device)
        else:
            # Layer-truncated self-draft: the target's first n layers +
            # its own norm/head, as views (no extra weights).
            n = draft_layers or max(1, cfg.n_layers // 4)
            if not 0 < n < cfg.n_layers:
                raise ValueError(
                    f"draft_layers={n} must be in [1, {cfg.n_layers - 1}]")
            dcfg = dataclasses.replace(cfg, n_layers=n)
            dparams = {k: v for k, v in self.params.items()
                       if k != "layers"}
            dparams["layers"] = {k: w[:n]
                                 for k, w in self.params["layers"].items()}
        self.draft_cfg = dcfg
        self.draft_params = dparams
        # One trash row past max_len, as the dense cache has.
        self.draft_cache = llama.init_kv_cache(dcfg, self.max_slots,
                                               self.max_len + 1,
                                               device=self.device)
        # Accept-rate accounting (host truth for kv_stats).
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_tok_ema: Optional[float] = None

    @torch.no_grad()
    def _draft_prefill(self, tokens, lengths, slots):
        _logits, ks, vs = llama.prefill_forward(
            self.draft_params, tokens, lengths, self.draft_cfg)
        llama.insert_prefill(self.draft_cache, ks, vs, slots)

    @torch.no_grad()
    def _draft_propose(self, tok, pos, active, k, s_active):
        """``k`` greedy draft steps from ``tok`` at ``pos``: the (k, B)
        proposals d1..dk."""
        step = self._make_decode_step(self.draft_params, self.draft_cache,
                                      active, s_active, cfg=self.draft_cfg)
        toks = []
        for _ in range(k):
            tok, pos = step(tok, pos)
            toks.append(tok)
        return torch.stack(toks)

    # ------------------------------------------------------------ warmup
    @torch.no_grad()
    def _warmup(self):
        """Run every prefill shape (cold and warm on the paged plane) and
        every decode bucket (verify pass, with spec) once up front, so
        allocator and library handles are warm before the first
        request; padding tables write only the null block, and no slot
        is written."""
        dev = self.device
        B = self.max_slots
        for g in self.prefill_groups:
            lengths = torch.ones(g, dtype=torch.long, device=dev)
            no_slot = np.full(g, -1)
            for bucket in self.buckets:
                toks = torch.zeros((g, bucket), dtype=torch.long,
                                   device=dev)
                if self.paged:
                    nw = -(-bucket // self.block_size)
                    pad_bt = torch.full((g, nw), self._pad_block,
                                        dtype=torch.long, device=dev)
                    pre = torch.full((g, self._np_max), self._pad_block,
                                     dtype=torch.long, device=dev)
                    self._prefill_cold(toks, lengths, pad_bt)
                    self._prefill_warm(toks, lengths,
                                       torch.zeros_like(lengths), pre,
                                       pad_bt)
                else:
                    self._prefill(toks, lengths, no_slot)
                if self.spec_k:
                    self._draft_prefill(toks, lengths, no_slot)
        active = torch.zeros(B, dtype=torch.bool, device=dev)
        ov = torch.zeros(B, dtype=torch.long, device=dev)
        if not self.paged:
            for sa in self.decode_buckets:
                self._decode_k(self.cache, ov, ov, active, active,
                               self.decode_chunk, int(sa))
        else:
            for nb in self._nb_buckets:
                bt = torch.full((B, nb), self._pad_block, dtype=torch.long,
                                device=dev)
                if self.spec_k:
                    # Spec rounds replace decode chunks.
                    zeros = torch.zeros((B, self.spec_k), dtype=torch.long,
                                        device=dev)
                    self._spec_verify(zeros, zeros, active, bt)
                else:
                    self._decode_paged(ov, ov, active, active, bt,
                                       self.decode_chunk)
            if self.spec_k:
                for sa in self.decode_buckets:
                    self._draft_propose(ov, ov, active, self.spec_k, int(sa))
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
        end position after this chunk (dense plane)."""
        high = 0
        for s in range(self.max_slots):
            if self.slot_req[s] is not None:
                high = max(high, int(self.slot_len[s]) + self.decode_chunk)
        for b in self.decode_buckets:
            if high <= b:
                return b
        return self.decode_buckets[-1]

    def _nb_bucket(self, nb: int) -> int:
        for b in self._nb_buckets:
            if nb <= b:
                return b
        return self._nb_buckets[-1]

    def _drain_queue(self):
        while True:
            try:
                self._backlog.append(self._queue.get_nowait())
            except queue.Empty:
                return

    def _shed(self, req: _Request, err: BaseException, where: str):
        """Fail ``req`` typed; a deadline shed also counts in
        ``ray_tpu_requests_expired_shed{where}``."""
        req.error = err
        if isinstance(err, DeadlineExceededError):
            overload_counters()["expired_shed"].inc(tags={"where": where})
        req.finish_notify()

    def _estimate_need_s(self, req: _Request) -> Optional[float]:
        """Estimated seconds to finish ``req`` from a standing start,
        from the measured prefill/chunk EMAs (None until measured)."""
        if self._chunk_ema is None:
            return None
        prefill = self._prefill_ema or self._chunk_ema
        if self.spec_k:
            # The chunk EMA measures one draft+verify round; tokens per
            # round vary with the accept rate.
            per_round = max(1.0, self._spec_tok_ema or 1.0)
            chunks = -(-req.max_new_tokens // int(per_round))
        else:
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
                    context={"where": "llm_admission"}),
                    "llm_admission")
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
                            context={"where": "llm_admission_infeasible"}),
                            "llm_admission_infeasible")
                        continue
            keep.append(r)
        self._backlog = keep

    def _admit_wave(self):
        """Move backlog requests into free slots and launch their
        prefills; first tokens are harvested in a later step.  On the
        paged plane a full pool stops the wave (retried at the next
        boundary), and a request that can never fit is shed typed."""
        self._drain_queue()
        self._admission_pass()
        if not self._backlog:
            return
        free = [s for s in range(self.max_slots) if self.slot_req[s] is None]
        wave: List[tuple] = []  # (slot, req, bucket, pos0)
        while free and self._backlog:
            req = self._backlog[0]
            try:
                entry = self._claim_slot(free[0], req)
            except BackPressureError as e:
                if self._req_impossible(req):
                    # Prompt + decode exceed the whole pool: fail it
                    # typed instead of wedging the head of the backlog.
                    self._backlog.pop(0)
                    self._shed(req, e, "llm_admission")
                    continue
                break  # pool pressure: retry at the next boundary
            self._backlog.pop(0)
            free.pop(0)
            wave.append(entry)
        if wave:
            self._launch_prefills(wave)

    def _req_impossible(self, req: _Request) -> bool:
        if not self.paged:
            return False
        # Generation truncates at the model horizon, so a huge
        # max_new_tokens never needs more than max_len positions.
        positions = min(len(req.prompt) + req.max_new_tokens, self.max_len)
        return -(-positions // self.block_size) > self.num_blocks - 1

    def _claim_slot(self, slot: int, req: _Request) -> tuple:
        """Bind ``req`` to ``slot``; the paged plane allocates its block
        table (prefix-cache fork first) and may raise a typed
        ``BackPressureError`` WITHOUT claiming.  Returns the prefill
        wave entry (slot, req, bucket, pos0)."""
        P = len(req.prompt)
        pos0 = 0
        if self.paged:
            shared = self.prefix_cache.lookup(req.prompt)
            table = BlockTable(self.allocator, shared=shared)
            try:
                table.ensure(P)
            except BaseException:
                table.release()  # give the forked prefix refs back
                raise
            self.slot_table[slot] = table
            pos0 = table.num_shared * self.block_size
            # The prompt's blocks are published into the trie at
            # HARVEST, not here: a same-wave request hitting the trie now
            # could gather blocks whose prefill has not run yet.
        self.slot_req[slot] = req
        self.slot_len[slot] = P
        self.slot_waiting[slot] = True
        return (slot, req, self._bucket(P - pos0), pos0)

    def _launch_prefills(self, wave: List[tuple]):
        # Group by (bucket, warm?): the two paged prefills differ.
        by_shape: Dict[tuple, List[tuple]] = {}
        for slot, req, bucket, pos0 in wave:
            by_shape.setdefault((bucket, pos0 > 0), []).append(
                (slot, req, pos0))
        for (bucket, warm), entries in by_shape.items():
            i = 0
            while i < len(entries):
                rest = len(entries) - i
                g = next((gg for gg in self.prefill_groups if gg >= rest),
                         self.prefill_groups[-1])
                self._launch_prefill_group(g, bucket, warm,
                                           entries[i:i + g])
                i += g

    def _launch_prefill_group(self, g, bucket, warm, group):
        dev = self.device
        toks = np.zeros((g, bucket), np.int64)
        lens = np.ones(g, np.int64)
        members = []
        t0 = time.perf_counter()
        if not self.paged:
            slots = np.full(g, -1, np.int64)
            for j, (slot, req, _pos0) in enumerate(group):
                P = len(req.prompt)
                toks[j, :P] = req.prompt
                lens[j] = P
                slots[j] = slot
                members.append((j, slot, req))
            with record_function("serve.prefill"):
                first = self._prefill(to_device(toks, dev),
                                      to_device(lens, dev), slots)
            self._pending_prefills.append((_HostCopy(first), members, t0))
            return
        bs = self.block_size
        nw = -(-bucket // bs)
        write_bt = np.full((g, nw), self._pad_block, np.int64)
        pos0s = np.zeros(g, np.int64)
        pre_bt = np.full((g, self._np_max), self._pad_block, np.int64)
        for j, (slot, req, pos0) in enumerate(group):
            P = len(req.prompt)
            suffix = req.prompt[pos0:]
            toks[j, :len(suffix)] = suffix
            lens[j] = len(suffix)
            pos0s[j] = pos0
            table = self.slot_table[slot]
            first_w = pos0 // bs
            wb = table.blocks[first_w:-(-P // bs)]
            write_bt[j, :len(wb)] = wb
            if warm:
                pre_bt[j, :first_w] = table.blocks[:first_w]
            members.append((j, slot, req))
        with record_function("serve.prefill"):
            if warm:
                first = self._prefill_warm(
                    to_device(toks, dev), to_device(lens, dev),
                    to_device(pos0s, dev), to_device(pre_bt, dev),
                    to_device(write_bt, dev))
            else:
                first = self._prefill_cold(
                    to_device(toks, dev), to_device(lens, dev),
                    to_device(write_bt, dev))
            if self.spec_k:
                # The draft prefills the FULL prompt (its dense cache is
                # per slot; prefix hits only skip TARGET compute).
                fb = self._bucket(max(len(req.prompt)
                                      for _s, req, _p in group))
                dtoks = np.zeros((g, fb), np.int64)
                dlens = np.ones(g, np.int64)
                dslots = np.full(g, -1, np.int64)
                for j, (slot, req, _pos0) in enumerate(group):
                    dtoks[j, :len(req.prompt)] = req.prompt
                    dlens[j] = len(req.prompt)
                    dslots[j] = slot
                self._draft_prefill(to_device(dtoks, dev),
                                    to_device(dlens, dev), dslots)
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
            self._emit_ema("prefill", self._prefill_ema)
            for j, slot, req in members:
                if self.slot_req[slot] is not req:
                    continue  # preempted while the prefill was in flight
                if self.paged:
                    # Publish the prompt's full blocks for COW sharing
                    # only now that the prefill writing them has run (a
                    # same-wave lookup must never gather unwritten
                    # blocks).
                    self.prefix_cache.insert(req.prompt,
                                             self.slot_table[slot].blocks)
                tok = int(first[j])
                req.t_first_token = now
                req.tokens.append(tok)
                self._ov_tok[slot] = tok
                self._ov_len[slot] = self.slot_len[slot]
                self._ov_mask[slot] = True
                self.slot_waiting[slot] = False
                if len(req.tokens) >= req.max_new_tokens:
                    self._finish(slot)
        self._pending_prefills.clear()

    def _release_slot(self, slot: int) -> Optional[_Request]:
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self.slot_len[slot] = 0
        self._ov_mask[slot] = False
        self.slot_waiting[slot] = False
        if self.paged:
            table, self.slot_table[slot] = self.slot_table[slot], None
            if table is not None:
                table.release()
        return req

    def _finish(self, slot: int):
        req = self._release_slot(slot)
        if req is not None:
            req.done = True
            req.finish_notify()

    def _preempt(self, slot: int):
        """Pool pressure: evict the running request in ``slot`` back to
        the backlog (recompute on readmit: greedy decode reproduces its
        tokens exactly), freeing its blocks."""
        req = self._release_slot(slot)
        self._preempted += 1
        if req is not None and not req.done:
            req.tokens = []
            req.t_first_token = None
            self._backlog.append(req)

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

    def _idle_wait(self):
        """Idle: block for work instead of spinning."""
        try:
            self._backlog.append(self._queue.get(timeout=0.05))
        except queue.Empty:
            pass

    def _loop(self):
        if self.spec_k:
            return self._loop_spec()
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
                        self._idle_wait()
        except BaseException as e:  # noqa: BLE001
            self._fatal(e)

    def _loop_spec(self):
        """Speculative scheduler: the same admission, but each iteration
        is a synchronous draft + verify round (the next round's inputs
        depend on this round's host-side acceptance, so the one-deep
        pipeline does not apply)."""
        try:
            with torch.no_grad():
                while not self._stop.is_set():
                    self._admit_wave()
                    self._harvest_prefills()
                    did = self._spec_round()
                    if not did and not any(
                            r is not None for r in self.slot_req) \
                            and not self._backlog:
                        self._idle_wait()
        except BaseException as e:  # noqa: BLE001
            self._fatal(e)

    def _slot_ctx(self, req: _Request) -> int:
        return len(req.prompt) + len(req.tokens)

    def _table_bt(self, snapshot) -> np.ndarray:
        """The active slots' block tables, padded with the null block to
        the smallest block-count bucket that covers them."""
        nb = self._nb_bucket(max(len(self.slot_table[s])
                                 for s, _r, _l in snapshot))
        bt = np.full((self.max_slots, nb), self._pad_block, np.int64)
        for s, _req, _l in snapshot:
            blocks = self.slot_table[s].blocks[:nb]
            bt[s, :len(blocks)] = blocks
        return bt

    def _spec_round(self) -> bool:
        """One accept/rollback iteration: the draft proposes ``spec_k``
        greedy tokens per active slot, the target verifies all of them in
        one pass over the gathered layout, and the host emits the longest
        matching prefix plus, on a mismatch, the target's own correction
        token.  Greedy-exact by induction: every target argmax is
        computed from already-verified tokens.  Rejected suffixes hand
        their freshly grown blocks straight back (``BlockTable.trim``)."""
        k = self.spec_k
        dev = self.device
        snapshot, active = self._active_snapshot()
        while snapshot and not self._grow_tables(snapshot, spec=True):
            snapshot, active = self._active_snapshot()
        if not snapshot:
            return False
        B = self.max_slots
        tok = np.zeros(B, np.int64)
        pos = np.zeros(B, np.int64)
        high = 1
        for s, req, _l in snapshot:
            tok[s] = req.tokens[-1]
            pos[s] = self._slot_ctx(req) - 1
            high = max(high, int(pos[s]) + k + 1)
        t0 = time.perf_counter()
        sa = next((b for b in self.decode_buckets if high <= b),
                  self.decode_buckets[-1])
        active_dev = to_device(active, dev)
        with record_function("serve.spec_draft"):
            dts = self._draft_propose(to_device(tok, dev),
                                      to_device(pos, dev), active_dev,
                                      k, int(sa))
            # Blocking by design: the verify inputs need d1..d_{k-1}.
            dtoks = _HostCopy(dts).numpy()  # (k, B)
        # Verify inputs [last accepted, d1..d_{k-1}]: the outputs are the
        # target's tokens for positions pos+1..pos+k, one per proposal.
        vtoks = np.zeros((B, k), np.int64)
        vpos = np.zeros((B, k), np.int64)
        for s, _req, _l in snapshot:
            vtoks[s, 0] = tok[s]
            if k > 1:
                vtoks[s, 1:] = dtoks[:k - 1, s]
            vpos[s] = pos[s] + np.arange(k)
        bt = self._table_bt(snapshot)
        with record_function("serve.spec_verify"):
            g_dev = self._spec_verify(to_device(vtoks, dev),
                                      to_device(vpos, dev), active_dev,
                                      to_device(bt, dev))
            # Blocking by design: acceptance runs on the host.
            g = _HostCopy(g_dev).numpy()  # (B, k)
        now = time.perf_counter()
        dt = now - t0
        self._chunk_ema = (dt if self._chunk_ema is None
                           else 0.8 * self._chunk_ema + 0.2 * dt)
        self._emit_ema("spec_round", self._chunk_ema)
        proposed = accepted = emitted_total = 0
        for s, req, _l in snapshot:
            if self.slot_req[s] is not req or req.done:
                continue
            a = 0
            while a < k and int(dtoks[a, s]) == int(g[s, a]):
                a += 1
            proposed += k
            accepted += a
            emit = [int(x) for x in dtoks[:a, s]]
            if a < k:
                emit.append(int(g[s, a]))
            finished = False
            for t_tok in emit:
                req.tokens.append(t_tok)
                emitted_total += 1
                if (len(req.tokens) >= req.max_new_tokens
                        or self._slot_ctx(req) >= self.max_len - 1):
                    finished = True
                    break
            if finished:
                self._finish(s)
            else:
                ctx = self._slot_ctx(req)
                self.slot_table[s].trim(ctx)
                self.slot_len[s] = ctx
        per_slot = emitted_total / max(1, len(snapshot))
        self._spec_tok_ema = (per_slot if self._spec_tok_ema is None
                              else 0.8 * self._spec_tok_ema + 0.2 * per_slot)
        self._count_spec(proposed, accepted)
        return True

    def _emit_ema(self, program: str, seconds) -> None:
        """``ray_tpu_serve_program_seconds{deployment,program}``: the
        per-program execution-time EMA the feasibility shed steers by."""
        record_program_ema(_LABEL, program, seconds)

    def _count_spec(self, proposed: int, accepted: int) -> None:
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        if not proposed:
            return
        m = kv_cache_counters()
        tags = {"deployment": _LABEL}
        m["spec_proposed"].inc(proposed, tags=tags)
        m["spec_accepted"].inc(accepted, tags=tags)

    def _active_snapshot(self):
        snapshot = []  # (slot, req, len_at_launch)
        active = np.zeros(self.max_slots, bool)
        for s in range(self.max_slots):
            req = self.slot_req[s]
            if req is not None and not self.slot_waiting[s]:
                active[s] = True
                snapshot.append((s, req, int(self.slot_len[s])))
        return snapshot, active

    def _grow_tables(self, snapshot, spec: bool = False) -> bool:
        """Ensure every active slot's table covers this chunk's writes;
        preempt latest-deadline requests under pool pressure.  Returns
        False when the snapshot changed (caller re-snapshots).  ``spec``:
        size for one verify pass (inputs at positions ctx-1 ..
        ctx+spec_k-2) instead of a decode chunk."""
        k = self.spec_k if spec else self.decode_chunk
        for s, req, _len0 in snapshot:
            while True:
                try:
                    # Clamp at the model horizon and the request's own
                    # budget: near its end the one-deep pipeline launches
                    # a chunk past the positions any kept step touches
                    # (writes there land in the null block, reads stay
                    # under lens).
                    if spec:
                        base = len(req.prompt) + len(req.tokens) + k - 1
                    else:
                        base = int(self.slot_len[s]) + k
                    self.slot_table[s].ensure(min(
                        base, self.max_len,
                        len(req.prompt) + req.max_new_tokens))
                    break
                except BackPressureError as e:
                    victim = self._pick_victim()
                    sole = not any(self.slot_req[o] is not None
                                   for o in range(self.max_slots) if o != s)
                    if victim is None or (victim == s and sole):
                        # Sole block holder and the pool (after prefix
                        # reclaim) still cannot hold it: shed it typed.
                        self.slot_req[s].error = e
                        self._finish(s)
                        return False
                    # Preempt the latest-deadline holder, active or still
                    # waiting on its prefill, possibly the one being
                    # grown: recompute on readmit beats failing work.
                    self._preempt(victim)
                    return False
        return True

    def _pick_victim(self) -> Optional[int]:
        """Latest deadline loses (no deadline sorts last, newest arrival
        breaks ties): the EDF inverse.  Every occupied slot is a
        candidate, including ones still waiting on their prefill."""
        best = None
        best_key = None
        for s in range(self.max_slots):
            req = self.slot_req[s]
            if req is None:
                continue
            key = (req.deadline if req.deadline is not None
                   else float("inf"), req.arrival)
            if best_key is None or key > best_key:
                best_key = key
                best = s
        return best

    def _launch_chunk(self):
        """Enqueue the next decode chunk with host overrides for newly
        admitted slots.  Returns the in-flight handle, or None if no slot
        is active."""
        snapshot, active = self._active_snapshot()
        if self.paged:
            while snapshot and not self._grow_tables(snapshot):
                snapshot, active = self._active_snapshot()
        if not snapshot:
            return None
        k = self.decode_chunk
        dev = self.device
        t0 = time.perf_counter()
        # One non-blocking copy of the overrides and the active mask (a
        # copy: this thread mutates the arrays right after the launch).
        ov = to_device(np.stack([self._ov_tok, self._ov_len,
                                 self._ov_mask, active]), dev)
        ov_args = (ov[0], ov[1], ov[2] != 0, ov[3] != 0)
        with record_function("serve.decode_chunk"):
            if self.paged:
                bt = to_device(self._table_bt(snapshot), dev)
                toks = self._decode_paged(*ov_args, bt, k)
            else:
                toks = self._decode_k(self.cache, *ov_args, k,
                                      self._decode_bucket())
            toks = _HostCopy(toks)
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
        self._emit_ema("decode_chunk", self._chunk_ema)
        for slot, req, len0 in snapshot:
            if req is None or req.done or self.slot_req[slot] is not req:
                continue  # finished, or preempted after the launch
            for step in range(k):
                tok = int(toks[step, slot])
                if req.t_first_token is None:
                    req.t_first_token = now
                req.tokens.append(tok)
                if (len(req.tokens) >= req.max_new_tokens
                        or len0 + step + 1 >= self.max_len - 1):
                    self._finish(slot)
                    break

    # ------------------------------------------------------------- stats
    def kv_stats(self) -> Dict[str, Any]:
        """The paged-KV series of this process (allocator occupancy,
        prefix cache, speculative accept counts) plus this engine's
        allocator and spec state."""
        out = {k: v for k, v in metrics_summary().items()
               if k.startswith(("ray_tpu_kv_", "ray_tpu_prefix_",
                                "ray_tpu_spec_"))}
        if self.paged:
            out["allocator"] = {
                "used": self.allocator.used_blocks,
                "free": self.allocator.free_blocks,
                "prefix_blocks": self.prefix_cache.num_blocks,
                "preempted": self._preempted,
            }
            out["kv_quant"] = self.kv_quant
            out["pool_bytes"] = self.pool_bytes
        if self.spec_k:
            out["spec"] = {
                "k": self.spec_k,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "accept_rate": round(
                    self._spec_accepted / self._spec_proposed, 4)
                if self._spec_proposed else None,
            }
        return out

    # ------------------------------------------------------------ teardown
    def release_kv_cache(self):
        """Return every pool block (tables + prefix trie) to the
        allocator.  Stops the scheduler first: tearing tables out from
        under a live decode loop would fail in-flight requests untyped."""
        if not self.paged:
            return
        if not self._stop.is_set():
            self._fatal(RuntimeError("LLM engine evicted: KV cache "
                                     "released"))
            t = getattr(self, "_thread", None)
            if t is not None and t is not threading.current_thread():
                t.join(timeout=30.0)
        for s in range(self.max_slots):
            t, self.slot_table[s] = self.slot_table[s], None
            if t is not None:
                t.release()
        self.prefix_cache.drop()

    def shutdown(self):
        """Stop the scheduler thread, fail any waiters, release the KV
        blocks and drain in-flight device work."""
        self._fatal(RuntimeError("LLMServer shut down"))
        t = getattr(self, "_thread", None)
        if t is not None and t is not threading.current_thread():
            t.join(timeout=30.0)
        self.release_kv_cache()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __del__(self):
        stop = getattr(self, "_stop", None)  # init may have raised
        if stop is not None:
            stop.set()


def _masked_attend(q, keys, vals, q_pos, key_abs, key_valid, scale):
    """Cache attention with EXPLICIT key positions and validity: the warm
    prefill attends [gathered prefix blocks || suffix], where a key's
    gathered index no longer equals its absolute position for the suffix
    half.  q: (G, P, Hq, D); keys/vals: (G, S, Hkv, D); q_pos: (G, P);
    key_abs/key_valid: (G, S)."""
    G, P, Hq, D = q.shape
    Hkv = keys.shape[2]
    qg = q.reshape(G, P, Hkv, Hq // Hkv, D)
    mask = (key_valid[:, None, None, None, :]
            & (key_abs[:, None, None, None, :]
               <= q_pos[:, None, None, :, None]))
    return llama._softmax_attend(qg, keys, vals, mask, scale).reshape(
        G, P, Hq, D)


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


def _cast_params(params, dtype: torch.dtype, device: torch.device):
    """f32 leaves to the compute dtype, every leaf on ``device``."""
    if isinstance(params, dict):
        return {k: _cast_params(v, dtype, device) for k, v in params.items()}
    if params.dtype == torch.float32:
        return params.to(device, dtype)
    return params.to(device)

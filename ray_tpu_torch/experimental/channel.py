"""Mutable-object channels: the compiled-DAG data plane (reference:
python/ray/experimental/channel/shared_memory_channel.py:159).

The native C++ ring (ray_tpu_torch.native.channel) is the substrate; this
module is the adapter layer that puts it on the hot path:

- **Typed serialization into the ring**: values cross as the same flat
  wire layout the object plane uses (cluster/serialization.py extern
  array table), so numpy / tensor leaves move as raw bytes and rebuild
  zero-copy on the reader side.
- **In-actor endpoint resolution**: a ``ChannelArg`` placeholder in a
  task's arguments resolves to the edge's reader endpoint inside the
  executing actor (``__rt_channel_step__`` trampoline, dispatched by
  ``Runtime._lookup_callable``); writer endpoints create the backing
  ring lazily, sized from the first pass (or an explicit hint).
- **Per-pass fallback**: a payload exceeding the ring's slot capacity
  ships as an object-plane ref inside a tiny ring frame, so one huge
  pass never breaks the compiled plan.
- **Error propagation**: a producer failure writes an error frame
  (with structured context: actor, method, frame index, ring) before
  re-raising, so blocked consumers fail fast instead of timing out —
  and a consumer that reads an error frame fans it out to ITS writer
  rings before re-raising, so one dead producer fails the whole DAG
  pass instead of wedging downstream readers (poison-pill fan-out).
- **Self-healing reads**: ring reads are deadline-bounded and probe
  peer liveness between poll slices — both the peer PROCESS (pid probe
  in native/channel.cc, promoted from a test hook to the blocked-wait
  path) and the producer ACTOR's FSM state (a thread-actor in this
  process, or a remote actor via the head) — so a producer dying
  mid-pass without flushing an error frame surfaces as a typed
  ``ActorDiedError`` within one probe slice, never a wedged reader.
- **Chaos hooks**: every frame write consults the active
  ``experimental.chaos`` schedule (kill-at-Nth-write, sever-mid-frame),
  which is how the recovery paths above are tested deterministically.

Same-host producer→consumer actor edges of ``CompiledDAG`` and
adjacent ``train.cross_pipeline`` stages ride these rings at memcpy
speed — no per-pass object minting, no reference-counting traffic.
Cross-host and driver-facing edges keep riding the object plane.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, Optional, Sequence, Tuple

from ray_tpu_torch.native.channel import (Channel, ChannelClosed,
                                    ChannelPeerDied)

from ..exceptions import (ActorDiedError, ActorError, ChannelError,
                          ObjectLostError, _picklable_cause)
from ..observability import tracing as _tracing
from ..observability.profiling import stuck_guard as _stuck_guard
from . import chaos as _chaos

__all__ = [
    "Channel", "ChannelClosed", "ChannelPeerDied", "ChannelArg",
    "ChannelError", "ChannelWriter", "ChannelReader", "KVBlockFrame",
    "channels_available", "channel_path", "submit_channel_call",
    "channel_host", "channel_location", "destroy_channel",
    "destroy_channel_at", "CHANNEL_STEP_METHOD",
]

# Actor-task descriptor name dispatched to the channel trampoline by
# Runtime._lookup_callable (core/runtime.py keeps the same literal).
CHANNEL_STEP_METHOD = "__rt_channel_step__"

DEFAULT_TIMEOUT_S = 120.0
_MIN_SLOT_BYTES = 64 * 1024
# Blocked reads poll in slices this long, probing producer liveness
# between slices (native pid probe + actor FSM state).
_READ_POLL_S = 0.2
# Actor-state probes (may cost a head RPC for remote producers) are
# throttled to this period.
_PROBE_PERIOD_S = 0.5

# Frame tags (first byte of every ring frame).
_TAG_VALUE = 0x57   # "W": flat wire bytes follow
_TAG_REF = 0x52     # "R": pickled ObjectRef (payload exceeded the slot)
_TAG_ERROR = 0x45   # "E": pickled {"err": exc, "ctx": {...}} dict
_TAG_KV = 0x4B      # "K": KV-block frame (paged-KV handoff: pickled
#                     meta + raw block slabs, serialization.export_kv_blocks
#                     layout) — read back as a KVBlockFrame

_available: Optional[bool] = None
_avail_lock = threading.Lock()

def _chan_metrics():
    """Ring data-plane series (rebuilt after registry resets):
    write/read wait histograms, frames/bytes counters, and the
    oversize object-plane-fallback counter."""
    from ..observability import metrics as _metrics

    wait_bounds = [1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0]
    return _metrics.metric_group("channel", lambda: {
        "write_wait": _metrics.Histogram(
            "ray_tpu_channel_write_wait_seconds",
            "blocked time per ring frame write",
            boundaries=wait_bounds, tag_keys=("ring",)),
        "read_wait": _metrics.Histogram(
            "ray_tpu_channel_read_wait_seconds",
            "blocked time per ring frame read",
            boundaries=wait_bounds, tag_keys=("ring",)),
        "frames": _metrics.Counter(
            "ray_tpu_channel_frames_total",
            "ring frames moved", tag_keys=("ring", "dir")),
        "bytes": _metrics.Counter(
            "ray_tpu_channel_bytes_total",
            "ring payload bytes moved", tag_keys=("ring", "dir")),
        "fallback": _metrics.Counter(
            "ray_tpu_channel_fallback_total",
            "oversize payloads shipped as object-plane ref frames",
            tag_keys=("ring",)),
    })


def _flow_id(ring: str, seq: int) -> int:
    """Deterministic flow-event id for one ring frame: both endpoints
    compute it independently (SPSC FIFO keeps their seq counters in
    lockstep), so the merged timeline draws producer→consumer arrows
    without any metadata crossing the ring."""
    import zlib

    return (zlib.crc32(ring.encode()) << 20) | (seq & 0xFFFFF)


def channels_available() -> bool:
    """True when the native ring builds/loads on this host (g++ in the
    image); callers degrade to the object plane when False."""
    global _available
    if _available is None:
        with _avail_lock:
            if _available is None:
                try:
                    from ray_tpu_torch.native.channel import _load

                    _load()
                    _available = True
                except Exception:
                    _available = False
    return _available


def channel_path(tag: str) -> str:
    """Unique ring path in memory-backed storage."""
    base = ("/dev/shm" if os.path.isdir("/dev/shm")
            else tempfile.gettempdir())
    return os.path.join(
        base, f"rtchan-{os.getpid()}-{tag}-{uuid.uuid4().hex[:8]}")


# ChannelError now lives in ray_tpu_torch.exceptions (imported above) so the
# runtime can propagate it typed through task results.


def _producer_state(producer) -> Optional[str]:
    """FSM state of the producer actor feeding a ring, from wherever
    this process can see it: the local actor table (thread actors in
    this process), else the head's registry.  None = unknown (no
    runtime, no producer recorded, or the lookup failed) — callers
    treat unknown as alive and keep waiting out their deadline."""
    if producer is None:
        return None
    from ..core.runtime import try_get_runtime

    rt = try_get_runtime()
    if rt is None:
        return None
    core = rt.actor_manager.get_core(producer)
    if core is not None:
        state = core.info.state.value
        return "ALIVE" if state == "PENDING_CREATION" else state
    if rt.cluster is None:
        return None
    try:
        _loc, state = rt.cluster.locate_actor_with_state(producer)
    except Exception:
        return None
    return state


def _death_report_context() -> dict:
    """Postmortem context for FT errors raised at channel edges: the
    newest death report this process's cluster client has seen (at
    most one bounded head probe per node, then cache-only — an error
    path, never the frame hot path)."""
    try:
        from ..core.runtime import try_get_runtime

        rt = try_get_runtime()
        if rt is not None and rt.cluster is not None:
            return rt.cluster.death_context(wait_s=0)
    except Exception:
        pass
    return {}


def _raise_if_producer_gone(producer, path: str) -> None:
    state = _producer_state(producer)
    if state in ("DEAD", "RESTARTING"):
        raise ActorDiedError(
            producer,
            f"producer of channel ring died mid-pass (state={state})",
            context={"ring": os.path.basename(path),
                     **_death_report_context()})


def _round_up_pow2(n: int) -> int:
    p = _MIN_SLOT_BYTES
    while p < n:
        p <<= 1
    return p


# ---------------------------------------------------------------------------
# Endpoints (process-wide, resolved lazily inside the executing worker)
# ---------------------------------------------------------------------------

class KVBlockFrame:
    """A received KV-block frame (paged-serving prefill→decode
    handoff): ``meta`` is the block-table header
    (``cluster/serialization.export_kv_blocks``), ``data`` the raw
    concatenated block slabs — rebuild zero-copy per-block views with
    ``serialization.kv_blocks_from_wire(meta, data)``."""

    __slots__ = ("meta", "data")

    def __init__(self, meta: dict, data):
        self.meta = meta
        self.data = data


class ChannelWriter:
    """Producer endpoint.  Creates the backing ring at first put, sized
    from the first payload unless ``slot_bytes`` hints otherwise."""

    def __init__(self, path: str, n_slots: int = 8, slot_bytes: int = 0,
                 timeout: float = DEFAULT_TIMEOUT_S):
        import collections

        self.path = path
        self.n_slots = max(2, int(n_slots))
        self.slot_bytes_hint = int(slot_bytes)
        self.timeout = timeout
        self._chan: Optional[Channel] = None
        self._lock = threading.Lock()
        # Value frames written so far ≙ this edge's pass index (FIFO
        # submission keeps frames in pass order); rides error-frame
        # context and is the chaos kill/sever trigger coordinate.
        self._seq = 0
        # Oversize-fallback refs pinned until their frame is long
        # consumed.  The reader resolves a ref frame inline before its
        # next read, and the ring caps the writer at n_slots frames
        # ahead, so by the time a ref is evicted here (2*n_slots
        # writes later) its get() has completed.
        self._fallback_refs = collections.deque(
            maxlen=2 * self.n_slots + 2)

    def _ensure(self, frame_len: int) -> Channel:
        with self._lock:
            if self._chan is None:
                # A stale producer must not re-create a torn-down ring.
                _check_not_destroyed(self.path)
                slot = _round_up_pow2(
                    max(self.slot_bytes_hint, frame_len))
                Channel.create(self.path, n_slots=self.n_slots,
                               slot_bytes=slot)
                self._chan = Channel(self.path, writer=True)
            return self._chan

    def _chaos_gate(self) -> None:
        """Consult the active chaos schedule before a frame write: may
        raise ChaosKill (producer dies mid-pass, nothing flushed) or
        sever the ring (both sides observe ChannelClosed)."""
        action = _chaos.ring_write_action(self.path, self._seq)
        if action is None:
            return
        if action[0] == "kill":
            raise _chaos.ChaosKill(
                f"killed at write #{self._seq} of "
                f"{os.path.basename(self.path)}",
                no_restart=action[1])
        if action[0] == "sever":
            try:
                self._ensure(1).close()
            except Exception:
                pass

    def put_value(self, value: Any) -> None:
        """Serialize ``value`` into the ring as its flat wire layout
        (tag, meta pickle, payload, raw extern bytes) assembled
        directly in slot memory — one memcpy.  A payload exceeding the
        slot capacity falls back to an object-plane ref frame so the
        pass completes without breaking the plan."""
        from ..cluster.serialization import serialize, wire_layout

        self._seq += 1
        self._chaos_gate()
        meta, bufs = wire_layout(serialize(value))
        hdr = pickle.dumps(meta, protocol=pickle.HIGHEST_PROTOCOL)
        parts = [bytes([_TAG_VALUE]), len(hdr).to_bytes(4, "big"),
                 hdr, *bufs]
        total = 5 + len(hdr) + sum(len(b) for b in bufs)
        chan = self._ensure(total)
        ring = os.path.basename(self.path)
        if total > chan.slot_bytes:
            parts = [self._ref_frame(value)]
            total = len(parts[0])
            _chan_metrics()["fallback"].inc(tags={"ring": ring})
        t_wall = time.time()
        t0 = time.perf_counter()
        chan.put_parts(parts, timeout=self.timeout)
        m = _chan_metrics()
        m["write_wait"].observe(time.perf_counter() - t0,
                                tags={"ring": ring})
        tags = {"ring": ring, "dir": "write"}
        m["frames"].inc(tags=tags)
        m["bytes"].inc(total, tags=tags)
        if _tracing.enabled():
            # Flow start: the consumer's read of this frame emits the
            # matching finish.  Stamped with the wall time from BEFORE
            # the frame was published — the consumer can read and
            # record its finish before this thread gets scheduled
            # again, and a start timestamped after its finish loses
            # the producer→consumer arrow in the renderer.
            from ..observability.timeline import (process_pid,
                                                  record_flow)

            record_flow(f"ring:{ring}", _flow_id(ring, self._seq), "s",
                        pid=process_pid(),
                        tid=threading.current_thread().name,
                        ts=t_wall, args={"seq": self._seq})

    def put_kv_blocks(self, meta: dict, bufs: Sequence) -> int:
        """Write one KV-block frame (the paged-serving handoff fast
        path): pickled block-table meta followed by the raw block
        slabs, assembled directly in slot memory — the sender's pool
        views memcpy once, the reader rebuilds zero-copy views.  A
        frame exceeding the slot capacity falls back to an object-plane
        ref (the reader's generic ref path resolves it), so one
        oversize prompt never wedges the handoff ring.  Returns the
        payload byte count (the transport counters' input)."""
        self._seq += 1
        self._chaos_gate()
        hdr = pickle.dumps(meta, protocol=pickle.HIGHEST_PROTOCOL)
        parts = [bytes([_TAG_KV]), len(hdr).to_bytes(4, "big"),
                 hdr, *bufs]
        total = 5 + len(hdr) + sum(len(b) for b in bufs)
        chan = self._ensure(total)
        ring = os.path.basename(self.path)
        if total > chan.slot_bytes:
            import numpy as np

            flat = bytearray(total - 5 - len(hdr))
            off = 0
            for b in bufs:
                flat[off:off + len(b)] = b
                off += len(b)
            parts = [self._ref_frame(
                KVBlockFrame(meta, np.frombuffer(bytes(flat),
                                                 dtype=np.uint8)))]
            # The ring carried only the ref frame — the payload rode
            # the object plane; counting the full KV bytes here would
            # permanently skew write-vs-read series for this ring.
            total = len(parts[0])
            _chan_metrics()["fallback"].inc(tags={"ring": ring})
        t0 = time.perf_counter()
        chan.put_parts(parts, timeout=self.timeout)
        m = _chan_metrics()
        m["write_wait"].observe(time.perf_counter() - t0,
                                tags={"ring": ring})
        tags = {"ring": ring, "dir": "write"}
        m["frames"].inc(tags=tags)
        m["bytes"].inc(total, tags=tags)
        return total

    def _ref_frame(self, value: Any) -> bytes:
        from ..core.runtime import get_runtime

        ref = get_runtime().put(value)
        # Pin the ref: dropping our only reference here would let the
        # out-of-scope reaper free the object before the consumer's
        # get() resolves it.
        self._fallback_refs.append(ref)
        return bytes([_TAG_REF]) + pickle.dumps(
            ref, protocol=pickle.HIGHEST_PROTOCOL)

    def put_error(self, err: BaseException,
                  ctx: Optional[dict] = None) -> None:
        """Best-effort: wake the consumer with the producer's failure
        instead of letting it block out its timeout.  The frame carries
        structured context (ring, frame/pass index, plus whatever the
        caller knows: actor, method) so the error surfacing at the
        driver names the originating edge."""
        frame_ctx = {"ring": os.path.basename(self.path),
                     "frame_seq": self._seq, **(ctx or {})}
        cur = _tracing.current()
        if cur is not None and "trace_id" not in frame_ctx:
            frame_ctx["trace_id"] = cur[0]
        try:
            payload = pickle.dumps({"err": _picklable_cause(err),
                                    "ctx": frame_ctx},
                                   protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:
            payload = pickle.dumps(
                {"err": RuntimeError(f"{type(err).__name__}: {err}"),
                 "ctx": frame_ctx})
        try:
            chan = self._ensure(len(payload) + 1)
            chan.put(bytes([_TAG_ERROR]) + payload, timeout=5.0)
        except Exception:
            pass

    def destroy(self) -> None:
        """Close (wakes both sides) and unlink.  The mapping itself is
        freed when the last reference to the Channel drops — a task
        thread still blocked inside put() holds one, so we never unmap
        under it."""
        with self._lock:
            chan, self._chan = self._chan, None
        self._fallback_refs.clear()
        if chan is not None:
            chan.close()
            try:
                os.unlink(chan.path)
            except OSError:
                pass


class ChannelReader:
    """Consumer endpoint.  Waits for the writer-created ring to appear
    on first use (creation is writer-side, sized from the first pass)."""

    def __init__(self, path: str, timeout: float = DEFAULT_TIMEOUT_S):
        self.path = path
        self.timeout = timeout
        self._chan: Optional[Channel] = None
        self._lock = threading.Lock()
        # Value/ref frames consumed so far — mirrors the writer's _seq
        # (SPSC FIFO), keying the consumer half of flow events.
        self._seq = 0
        # Lets close() break a reader still waiting for the ring FILE
        # to appear (the native close flag can only wake waits on an
        # existing ring).
        self._closed = threading.Event()

    def _ensure(self, producer=None,
                deadline: Optional[float] = None) -> Channel:
        """The waiting loop runs WITHOUT holding ``_lock``: it sleeps
        and probes producer liveness (which can cost a head RPC), and a
        blocked wait under the lock would also wedge ``close()`` behind
        a full read timeout.  The lock only guards the install of
        ``self._chan`` against a concurrent ``close()``."""
        with self._lock:
            if self._chan is not None:
                return self._chan
        if deadline is None:
            deadline = time.monotonic() + self.timeout
        probe_at = time.monotonic() + _PROBE_PERIOD_S
        while True:
            if self._closed.is_set():
                raise ChannelError(
                    "ring torn down while waiting for its "
                    "writer to create it",
                    context={"ring": os.path.basename(self.path)})
            _check_not_destroyed(self.path)
            try:
                chan = Channel(self.path, writer=False)
            except FileNotFoundError:
                now = time.monotonic()
                if now >= probe_at:
                    # The writer creates the ring at its first
                    # put: a dead producer means it never will.
                    probe_at = now + _PROBE_PERIOD_S
                    _raise_if_producer_gone(producer, self.path)
                if now > deadline:
                    # Typed (not a bare TimeoutError): the
                    # poison-pill fan-out and replan paths key
                    # on FT error types.
                    raise ChannelError(
                        "ring was never created by its writer "
                        f"(waited {self.timeout:.0f}s)",
                        context={"ring":
                                 os.path.basename(self.path)})
                time.sleep(0.001)
                continue
            with self._lock:
                if self._closed.is_set():
                    chan.close()
                    raise ChannelError(
                        "ring torn down while waiting for its "
                        "writer to create it",
                        context={"ring": os.path.basename(self.path)})
                if self._chan is None:
                    self._chan = chan
                elif chan is not self._chan:
                    chan.close()  # lost a (theoretical) install race
                return self._chan

    def _read_frame(self, producer) -> bytearray:
        """Deadline-bounded blocking read.  Polls in short slices and
        probes producer liveness between them; a producer dying WITHOUT
        flushing an error frame (hard kill) surfaces as a typed
        ActorDiedError within ~one probe period instead of wedging the
        reader until its full timeout.  ONE timeout budget covers both
        waiting for the ring to exist and waiting for the frame."""
        deadline = time.monotonic() + self.timeout
        # Stuck detector: this loop PROMISES to resolve (frame, typed
        # error, or deadline raise) within self.timeout — running
        # STUCK_FACTOR x past that means the machinery itself is wedged
        # (a native wait stuck, a liveness-probe RPC hung); snapshot
        # the stacks at that moment for the post-mortem.
        with _stuck_guard("channel_wait", self.timeout,
                          {"ring": os.path.basename(self.path)}):
            return self._read_frame_bounded(producer, deadline)

    def _read_frame_bounded(self, producer, deadline) -> bytearray:
        chan = self._ensure(producer, deadline)
        probe_at = 0.0
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise ChannelError(
                    f"read deadline ({self.timeout:.0f}s) expired",
                    context={"ring": os.path.basename(self.path)})
            try:
                return chan.get_buffer(timeout=min(_READ_POLL_S, left))
            except ChannelPeerDied as e:
                # Native pid probe: the writer PROCESS is gone.
                raise ActorDiedError(
                    producer,
                    "producer process of channel ring died mid-pass",
                    context={"ring": os.path.basename(self.path),
                             **_death_report_context()}) from e
            except ChannelClosed as e:
                # Severed / torn down under us: typed, not a raw
                # ConnectionError, so one close fails the pass fast.
                raise ChannelError(
                    f"ring closed mid-pass: {e}",
                    context={"ring": os.path.basename(self.path)}) from e
            except TimeoutError:
                now = time.monotonic()
                if now >= probe_at:
                    probe_at = now + _PROBE_PERIOD_S
                    # Actor-FSM probe: catches thread actors in this
                    # process (same pid, invisible to the native probe)
                    # and head-reported remote deaths/restarts.
                    _raise_if_producer_gone(producer, self.path)

    def get_value(self, producer=None) -> Any:
        from ..cluster.serialization import deserialize, sealed_from_flat

        t0 = time.perf_counter()
        data = self._read_frame(producer)
        ring = os.path.basename(self.path)
        m = _chan_metrics()
        m["read_wait"].observe(time.perf_counter() - t0,
                               tags={"ring": ring})
        if not data:
            raise ChannelError(
                "empty frame",
                context={"ring": os.path.basename(self.path)})
        tag = data[0]
        if tag in (_TAG_VALUE, _TAG_REF, _TAG_KV):
            self._seq += 1
            tags = {"ring": ring, "dir": "read"}
            m["frames"].inc(tags=tags)
            m["bytes"].inc(len(data), tags=tags)
            if _tracing.enabled():
                from ..observability.timeline import (process_pid,
                                                      record_flow)

                record_flow(f"ring:{ring}", _flow_id(ring, self._seq),
                            "f", pid=process_pid(),
                            tid=threading.current_thread().name,
                            args={"seq": self._seq})
        if tag == _TAG_VALUE:
            mv = memoryview(data)
            hl = int.from_bytes(mv[1:5], "big")
            meta = pickle.loads(mv[5:5 + hl])
            # Array leaves are zero-copy views into the frame buffer
            # (already our private copy straight out of the slot).
            return deserialize(sealed_from_flat(meta, mv[5 + hl:]))
        if tag == _TAG_KV:
            mv = memoryview(data)
            hl = int.from_bytes(mv[1:5], "big")
            meta = pickle.loads(mv[5:5 + hl])
            # Raw block slabs stay a zero-copy view over the private
            # frame copy; the consumer scatters them into its pool.
            return KVBlockFrame(meta, mv[5 + hl:])
        if tag == _TAG_REF:
            from ..core.runtime import get_runtime

            ref = pickle.loads(memoryview(data)[1:])
            return get_runtime().get(ref)
        if tag == _TAG_ERROR:
            payload = pickle.loads(memoryview(data)[1:])
            if isinstance(payload, dict):
                err, ctx = payload.get("err"), dict(
                    payload.get("ctx") or {})
            else:  # legacy bare-exception frame
                err, ctx = payload, {}
            if isinstance(err, (ActorError, ObjectLostError,
                                ChannelError)):
                # Already typed + contextual (poison-pill fan-out keeps
                # the ORIGINATING edge's context intact hop to hop).
                raise err
            raise ChannelError(
                f"producer failed: {type(err).__name__}: {err}",
                context=ctx) from err
        raise ChannelError(
            f"unknown frame tag {tag:#x}",
            context={"ring": os.path.basename(self.path)})

    def close(self) -> None:
        # Flag first: a waiter inside _ensure's creation loop (which
        # polls outside the lock) exits within one iteration.
        self._closed.set()
        with self._lock:
            chan, self._chan = self._chan, None
        if chan is not None:
            chan.close()


# Per-process endpoint caches: the same ring is written/read by exactly
# one endpoint object per process regardless of how many actor tasks
# touch it (SPSC ring contract).
_writers: Dict[str, ChannelWriter] = {}
_readers: Dict[str, ChannelReader] = {}
_ep_lock = threading.Lock()
# Tombstones of destroyed ring paths (paths are uuid-unique, never
# reused).  A STALE task from an aborted pass touching a torn-down
# edge gets a fresh endpoint (its cached one was popped at destroy) —
# without the tombstone a stale reader would wait its full timeout for
# a ring file that will never reappear (wedging the actor FIFO behind
# it), and a stale producer's error path would re-CREATE the destroyed
# ring file.  Bounded FIFO (dict preserves insertion order).
_destroyed: Dict[str, None] = {}
_MAX_TOMBSTONES = 1024


def _mark_destroyed(path: str) -> None:
    """Caller holds _ep_lock."""
    _destroyed[path] = None
    while len(_destroyed) > _MAX_TOMBSTONES:
        _destroyed.pop(next(iter(_destroyed)))


def _check_not_destroyed(path: str) -> None:
    if path in _destroyed:
        raise ChannelError(
            "ring was torn down (stale edge from an aborted pass)",
            context={"ring": os.path.basename(path)})


def _writer_for(spec: Tuple) -> ChannelWriter:
    path, n_slots, slot_bytes, timeout = spec
    with _ep_lock:
        w = _writers.get(path)
        if w is None:
            w = _writers[path] = ChannelWriter(
                path, n_slots=n_slots, slot_bytes=slot_bytes,
                timeout=timeout)
        return w


def _reader_for(path: str, timeout: float) -> ChannelReader:
    with _ep_lock:
        r = _readers.get(path)
        if r is None:
            r = _readers[path] = ChannelReader(path, timeout=timeout)
        return r


def destroy_channel(path: str) -> None:
    """Teardown: close + unlink the ring, waking any blocked peer.
    Safe to call for rings that were never created or already gone.
    The path is tombstoned: endpoints created for it afterwards (stale
    tasks of an aborted pass) fail fast instead of waiting out their
    timeout or re-creating the file."""
    with _ep_lock:
        _mark_destroyed(path)
        writer = _writers.pop(path, None)
        reader = _readers.pop(path, None)
    if reader is not None:
        try:
            reader.close()
        except Exception:
            pass
    if writer is not None:
        try:
            writer.destroy()
            return
        except Exception:
            pass
    try:
        chan = Channel(path, writer=False)
    except Exception:
        return  # never created, already unlinked, or lib unavailable
    try:
        chan.destroy()
    except Exception:
        pass


# ---------------------------------------------------------------------------
# The in-actor trampoline
# ---------------------------------------------------------------------------

class ChannelArg:
    """Placeholder in a task's arguments: resolved to the value read
    from ``path`` inside the executing actor.  Duplicate placeholders
    for the same path within one call consume ONE frame.  ``producer``
    (the writing actor's id, when the planner knows it) powers the
    reader's liveness probing."""

    __slots__ = ("path", "timeout", "producer")

    def __init__(self, path: str, timeout: float = DEFAULT_TIMEOUT_S,
                 producer=None):
        self.path = path
        self.timeout = timeout
        self.producer = producer

    def __repr__(self):
        return f"ChannelArg({os.path.basename(self.path)})"


def bind_channel_step(instance):
    """Build the executable for a ``__rt_channel_step__`` actor task:
    read channel args, run the real method, tee the result into the
    edge's writer rings (Runtime._lookup_callable dispatches here).

    Failure semantics:
    - an UPSTREAM failure (error frame / dead producer detected while
      resolving channel args) fans out to this step's own writer rings
      before re-raising — the poison pill that fails the whole pass
      fast instead of wedging readers further downstream;
    - this step's OWN failure writes context-rich error frames;
    - an injected ChaosKill kills the actor and flushes NOTHING (a
      simulated hard death: downstream must detect via liveness
      probing, which is exactly what it exercises)."""

    def run(_rt_chan_plan, *args, **kwargs):
        from ..core import runtime_context as rc_mod
        from ..core.runtime import try_get_runtime

        method_name, writes, returns_value = _rt_chan_plan
        tctx = rc_mod.current_task_context()
        actor_id = tctx.actor_id if tctx is not None else None
        frame_ctx = {"method": method_name}
        if actor_id is not None:
            frame_ctx["actor_id"] = actor_id.hex()[:16]
        seen: Dict[str, Any] = {}

        def resolve(v):
            if isinstance(v, ChannelArg):
                if v.path not in seen:
                    seen[v.path] = _reader_for(
                        v.path, v.timeout).get_value(
                            producer=v.producer)
                return seen[v.path]
            return v

        try:
            args = tuple(resolve(a) for a in args)
            kwargs = {k: resolve(v) for k, v in kwargs.items()}
        except (ChannelError, ActorError, ObjectLostError) as e:
            for w in writes:
                _writer_for(w).put_error(e, frame_ctx)
            raise
        # Rings that already received this pass's VALUE frame must not
        # also get the error frame — that would leave them one frame
        # ahead (their consumer completes this pass, then reads a
        # stale, misattributed error next pass).
        written: set = set()
        try:
            result = getattr(instance, method_name)(*args, **kwargs)
            for w in writes:
                _writer_for(w).put_value(result)
                written.add(w)
        except _chaos.ChaosKill as ck:
            rt = try_get_runtime()
            if rt is not None and actor_id is not None:
                rt.kill_actor(actor_id, no_restart=ck.no_restart)
            raise ActorDiedError(
                actor_id, f"chaos: {ck}",
                context={"method": method_name})
        except ChannelClosed as e:
            err = ChannelError(
                f"ring closed mid-pass under {method_name!r}: {e}",
                context=frame_ctx)
            err.__cause__ = e
            for w in writes:
                if w not in written:
                    _writer_for(w).put_error(err, frame_ctx)
            raise err
        except BaseException as e:
            for w in writes:
                if w not in written:
                    _writer_for(w).put_error(e, frame_ctx)
            raise
        return result if returns_value else None

    return run


# ---------------------------------------------------------------------------
# Submission helpers (compiled DAG + cross-pipeline share these)
# ---------------------------------------------------------------------------

def writer_spec(path: str, n_slots: int = 8, slot_bytes: int = 0,
                timeout: float = DEFAULT_TIMEOUT_S) -> Tuple:
    """Picklable writer-endpoint description carried in the task plan."""
    return (path, int(n_slots), int(slot_bytes), float(timeout))


def submit_channel_call(handle, method_name: str, args: Sequence[Any],
                        kwargs: Optional[dict] = None, *,
                        writes: Sequence[Tuple] = (),
                        returns_value: bool = True):
    """Submit an actor method whose args may contain ``ChannelArg``
    markers and whose result tees into ``writes`` rings.  Returns the
    usual ObjectRef (carrying the result, or None when
    ``returns_value`` is False)."""
    from ..core.runtime import get_runtime
    from ..core.task_spec import TaskOptions

    plan = (method_name, tuple(writes), bool(returns_value))
    opts = TaskOptions(max_retries=0,
                       name=f"{method_name}[chan]")
    return get_runtime().submit_actor_task(
        handle._actor_id, CHANNEL_STEP_METHOD,
        (plan,) + tuple(args), kwargs or {}, opts,
        klass=handle._klass)


def channel_location(handle_or_id) -> Optional[Tuple[str, Optional[str]]]:
    """``(host_key, node_address)`` for this actor's channel endpoints,
    or None if the actor cannot terminate a channel edge at all.  Two
    actors whose host keys are EQUAL share a /dev/shm namespace, so a
    ring between them is valid; everything else stays on the object
    plane.  ``node_address`` is None when the actor is hosted by THIS
    process (teardown is local), else the hosting node's RPC address
    (teardown sends ``channel_destroy`` there).

    Channel-capable means: sync, max_concurrency == 1 (the per-actor
    FIFO is what keeps ring frames in pass order), and not isolate
    (the trampoline must run in the process the ring lives in).  For an
    actor hosted by this process the key is our node's IP (or "local"
    outside cluster mode); for a cluster actor the hosting node answers
    an ``actor_info`` RPC and the key is its address's IP — a compiled
    DAG whose producer and consumer landed on one machine rides the
    ring even though both are remote to the driver."""
    from ..core.runtime import try_get_runtime

    rt = try_get_runtime()
    if rt is None:
        return None
    actor_id = getattr(handle_or_id, "_actor_id", handle_or_id)
    core = rt.actor_manager.get_core(actor_id)
    if core is not None:
        info = core.info
        if info.is_async or info.max_concurrency != 1 or info.isolate:
            return None
        host = (rt.address.rsplit(":", 1)[0] if rt.cluster is not None
                else "local")
        return (host, None)
    if rt.cluster is None:
        return None
    try:
        loc, state = rt.cluster.locate_actor_with_state(actor_id)
    except Exception:
        return None
    if loc is None or state != "ALIVE":
        return None
    _node_id, address = loc
    try:
        resp = rt.cluster.pool.get(address).call(
            "actor_info", {"actor_id": actor_id}, timeout=30.0)
    except Exception:  # raylint: disable=ft-exception-swallow -- planner probe: ANY failure means "cannot host a ring" and the edge falls back to the object plane
        return None
    if not resp.get("found") or resp.get("is_async") \
            or resp.get("max_concurrency") != 1 or resp.get("isolate"):
        return None
    return (address.rsplit(":", 1)[0], address)


def channel_host(handle_or_id) -> Optional[str]:
    """Just the host key of :func:`channel_location`."""
    loc = channel_location(handle_or_id)
    return loc[0] if loc is not None else None


def destroy_channel_at(path: str,
                       addresses: Sequence[Optional[str]] = ()) -> None:
    """Teardown for a ring whose endpoints may live in OTHER processes:
    ask each hosting node (``channel_destroy`` RPC) to close + unlink
    and drop its cached endpoints, then clean up locally.  None entries
    (this process) and unreachable nodes are fine — local cleanup
    always runs and a missing file is not an error."""
    from ..core.runtime import try_get_runtime

    rt = try_get_runtime()
    for address in {a for a in addresses if a}:
        if rt is None or rt.cluster is None:
            break
        try:
            # channel_destroy is naturally idempotent (a missing file
            # is not an error), so transport drops are simply retried.
            rt.cluster.pool.get(address).call_with_retry(
                "channel_destroy", {"path": path}, timeout=10.0,
                deadline_s=15.0)
        except Exception:  # raylint: disable=ft-exception-swallow -- best-effort teardown: an unreachable host's ring dies with its node
            pass
    destroy_channel(path)

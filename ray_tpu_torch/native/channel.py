"""ctypes binding for the C++ shared-memory channel (channel.cc).

Reference: python/ray/experimental/channel/shared_memory_channel.py:159
over src/ray/core_worker/experimental_mutable_object_manager.h — the
compiled-DAG data plane: a pre-allocated mutable ring two processes on
one host exchange payloads through at memcpy speed, with blocking
acquire/release semantics (backpressure) instead of per-message object
allocation.

The .so builds lazily with g++ (no pybind11 in the image; the CPython
boundary is plain ctypes over an extern-C surface).
"""

from __future__ import annotations

import ctypes
import errno
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

_lib = None
_lib_lock = threading.Lock()


class ChannelClosed(ConnectionError):
    """The peer closed the channel (and, for readers, it is drained)."""


class ChannelPeerDied(ChannelClosed):
    """The peer PROCESS died without closing the channel (detected by
    the pid probe between blocked-wait slices).  Distinct from a clean
    close: recovery layers treat it as an actor/process death, not a
    drained stream."""


def _build_lib() -> str:
    src = os.path.join(os.path.dirname(__file__), "channel.cc")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.path.join(tempfile.gettempdir(),
                         f"ray_tpu_native_{os.getuid()}")
    os.makedirs(cache, exist_ok=True)
    out = os.path.join(cache, f"libray_tpu_channel_{digest}.so")
    if os.path.exists(out):
        return out
    tmp = out + f".build{os.getpid()}"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, src, "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise ImportError(
            f"building the native channel failed:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: racing builders converge
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build_lib())
        lib.rtchan_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                      ctypes.c_uint64]
        lib.rtchan_create.restype = ctypes.c_int
        lib.rtchan_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.rtchan_open.restype = ctypes.c_void_p
        lib.rtchan_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint64, ctypes.c_double]
        lib.rtchan_put.restype = ctypes.c_int
        lib.rtchan_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint64, ctypes.c_double]
        lib.rtchan_get.restype = ctypes.c_int64
        lib.rtchan_next_len.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.rtchan_next_len.restype = ctypes.c_int64
        lib.rtchan_size.argtypes = [ctypes.c_void_p]
        lib.rtchan_size.restype = ctypes.c_int
        lib.rtchan_slot_bytes.argtypes = [ctypes.c_void_p]
        lib.rtchan_slot_bytes.restype = ctypes.c_int64
        lib.rtchan_n_slots.argtypes = [ctypes.c_void_p]
        lib.rtchan_n_slots.restype = ctypes.c_int64
        lib.rtchan_debug_lock.argtypes = [ctypes.c_void_p]
        lib.rtchan_debug_lock.restype = ctypes.c_int
        lib.rtchan_peer_dead.argtypes = [ctypes.c_void_p]
        lib.rtchan_peer_dead.restype = ctypes.c_int
        lib.rtchan_write_begin.argtypes = [
            ctypes.c_void_p, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int64)]
        lib.rtchan_write_begin.restype = ctypes.c_void_p
        lib.rtchan_write_commit.argtypes = [ctypes.c_void_p,
                                            ctypes.c_uint64]
        lib.rtchan_write_commit.restype = ctypes.c_int
        lib.rtchan_read_begin.argtypes = [
            ctypes.c_void_p, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int64)]
        lib.rtchan_read_begin.restype = ctypes.c_void_p
        lib.rtchan_read_commit.argtypes = [ctypes.c_void_p]
        lib.rtchan_read_commit.restype = ctypes.c_int
        lib.rtchan_close.argtypes = [ctypes.c_void_p]
        lib.rtchan_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class Channel:
    """Single-producer single-consumer mutable shm ring.

    ``Channel.create(...)`` allocates the backing file (once, by the
    coordinator); each side then constructs ``Channel(path,
    writer=...)``.  ``put``/``get`` move ``bytes`` payloads with
    blocking backpressure; ``close`` wakes both sides.
    """

    def __init__(self, path: str, *, writer: bool):
        lib = _load()
        self._lib = lib
        self._h = lib.rtchan_open(path.encode(), 1 if writer else 0)
        if not self._h:
            raise FileNotFoundError(
                f"no channel at {path!r} (create() first?)")
        self.path = path
        self.writer = writer

    # ------------------------------------------------------------ setup
    @staticmethod
    def create(path: Optional[str] = None, *, n_slots: int = 8,
               slot_bytes: int = 1 << 20) -> str:
        """Allocate the channel; returns its path (put it in /dev/shm
        so the ring lives in memory)."""
        lib = _load()
        if path is None:
            path = os.path.join(
                "/dev/shm" if os.path.isdir("/dev/shm")
                else tempfile.gettempdir(),
                f"rtchan-{os.getpid()}-{os.urandom(6).hex()}")
        rc = lib.rtchan_create(path.encode(), n_slots, slot_bytes)
        if rc != 0:
            raise OSError(-rc, os.strerror(-rc), path)
        return path

    # ------------------------------------------------------------- data
    def put(self, data: bytes, timeout: float = 60.0) -> None:
        rc = self._lib.rtchan_put(self._h, data, len(data),
                                  float(timeout))
        if rc == 0:
            return
        if rc == -errno.ECONNRESET:
            raise ChannelPeerDied(
                f"reader process of channel {self.path} died")
        if rc == -errno.EPIPE:
            raise ChannelClosed(f"channel {self.path} closed")
        if rc == -errno.ETIMEDOUT:
            raise TimeoutError(
                f"channel {self.path} full for {timeout}s")
        if rc == -errno.EMSGSIZE:
            raise ValueError(
                f"payload of {len(data)} bytes exceeds slot size")
        raise OSError(-rc, os.strerror(-rc))

    def get(self, timeout: float = 60.0) -> bytes:
        n = self._lib.rtchan_next_len(self._h, float(timeout))
        if n < 0:
            if n == -errno.ECONNRESET:
                raise ChannelPeerDied(
                    f"writer process of channel {self.path} died")
            if n == -errno.EPIPE:
                raise ChannelClosed(
                    f"channel {self.path} closed and drained")
            if n in (-errno.ETIMEDOUT, -errno.EAGAIN):
                raise TimeoutError(
                    f"channel {self.path} empty for {timeout}s")
            raise OSError(-n, os.strerror(-n))
        buf = ctypes.create_string_buffer(int(n))
        got = self._lib.rtchan_get(self._h, buf, int(n), float(timeout))
        if got < 0:
            raise OSError(-got, os.strerror(-got))
        return buf.raw[:got]

    # ------------------------------------------------ in-place access
    # SPSC makes direct slot access safe: the writer owns an
    # unpublished slot exclusively; the reader owns the head slot until
    # commit.  One memcpy per side instead of three (assemble / copy-in
    # / copy-out) — the channel data plane's hot path.

    def put_parts(self, parts, timeout: float = 60.0) -> None:
        """Assemble ``parts`` (bytes-like pieces) directly in the next
        free slot and publish; semantically ``put(b"".join(parts))``
        without the join copy."""
        srcs = []
        for p in parts:
            mv = p if isinstance(p, memoryview) else memoryview(p)
            srcs.append(mv if mv.format == "B" and mv.ndim == 1
                        else mv.cast("B"))
        total = sum(len(s) for s in srcs)
        if total > self.slot_bytes:
            self._raise_put_err(-errno.EMSGSIZE, total)
        err = ctypes.c_int64(0)
        base = self._lib.rtchan_write_begin(self._h, float(timeout),
                                            ctypes.byref(err))
        if not base:
            self._raise_put_err(int(err.value), total)
        view = memoryview(
            (ctypes.c_char * total).from_address(base)).cast("B")
        off = 0
        for s in srcs:
            view[off:off + len(s)] = s
            off += len(s)
        rc = self._lib.rtchan_write_commit(self._h, total)
        if rc != 0:
            self._raise_put_err(rc, total)

    def _raise_put_err(self, rc: int, length: int):
        if rc == -errno.ECONNRESET:
            raise ChannelPeerDied(
                f"reader process of channel {self.path} died")
        if rc == -errno.EPIPE:
            raise ChannelClosed(f"channel {self.path} closed")
        if rc == -errno.ETIMEDOUT:
            raise TimeoutError(f"channel {self.path} full")
        if rc == -errno.EMSGSIZE:
            raise ValueError(
                f"payload of {length} bytes exceeds slot size "
                f"{self.slot_bytes} of channel ring {self.path}")
        raise OSError(-rc, os.strerror(-rc))

    def get_buffer(self, timeout: float = 60.0) -> bytearray:
        """Receive the next frame as a fresh ``bytearray`` copied
        straight out of the slot (no zero-filled staging buffer, no
        second slice copy — the consumer may hold views into it)."""
        n = ctypes.c_int64(0)
        base = self._lib.rtchan_read_begin(self._h, float(timeout),
                                           ctypes.byref(n))
        if not base:
            v = int(n.value)
            if v == -errno.ECONNRESET:
                raise ChannelPeerDied(
                    f"writer process of channel {self.path} died")
            if v == -errno.EPIPE:
                raise ChannelClosed(
                    f"channel {self.path} closed and drained")
            if v in (-errno.ETIMEDOUT, -errno.EAGAIN):
                raise TimeoutError(
                    f"channel {self.path} empty for {timeout}s")
            raise OSError(-v, os.strerror(-v))
        ln = int(n.value)
        buf = bytearray((ctypes.c_char * ln).from_address(base))
        self._lib.rtchan_read_commit(self._h)
        return buf

    def qsize(self) -> int:
        return max(0, self._lib.rtchan_size(self._h))

    @property
    def slot_bytes(self) -> int:
        """Per-slot capacity; a payload above this cannot ride the ring
        (the adapter layer falls back to the object plane per-pass)."""
        return int(self._lib.rtchan_slot_bytes(self._h))

    @property
    def n_slots(self) -> int:
        return int(self._lib.rtchan_n_slots(self._h))

    def peer_dead(self) -> bool:
        """True when the OTHER endpoint's process attached and has since
        died (same pid probe the blocked waits run between slices)."""
        return bool(self._lib.rtchan_peer_dead(self._h))

    def _debug_lock(self) -> None:
        """Test hook: take the shared robust mutex and never release it
        (simulates a peer dying mid-critical-section)."""
        self._lib.rtchan_debug_lock(self._h)

    # --------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._h:
            self._lib.rtchan_close(self._h)

    def destroy(self) -> None:
        """Close, unmap, and unlink the backing file."""
        if self._h:
            self._lib.rtchan_close(self._h)
            self._lib.rtchan_free(self._h)
            self._h = None
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def __del__(self):
        if getattr(self, "_h", None):
            try:
                self._lib.rtchan_free(self._h)
            except Exception:
                pass
            self._h = None

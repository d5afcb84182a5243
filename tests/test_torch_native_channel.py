"""The port's copy of ``tests/test_native_channel.py``, run against ray_tpu_torch
(its own runtime fixtures: ``_torch_runtime.py``).

Native C++ shared-memory channel (N19 mutable-object substrate).

Reference: experimental_mutable_object_manager.h acquire/release +
shared_memory_channel.py:159.  The ring is exercised in-process, across
OS processes, for backpressure, close semantics, and throughput sanity.
"""

import multiprocessing as mp
import threading
import time

import pytest

from ray_tpu_torch.native import Channel, ChannelClosed


def test_basic_put_get(tmp_path):
    path = Channel.create(str(tmp_path / "ch"), n_slots=4,
                          slot_bytes=1024)
    w = Channel(path, writer=True)
    r = Channel(path, writer=False)
    try:
        w.put(b"hello")
        w.put(b"world")
        assert r.qsize() == 2
        assert r.get() == b"hello"
        assert r.get() == b"world"
        with pytest.raises(TimeoutError):
            r.get(timeout=0.1)
        with pytest.raises(ValueError):
            w.put(b"x" * 2048)
    finally:
        w.destroy()


def test_backpressure_blocks_producer(tmp_path):
    path = Channel.create(str(tmp_path / "ch"), n_slots=2,
                          slot_bytes=64)
    w = Channel(path, writer=True)
    r = Channel(path, writer=False)
    try:
        w.put(b"a")
        w.put(b"b")
        with pytest.raises(TimeoutError):
            w.put(b"c", timeout=0.1)  # ring full
        got = []
        t = threading.Thread(
            target=lambda: (time.sleep(0.2), got.append(r.get())))
        t.start()
        w.put(b"c", timeout=5.0)  # unblocks when the reader drains
        t.join()
        assert got == [b"a"]
        assert r.get() == b"b"
        assert r.get() == b"c"
    finally:
        w.destroy()


def test_close_wakes_reader(tmp_path):
    path = Channel.create(str(tmp_path / "ch"))
    w = Channel(path, writer=True)
    r = Channel(path, writer=False)
    try:
        w.put(b"last")
        w.close()
        assert r.get() == b"last"  # drained before EPIPE
        with pytest.raises(ChannelClosed):
            r.get(timeout=5.0)
    finally:
        w.destroy()


def _producer_main(path, n, size):
    ch = Channel(path, writer=True)
    payload = bytes(size)
    for i in range(n):
        ch.put(payload + i.to_bytes(4, "big"), timeout=60.0)
    ch.close()


def test_cross_process_ring(tmp_path):
    """The real shape: producer in another OS process, slots reused
    far more times than the ring has capacity."""
    path = Channel.create(str(tmp_path / "ch"), n_slots=4,
                          slot_bytes=64 * 1024)
    n = 500
    proc = mp.get_context("spawn").Process(
        target=_producer_main, args=(path, n, 1024))
    proc.start()
    r = Channel(path, writer=False)
    try:
        for i in range(n):
            data = r.get(timeout=60.0)
            assert int.from_bytes(data[-4:], "big") == i
        with pytest.raises(ChannelClosed):
            r.get(timeout=10.0)
        proc.join(timeout=10)
        assert proc.exitcode == 0
    finally:
        r.destroy()


def test_writer_close_wakes_blocked_reader(tmp_path):
    """A reader already parked in get() must fail over promptly when
    the writer closes — not sit out its full timeout."""
    path = Channel.create(str(tmp_path / "ch"))
    w = Channel(path, writer=True)
    r = Channel(path, writer=False)
    outcome = []

    def blocked_get():
        t0 = time.perf_counter()
        try:
            r.get(timeout=60.0)
            outcome.append(("value", time.perf_counter() - t0))
        except ChannelClosed:
            outcome.append(("closed", time.perf_counter() - t0))

    t = threading.Thread(target=blocked_get)
    t.start()
    time.sleep(0.3)  # let the reader park on the condvar
    w.close()
    t.join(timeout=10)
    assert not t.is_alive()
    assert outcome and outcome[0][0] == "closed"
    assert outcome[0][1] < 10.0  # woke on close, not on timeout


def _lock_and_die(path):
    ch = Channel(path, writer=False)
    ch._debug_lock()  # take the shared robust mutex ...
    import os

    os._exit(0)       # ... and die holding it


def test_reader_crash_releases_robust_mutex(tmp_path):
    """A peer dying while holding the shared mutex must not wedge the
    ring: the robust-mutex EOWNERDEAD path hands the lock to the next
    acquirer (channel.cc lock_robust)."""
    path = Channel.create(str(tmp_path / "ch"), n_slots=4,
                          slot_bytes=1024)
    proc = mp.get_context("spawn").Process(
        target=_lock_and_die, args=(path,))
    proc.start()
    proc.join(timeout=30)
    assert proc.exitcode == 0
    w = Channel(path, writer=True)
    r = Channel(path, writer=False)
    try:
        w.put(b"survived", timeout=10.0)  # EOWNERDEAD recovered here
        assert r.get(timeout=10.0) == b"survived"
    finally:
        w.destroy()


def test_payload_larger_than_ring_clean_error(tmp_path):
    """Oversize payloads surface a clean ValueError naming the slot
    capacity — on both the copy and the in-place write paths — and
    leave the ring usable."""
    path = Channel.create(str(tmp_path / "ch"), n_slots=2,
                          slot_bytes=4096)
    w = Channel(path, writer=True)
    r = Channel(path, writer=False)
    try:
        with pytest.raises(ValueError, match="exceeds slot size"):
            w.put(b"x" * 8192)
        with pytest.raises(ValueError, match="exceeds slot size"):
            w.put_parts([b"x" * 4000, b"y" * 4000])
        w.put(b"still works")
        assert r.get(timeout=5.0) == b"still works"
    finally:
        w.destroy()


def test_inplace_parts_roundtrip(tmp_path):
    """put_parts assembles multi-piece frames directly in slot memory;
    get_buffer returns them without staging copies."""
    import numpy as np

    path = Channel.create(str(tmp_path / "ch"), n_slots=4,
                          slot_bytes=1 << 16)
    w = Channel(path, writer=True)
    r = Channel(path, writer=False)
    try:
        arr = np.arange(512, dtype=np.float32)
        w.put_parts([b"hdr:", memoryview(arr)])
        buf = r.get_buffer(timeout=5.0)
        assert bytes(buf[:4]) == b"hdr:"
        back = np.frombuffer(memoryview(buf)[4:], dtype=np.float32)
        assert np.array_equal(back, arr)
        assert w.slot_bytes == 1 << 16
        assert w.n_slots == 4
    finally:
        w.destroy()


def test_throughput_sanity(tmp_path):
    """Same-host channel beats the per-message-object path by a wide
    margin.  The bound is deliberately loose (0.3 GB/s) so a loaded CI
    box doesn't flake; typical is several GB/s."""
    path = Channel.create(str(tmp_path / "ch"), n_slots=8,
                          slot_bytes=1 << 20)
    w = Channel(path, writer=True)
    r = Channel(path, writer=False)
    payload = bytes(1 << 20)
    n = 200
    err = []

    def drain():
        try:
            for _ in range(n):
                r.get(timeout=30.0)
        except BaseException as e:  # noqa: BLE001
            err.append(e)

    t = threading.Thread(target=drain)
    t0 = time.perf_counter()
    t.start()
    try:
        for _ in range(n):
            w.put(payload, timeout=30.0)
        t.join(timeout=60)
        dt = time.perf_counter() - t0
        assert not err, err
        rate = n * len(payload) / dt / 1e9
        assert rate > 0.3, f"{rate:.2f} GB/s"
    finally:
        w.destroy()

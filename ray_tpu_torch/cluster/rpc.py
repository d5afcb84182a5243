"""Socket RPC: length-prefixed pickled messages, request/response.

Reference analogue: src/ray/rpc/ (gRPC server/client wrappers with a
retryable client and chaos injection, rpc_chaos.h:23).  This framework
keeps the same shape — a threaded server dispatching named methods, a
client with pending-request correlation and bounded retries, and a
fault-injection hook driven by ``RAY_TPU_TESTING_RPC_FAILURE`` — over
plain TCP sockets (no gRPC dependency; the control plane is low-rate,
the data plane's heavy bytes ride the same framed stream).

Wire format: two length-prefixed pickles per message — an envelope
``(kind, request_id, method)`` of plain strings (always deserializable)
followed by the payload.  Separating the two means a payload that fails
``pickle.loads`` (e.g. a user exception with a broken ``__reduce__``)
can still be correlated to its request id and fail ONLY that call,
instead of killing the connection's reader thread and hanging every
pending call.  kind is "req" / "resp" / "err".

Fault injection: every outgoing call consults the process's active
``experimental.chaos`` schedule (programmable drops/delays) AND the
legacy per-client ``RAY_TPU_TESTING_RPC_FAILURE`` budget the schedule
API superseded.  Mutating control-plane calls ride
``call_idempotent`` — exponential backoff under a deadline, with an
idempotency key the server deduplicates on, so a chaos-dropped
``register_actor`` retries without double-apply.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional, Tuple

from ..core import deadlines as _deadlines
from ..experimental import chaos as _chaos
from ..observability import tracing as _tracing

_LEN = struct.Struct(">Q")

# The idempotency-key field injected into dict payloads by
# call_idempotent and consumed by idempotent_handler on the server.
IDEMPOTENCY_KEY = "_idem"


def _rpc_metrics():
    """Retry / idempotency counters (rebuilt after registry resets)."""
    from ..observability import metrics as _metrics

    return _metrics.metric_group("rpc", lambda: {
        "retries": _metrics.Counter(
            "ray_tpu_rpc_retries_total",
            "rpc transport retries under retry_call deadlines",
            tag_keys=("method",)),
        "idem_hits": _metrics.Counter(
            "ray_tpu_idempotency_hits_total",
            "duplicate mutating calls answered from the "
            "idempotency cache", tag_keys=("method",)),
    })


def retry_call(call_fn: Callable[..., Any], method: str, payload: Any,
               *, timeout: Optional[float], deadline_s: float,
               base_backoff_s: float = 0.05,
               max_backoff_s: float = 2.0) -> Any:
    """Drive ``call_fn(method, payload, timeout)`` to completion under
    a total deadline, retrying ConnectionError/TimeoutError with
    exponential backoff (reference: retryable_grpc_client.h).  The
    FINAL attempt's error propagates."""
    deadline = time.monotonic() + deadline_s
    backoff = base_backoff_s
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(
                f"rpc {method!r} exhausted its {deadline_s:.0f}s "
                f"retry deadline")
        per_call = left if timeout is None else min(timeout, left)
        try:
            return call_fn(method, payload, per_call)
        except (ConnectionError, TimeoutError) as e:
            if time.monotonic() + backoff >= deadline:
                raise type(e)(
                    f"rpc {method!r} still failing at its "
                    f"{deadline_s:.0f}s retry deadline: {e}") from e
            _rpc_metrics()["retries"].inc(tags={"method": method})
            time.sleep(backoff)
            backoff = min(backoff * 2, max_backoff_s)


def idempotent_handler(fn: Callable[[Any], Any],
                       cache: "IdempotencyCache"):
    """Server-side wrapper for a MUTATING handler: a payload carrying
    an idempotency key returns the cached first reply on re-delivery
    instead of re-applying the mutation (client retries after a lost
    response must not double-apply).  A retry racing a STILL-EXECUTING
    first delivery parks on its in-flight marker rather than running
    the handler a second time concurrently."""

    def wrapped(payload):
        key = (payload.pop(IDEMPOTENCY_KEY, None)
               if isinstance(payload, dict) else None)
        if key is None:
            return fn(payload)
        while True:
            hit, reply = cache.get(key)
            if hit:
                _rpc_metrics()["idem_hits"].inc(
                    tags={"method": getattr(fn, "__name__", "")})
                return reply
            ev, mine = cache.claim(key)
            if not mine:
                # First delivery still executing: wait it out, then
                # re-read (if it RAISED, nothing was cached and this
                # retry claims the key and runs the handler itself).
                ev.wait(timeout=60.0)
                continue
            try:
                reply = fn(payload)
                cache.put(key, reply)
                return reply
            finally:
                cache.release(key)

    return wrapped


class IdempotencyCache:
    """Bounded first-reply cache keyed by client-minted call keys,
    with in-flight markers so duplicate deliveries serialize instead
    of double-applying."""

    def __init__(self, capacity: int = 4096):
        self._capacity = capacity
        self._lock = threading.Lock()
        self._replies: Dict[str, Any] = {}
        self._order: list = []
        self._inflight: Dict[str, threading.Event] = {}

    def get(self, key: str) -> Tuple[bool, Any]:
        with self._lock:
            if key in self._replies:
                return True, self._replies[key]
        return False, None

    def claim(self, key: str) -> Tuple[threading.Event, bool]:
        """(event, True) when this caller now owns the key's first
        execution; (other's event, False) when one is already running."""
        with self._lock:
            ev = self._inflight.get(key)
            if ev is not None:
                return ev, False
            ev = self._inflight[key] = threading.Event()
            return ev, True

    def release(self, key: str) -> None:
        with self._lock:
            ev = self._inflight.pop(key, None)
        if ev is not None:
            ev.set()

    def put(self, key: str, reply: Any) -> None:
        with self._lock:
            if key not in self._replies:
                self._order.append(key)
                while len(self._order) > self._capacity:
                    self._replies.pop(self._order.pop(0), None)
            self._replies[key] = reply

    def export(self) -> Dict[str, Any]:
        """Insertion-ordered {key: reply} copy — persisted with the
        head's durable tables so the dedup window spans a restart (a
        client retrying a mutation whose ack raced a head kill -9
        replays the first reply instead of double-applying)."""
        with self._lock:
            return {k: self._replies[k] for k in self._order
                    if k in self._replies}

    def load(self, entries: Dict[str, Any]) -> None:
        for key, reply in (entries or {}).items():
            self.put(key, reply)


class DeserializationError(RuntimeError):
    """A message payload failed ``pickle.loads`` on the receiver.

    Deliberately NOT a ConnectionError: the connection is healthy and
    the peer is alive — only this one payload is bad.  Subclassing
    ConnectionError would trip the callers' node-death/retry paths and
    cascade false node failures."""


# The catch-set for best-effort / fire-and-forget RPCs: everything the
# TRANSPORT can do to a call, including a reply that fails to decode —
# but NOT server-shipped application/FT exceptions, which such callers
# must either handle or deliberately disable the lint for.
TRANSPORT_ERRORS = (ConnectionError, TimeoutError, OSError,
                    DeserializationError)


def _send_msg(sock: socket.socket, kind: str, req_id: str, method: str,
              payload: Any, lock: threading.Lock,
              trace: Optional[Tuple] = None,
              deadline: Optional[float] = None):
    """Bytes-like payloads are framed RAW (kind gets a "+raw" suffix) —
    no pickle copy on either side; the data plane's chunk transfers and
    pre-serialized task bundles ride this path at memcpy speed.

    ``trace`` is the submitter's (trace_id, parent_span_id) and
    ``deadline`` the request's absolute end-to-end deadline (epoch s,
    core/deadlines.py): both ride the ENVELOPE (4th and 5th fields, not
    the payload) so every RPC — including raw-framed ones — propagates
    request context without touching its body.  Fields are appended
    only when set, so old-shape 3/4-tuples stay on the wire for
    context-free calls."""
    wire_kind = (kind + "+raw"
                 if isinstance(payload, (bytes, bytearray, memoryview))
                 else kind)
    if deadline is not None:
        head: Tuple = (wire_kind, req_id, method, trace, deadline)
    elif trace is not None:
        head = (wire_kind, req_id, method, trace)
    else:
        head = (wire_kind, req_id, method)
    env = pickle.dumps(head, protocol=pickle.HIGHEST_PROTOCOL)
    if wire_kind.endswith("+raw"):
        body = payload
    else:
        body = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    with lock:
        # Scatter-gather write: no concatenation copy of the body.
        sendmsg_all(sock, [_LEN.pack(len(env)), memoryview(env),
                           _LEN.pack(len(body)), body])


def sendmsg_all(sock: socket.socket, bufs) -> None:
    """Scatter-gather write of the whole iovec.  sendmsg may queue only
    a prefix (signal, full send buffer) — loop on the remainder or the
    framing desynchronizes.  The iovec is capped at IOV_MAX-ish per
    call: a payload spanning thousands of tiny pieces would EMSGSIZE."""
    bufs = [b if isinstance(b, memoryview) else memoryview(b)
            for b in bufs]
    while bufs:
        sent = sock.sendmsg(bufs[:1024])
        while bufs and sent >= len(bufs[0]):
            sent -= len(bufs[0])
            bufs.pop(0)
        if sent and bufs:
            bufs[0] = bufs[0][sent:]


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("socket closed")
        got += r
    return buf


def _recv_segment(sock: socket.socket) -> bytearray:
    header = _recv_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(header)
    return _recv_exact(sock, length)


def _recv_msg(sock: socket.socket
              ) -> Tuple[str, str, str, bytes, bool, Optional[Tuple],
                         Optional[float]]:
    """Returns (kind, req_id, method, raw_payload, is_raw, trace,
    deadline).  A pickled payload is NOT deserialized here: the caller
    decodes it after correlation so a bad payload fails one call, not
    the connection.  Raw payloads skip pickle entirely.  ``trace`` is
    the optional 4th envelope field (trace_id, parent_span_id);
    ``deadline`` the optional 5th (absolute end-to-end deadline)."""
    env = pickle.loads(_recv_segment(sock))
    body = _recv_segment(sock)
    kind, req_id, method = env[0], env[1], env[2]
    trace = env[3] if len(env) > 3 else None
    deadline = env[4] if len(env) > 4 else None
    if kind.endswith("+raw"):
        return kind[:-4], req_id, method, body, True, trace, deadline
    return kind, req_id, method, body, False, trace, deadline


def _tune_socket(sock: socket.socket) -> None:
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    # Big windows keep chunked object pulls streaming (the default
    # buffers stall a 4 MiB in-flight window on loopback).
    for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
        try:
            sock.setsockopt(socket.SOL_SOCKET, opt, 4 * 1024 * 1024)
        except OSError:
            pass


class Deferred:
    """A handler may return ``Deferred(fn)``: the submission phase ran
    inline (preserving per-connection arrival order — actor-call
    ordering, reference actor_scheduling_queue.h) and ``fn()`` produces
    the response later on a worker thread."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn


class RpcServer:
    """Threaded method-dispatch server.

    ``handlers`` maps method name → fn(payload) -> response payload.
    Each connection gets a reader thread; each request gets a worker
    thread (requests may block, e.g. ``get_object`` waits for a seal —
    reference server-call concurrency, rpc/server_call.h).  Methods in
    ``ordered`` run their handler inline on the connection reader
    thread so same-connection requests enter in arrival order; they
    should return a ``Deferred`` for any blocking completion work.
    """

    def __init__(self, handlers: Dict[str, Callable[[Any], Any]],
                 host: str = "127.0.0.1", port: int = 0,
                 ordered: Optional[set] = None):
        self.handlers = dict(handlers)
        self.ordered = set(ordered or ())
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.address = "%s:%d" % self._sock.getsockname()
        self._stopped = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"rpc-accept-{self.address}")
        self._accept_thread.start()

    def add_handler(self, method: str, fn: Callable[[Any], Any]):
        self.handlers[method] = fn

    def _accept_loop(self):
        while not self._stopped.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            _tune_socket(conn)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             daemon=True).start()

    def _conn_loop(self, conn: socket.socket):
        wlock = threading.Lock()
        try:
            while not self._stopped.is_set():
                kind, req_id, method, raw, is_raw, trace, deadline = \
                    _recv_msg(conn)
                try:
                    payload = raw if is_raw else pickle.loads(raw)
                except BaseException as e:  # noqa: BLE001
                    self._reply_err(conn, wlock, req_id, method,
                                    DeserializationError(
                                        f"request payload for {method!r} "
                                        f"failed to deserialize: "
                                        f"{type(e).__name__}: {e}"))
                    continue
                if method in self.ordered:
                    # Inline submission phase; Deferred completion runs
                    # on its own thread.
                    self._handle_one(conn, wlock, req_id, method, payload,
                                     inline=True, trace=trace,
                                     deadline=deadline)
                else:
                    threading.Thread(
                        target=self._handle_one,
                        args=(conn, wlock, req_id, method, payload),
                        kwargs={"trace": trace, "deadline": deadline},
                        daemon=True).start()
        except (ConnectionError, EOFError, OSError):
            pass
        except BaseException:  # noqa: BLE001  malformed envelope: drop conn
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _sanitize_err(e: BaseException) -> BaseException:
        """Only ship exceptions that round-trip; else stringify.  A bare
        ``pickle.dumps`` probe is not enough — an exception can dump
        fine and still explode in ``loads`` (default Exception reduce vs
        a custom __init__ signature)."""
        from ..exceptions import _picklable_cause

        return _picklable_cause(e)

    def _reply_err(self, conn, wlock, req_id, method, err: BaseException):
        try:
            _send_msg(conn, "err", req_id, method,
                      self._sanitize_err(err), wlock)
        except (ConnectionError, OSError):
            pass

    def _handle_one(self, conn, wlock, req_id, method, payload,
                    inline: bool = False, trace=None, deadline=None):
        try:
            fn = self.handlers.get(method)
            if fn is None:
                raise AttributeError(f"no rpc method {method!r}")
            # Re-install the caller's trace AND deadline context around
            # the handler so anything it submits (task specs, nested
            # RPCs) inherits them — and restore after: handler threads
            # (and the inline reader thread) are reused across
            # requests.  Expired deadlines are NOT shed here — the
            # control plane must stay reachable past a request budget
            # (teardown/cleanup RPCs); task-level dequeue points do the
            # shedding.
            with _tracing.scope_from(trace), _deadlines.scope(deadline):
                result = fn(payload)
            if isinstance(result, Deferred):
                threading.Thread(
                    target=self._finish_deferred,
                    args=(conn, wlock, req_id, method, result.fn),
                    daemon=True).start()
                return
        except BaseException as e:  # noqa: BLE001
            self._reply_err(conn, wlock, req_id, method, e)
            return
        try:
            _send_msg(conn, "resp", req_id, method, result, wlock)
        except (ConnectionError, OSError):
            pass
        except BaseException as e:  # result itself unpicklable
            self._reply_err(conn, wlock, req_id, method, e)

    def _finish_deferred(self, conn, wlock, req_id, method, fn):
        try:
            result = fn()
        except BaseException as e:  # noqa: BLE001
            self._reply_err(conn, wlock, req_id, method, e)
            return
        try:
            _send_msg(conn, "resp", req_id, method, result, wlock)
        except (ConnectionError, OSError):
            pass
        except BaseException as e:  # result itself unpicklable
            self._reply_err(conn, wlock, req_id, method, e)

    def shutdown(self):
        self._stopped.set()
        # Closing a listening socket does NOT wake a thread blocked in
        # accept() on this kernel — a dummy self-connection pops it out
        # deterministically (the loop re-checks _stopped and exits).
        try:
            socket.create_connection(self._sock.getsockname(),
                                     timeout=0.5).close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # Reap the acceptor so shutdown leaves no half-dead thread.
        self._accept_thread.join(timeout=2.0)


class RpcClient:
    """Persistent connection to one RpcServer; thread-safe concurrent
    calls correlated by request id (reference: retryable_grpc_client.h)."""

    def __init__(self, address: str, connect_timeout: float = 10.0,
                 abort: Optional[Callable[[], bool]] = None):
        self.address = address
        # Legacy env-var chaos budget (per client, so subprocess
        # workers inherit faults); the programmable schedule is
        # consulted globally in call_async.  ``chaos_tag`` names the
        # logical caller for targeted fault rules (partition_node):
        # vcluster sets it to the virtual node's id; it defaults to
        # the peer address.
        self._chaos = _chaos.env_rpc_budget()
        self.chaos_tag = ""
        self._lock = threading.Lock()      # connection state
        self._wlock = threading.Lock()     # socket writes
        self._pending: Dict[str, _PendingCall] = {}
        self._sock: Optional[socket.socket] = None
        self._closed = False
        self._connect(connect_timeout, abort)

    def _connect(self, timeout: float,
                 abort: Optional[Callable[[], bool]] = None):
        host, port = self.address.rsplit(":", 1)
        deadline = time.monotonic() + timeout
        last_err: Optional[Exception] = None
        while time.monotonic() < deadline:
            if abort is not None and abort():
                # The owner (e.g. a ReconnectingClient being closed)
                # withdrew the dial: stop burning the connect budget.
                raise ConnectionError(
                    f"dial to {self.address} aborted: client closed")
            try:
                sock = socket.create_connection((host, int(port)),
                                                timeout=timeout)
                _tune_socket(sock)
                sock.settimeout(None)
                self._sock = sock
                threading.Thread(target=self._read_loop, args=(sock,),
                                 daemon=True,
                                 name=f"rpc-read-{self.address}").start()
                return
            except OSError as e:
                last_err = e
                time.sleep(0.05)
        raise ConnectionError(
            f"cannot connect to {self.address}: {last_err}")

    def _read_loop(self, sock: socket.socket):
        try:
            while True:
                kind, req_id, method, raw, is_raw, _trace, _deadline = \
                    _recv_msg(sock)
                with self._lock:
                    call = self._pending.pop(req_id, None)
                if call is None:
                    continue
                try:
                    payload = raw if is_raw else pickle.loads(raw)
                except BaseException as e:  # noqa: BLE001
                    # Fail the one correlated call; the connection and
                    # every other pending call stay healthy.
                    call.finish(DeserializationError(
                        f"response payload for {method!r} failed to "
                        f"deserialize: {type(e).__name__}: {e}"),
                        is_error=True)
                    continue
                call.finish(payload, is_error=(kind == "err"))
        except (ConnectionError, EOFError, OSError) as e:
            self._fail_all(e)
        except BaseException as e:  # noqa: BLE001
            # Envelope decode/unpack failure: the stream is unframed
            # garbage from here on — connection-fatal, fail everything
            # rather than leaving pending calls to hang on a dead reader.
            self._fail_all(ConnectionError(
                f"protocol error from {self.address}: "
                f"{type(e).__name__}: {e}"))

    def _fail_all(self, exc: Exception):
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
            self._sock = None
        err = ConnectionError(
            f"connection to {self.address} lost: {exc}")
        for call in pending:
            call.finish(err, is_error=True)

    def call(self, method: str, payload: Any = None,
             timeout: Optional[float] = None) -> Any:
        return self.call_async(method, payload).result(timeout)

    def call_with_retry(self, method: str, payload: Any = None, *,
                        timeout: Optional[float] = None,
                        deadline_s: float = 30.0) -> Any:
        """Retry transport failures under a deadline (idempotent or
        read-only methods only — there is no dedup key on this path)."""
        return retry_call(self.call, method, payload,
                          timeout=timeout, deadline_s=deadline_s)

    def call_async(self, method: str, payload: Any = None,
                   callback: Optional[Callable[[Any, bool], None]] = None,
                   deadline: Optional[float] = None) -> "_PendingCall":
        _chaos.on_rpc(method, self.chaos_tag or self.address)
        self._chaos.maybe_fail(method)
        req_id = uuid.uuid4().hex
        call = _PendingCall(method, callback)
        trace = _tracing.current()
        # The request's end-to-end deadline rides the envelope's 5th
        # field: explicit (owner-side task pushes pass the spec's), else
        # the thread's ambient deadline (a handler re-submitting under
        # the caller's budget).
        if deadline is None:
            deadline = _deadlines.current()
        with self._lock:
            sock = self._sock
            if sock is None or self._closed:
                raise ConnectionError(f"not connected to {self.address}")
            self._pending[req_id] = call
        try:
            _send_msg(sock, "req", req_id, method, payload, self._wlock,
                      trace=trace, deadline=deadline)
        except (ConnectionError, OSError) as e:
            with self._lock:
                self._pending.pop(req_id, None)
            # A failed write means the socket is dead: fail everything
            # and clear _sock so reconnect wrappers re-dial instead of
            # reusing this client (the read loop may not have noticed
            # yet).
            self._fail_all(e)
            raise ConnectionError(
                f"send to {self.address} failed: {e}") from e
        except BaseException:
            with self._lock:
                self._pending.pop(req_id, None)
            raise
        return call

    def close(self):
        self._closed = True
        with self._lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._fail_all(ConnectionError("client closed"))


class _PendingCall:
    def __init__(self, method: str,
                 callback: Optional[Callable[[Any, bool], None]] = None):
        self.method = method
        self._event = threading.Event()
        self._result: Any = None
        self._is_error = False
        self._callback = callback

    def finish(self, result: Any, is_error: bool):
        self._result = result
        self._is_error = is_error
        self._event.set()
        if self._callback is not None:
            try:
                self._callback(result, is_error)
            except Exception:
                import traceback

                traceback.print_exc()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"rpc {self.method!r} timed out after {timeout}s")
        if self._is_error:
            raise self._result
        return self._result

    def done(self) -> bool:
        return self._event.is_set()


class ReconnectingClient:
    """RpcClient wrapper that re-dials on a lost connection (reference:
    the retryable gRPC client every daemon keeps toward the GCS,
    retryable_grpc_client.h) — the peer surviving a restart at the same
    address resumes service transparently.

    **Head-set aware**: the wrapper holds an ordered CANDIDATE list
    (primary first, then standbys) with a per-candidate re-dial
    cooldown.  A lost connection re-dials the current candidate, then
    walks the rest of the set — so a head failover costs one walk of
    the list, not an infinite redial against the dead primary.
    ``set_candidates`` absorbs server-advertised head sets;
    ``failover()`` forces the walk to start PAST the current address
    (the caller just learned it is not primary)."""

    _REDIAL_COOLDOWN_S = 5.0
    # With several candidates the cooldown is what keeps a walk from
    # re-paying the dead primary's dial budget on every reconnect;
    # kept well under the single-candidate value so a recovered head
    # is rediscovered quickly.
    _MULTI_COOLDOWN_S = 2.0

    def __init__(self, address: str, connect_timeout: float = 10.0,
                 candidates: Optional[list] = None,
                 shared_cooldowns: Optional[Dict[str, tuple]] = None):
        self.address = address
        self._connect_timeout = connect_timeout
        self._lock = threading.Lock()
        self._closed = False
        # addr -> (no_dial_until, current_backoff_s).  Pass ONE dict
        # to a fleet of clients (``shared_cooldowns``) so the first
        # client to burn a dial budget against a dead head spares
        # every other client the same probe — without sharing, N
        # clients walking serially pay N dial budgets and a failover
        # can outlast the node lease.  Escalates per consecutive
        # failure so a permanently dead candidate costs ever less.
        self._cooldowns: Dict[str, tuple] = (
            shared_cooldowns if shared_cooldowns is not None else {})
        self._chaos_tag = ""
        self._candidates = [address]
        for cand in candidates or ():
            if cand and cand not in self._candidates:
                self._candidates.append(cand)
        # Constructor walks the set too: "the primary is down, dial
        # the standby" must hold from the very first connection, not
        # only on re-dials.
        budget = (connect_timeout if len(self._candidates) == 1
                  else max(1.0, min(2.0, connect_timeout
                                    / len(self._candidates))))
        last_err: Optional[Exception] = None
        self._client = None
        now = time.monotonic()
        order = ([c for c in self._candidates
                  if not self._in_cooldown(c, now)]
                 or list(self._candidates))
        for cand in order:
            try:
                self._client = RpcClient(cand, budget)
                self.address = cand
                self._cooldowns.pop(cand, None)
                break
            except ConnectionError as e:
                self._mark_dial_failed(cand)
                last_err = e
        if self._client is None:
            raise ConnectionError(
                f"no head candidate reachable "
                f"({self._candidates}): {last_err}")

    @property
    def chaos_tag(self) -> str:
        return self._chaos_tag

    @chaos_tag.setter
    def chaos_tag(self, tag: str) -> None:
        self._chaos_tag = tag
        self._client.chaos_tag = tag

    @property
    def candidates(self) -> list:
        with self._lock:
            return list(self._candidates)

    def set_candidates(self, addresses) -> None:
        """Absorb a server-advertised head set (order preserved,
        current connection kept).  New addresses append; addresses the
        server no longer advertises stay — a momentarily incomplete
        advertisement must not strand the client with one candidate."""
        with self._lock:
            for cand in addresses or ():
                if cand and cand not in self._candidates:
                    self._candidates.append(cand)

    def _cooldown_for(self) -> float:
        return (self._MULTI_COOLDOWN_S if len(self._candidates) > 1
                else self._REDIAL_COOLDOWN_S)

    def _in_cooldown(self, addr: str, now: float) -> bool:
        until, _backoff = self._cooldowns.get(addr, (0.0, 0.0))
        return until > now

    def _mark_dial_failed(self, addr: str) -> None:
        base = self._cooldown_for()
        _until, prev = self._cooldowns.get(addr, (0.0, 0.0))
        if len(self._candidates) > 1 and prev:
            # Escalate for head sets: a permanently dead candidate
            # costs one probe per doubling window, not one per walk.
            backoff = min(prev * 2, 15.0)
        else:
            backoff = base
        self._cooldowns[addr] = (time.monotonic() + backoff, backoff)

    def _reconnect(self, skip_current: bool = False) -> RpcClient:
        with self._lock:
            if self._closed:
                # A closed client must NOT resurrect the connection:
                # background pollers retrying through here after
                # close() would re-dial a peer we already detached
                # from (and hang teardown behind fresh long-polls).
                raise ConnectionError(
                    f"client to {self.address} is closed")
            client = self._client
            if client._sock is not None and not skip_current:
                return client  # another caller already re-dialed
            # Walk the candidate set starting at the current address
            # (or just past it on an explicit failover), skipping
            # candidates still cooling down from a failed dial.
            try:
                start = self._candidates.index(self.address)
            except ValueError:
                start = 0
            if skip_current:
                start += 1
            order = [self._candidates[(start + i)
                                      % len(self._candidates)]
                     for i in range(len(self._candidates))]
            now = time.monotonic()
            dialable = [a for a in order
                        if not self._in_cooldown(a, now)]
            if not dialable:
                # Every candidate recently burned a connect budget:
                # fail fast instead of every caller serially paying
                # it again (callers with patience use call_retry and
                # span the cooldown).
                raise ConnectionError(
                    f"no head candidate reachable "
                    f"({self._candidates}: all in re-dial cooldown)")
            client.close()
            # Dialing under the lock is the POINT: concurrent callers
            # racing a lost connection must serialize behind ONE
            # re-dial (the early return above) instead of stampeding
            # the recovering peer with N sockets.
            last_err: Optional[Exception] = None
            # One candidate gets the full budget (a restarting head
            # deserves the patience); a SET caps each candidate at
            # 1-2s — a dead primary must cost seconds of the walk,
            # not the whole budget, or failover blows the
            # availability target (the cooldown keeps later walks
            # from re-paying even that).
            budget = (max(2.0, self._connect_timeout)
                      if len(dialable) == 1
                      else max(1.0, min(2.0, self._connect_timeout
                                        / len(dialable))))
            for cand in dialable:
                try:
                    fresh = RpcClient(cand,  # raylint: disable=blocking-under-lock -- the lock exists to serialize exactly this re-dial; no RPC ever runs under it
                                      budget,
                                      abort=lambda: self._closed)
                except ConnectionError as e:
                    self._mark_dial_failed(cand)
                    last_err = e
                    continue
                if self._closed:
                    # close() raced the dial (it sets the flag without
                    # waiting for this lock): the fresh connection
                    # must not outlive the wrapper.
                    fresh.close()
                    raise ConnectionError(
                        f"client to {self.address} is closed")
                fresh.chaos_tag = self._chaos_tag
                self._cooldowns.pop(cand, None)
                self.address = cand
                self._client = fresh
                return self._client
            raise ConnectionError(
                f"no head candidate reachable "
                f"({self._candidates}): {last_err}")

    def failover(self) -> None:
        """Advance to the next candidate (the current address just
        answered that it is not the primary).  No-op with a single
        candidate."""
        if len(self.candidates) <= 1:
            return
        try:
            self._reconnect(skip_current=True)
        except ConnectionError:
            pass  # next call's _reconnect keeps walking

    def call(self, method: str, payload: Any = None,
             timeout: Optional[float] = None) -> Any:
        try:
            return self._client.call(method, payload, timeout)
        except ConnectionError:
            return self._reconnect().call(method, payload, timeout)

    def call_retry(self, method: str, payload: Any = None, *,
                   timeout: Optional[float] = None,
                   deadline_s: float = 30.0) -> Any:
        """Read-only/naturally-idempotent calls: backoff-retry
        transport failures until ``deadline_s``."""
        return retry_call(self.call, method, payload,
                          timeout=timeout, deadline_s=deadline_s)

    def call_idempotent(self, method: str, payload: Dict[str, Any], *,
                        timeout: Optional[float] = None,
                        deadline_s: float = 30.0) -> Any:
        """MUTATING calls: mint one idempotency key for the logical
        call, then backoff-retry under the deadline.  The server's
        idempotent_handler wrapper replays the first reply for a
        duplicate key, so a retry after a lost RESPONSE does not
        double-apply the mutation."""
        keyed = {**payload, IDEMPOTENCY_KEY: uuid.uuid4().hex}
        return retry_call(
            lambda m, p, t: self.call(m, dict(p), t), method, keyed,
            timeout=timeout, deadline_s=deadline_s)

    def call_async(self, method: str, payload: Any = None,
                   callback: Optional[Callable[[Any, bool], None]] = None,
                   deadline: Optional[float] = None):
        try:
            return self._client.call_async(method, payload, callback,
                                           deadline=deadline)
        except ConnectionError:
            return self._reconnect().call_async(method, payload, callback,
                                                deadline=deadline)

    @property
    def _sock(self):
        return self._client._sock

    def close(self):
        # Flag first, WITHOUT the lock: a re-dial in progress holds
        # the lock for its whole connect budget, and the flag is what
        # aborts that dial (within one retry tick).  Only then take
        # the lock to close whichever client is current.
        self._closed = True
        with self._lock:
            client = self._client
        client.close()


class ClientPool:
    """Caches one RpcClient per address (worker↔worker object fetches,
    driver↔many-nodes pushes)."""

    def __init__(self):
        self._clients: Dict[str, RpcClient] = {}
        self._lock = threading.Lock()

    def get(self, address: str) -> RpcClient:
        with self._lock:
            client = self._clients.get(address)
        if client is not None and client._sock is not None:
            return client
        fresh = RpcClient(address)
        with self._lock:
            self._clients[address] = fresh
        return fresh

    def invalidate(self, address: str):
        with self._lock:
            client = self._clients.pop(address, None)
        if client is not None:
            client.close()

    def close_all(self):
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()

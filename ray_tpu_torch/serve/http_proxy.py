"""HTTP ingress proxy.

Reference: serve/_private/proxy.py:538,759 — ASGI proxy actors route
HTTP to deployment handles.  TPU-first MVP: a stdlib
ThreadingHTTPServer in the driver process (no asgi/uvicorn
dependencies); ``POST /<deployment>`` with a JSON body calls the
deployment and returns the JSON-encoded result.  Each request thread
blocks on its own DeploymentResponse, so concurrency = server threads.

Overload semantics: an ``X-Request-Deadline-S: <seconds>`` header
mints the request's end-to-end deadline at ingress (carried through
the handle, the RPC envelope, and the replica mailbox); a typed
``BackPressureError`` / ``PendingCallsLimitExceededError`` maps to
**503 + Retry-After**, a blown deadline to **504**.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..observability import tracing as _tracing

DEADLINE_HEADER = "X-Request-Deadline-S"
_DEFAULT_TIMEOUT_S = 60.0
_access_log = logging.getLogger("ray_tpu.serve.http")


class _Proxy:
    def __init__(self, host: str, port: int, handles: Dict[str, object]):
        self.handles = handles
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                from ray_tpu_torch.core import deadlines as _deadlines
                from ray_tpu_torch.exceptions import (
                    BackPressureError, DeadlineExceededError,
                    GetTimeoutError, PendingCallsLimitExceededError)

                name = self.path.strip("/").split("/")[0]
                handle = proxy.handles.get(name)
                if handle is None:
                    self.send_error(404, f"no deployment {name!r}")
                    return
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) if length else b""
                try:
                    deadline_s = float(
                        self.headers.get(DEADLINE_HEADER) or 0) or None
                except ValueError:
                    deadline_s = None
                deadline = (time.time() + deadline_s
                            if deadline_s else None)
                # An explicit deadline governs the wait — a client
                # declaring a 120 s budget must not be cut off at the
                # no-header default.
                timeout = (deadline_s if deadline_s
                           else _DEFAULT_TIMEOUT_S)
                extra_headers = []
                t_req0 = time.time()
                trace_id = None
                try:
                    payload = json.loads(raw) if raw else None
                    # The ingress deadline scope makes the handle (and
                    # everything downstream of it) inherit the budget;
                    # the ingress SPAN makes this HTTP request the
                    # trace root, so the access-log record, the
                    # replica's spans, and its log lines all share one
                    # trace id.
                    with _deadlines.scope(deadline), \
                            _tracing.span("http.request",
                                          {"deployment": name}) as span:
                        trace_id = span.trace_id
                        result = handle.remote(payload).result(
                            timeout=timeout)
                    body = json.dumps({"result": result}).encode()
                    status = 200
                except (BackPressureError,
                        PendingCallsLimitExceededError) as e:
                    # Admission-control rejection: the request never
                    # ran — tell the client WHEN to come back.
                    retry_after = getattr(e, "retry_after_s", None)
                    extra_headers.append(
                        ("Retry-After",
                         str(max(1, math.ceil(retry_after or 1.0)))))
                    body = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode()
                    status = 503
                except (DeadlineExceededError, GetTimeoutError) as e:
                    body = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode()
                    status = 504
                except Exception as e:  # noqa: BLE001 — 500 w/ message
                    body = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode()
                    status = 500
                # Access-log record (structured plane): one line per
                # request, carrying the ingress trace id — `ray_tpu
                # logs --trace <id>` pulls the proxy line next to the
                # replica's.  Lazy %-args: this is the serving hot
                # path (raylint log-hygiene).
                if _access_log.isEnabledFor(logging.DEBUG):
                    _access_log.debug(
                        "%s %s -> %d in %.1fms trace=%s", name,
                        self.command, status,
                        (time.time() - t_req0) * 1e3, trace_id)
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in extra_headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            do_GET = do_POST

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True)
        self._thread.start()

    def shutdown(self):
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(timeout=2.0)


_proxy: Optional[_Proxy] = None


def start_proxy(handles: Dict[str, object], host: str = "127.0.0.1",
                port: int = 0) -> int:
    global _proxy
    stop_proxy()
    _proxy = _Proxy(host, port, handles)
    return _proxy.port


def proxy_handles() -> Optional[Dict[str, object]]:
    return _proxy.handles if _proxy else None


def stop_proxy():
    global _proxy
    if _proxy is not None:
        _proxy.shutdown()
        _proxy = None


# --------------------------------------------------------------------------
# Per-node proxy fleet (reference: serve/_private/proxy_state.py — one
# health-checked, drainable proxy per node behind an external LB, so
# ingress survives any single node's death).
# --------------------------------------------------------------------------

class ProxyActor:
    """One HTTP ingress on its node; resolves deployment handles
    inside its own process so routing state is node-local."""

    def __init__(self, deployment_names, port: int = 0):
        from . import get_deployment_handle

        handles = {n: get_deployment_handle(n)
                   for n in deployment_names}
        import ray_tpu_torch

        rt = ray_tpu_torch.get_runtime()
        host = "127.0.0.1"
        if rt.cluster is not None:
            host = rt.cluster.address.rsplit(":", 1)[0]
        self._proxy = _Proxy(host, port, handles)
        self._host = host
        self._draining = False

    def address(self) -> str:
        return f"{self._host}:{self._proxy.port}"

    def healthy(self) -> bool:
        return not self._draining

    def refresh(self, deployment_names) -> bool:
        """Redeploy/membership refresh: REBUILD the routing table —
        deployments absent from the list stop being routable (deleted
        apps must 404, not hit dead replicas)."""
        from . import get_deployment_handle

        fresh = {n: get_deployment_handle(n) for n in deployment_names}
        self._proxy.handles.clear()
        self._proxy.handles.update(fresh)
        return True

    def drain(self) -> bool:
        """Stop accepting (reference: draining before node removal).
        In-flight requests finish; the LB health check goes false."""
        self._draining = True
        self._proxy.shutdown()
        return True


class ProxyFleet:
    """One ProxyActor per alive node (NodeAffinity-pinned)."""

    def __init__(self, deployment_names, port: int = 0):
        import ray_tpu_torch
        from ray_tpu_torch.core.task_spec import (
            NodeAffinitySchedulingStrategy)

        rt = ray_tpu_torch.get_runtime()
        Actor = ray_tpu_torch.remote(ProxyActor)
        self.proxies = {}
        nodes = (rt.cluster.list_nodes() if rt.cluster is not None
                 else [])
        alive = [n for n in nodes if n.get("alive")]
        if not alive:
            self.proxies["local"] = Actor.remote(
                list(deployment_names), port)
        else:
            for n in alive:
                self.proxies[n["node_id"]] = Actor.options(
                    scheduling_strategy=NodeAffinitySchedulingStrategy(
                        node_id=n["node_id"], soft=False),
                    num_cpus=0).remote(list(deployment_names), port)
        self.address_of = dict(zip(
            self.proxies,
            ray_tpu_torch.get([p.address.remote()
                         for p in self.proxies.values()], timeout=60)))
        self.addresses = list(self.address_of.values())

    def healthy_addresses(self):
        """The LB target list: addresses whose proxy answers healthy.
        All probes fly in parallel, so the poll costs ONE timeout even
        with several dead nodes."""
        import ray_tpu_torch

        refs = {nid: p.healthy.remote()
                for nid, p in self.proxies.items()}
        out = []
        for nid, ref in refs.items():
            try:
                if ray_tpu_torch.get(ref, timeout=5):
                    out.append(self.address_of[nid])
            except Exception:
                pass  # dead node's proxy: excluded
        return out

    def drain(self, node_id: str) -> bool:
        p = self.proxies.get(node_id)
        if p is None:
            return False
        import ray_tpu_torch

        return ray_tpu_torch.get(p.drain.remote(), timeout=30)

    def shutdown(self):
        import ray_tpu_torch

        # Drain first: kill() alone leaves each ThreadingHTTPServer's
        # daemon thread bound and serving in its node process.
        drains = [p.drain.remote() for p in self.proxies.values()]
        for ref in drains:
            try:
                ray_tpu_torch.get(ref, timeout=30)
            except Exception:
                pass
        for p in self.proxies.values():
            try:
                ray_tpu_torch.kill(p)
            except Exception:
                pass
        self.proxies = {}

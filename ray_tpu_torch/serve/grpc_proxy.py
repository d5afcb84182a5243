"""gRPC ingress proxy.

Reference: serve/_private/proxy.py:538 (gRPCProxy) — a second ingress
protocol next to HTTP, for clients that want typed RPC + streaming
instead of JSON-over-HTTP.

Protoless generic service (no codegen step): one gRPC server exposes

  /ray_tpu.serve.Ingress/Call        unary-unary
  /ray_tpu.serve.Ingress/CallStream  unary-stream

Requests/responses are serialization bundles (cloudpickle + extern
arrays), so any payload a deployment accepts over a handle works over
gRPC — including numpy/bf16 arrays.  The request dict carries
``{"deployment", "method"?, "args", "kwargs"}``; Call returns
``{"result": ...}`` or ``{"error": exc}``, CallStream yields one
bundle per item of a streaming deployment response.
"""

from __future__ import annotations

import re
import time
from typing import Dict, Optional

from ..cluster.serialization import dumps, loads

CALL = "/ray_tpu.serve.Ingress/Call"
CALL_STREAM = "/ray_tpu.serve.Ingress/CallStream"


class _Ingress:
    def __init__(self, handles: Dict[str, object]):
        self.handles = handles

    def _resolve(self, req):
        handle = self.handles.get(req["deployment"])
        if handle is None:
            raise KeyError(f"no deployment {req['deployment']!r}")
        method = req.get("method")
        if method:
            handle = handle.options(method_name=method)
        mux = req.get("multiplexed_model_id")
        if mux:
            handle = handle.options(multiplexed_model_id=mux)
        return handle

    def call(self, request: bytes, _ctx) -> bytes:
        import grpc

        from ..core import deadlines as _deadlines
        from ..exceptions import (BackPressureError,
                                  DeadlineExceededError, GetTimeoutError,
                                  PendingCallsLimitExceededError)

        req = loads(request)
        deadline_s = req.get("deadline_s")
        deadline = (None if deadline_s is None
                    else time.time() + float(deadline_s))
        try:
            handle = self._resolve(req)
            timeout = req.get("timeout", 60.0)
            if deadline_s is not None:
                timeout = min(timeout, float(deadline_s))
            with _deadlines.scope(deadline):
                result = handle.remote(
                    *req.get("args", ()),
                    **req.get("kwargs", {})).result(timeout=timeout)
            return dumps({"result": result})
        except (BackPressureError, PendingCallsLimitExceededError) as e:
            # Admission-control rejection → UNAVAILABLE (the gRPC
            # idiom for "overloaded, retry later"); retry_after rides
            # the details string for clients that parse it.
            retry_after = getattr(e, "retry_after_s", None) or 1.0
            _ctx.abort(grpc.StatusCode.UNAVAILABLE,
                       f"backpressure: {e} "
                       f"[retry_after_s={retry_after:.3f}]")
        except (DeadlineExceededError, GetTimeoutError) as e:
            _ctx.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        except Exception as e:  # noqa: BLE001
            return dumps({"error": e})

    def call_stream(self, request: bytes, _ctx):
        req = loads(request)
        try:
            handle = self._resolve(req).options(stream=True)
            for item in handle.remote(*req.get("args", ()),
                                      **req.get("kwargs", {})):
                yield dumps({"item": item})
        except Exception as e:  # noqa: BLE001
            # NOT BaseException: grpc throws GeneratorExit into this
            # generator on client cancellation, and yielding after
            # catching it is a RuntimeError.
            yield dumps({"error": e})


class _GrpcProxy:
    def __init__(self, host: str, port: int, handles: Dict[str, object]):
        import grpc
        from concurrent.futures import ThreadPoolExecutor

        ingress = _Ingress(handles)
        self.handles = handles

        rpcs = {
            "Call": grpc.unary_unary_rpc_method_handler(
                ingress.call,
                request_deserializer=None, response_serializer=None),
            "CallStream": grpc.unary_stream_rpc_method_handler(
                ingress.call_stream,
                request_deserializer=None, response_serializer=None),
        }
        handler = grpc.method_handlers_generic_handler(
            "ray_tpu.serve.Ingress", rpcs)
        self.server = grpc.server(ThreadPoolExecutor(max_workers=16))
        self.server.add_generic_rpc_handlers((handler,))
        self.port = self.server.add_insecure_port(f"{host}:{port}")
        self.server.start()

    def shutdown(self):
        self.server.stop(grace=1.0)


_grpc_proxy: Optional[_GrpcProxy] = None


def start_grpc_proxy(handles: Dict[str, object],
                     host: str = "127.0.0.1", port: int = 0) -> int:
    """Start (or restart) the gRPC ingress; returns the bound port."""
    global _grpc_proxy
    stop_grpc_proxy()
    _grpc_proxy = _GrpcProxy(host, port, handles)
    return _grpc_proxy.port


def grpc_proxy_handles() -> Optional[Dict[str, object]]:
    """Live handle map of the running gRPC ingress (refreshed in
    place on redeploys, like the HTTP proxy's)."""
    return _grpc_proxy.handles if _grpc_proxy else None


def stop_grpc_proxy() -> None:
    global _grpc_proxy
    if _grpc_proxy is not None:
        _grpc_proxy.shutdown()
        _grpc_proxy = None


# ----------------------------------------------------------- client side
class GrpcServeClient:
    """Minimal client for the generic ingress (tests / examples; any
    gRPC stack can speak it by sending serialization bundles)."""

    def __init__(self, target: str):
        import grpc

        self._channel = grpc.insecure_channel(target)
        self._call = self._channel.unary_unary(CALL)
        self._stream = self._channel.unary_stream(CALL_STREAM)

    def call(self, deployment: str, *args, method: str = "",
             multiplexed_model_id: str = "", timeout: float = 60.0,
             deadline_s: Optional[float] = None, **kwargs):
        import grpc

        try:
            out = loads(self._call(dumps({
                "deployment": deployment, "method": method,
                "multiplexed_model_id": multiplexed_model_id,
                "args": args, "kwargs": kwargs, "timeout": timeout,
                "deadline_s": deadline_s}),
                timeout=timeout + 30.0))
        except grpc.RpcError as e:
            # Translate the ingress's overload statuses back into the
            # framework's typed errors.
            from ..exceptions import (BackPressureError,
                                      DeadlineExceededError)

            code = e.code() if callable(getattr(e, "code", None)) \
                else None
            details = (e.details() or "") if callable(
                getattr(e, "details", None)) else ""
            if code == grpc.StatusCode.UNAVAILABLE:
                m = re.search(r"retry_after_s=([0-9.]+)", details)
                raise BackPressureError(
                    f"gRPC ingress rejected: {details}",
                    retry_after_s=float(m.group(1)) if m else None
                ) from e
            if code == grpc.StatusCode.DEADLINE_EXCEEDED:
                raise DeadlineExceededError(
                    f"gRPC ingress: {details}") from e
            raise
        if "error" in out:
            raise out["error"]
        return out["result"]

    def call_stream(self, deployment: str, *args, method: str = "",
                    timeout: float = 60.0, **kwargs):
        for raw in self._stream(dumps({
                "deployment": deployment, "method": method,
                "args": args, "kwargs": kwargs}), timeout=timeout):
            out = loads(raw)
            if "error" in out:
                raise out["error"]
            yield out["item"]

    def close(self):
        self._channel.close()

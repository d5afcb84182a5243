"""Replica actor: hosts one copy of the user's deployment callable.

Reference: serve/_private/replica.py:750,807,998 — ``ReplicaActor``
wraps the user class/function in a ``UserCallableWrapper`` running on
an asyncio loop; requests arrive as actor calls.  Same shape here: the
replica is an async ray_tpu actor (the actor runtime gives async
classes an asyncio loop + high max_concurrency), so ``@serve.batch``
methods can queue and flush batches while other requests await.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional, Tuple


class Replica:
    """User-code host.  Created by the controller via
    ``ray_tpu_torch.remote(Replica).options(...)``."""

    def __init__(self, deployment_name: str, callable_def,
                 init_args: Tuple, init_kwargs: Dict[str, Any],
                 role: str = "both"):
        self._deployment = deployment_name
        # Disaggregated-serving role (prefill | decode | both): the
        # controller assigns it per replica from the deployment's
        # ``replica_roles``; the router filters on it.  User callables
        # that declare ``role`` / ``serve_deployment`` params get them
        # injected so the instance can route its own KV handoffs
        # (serve/llm.py LLMServer does).
        self._role = role
        if inspect.isclass(callable_def):
            init_kwargs = dict(init_kwargs)
            try:
                params = inspect.signature(
                    callable_def.__init__).parameters
            except (TypeError, ValueError):
                params = {}
            if role != "both" and "role" in params \
                    and "role" not in init_kwargs:
                init_kwargs["role"] = role
            if "serve_deployment" in params \
                    and "serve_deployment" not in init_kwargs:
                init_kwargs["serve_deployment"] = deployment_name
            self._instance = callable_def(*init_args, **init_kwargs)
        else:
            if init_args or init_kwargs:
                raise TypeError(
                    "function deployments take no init args")
            self._instance = callable_def
        self._num_ongoing = 0
        # The hosting actor's core (resolved lazily from the first
        # request's task context): its mailbox length is the queued
        # half of this replica's reported queue depth.
        self._actor_core = None

    def _queue_depth(self) -> int:
        """ongoing + mailbox-queued — the load signal piggybacked on
        every response for the router's power-of-two choice (the
        reference probes this over RPC, pow_2_scheduler.py:52)."""
        if self._actor_core is None:
            try:
                import ray_tpu_torch
                from ray_tpu_torch.core import runtime_context as rc

                ctx = rc.current_task_context()
                if ctx is not None and ctx.actor_id is not None:
                    self._actor_core = (ray_tpu_torch.get_runtime()
                                        .actor_manager
                                        .get_core(ctx.actor_id))
            except Exception:
                self._actor_core = None
        queued = (self._actor_core._pending_calls
                  if self._actor_core is not None else 0)
        return self._num_ongoing + queued

    async def handle_request(self, method: str, args: Tuple,
                             kwargs: Dict[str, Any],
                             multiplexed_model_id: str = ""):
        from .handle import _PIGGYBACK_KEY
        from .multiplex import _reset_model_id, _set_model_id

        self._num_ongoing += 1
        # Resolve the actor core NOW: the task context is installed
        # for this coroutine's first (pre-await) step only.
        self._queue_depth()
        token = _set_model_id(multiplexed_model_id)
        try:
            if method:
                fn = getattr(self._instance, method)
            else:
                fn = self._instance  # __call__ or plain function
            out = fn(*args, **kwargs)
            if inspect.isawaitable(out):
                out = await out
            # Piggyback the replica's queue depth on the reply — the
            # handle unwraps it and feeds its router.
            return {_PIGGYBACK_KEY: out, "q": self._queue_depth()}
        finally:
            _reset_model_id(token)
            self._num_ongoing -= 1

    async def handle_request_streaming(self, method: str, args: Tuple,
                                       kwargs: Dict[str, Any],
                                       multiplexed_model_id: str = ""):
        """Generator endpoint: the user method yields items, forwarded
        through the actor streaming-generator machinery (reference:
        replica streaming + proxy_response_generator.py)."""
        from .multiplex import _reset_model_id, _set_model_id

        self._num_ongoing += 1
        token = _set_model_id(multiplexed_model_id)
        try:
            fn = getattr(self._instance, method) if method \
                else self._instance
            out = fn(*args, **kwargs)
            if inspect.isasyncgen(out):
                async for item in out:
                    yield item
            else:
                for item in out:
                    yield item
        finally:
            _reset_model_id(token)
            self._num_ongoing -= 1

    async def get_role(self) -> str:
        return self._role

    async def num_ongoing_requests(self) -> int:
        """Queue-length probe (reference: pow-2 scheduler probes
        replicas for their ongoing count, pow_2_scheduler.py:52)."""
        return self._num_ongoing

    async def reconfigure(self, user_config):
        """Reference: lightweight config updates without restart
        (deployment_state.py version diffing)."""
        fn = getattr(self._instance, "reconfigure", None)
        if fn is not None:
            out = fn(user_config)
            if inspect.isawaitable(out):
                await out

    async def shutdown_user(self):
        """Invoke the user callable's ``shutdown`` hook, if any (the
        controller calls this before killing the replica actor)."""
        fn = getattr(self._instance, "shutdown", None)
        if fn is not None:
            out = fn()
            if inspect.isawaitable(out):
                await out

    async def health_check(self) -> bool:
        fn = getattr(self._instance, "check_health", None)
        if fn is None:
            return True
        out = fn()
        if inspect.isawaitable(out):
            out = await out
        return bool(out) if out is not None else True

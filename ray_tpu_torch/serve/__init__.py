"""ray_tpu.serve — model serving on the ray_tpu runtime.

Reference: python/ray/serve (74.4k LoC).  MVP of the same shape:
``@serve.deployment`` → ``serve.run`` starts a controller actor that
creates replica actors; ``DeploymentHandle`` routes with
power-of-two-choices; ``@serve.batch`` coalesces requests inside a
replica; an optional stdlib HTTP proxy serves ``POST /<name>``;
``ray_tpu_torch.serve.llm`` adds a continuous-batched decode deployment
on the GPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from .batching import batch
from .multiplex import get_multiplexed_model_id, multiplexed
from .handle import DeploymentHandle, DeploymentResponse
# Overload-plane error types, re-exported so serving code can catch
# them without importing ray_tpu_torch.exceptions.
from ..exceptions import BackPressureError, DeadlineExceededError

_CONTROLLER_NAME = "serve_controller"


class Application:
    def __init__(self, deployment: "Deployment", init_args: Tuple,
                 init_kwargs: Dict[str, Any]):
        self.deployment = deployment
        self.init_args = init_args
        self.init_kwargs = init_kwargs


class Deployment:
    """Result of ``@serve.deployment`` (reference: serve/api.py:246)."""

    def __init__(self, callable_def, name: str,
                 config: Optional[Dict[str, Any]] = None):
        self._callable = callable_def
        self.name = name
        self._config = config or {}

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                max_ongoing_requests: Optional[int] = None,
                max_queued_requests: Optional[int] = None,
                user_config: Any = None,
                autoscaling_config: Optional[dict] = None,
                ray_actor_options: Optional[dict] = None,
                replica_roles: Optional[dict] = None,
                ingress_role: Optional[str] = None) -> "Deployment":
        cfg = dict(self._config)
        for k, v in (("num_replicas", num_replicas),
                     ("max_ongoing_requests", max_ongoing_requests),
                     ("max_queued_requests", max_queued_requests),
                     ("user_config", user_config),
                     ("autoscaling_config", autoscaling_config),
                     ("ray_actor_options", ray_actor_options),
                     ("replica_roles", replica_roles),
                     ("ingress_role", ingress_role)):
            if v is not None:
                cfg[k] = v
        return Deployment(self._callable, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def __call__(self, *a, **kw):
        raise RuntimeError(
            "deployments are not called directly — use "
            "serve.run(D.bind(...)) and handle.remote(...)")


def deployment(_callable=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_ongoing_requests: int = 100,
               max_queued_requests: int = -1,
               user_config: Any = None,
               autoscaling_config: Optional[dict] = None,
               ray_actor_options: Optional[dict] = None,
               replica_roles: Optional[dict] = None,
               ingress_role: Optional[str] = None):
    """``@serve.deployment`` decorator (reference: serve/api.py:246).

    ``max_queued_requests`` (reference: serve deployment config of the
    same name): bounds each replica's mailbox beyond the
    ``max_ongoing_requests`` executing — a full replica rejects with a
    typed error the router routes around, and the ingress maps to
    503 + Retry-After / gRPC UNAVAILABLE.  -1 (default) = unbounded.

    ``autoscaling_config`` (reference: serve autoscaling_policy.py):
    ``{"min_replicas", "max_replicas", "target_ongoing_requests",
    "interval_s", "downscale_delay_s"}`` — queue-depth-driven replica
    count between min and max.

    ``replica_roles`` (prefill/decode disaggregation):
    ``{"prefill": 1, "decode": {"num": 2, "ray_actor_options": {...}}}``
    splits the replica set into roles; the router sends ingress
    traffic to ``ingress_role`` replicas (default: ``"prefill"`` when
    one exists), and prefill replicas hand KV blocks to decode peers
    over the shm ring (same host) or the striped object plane
    (cross host) — see docs/serving.md."""

    def deco(cd):
        return Deployment(cd, name or cd.__name__, {
            "num_replicas": num_replicas,
            "max_ongoing_requests": max_ongoing_requests,
            "max_queued_requests": max_queued_requests,
            "user_config": user_config,
            "autoscaling_config": autoscaling_config,
            "ray_actor_options": ray_actor_options,
            "replica_roles": replica_roles,
            "ingress_role": ingress_role,
        })

    if _callable is not None:
        return deco(_callable)
    return deco


# --------------------------------------------------------------------------
# Control-plane client
# --------------------------------------------------------------------------
def _get_controller(create: bool = True):
    import ray_tpu_torch

    try:
        return ray_tpu_torch.get_actor(_CONTROLLER_NAME)
    except Exception:
        if not create:
            raise
    from .controller import ServeController

    # High concurrency: membership polls and status queries must stay
    # answerable while a deploy/rolling update runs (state is guarded
    # by the controller's own lock).
    return ray_tpu_torch.remote(ServeController).options(
        name=_CONTROLLER_NAME, lifetime="detached",
        max_concurrency=16).remote()


def run(app: Application, *, name: Optional[str] = None,
        http_port: Optional[int] = None,
        grpc_port: Optional[int] = None) -> DeploymentHandle:
    """Deploy an application; returns its handle
    (reference: serve.run, api.py:492)."""
    import ray_tpu_torch

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    dep = app.deployment if name is None else \
        app.deployment.options(name=name)
    controller = _get_controller()
    # user_config is applied to each replica at construction
    # (_start_replica reconfigures) — no second pass here.
    ray_tpu_torch.get(controller.deploy.remote(
        dep.name, dep._callable, app.init_args, app.init_kwargs,
        dep._config))
    handle = get_deployment_handle(dep.name)
    from . import http_proxy

    from . import grpc_proxy

    live = http_proxy.proxy_handles()
    if live is not None:
        # A redeploy replaced the replicas; refresh the running
        # proxy's handle in place so HTTP traffic follows.  (Handles
        # users kept from before a redeploy must be re-fetched with
        # get_deployment_handle — reference handles refresh via
        # long-poll, not implemented here.)
        live[dep.name] = handle
    grpc_live = grpc_proxy.grpc_proxy_handles()
    if grpc_live is not None:
        grpc_live[dep.name] = handle  # same in-place redeploy refresh
    if http_port is not None:
        handles = dict(live or {})
        handles[dep.name] = handle
        port = http_proxy.start_proxy(handles, port=http_port)
        handle.http_port = port
    if grpc_port is not None:
        # Seed a restart from BOTH live maps so earlier apps keep
        # serving whichever ingress they were on.
        handles = {**(live or {}), **(grpc_live or {})}
        handles[dep.name] = handle
        handle.grpc_port = grpc_proxy.start_grpc_proxy(
            handles, port=grpc_port)
    return handle


def get_deployment_handle(name: str) -> DeploymentHandle:
    import ray_tpu_torch

    controller = _get_controller(create=False)
    membership = ray_tpu_torch.get(controller.get_membership.remote(name, -1))
    return DeploymentHandle(name, membership["replicas"],
                            controller=controller,
                            version=membership["version"],
                            roles=membership.get("roles"),
                            ingress_role=membership.get("ingress_role"))


def status() -> Dict[str, Any]:
    import ray_tpu_torch

    controller = _get_controller(create=False)
    return ray_tpu_torch.get(controller.list_deployments.remote())


def delete(name: str):
    import ray_tpu_torch

    controller = _get_controller(create=False)
    return ray_tpu_torch.get(controller.delete.remote(name))


def shutdown():
    import ray_tpu_torch

    from . import http_proxy

    http_proxy.stop_proxy()
    try:
        from . import grpc_proxy

        grpc_proxy.stop_grpc_proxy()
    except Exception:
        pass
    try:
        controller = _get_controller(create=False)
    except Exception:
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote())
        ray_tpu_torch.kill(controller)
    except Exception:
        pass


__all__ = [
    "Application", "BackPressureError", "DeadlineExceededError",
    "Deployment", "DeploymentHandle",
    "DeploymentResponse", "batch", "delete", "deployment",
    "get_deployment_handle", "get_multiplexed_model_id", "multiplexed",
    "run", "shutdown", "status",
]

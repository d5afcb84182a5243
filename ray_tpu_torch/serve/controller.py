"""Serve controller: owns deployment state and replica lifecycles.

Reference: serve/_private/controller.py:84,719 (``ServeController``
actor with reconciliation loops) + deployment_state.py:1245,2343
(replica lifecycle / rolling updates) + autoscaling_policy.py /
autoscaling_state.py (queue-depth-driven replica count).

Scope: deploy with ZERO-DOWNTIME rolling updates (new replica up and
healthy before an old one drains and stops; falls back to
stop-then-start when replicas hold exclusive hardware like the one
GPU), queue-depth autoscaling between min/max replicas, lightweight
reconfigure, health-gated construction, and membership versioning that
handles poll to follow replica-set changes (the reference pushes these
over LongPoll; the handles here poll the version at ~1 Hz).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple


class ServeController:
    """Runs as a detached named actor ("serve_controller")."""

    def __init__(self):
        # name -> {config, replicas: [handles], version,
        #          membership_version, next_replica_id,
        #          callable, init_args, init_kwargs, autoscale state}
        self._deployments: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.RLock()
        # One deploy at a time per deployment NAME (the controller
        # actor itself runs concurrent calls so membership polls stay
        # live): without this, two racing deploys both read the same
        # version and mix two replica sets.
        self._deploy_locks: Dict[str, threading.Lock] = {}
        self._stop = threading.Event()
        self._autoscaler = threading.Thread(
            target=self._autoscale_loop, daemon=True)
        self._autoscaler.start()
        # Controller recovery: deployment specs checkpoint to
        # the head's durable KV (journaled — survives a head kill -9).
        # A FRESH controller (this actor restarted on a survivor after
        # its node died) redeploys everything the checkpoint names; on
        # first boot the checkpoint is absent and this is a no-op.
        self._recover_from_checkpoint()

    # ------------------------------------------------------ checkpointing
    _CKPT_KEY = "controller_deployments"
    _CKPT_NS = "serve"

    @staticmethod
    def _head_kv():
        """The durable KV, or None outside cluster mode (single-node
        serve keeps everything in-process — nothing survives the
        process anyway)."""
        import ray_tpu_torch

        try:
            rt = ray_tpu_torch.get_runtime()
        except RuntimeError:
            return None
        return rt.cluster

    def _checkpoint(self):
        kv = self._head_kv()
        if kv is None:
            return
        from ..cluster.serialization import dumps

        with self._lock:
            specs = {name: dumps({
                "callable": d["callable"],
                "init_args": d["init_args"],
                "init_kwargs": d["init_kwargs"],
                "config": d["config"],
            }) for name, d in self._deployments.items()}
        try:
            kv.kv_put(self._CKPT_KEY, specs, ns=self._CKPT_NS)
        except Exception:  # raylint: disable=ft-exception-swallow -- checkpointing is best-effort: a head outage mid-deploy must not fail the deploy (the next deploy/delete re-checkpoints)
            pass

    def _recover_from_checkpoint(self):
        kv = self._head_kv()
        if kv is None:
            return
        from ..cluster.serialization import loads

        try:
            specs = kv.kv_get(self._CKPT_KEY, ns=self._CKPT_NS)
        except Exception:  # raylint: disable=ft-exception-swallow -- recovery is opportunistic at construction; an unreachable head means there is nothing to recover yet
            return
        for name, blob in (specs or {}).items():
            if name in self._deployments:
                continue
            try:
                spec = loads(blob)
                self.deploy(name, spec["callable"],
                            spec["init_args"], spec["init_kwargs"],
                            spec["config"])
            except Exception:  # raylint: disable=ft-exception-swallow -- one unrecoverable deployment (its class no longer imports, its resources are gone) must not block the rest of the recovery
                pass

    # ------------------------------------------------------------ deploy
    def deploy(self, name: str, callable_def, init_args: Tuple,
               init_kwargs: Dict[str, Any], config: Dict[str, Any]):
        """Slow work (replica construction, health gates, drains) runs
        OUTSIDE the lock so membership polls and status queries stay
        live throughout a deploy (the controller actor itself runs with
        high max_concurrency for the same reason)."""
        with self._lock:
            name_lock = self._deploy_locks.setdefault(
                name, threading.Lock())
        with name_lock:
            # Holding the per-NAME lock across the (blocking) rollout
            # is the invariant: two racing deploys of one deployment
            # must serialize end to end.  No RPC handler or other
            # deployment ever contends on this lock.
            out = self._deploy_locked(name, callable_def, init_args,  # raylint: disable=blocking-under-lock -- per-deployment rollout serialization is this lock's purpose
                                      init_kwargs, config)
        self._checkpoint()
        return out

    @staticmethod
    def _role_plan(config) -> List[Optional[str]]:
        """The per-replica role sequence a deployment's config asks
        for: ``replica_roles={"prefill": 1, "decode": 2}`` (values may
        also be ``{"num": n, "ray_actor_options": {...}}`` for
        per-role placement) expands to one entry per replica; plain
        deployments get ``[None] * num_replicas``."""
        roles = config.get("replica_roles")
        if not roles:
            num = max(1, int(config.get("num_replicas", 1)))
            auto = config.get("autoscaling_config")
            if auto:
                num = max(int(auto.get("min_replicas", 1)),
                          min(num, int(auto.get("max_replicas", num))))
            return [None] * num
        plan: List[Optional[str]] = []
        for role, opts in roles.items():
            if role not in ("prefill", "decode", "both"):
                raise ValueError(f"unknown replica role {role!r}")
            n = int(opts.get("num", 1)) if isinstance(opts, dict) \
                else int(opts)
            plan.extend([role] * max(0, n))
        if not plan:
            raise ValueError("replica_roles names zero replicas")
        return plan

    def _deploy_locked(self, name, callable_def, init_args,
                       init_kwargs, config):
        plan = self._role_plan(config)
        num = len(plan)
        spec = {"config": dict(config), "callable": callable_def,
                "init_args": init_args, "init_kwargs": init_kwargs}
        with self._lock:
            existing = self._deployments.get(name)
            version = (existing["version"] + 1) if existing else 1
            if existing is None:
                self._deployments[name] = {
                    **spec, "replicas": [], "role_by_id": {},
                    "version": version,
                    "membership_version": 0, "next_replica_id": 0,
                    "last_downscale_ok": time.monotonic()}
        if existing is None:
            for role in plan:
                self._start_replica(name, role=role)
            with self._lock:
                n = len(self._deployments[name]["replicas"])
            return {"name": name, "version": version,
                    "num_replicas": n}

        # Redeploy: CANARY the new version before committing it — a
        # broken version must not replace the stored spec (the
        # reference marks the deployment UNHEALTHY and keeps serving
        # the old version).
        if self._exclusive_resources(config):
            # Replicas hold exclusive hardware (e.g. THE GPU): a
            # rolling overlap deadlocks on the resource, so old
            # replicas stop before new ones start (brief downtime —
            # and no canary is possible for the same reason).
            with self._lock:
                d = self._deployments[name]
                old = list(d["replicas"])
                d["replicas"] = []
                d.update(**spec, version=version)
                self._bump_membership(name)
            self._stop_replicas(old)
            for role in plan:
                self._start_replica(name, role=role)
        else:
            canary = self._construct_replica(name, spec, version, 0,
                                             role=plan[0])
            with self._lock:
                d = self._deployments[name]
                old = list(d["replicas"])
                d.update(**spec, version=version)
                d["next_replica_id"] = max(d["next_replica_id"], 1)
                d["replicas"].append(canary)
                if plan[0] is not None:
                    d["role_by_id"][self._replica_key(canary)] = plan[0]
                self._bump_membership(name)
            # Rolling update (deployment_state.py:1245): one new
            # replica up and healthy, then one old drained and
            # stopped — traffic always has a live target.
            for i in range(num):
                if i > 0:
                    self._start_replica(name, role=plan[i])
                if old:
                    victim = old.pop(0)
                    with self._lock:
                        d = self._deployments[name]
                        if victim in d["replicas"]:
                            d["replicas"].remove(victim)
                            self._bump_membership(name)
                    self._drain_and_stop(victim)
            if old:
                with self._lock:
                    d = self._deployments[name]
                    d["replicas"] = [r for r in d["replicas"]
                                     if r not in old]
                    self._bump_membership(name)
                self._stop_replicas(old)
        with self._lock:
            n = len(self._deployments[name]["replicas"])
        return {"name": name, "version": version, "num_replicas": n}

    @staticmethod
    def _exclusive_resources(config: Dict[str, Any]) -> bool:
        opts = config.get("ray_actor_options") or {}
        if opts.get("num_gpus"):
            return True
        return bool((opts.get("resources") or {}).get("GPU"))

    @staticmethod
    def _replica_key(replica):
        return getattr(replica, "_actor_id", id(replica))

    def _construct_replica(self, name: str, spec: Dict[str, Any],
                           version: int, rid: int,
                           role: Optional[str] = None):
        """Create + health-gate one replica from an explicit spec (no
        lock held; the caller publishes it)."""
        import ray_tpu_torch

        from .replica import Replica

        config = spec["config"]
        ray_actor_options = dict(config.get("ray_actor_options") or {})
        if role is not None:
            # Per-role placement: a role entry may carry its own actor
            # options (e.g. pin decode replicas to the TPU-rich node,
            # prefill to the CPU-rich one) layered over the shared ones.
            opts = (config.get("replica_roles") or {}).get(role)
            if isinstance(opts, dict):
                ray_actor_options.update(
                    opts.get("ray_actor_options") or {})
        RemoteReplica = ray_tpu_torch.remote(Replica)
        # Admission control: max_queued_requests bounds the replica's
        # MAILBOX (max_ongoing_requests bounds concurrent execution).
        # A full mailbox rejects the submission with a typed
        # PendingCallsLimitExceededError, which the router treats as
        # route-elsewhere — so overload degrades by shedding, not by
        # unbounded queueing (default -1 = unbounded, reference
        # serve's max_queued_requests).
        max_queued = int(config.get("max_queued_requests", -1))
        if max_queued == 0:
            raise ValueError("max_queued_requests must be >= 1 (or -1 "
                             "for unbounded)")
        replica = RemoteReplica.options(
            name=f"SERVE_{name}#{version}_{rid}",
            max_concurrency=int(config.get("max_ongoing_requests", 100)),
            max_pending_calls=max_queued,
            **ray_actor_options,
        ).remote(name, spec["callable"], spec["init_args"],
                 spec["init_kwargs"], role or "both")
        # Health-gate before routing traffic (reference: replicas must
        # pass initialization before the deployment goes HEALTHY).
        ray_tpu_torch.get(replica.health_check.remote())
        if config.get("user_config") is not None:
            ray_tpu_torch.get(replica.reconfigure.remote(
                config["user_config"]))
        return replica

    def _start_replica(self, name: str, role: Optional[str] = None):
        """Create one replica of the deployment's CURRENT spec, wait
        for health (outside the lock), publish it."""
        import ray_tpu_torch

        with self._lock:
            d = self._deployments[name]
            spec = {k: d[k] for k in ("config", "callable", "init_args",
                                      "init_kwargs")}
            version = d["version"]
            rid = d["next_replica_id"]
            d["next_replica_id"] += 1
        replica = self._construct_replica(name, spec, version, rid,
                                          role=role)
        stale = False
        with self._lock:
            d = self._deployments.get(name)
            if d is None or d["version"] != version:
                # Deleted or redeployed while we were constructing.
                # The kill RPCs run after the lock drops — stopping a
                # replica under the controller lock would wedge every
                # membership poll behind a remote kill.
                stale = True
            else:
                d["replicas"].append(replica)
                if role is not None:
                    d["role_by_id"][self._replica_key(replica)] = role
                self._bump_membership(name)
        if stale:
            self._stop_replicas([replica])
            return None
        return replica

    def _bump_membership(self, name: str):
        d = self._deployments[name]
        d["membership_version"] += 1
        rb = d.get("role_by_id")
        if rb:
            live = {self._replica_key(r) for r in d["replicas"]}
            d["role_by_id"] = {k: v for k, v in rb.items()
                               if k in live}

    # --------------------------------------------------------- membership
    def get_replicas(self, name: str) -> List[Any]:
        with self._lock:
            d = self._deployments.get(name)
            if d is None:
                raise KeyError(f"no deployment named {name!r} "
                               f"(have {list(self._deployments)})")
            return list(d["replicas"])

    def get_membership(self, name: str,
                       known_version: int = -1) -> Optional[Dict]:
        """None if unchanged since ``known_version``; else the current
        replica set (the handles' poll-based stand-in for the
        reference's LongPoll channel)."""
        with self._lock:
            d = self._deployments.get(name)
            if d is None:
                raise KeyError(f"no deployment named {name!r}")
            if d["membership_version"] == known_version:
                return None
            role_by_id = d.get("role_by_id") or {}
            replicas = list(d["replicas"])
            out = {"version": d["membership_version"],
                   "replicas": replicas}
            if role_by_id:
                out["roles"] = [
                    role_by_id.get(self._replica_key(r), "both")
                    for r in replicas]
                # Default ingress: prefill replicas front the request
                # path (they own TTFT); override via config.
                out["ingress_role"] = d["config"].get(
                    "ingress_role") or (
                    "prefill" if any(v == "prefill"
                                     for v in role_by_id.values())
                    else None)
            return out

    def list_deployments(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                name: {"version": d["version"],
                       "num_replicas": len(d["replicas"]),
                       "config": d["config"]}
                for name, d in self._deployments.items()
            }

    # -------------------------------------------------------- reconfigure
    def reconfigure(self, name: str, user_config: Any):
        """Push a lightweight config update to live replicas without
        restarting them (reference: deployment_state version diffing)."""
        import ray_tpu_torch

        for r in self.get_replicas(name):
            ray_tpu_torch.get(r.reconfigure.remote(user_config))
        with self._lock:
            self._deployments[name]["config"]["user_config"] = user_config

    # -------------------------------------------------------- autoscaling
    def _autoscale_loop(self):
        """Queue-depth-driven replica count (reference:
        autoscaling_policy.py): desired = ceil(total_ongoing / target),
        clamped to [min, max].  Upscale immediately; downscale only
        after the load has stayed low for ``downscale_delay_s``."""
        import math

        while not self._stop.wait(0.1):
            with self._lock:
                names = [n for n, d in self._deployments.items()
                         if d["config"].get("autoscaling_config")]
            for name in names:
                try:
                    self._autoscale_one(name, math)
                except Exception:
                    pass

    def _autoscale_one(self, name: str, math):
        import ray_tpu_torch

        with self._lock:
            d = self._deployments.get(name)
            if d is None:
                return
            auto = d["config"].get("autoscaling_config") or {}
            interval = float(auto.get("interval_s", 1.0))
            last = d.get("last_autoscale_check", 0.0)
            if time.monotonic() - last < interval:
                return
            d["last_autoscale_check"] = time.monotonic()
            replicas = list(d["replicas"])
        if not replicas:
            return
        total = 0
        for r in replicas:
            try:
                total += ray_tpu_torch.get(r.num_ongoing_requests.remote(),
                                     timeout=5.0)
            except Exception:
                pass
        target = max(1.0, float(auto.get("target_ongoing_requests", 2)))
        lo = int(auto.get("min_replicas", 1))
        hi = int(auto.get("max_replicas", len(replicas)))
        desired = max(lo, min(hi, math.ceil(total / target)))
        no_downscale = False
        scale_up = 0
        with self._lock:
            d = self._deployments.get(name)
            if d is None or d["replicas"] != replicas:
                return  # membership changed under us; resample next tick
            cur = len(replicas)
            if desired >= cur:
                d["last_downscale_ok"] = time.monotonic()
                scale_up = desired - cur
                no_downscale = True
        if no_downscale:
            for _ in range(scale_up):
                self._start_replica(name)  # constructs outside the lock
            return
        with self._lock:
            d = self._deployments.get(name)
            if d is None or d["replicas"] != replicas:
                return
            delay = float(auto.get("downscale_delay_s", 30.0))
            if time.monotonic() - d["last_downscale_ok"] < delay:
                return
            victims = d["replicas"][desired:]
            d["replicas"] = d["replicas"][:desired]
            self._bump_membership(name)
        for v in victims:
            self._drain_and_stop(v)

    # ------------------------------------------------------------ teardown
    def _drain_and_stop(self, replica, timeout: float = 30.0):
        """Wait for in-flight requests to finish (handles stop routing
        here once they observe the membership bump), then stop."""
        import ray_tpu_torch

        # Handles poll membership at ~1 Hz: linger past one period so
        # in-flight routing decisions against the old set land first.
        time.sleep(1.2)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if ray_tpu_torch.get(replica.num_ongoing_requests.remote(),
                               timeout=5.0) == 0:
                    break
            except Exception:
                break
            time.sleep(0.1)
        self._stop_replicas([replica])

    @staticmethod
    def _stop_replicas(replicas):
        import ray_tpu_torch

        for r in replicas:
            # Give user code a shutdown hook first: an actor kill stops
            # the actor's threads but not background threads the user
            # callable started (e.g. LLMServer's scheduler).
            try:
                ray_tpu_torch.get(r.shutdown_user.remote(), timeout=60)
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass

    def delete(self, name: str):
        with self._lock:
            d = self._deployments.pop(name, None)
        if d:
            self._stop_replicas(d["replicas"])
            self._checkpoint()
        return d is not None

    def shutdown(self):
        self._stop.set()
        self._autoscaler.join(timeout=2.0)
        for name in list(self._deployments):
            self.delete(name)
        return True

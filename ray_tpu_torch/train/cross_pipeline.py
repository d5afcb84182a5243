"""Cross-process pipeline parallelism: GPipe over stage actors
(counterpart of ``ray_tpu/train/cross_pipeline.py``).

The schedule of ``parallel/pipeline.py`` covers pipe stages WITHIN one
process group; this module pipelines ACROSS processes: each stage is an
actor owning its layer block (and, with ``mesh_spec``, the mesh of its
own process group), activations ride the object plane between stages
(the compiled-DAG channel role), and the head places one stage per
slice (SLICE_SPREAD, cluster/head.py), so only stage boundaries cross
hosts.

Schedule: per step, M microbatches flow all-forward then all-backward
(GPipe).  Every call is an async actor call chained by object refs, so
stage i runs microbatch m while stage i+1 runs m-1: the pipeline
overlap comes from per-actor FIFO execution + dataflow, with no central
tick loop.  Backward is stage-granular recomputation: a stage keeps
only its INPUT per in-flight microbatch and re-runs its forward under
``torch.autograd`` when the output cotangent arrives
(``models/llama_pipeline.stage_backward``).

Stage boundaries where BOTH adjacent stages live on this host ride the
native channel data plane (experimental.channel shm rings, one forward
+ one backward ring per boundary, M+1 slots deep so a full GPipe wave
never blocks a producer).  A CUDA activation or cotangent crosses a
ring as a compiled-DAG edge does: one copy to the host at the writer,
one to the reader's device.  Cross-host boundaries (stages placed on
other slices) ride the object plane; the decision is per edge.

Optimizer parity with the one-piece step (llama.default_optimizer:
global-norm clip 1.0 + AdamW) is kept exactly: stages accumulate
microbatch grads, the driver sums the per-stage squared norms into the
TRUE global norm, and each stage clips by that norm
(``train/optim.ClipAdamW`` with the norm passed in).

Stages run on the card unless ``device="cpu"``; with no card they
raise ``DeviceUnavailableError`` (``core/device.py``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.exceptions import (ActorError, ChannelError,
                                      ObjectLostError, TaskError)
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.parallel.mesh import MeshSpec

# The errors a wave fails with when a stage, a ring or an object is lost
# (the retryable faults of train_step).
_WAVE_ERRORS = (ActorError, ChannelError, ObjectLostError, TaskError)

_log = logging.getLogger("ray_tpu.train")

PyTree = Any


@ray_tpu_torch.remote
class _StageWorker:
    """One pipeline stage: owns its parameter slice, optimizer state,
    mesh, and the stage's forward / loss programs."""

    def __init__(self, stage: int, n_stages: int, config: LlamaConfig,
                 mesh_spec: Optional[MeshSpec], seed: int,
                 learning_rate: float, weight_decay: float,
                 clip_norm: float, device: Optional[str] = None):
        import torch

        from ray_tpu_torch.core.device import resolve_device
        from ray_tpu_torch.models import llama, llama_pipeline
        from ray_tpu_torch.parallel.sharding import use_mesh

        from .optim import ClipAdamW, tree_map
        from .worker_group import _mesh_for

        self._torch = torch
        self.device = resolve_device(device)
        self.stage, self.n = stage, n_stages
        self.cfg = config
        self.first = stage == 0
        self.last = stage == n_stages - 1
        self._mesh = (_mesh_for(mesh_spec, self.device.type)
                      if mesh_spec is not None else None)
        self._use_mesh = use_mesh

        # Identical init numerics to the one-piece model: build the full
        # tree from the same seed, keep (a copy of) this stage's slice.
        full = llama.init_params(config, seed, device=self.device)
        self.params = tree_map(
            torch.clone, llama_pipeline.stage_slice(full, stage, n_stages))
        del full
        self._opt = ClipAdamW(learning_rate, weight_decay=weight_decay,
                              clip_norm=clip_norm)
        self.opt_state = self._opt.init(self.params)

        self._fwd = llama_pipeline.make_stage_fwd(config, self.first)
        if self.last:
            self._fwd_loss = llama_pipeline.make_stage_fwd_loss(config)
        self._backward = llama_pipeline.stage_backward

        self._inputs: Dict[int, Any] = {}   # mb_idx -> stage input
        self._grad_acc: Optional[List[Any]] = None
        self._losses: List[Any] = []  # device scalars until apply_update
        self._n_mb = 0

    # ------------------------------------------------------------ helpers
    def device_info(self) -> Dict[str, Any]:
        """This stage's device identity for the driver's MFU roofline:
        device kind + process-qualified device ids (the driver dedups
        across stages: colocated in-process stages share one card and
        must not double-count it)."""
        import os

        torch, dev = self._torch, self.device
        kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        return {"kind": kind, "devices": [f"{os.getpid()}:{dev}"]}

    def _run(self, fn, *args):
        if self._mesh is not None:
            with self._use_mesh(self._mesh):
                return fn(*args)
        return fn(*args)

    def _on_device(self, x):
        from ray_tpu_torch.core.device import to_device

        torch = self._torch
        if isinstance(x, torch.Tensor) and x.device == self.device:
            return x
        return to_device(x, self.device)

    def _acc(self, gp: PyTree):
        from .optim import tree_leaves

        torch = self._torch
        leaves = [g.float() for g in tree_leaves(gp)]
        if self._grad_acc is None:
            self._grad_acc = leaves
        else:
            torch._foreach_add_(self._grad_acc, leaves)
        self._n_mb += 1

    # ------------------------------------------------------------ schedule
    def forward(self, mb_idx: int, inp):
        """Stage 0..K-2 forward; keeps the input for the recompute
        backward."""
        inp = self._on_device(inp)
        self._inputs[mb_idx] = inp
        with self._torch.no_grad():
            return self._run(self._fwd, self.params, inp)

    def fwd_bwd_last(self, mb_idx: int, h_in, tokens):
        """Last stage: loss forward + backward in one call (its output
        cotangent is available immediately)."""
        torch = self._torch
        one = torch.ones((), dtype=torch.float32, device=self.device)
        loss, gp, gh = self._run(
            lambda: self._backward(self._fwd_loss, self.params,
                                   self._on_device(h_in), one,
                                   self._on_device(tokens),
                                   with_value=True))
        self._acc(gp)
        # Keep the loss on the device: one blocking read per optimizer
        # step in apply_update instead of one per microbatch.
        self._losses.append(loss)
        return gh

    def backward(self, mb_idx: int, g_out):
        """Middle stage: recompute the forward under autograd, return
        the input cotangent for the upstream stage.  The saved input is
        dropped here (where the reference donates it)."""
        h_in = self._inputs.pop(mb_idx)
        gp, gh = self._run(self._backward, self._fwd, self.params, h_in,
                           self._on_device(g_out))
        self._acc(gp)
        return gh

    def backward_first(self, mb_idx: int, g_out) -> bool:
        tokens = self._inputs.pop(mb_idx)
        gp, _ = self._run(self._backward, self._fwd, self.params, tokens,
                          self._on_device(g_out))
        self._acc(gp)
        return True

    # ------------------------------------------------------------ update
    def grad_sqnorm(self) -> float:
        """Σ g² of the microbatch-averaged grads (the driver sums the
        stages into the true global norm)."""
        torch = self._torch
        m = float(max(self._n_mb, 1))
        norms = torch._foreach_norm(self._grad_acc)
        return float(torch.stack(norms).square().sum()) / (m * m)

    def reset_accum(self) -> bool:
        """Recovery: drop partial microbatch state from an aborted
        step so the retried step starts clean."""
        self._grad_acc = None
        self._losses = []
        self._n_mb = 0
        self._inputs.clear()
        return True

    def apply_update(self, global_sqnorm: float) -> Dict[str, float]:
        from .optim import apply_updates, tree_unflatten

        torch = self._torch
        m = float(max(self._n_mb, 1))
        gnorm = float(np.sqrt(global_sqnorm))
        norm = torch.tensor(gnorm, dtype=torch.float32, device=self.device)
        grads = tree_unflatten(self.params,
                               torch._foreach_div(self._grad_acc, m))
        # Every stage clips by the same global norm.  The moments and
        # the params are updated in place: only this stage reads them,
        # and every backward of the step has run.
        updates, self.opt_state = self._opt.update(
            grads, self.opt_state, self.params, inplace=True,
            norm_fn=lambda _leaves: norm)
        self.params = apply_updates(self.params, updates, inplace=True)
        out = {"grad_norm": gnorm}
        if self._losses:
            out["loss"] = float(torch.stack(self._losses).mean())
        self._grad_acc = None
        self._losses = []
        self._n_mb = 0
        self._inputs.clear()
        return out


def _first_failure(refs) -> Optional[BaseException]:
    """The error of the first of ``refs``, in order, that finished with a
    typed error, or None.  Each ref is waited for until it finishes: a
    killed stage's queued calls fail at once, but the call it died in,
    whose error names the edge, stores that error only later.  One
    channel read timeout bounds the waits together; a ref still running
    after it is passed over."""
    from ray_tpu_torch.experimental.channel import DEFAULT_TIMEOUT_S

    deadline = time.monotonic() + DEFAULT_TIMEOUT_S
    for ref in refs:
        left = max(0.0, deadline - time.monotonic())
        ready, _ = ray_tpu_torch.wait([ref], timeout=left)
        if not ready:
            continue
        try:
            ray_tpu_torch.get(ref)
        except _WAVE_ERRORS as e:
            return e
    return None


def _device_error(exc: BaseException):
    """A ``DeviceUnavailableError`` for a stage whose constructor raised
    one (an actor's creation error reaches the caller as its repr inside
    ``ActorDiedError``), or None."""
    from ray_tpu_torch.core.device import DeviceUnavailableError

    if DeviceUnavailableError.__name__ not in str(exc):
        return None
    return DeviceUnavailableError(f"a pipeline stage found no card: {exc}")


class CrossSlicePipeline:
    """Driver handle: K stage actors, one per slice.

    ``resources_per_stage`` places stages through a placement group
    with the given strategy (default SLICE_SPREAD: one stage per slice;
    unlabeled nodes degrade to one stage per node); its ``"GPU"`` entry
    becomes each stage's ``num_gpus``.  Without resources the actors
    schedule wherever capacity exists (single-process runs).  The
    stages run on the card unless ``device="cpu"``.
    """

    def __init__(self, config: LlamaConfig, n_stages: int,
                 num_microbatches: int, *,
                 mesh_spec: Optional[MeshSpec] = None,
                 resources_per_stage: Optional[Dict[str, float]] = None,
                 placement_strategy: str = "SLICE_SPREAD",
                 seed: int = 0, learning_rate: float = 3e-4,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 device: Optional[str] = None):
        from ray_tpu_torch.models.llama_pipeline import check_pipeline_config

        check_pipeline_config(config, n_stages)
        self.n_stages = n_stages
        self.num_microbatches = num_microbatches
        self.config = config
        self._n_params: Optional[int] = None  # lazy (model-plane MFU)
        self._gang_devices = None             # lazy (kind, card count)
        self._pg = None
        self._fwd_ch: List[Optional[str]] = []
        self._bwd_ch: List[Optional[str]] = []
        self._ch_nodes: Dict[str, set] = {}
        opts_per_stage: List[Dict[str, Any]] = [{} for _ in range(n_stages)]
        if resources_per_stage:
            from ray_tpu_torch.core.task_spec import (
                PlacementGroupSchedulingStrategy)
            from ray_tpu_torch.util.placement_group import placement_group

            self._pg = placement_group(
                [dict(resources_per_stage) for _ in range(n_stages)],
                strategy=placement_strategy)
            self._pg.wait(timeout_seconds=60)
            for i in range(n_stages):
                res = dict(resources_per_stage)
                opts_per_stage[i] = {
                    "scheduling_strategy": PlacementGroupSchedulingStrategy(
                        placement_group=self._pg,
                        placement_group_bundle_index=i),
                    "num_cpus": res.pop("CPU", None),
                    "num_gpus": res.pop("GPU", None),
                    "resources": res or None,
                }
        self.stages = [
            _StageWorker.options(**opts_per_stage[i]).remote(
                i, n_stages, config, mesh_spec, seed, learning_rate,
                weight_decay, clip_norm, device)
            for i in range(n_stages)]
        # A stage whose constructor failed (no card, a mesh larger than
        # its group) fails here, with its own error, not at the first
        # step.
        try:
            self._gang_roofline(raise_errors=True)
        except Exception as e:
            self.shutdown()
            dev_err = _device_error(e)
            if dev_err is not None:
                raise dev_err from e
            raise
        self._plan_channels()

    def _plan_channels(self):
        """One fwd + one bwd shm ring per adjacent SAME-HOST stage
        pair; cross-host pairs stay on the object plane (per-edge
        decision, so a pipeline straddling slices still benefits on
        its local boundaries)."""
        from ray_tpu_torch.experimental import channel as chx

        n = self.n_stages
        self._fwd_ch = [None] * max(0, n - 1)
        self._bwd_ch = [None] * max(0, n - 1)
        self._ch_nodes = {}
        # M microbatches can sit in a ring while a downstream stage
        # works; M+1 slots keep the all-forward wave non-blocking.
        self._ch_slots = self.num_microbatches + 1
        if not chx.channels_available():
            return
        locs = [chx.channel_location(s) for s in self.stages]
        for i in range(n - 1):
            if locs[i] is not None and locs[i + 1] is not None \
                    and locs[i][0] == locs[i + 1][0]:
                self._fwd_ch[i] = chx.channel_path(f"pp-fwd{i}")
                self._bwd_ch[i] = chx.channel_path(f"pp-bwd{i}")
                # Endpoint-hosting nodes (None = this process) so
                # shutdown can reach rings living in worker processes.
                nodes = {locs[i][1], locs[i + 1][1]}
                self._ch_nodes[self._fwd_ch[i]] = nodes
                self._ch_nodes[self._bwd_ch[i]] = nodes

    def _call(self, stage_idx: int, method: str, args, *,
              write: Optional[str] = None):
        """Submit a stage method; ``write`` tees its result into that
        ring (so the ref carries only a token), ``ChannelArg`` markers
        in ``args`` read from rings.  Falls through to a plain actor
        call on pure object-plane edges."""
        from ray_tpu_torch.experimental import channel as chx

        uses_chan = write is not None or any(
            isinstance(a, chx.ChannelArg) for a in args)
        if not uses_chan:
            return getattr(self.stages[stage_idx], method).remote(*args)
        writes = ()
        if write is not None:
            writes = (chx.writer_spec(write, self._ch_slots),)
        return chx.submit_channel_call(
            self.stages[stage_idx], method, args, writes=writes,
            returns_value=write is None)

    def _edge_in(self, boundary: int, ref, forward: bool = True):
        """The consumer-side argument for a stage boundary: a channel
        marker when the boundary has a ring, else the producer ref.
        The marker carries the producing stage's actor id so the
        reader's liveness probing can name (and detect) a dead
        producer."""
        from ray_tpu_torch.experimental import channel as chx

        path = (self._fwd_ch if forward else self._bwd_ch)[boundary]
        if path is None:
            return ref
        producer = self.stages[boundary if forward else boundary + 1]
        return chx.ChannelArg(
            path, producer=getattr(producer, "_actor_id", None))

    def train_step(self, tokens: np.ndarray) -> Dict[str, float]:
        """One GPipe step over ``tokens`` (B, S) integers.  B must
        divide by num_microbatches.

        Fault tolerance: the microbatch WAVE (forward/backward
        accumulation) is retried ONCE if it dies to a data-plane or
        actor fault (severed ring, stage killed mid-pass): wait out any
        head-driven stage restart, drop the aborted wave's partial
        microbatch state on every surviving stage, tear down the stale
        rings and re-plan them against the stages' current endpoints.
        The wave is side-effect-free until ``apply_update``, so the
        retry is exact; the UPDATE phase is deliberately NOT retried
        (some stages may already have applied: re-running it would
        double-apply the optimizer step), its failures propagate typed.
        A restarted stage re-runs its constructor (same seed, same
        init); a stage dead for good (no restart budget) re-raises the
        typed error."""
        import time as _time

        from ray_tpu_torch.observability import device as _device_mod
        from ray_tpu_torch.observability import tracing

        # One trace per train step: every microbatch task on every
        # stage (and the retried wave, if any) shares the trace id.
        t0 = _time.perf_counter()
        with tracing.span("train.step",
                          args={"stages": self.n_stages}) as span:
            # The annotation carries the step's trace id into any
            # device trace captured while the wave runs.
            with _device_mod.annotation("train.step"):
                try:
                    self._run_wave(tokens)
                except _WAVE_ERRORS as e:
                    cause = e.cause if isinstance(e, TaskError) else e
                    if not isinstance(cause,
                                      (ActorError, ChannelError,
                                       ObjectLostError)):
                        raise
                    if not self._recover_stages():
                        raise
                    # A correlated log line: `logs --trace <step trace>`
                    # shows WHY this step was slow next to its spans.
                    _log.warning(
                        "train.step wave retried after %s trace=%s",
                        type(cause).__name__, span.trace_id)
                    self._run_wave(tokens)
                out = self._apply_updates()
            # Step time ends HERE: the roofline gather below is a
            # one-off gang RPC that must not pollute the first step's
            # tokens/s gauge.
            step_s = _time.perf_counter() - t0
            # Model-plane series: per-step tokens/s (+ MFU where the
            # card's peak is known).  The roofline is the GANG's: kind
            # and distinct card count come from the stage workers, not
            # the driver.
            kind, n_dev = self._gang_roofline()
            _device_mod.record_train_step(
                int(tokens.shape[0]) * (int(tokens.shape[1]) - 1),
                step_s, n_params=self._total_params(),
                device_kind=kind or None, n_devices=n_dev)
            return out

    def _total_params(self) -> Optional[int]:
        """Whole-model parameter count for the MFU gauge, computed once
        from the shapes alone (meta tensors: no weights materialize on
        the driver)."""
        if self._n_params is None:
            from ray_tpu_torch.models import llama

            self._n_params = llama.param_count(
                llama.param_shapes(self.config))
        return self._n_params or None

    def _gang_roofline(self, raise_errors: bool = False):
        """(device_kind, distinct device count) across the stage gang,
        gathered once: each stage reports process-qualified device ids,
        deduped here so colocated in-process stages (which share one
        card) don't double-count it."""
        if self._gang_devices is None:
            try:
                infos = ray_tpu_torch.get(
                    [s.device_info.remote() for s in self.stages],
                    timeout=120.0 if raise_errors else 30.0)
                devs: set = set()
                kind = ""
                for info in infos:
                    devs.update(info["devices"])
                    kind = kind or info["kind"]
                self._gang_devices = (kind, max(1, len(devs)))
            except Exception:
                if raise_errors:
                    raise
                # Transient (a stage mid-restart): DON'T cache the
                # failure; the next step retries.
                return "", 1
        return self._gang_devices

    def _recover_stages(self, timeout_s: float = 60.0) -> bool:
        """Wait for every stage to be ALIVE again (restarts included),
        reset their partial step state, and rebuild the boundary rings.
        False when some stage is dead for good."""
        import time as _time

        from ray_tpu_torch.experimental.channel import (_producer_state,
                                                        destroy_channel_at)

        deadline = _time.monotonic() + timeout_s
        for stage in self.stages:
            aid = getattr(stage, "_actor_id", None)
            while True:
                state = _producer_state(aid)
                if state in (None, "ALIVE"):
                    break
                if state == "DEAD" or _time.monotonic() > deadline:
                    return False
                _time.sleep(0.2)
        # Destroy the stale rings BEFORE touching the stages: aborted
        # channel-step tasks may still sit in the stage FIFOs blocked
        # on these rings, and reset_accum queues behind them; the
        # destroy fails those reads immediately (ChannelClosed).
        for path in (self._fwd_ch + self._bwd_ch):
            if path is not None:
                destroy_channel_at(path, self._ch_nodes.get(path, ()))
        try:
            ray_tpu_torch.get(
                [s.reset_accum.remote() for s in self.stages],
                timeout=timeout_s)
        except Exception:
            return False
        self._plan_channels()
        from ray_tpu_torch.observability import metrics as _metrics

        _metrics.Counter(
            "ray_tpu_pipeline_recoveries_total",
            "cross-pipeline wave recoveries (stage restart + ring "
            "rebuild + retry)").inc()
        return True

    def _run_wave(self, tokens: np.ndarray) -> None:
        """The GPipe microbatch wave: all-forward then all-backward,
        grads ACCUMULATED on the stages (no parameter mutation: this
        whole phase is retryable after reset_accum)."""
        M = self.num_microbatches
        B = tokens.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        mbs = np.split(np.asarray(tokens), M, axis=0)

        # All-forward: chained edges (shm ring where the boundary is
        # same-host, object refs otherwise); actor FIFO pipelines the
        # stages either way.
        K = self.n_stages
        h = [self._call(0, "forward", (i, mb), write=self._fwd_ch[0])
             for i, mb in enumerate(mbs)]
        wave = list(h)
        for j in range(1, K - 1):
            h = [self._call(j, "forward",
                            (i, self._edge_in(j - 1, r)),
                            write=self._fwd_ch[j])
                 for i, r in enumerate(h)]
            wave += h
        # The last stage folds backward into forward; then all-backward
        # in reverse microbatch order (frees newest inputs first).
        g = [self._call(K - 1, "fwd_bwd_last",
                        (i, self._edge_in(K - 2, r), mbs[i]),
                        write=self._bwd_ch[K - 2])
             for i, r in enumerate(h)]
        wave += g
        for j in range(K - 2, 0, -1):
            g = [self._call(j, "backward",
                            (i, self._edge_in(j, r, forward=False)),
                            write=self._bwd_ch[j - 1])
                 for i, r in enumerate(g)]
            wave += g
        done = [self._call(0, "backward_first",
                           (i, self._edge_in(0, r, forward=False)))
                for i, r in enumerate(g)]
        try:
            ray_tpu_torch.get(done)
        except _WAVE_ERRORS as e:
            # A stage's last calls fail only as "actor is dead"; the
            # first call that failed, in wave order, names the edge
            # where the wave broke (its ring, stage and method).
            raise _first_failure(wave + done) or e

    def _apply_updates(self) -> Dict[str, float]:
        """Two-phase clipped update over the accumulated grads.
        Mutates stage parameters: never retried (see train_step)."""
        sq = sum(ray_tpu_torch.get(
            [s.grad_sqnorm.remote() for s in self.stages]))
        metrics = ray_tpu_torch.get(
            [s.apply_update.remote(sq) for s in self.stages])
        out = dict(metrics[-1])  # the last stage carries the loss
        out["grad_norm"] = metrics[0]["grad_norm"]
        return out

    def shutdown(self):
        for s in self.stages:
            try:
                ray_tpu_torch.kill(s)
            except Exception:
                pass
        from ray_tpu_torch.experimental.channel import destroy_channel_at

        for path in (self._fwd_ch + self._bwd_ch):
            if path is not None:
                destroy_channel_at(path, self._ch_nodes.get(path, ()))
        self._fwd_ch = [None] * len(self._fwd_ch)
        self._bwd_ch = [None] * len(self._bwd_ch)
        self._ch_nodes = {}
        if self._pg is not None:
            from ray_tpu_torch.util.placement_group import (
                remove_placement_group)

            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
        self.stages = []

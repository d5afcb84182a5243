"""Driver entry points of the port (counterpart of the repository's
``__graft_entry__.py``).

- :func:`entry` returns the llama_125m forward and its arguments, on
  the card.
- :func:`dryrun_multichip` takes TWO full sharded train steps over an
  n-rank mesh covering every parallelism axis: a dense Llama step on
  {tensor, fsdp, pipe, data} and a MoE + ring-attention step on
  {expert, seq, fsdp, data}.  One process a rank: n cards joined over
  NCCL (a machine with fewer cards raises), or, with ``device="cpu"``,
  n CPU processes over gloo (the counterpart of the reference's n
  virtual CPU devices); n = 1 runs in this process.
- :func:`dryrun_cross_pipeline` takes one GPipe train step ACROSS two
  worker node processes (``train/cross_pipeline.py``), each stage on
  its process's one-rank mesh, and holds its loss to the
  single-process step's.

    python -m ray_tpu_torch.tools.dryrun   # entry(): the logits' shape

A rank process of :func:`dryrun_multichip` is
``python -m ray_tpu_torch.tools.dryrun --rank R --world N --device
{cuda,cpu} --store DIR``; it joins the group over a ``FileStore`` in
DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import checkout_env

_MODULE = "ray_tpu_torch.tools.dryrun"
# Set in every rank process: a rank never starts ranks of its own.
_CHILD_ENV = "RAY_TPU_TORCH_DRYRUN_CHILD"


def entry(device=None):
    """Returns ``(fn, example_args)``: the forward of the flagship Llama
    model (llama_125m, S = 512, B = 4) and its params and tokens, on
    the card unless ``device="cpu"``."""
    import torch

    from ray_tpu_torch.core.device import resolve_device
    from ray_tpu_torch.models import llama

    dev = resolve_device(device)
    cfg = llama.LlamaConfig.llama_125m(max_seq_len=512, remat=False)
    params = llama.init_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 512), generator=g,
                           device=dev)

    def fn(params, tokens):
        return llama.forward(params, tokens, cfg, device=dev)

    return fn, (params, tokens)


def _mesh_spec_for(n_devices: int):
    """Dense-stage mesh: spread n devices innermost-first over
    tensor → fsdp → pipe, 2 each while divisible; data absorbs the rest."""
    from ray_tpu_torch.parallel import MeshSpec

    sizes = {"tensor": 1, "fsdp": 1, "pipe": 1, "data": 1}
    rem = n_devices
    for axis in ("tensor", "fsdp", "pipe"):
        if rem % 2 == 0 and rem > 1:
            sizes[axis] = 2
            rem //= 2
    sizes["data"] *= rem  # absorb any leftover (incl. odd counts)
    return MeshSpec(**sizes)


def _moe_mesh_spec_for(n_devices: int):
    """MoE-stage mesh: seq → expert → fsdp get 2 each while divisible;
    data absorbs the rest.  Exercises ring attention (seq axis) and
    expert-parallel MoE dispatch (expert axis) in one real step."""
    from ray_tpu_torch.parallel import MeshSpec

    sizes = {"seq": 1, "expert": 1, "fsdp": 1, "data": 1}
    rem = n_devices
    for axis in ("seq", "expert", "fsdp"):
        if rem % 2 == 0 and rem > 1:
            sizes[axis] = 2
            rem //= 2
    sizes["data"] *= rem
    return MeshSpec(**sizes)


def _run_stages(n_devices: int, device_type: str) -> dict:
    """Both train steps on this rank of an n-rank group (started by the
    caller, or by ``local_mesh`` for one rank); returns each stage's
    mesh and loss."""
    import torch

    from ray_tpu_torch.core.device import resolve_device
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import (build_mesh, local_mesh,
                                        shard_params, use_mesh)

    dev = resolve_device(device_type)

    def run_step(cfg, spec, seed):
        """One full train step for cfg over spec's mesh."""
        mesh = (build_mesh(spec, device_type) if n_devices > 1
                else local_mesh(device_type))
        with use_mesh(mesh):
            state = llama.init_train_state(cfg, seed=seed, device=dev)
            state["params"] = shard_params(state["params"],
                                           llama.param_logical_axes(cfg))
            step = llama.make_train_step(cfg, device=dev)
            batch_size = max(4, spec.data * spec.fsdp)
            g = torch.Generator()
            g.manual_seed(seed + 1)
            tokens = torch.randint(0, cfg.vocab_size,
                                   (batch_size, cfg.max_seq_len),
                                   generator=g)
            _state, metrics = step(state, {"tokens": tokens})
            loss = float(metrics["loss"].cpu())
        if not 0.0 < loss < 20.0:
            raise RuntimeError(f"dryrun loss {loss} outside (0, 20)")
        return loss

    # Stage 1: dense; layers divide by pipe, heads by tensor.
    spec_dense = _mesh_spec_for(n_devices)
    cfg_dense = llama.LlamaConfig.debug(
        n_layers=max(2, spec_dense.pipe * 2), max_seq_len=64,
        # GPipe microbatching over the pipe axis when pipe > 1.
        pipeline_microbatches=2 if spec_dense.pipe > 1 else 0)
    loss_dense = run_step(cfg_dense, spec_dense, seed=0)

    # Stage 2: MoE; ring attention over "seq", the Switch FFN's
    # dispatch over "expert".
    spec_moe = _moe_mesh_spec_for(n_devices)
    cfg_moe = llama.LlamaConfig.moe_debug(
        max_seq_len=64,
        attention_impl="ring" if spec_moe.seq > 1 else "dot")
    loss_moe = run_step(cfg_moe, spec_moe, seed=2)
    return {"dense": {"mesh": spec_dense.axis_sizes(), "loss": loss_dense},
            "moe": {"mesh": spec_moe.axis_sizes(), "loss": loss_moe}}


def _line(n_devices: int, res: dict) -> str:
    return (f"dryrun_multichip({n_devices}): "
            f"dense mesh={res['dense']['mesh']} "
            f"loss={res['dense']['loss']:.3f}; "
            f"moe mesh={res['moe']['mesh']} loss={res['moe']['loss']:.3f} ok")


def _rank_main(rank: int, world: int, device_type: str, store: str):
    """One rank process: join the group, run both stages; rank 0 writes
    the result beside the store and prints the line."""
    import torch
    import torch.distributed as dist

    if device_type == "cuda":
        if torch.cuda.device_count() < world:
            # The parent saw enough cards; a rank that does not must not
            # fall back to anything else.
            raise RuntimeError(
                f"dryrun rank {rank} sees {torch.cuda.device_count()} "
                f"card(s); expected {world}. CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}")
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        store=dist.FileStore(os.path.join(store, "store"), world),
        rank=rank, world_size=world)
    try:
        res = _run_stages(world, device_type)
        if rank == 0:
            Path(store, "result.json").write_text(json.dumps(res))
            print(_line(world, res), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """ONE full training step (forward, backward, optimizer) for each of
    the two stages over an n-rank mesh with the production sharding
    rules; prints the reference's line and returns ``{"dense": {"mesh",
    "loss"}, "moe": {...}, "device": "cuda" or "cpu"}``.

    The ranks run on ``n_devices`` cards over NCCL, and a machine with
    fewer cards raises :class:`DeviceUnavailableError`; with
    ``device="cpu"`` they run as CPU processes over gloo.
    ``n_devices == 1`` runs in this process."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.core.device import DeviceUnavailableError

    if os.environ.get(_CHILD_ENV):
        raise RuntimeError("dryrun_multichip called inside one of its own "
                           "rank processes; a rank starts no ranks")
    device_type = "cuda" if device is None else torch.device(device).type
    if device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise DeviceUnavailableError(
                f"dryrun_multichip({n_devices}) runs one rank a card and "
                f"this machine has {have} card(s); pass device='cpu' to "
                f"run {n_devices} gloo ranks on the CPU")
    elif device_type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    if n_devices == 1:
        created = not dist.is_initialized()
        try:
            res = _run_stages(1, device_type)
        finally:
            if created and dist.is_initialized():
                dist.destroy_process_group()  # the one local_mesh began
        print(_line(1, res), flush=True)
        return dict(res, device=device_type)

    env = checkout_env(**{_CHILD_ENV: "1"})
    if device_type == "cpu":
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as store:
        logs = [Path(store, f"rank{r}.log") for r in range(n_devices)]
        procs = []
        try:
            for r in range(n_devices):
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", _MODULE, "--rank", str(r),
                         "--world", str(n_devices), "--device",
                         device_type, "--store", store],
                        stdout=log, stderr=subprocess.STDOUT, env=env))
            deadline = time.monotonic() + 1800
            failed = None
            for r, p in enumerate(procs):
                try:
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    failed = (r, "no exit within 1800 s")
                    break
                if p.returncode != 0:
                    failed = (r, f"exit {p.returncode}")
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed:
            r, why = failed
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) over {device_type} ranks: "
                f"rank {r} {why}:\n{logs[r].read_text()[-4000:]}")
        sys.stdout.write(logs[0].read_text())
        res = json.loads(Path(store, "result.json").read_text())
        return dict(res, device=device_type)


def dryrun_cross_pipeline(device=None) -> None:
    """One GPipe train step genuinely ACROSS processes: two worker
    NODES each host one pipeline stage (one rank each); activations
    cross between the processes; the loss is held to the single-process
    step's (rtol 1e-4).  On the card unless ``device="cpu"`` (then the
    nodes start with CUDA hidden).  Needs a fresh interpreter: refuses
    to tear down a runtime that is already initialised."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    from ray_tpu_torch.core.device import resolve_device
    from ray_tpu_torch.core.tpu_topology import (SLICE_LABEL,
                                                 WORKER_INDEX_LABEL)
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.train.cross_pipeline import CrossSlicePipeline

    if ray_tpu_torch.is_initialized():
        raise RuntimeError(
            "dryrun_cross_pipeline needs a fresh interpreter (it "
            "builds its own cluster); shut down the active runtime "
            "first")

    dev = resolve_device(device)
    cfg = llama.LlamaConfig.debug(tie_embeddings=False,
                                  dtype=torch.float32)
    g = torch.Generator()
    g.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=g,
                           dtype=torch.int32)

    state = llama.init_train_state(cfg, device=dev)
    step = llama.make_train_step(cfg, device=dev)
    _s, ref = step(state, {"tokens": tokens})
    ref = float(ref["loss"])

    c = Cluster()
    try:
        for i, sl in enumerate(("s0", "s1")):
            c.add_node(num_cpus=2, name=f"stage{i}",
                       resources={"stage_slot": 1},
                       labels={SLICE_LABEL: sl, WORKER_INDEX_LABEL: "0"},
                       hide_cuda=dev.type == "cpu")
        c.connect(num_cpus=0)
        pipe = None
        try:
            pipe = CrossSlicePipeline(
                cfg, n_stages=2, num_microbatches=2, mesh_spec=MeshSpec(),
                resources_per_stage={"CPU": 1, "stage_slot": 1},
                placement_strategy="SLICE_SPREAD", device=dev.type)
            loss = pipe.train_step(tokens.numpy())["loss"]
        finally:
            if pipe is not None:
                pipe.shutdown()
            ray_tpu_torch.shutdown()
    finally:
        c.shutdown()
    if not abs(loss - ref) <= 1e-4 * abs(ref):
        raise RuntimeError(f"dryrun_cross_pipeline: GPipe loss {loss} != "
                           f"single-process {ref} (rtol 1e-4)")
    print(f"dryrun_cross_pipeline: 2 stage processes x 1 rank, "
          f"GPipe loss={loss:.4f} == single-process {ref:.4f} ok")


def main(argv=None):
    ap = argparse.ArgumentParser(prog=f"python -m {_MODULE}",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--device", choices=("cuda", "cpu"))
    ap.add_argument("--store")
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.world, args.device, args.store)
        return
    fn, fargs = entry()
    out = fn(*fargs)
    print("entry forward:", tuple(out.shape), out.dtype)


if __name__ == "__main__":
    main()

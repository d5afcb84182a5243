"""One rank of a multi-process CPU run of the port's parallelism layer,
for tests/test_torch_parallel.py and tests/test_torch_ring_attention.py.

    python tests/_torch_gloo_worker.py CASE RANK WORLD DIR

The rank joins a gloo group over a FileStore in DIR (no port is taken),
reads its inputs from DIR/inputs.npz (written by the test from seeded
numpy and converted JAX weights), runs CASE and writes DIR/out_RANK.npz.
It imports neither jax nor ray_tpu: the test compares the outputs with
the JAX package in its own process.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ray_tpu_torch.models import llama  # noqa: E402
from ray_tpu_torch.parallel import (MeshSpec, build_mesh,  # noqa: E402
                                    shard_params, use_mesh)


def _params(inputs, prefix="p/"):
    """The nested param dict stored under ``prefix`` (keys joined by
    '/')."""
    out = {}
    for key in inputs.files:
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.from_numpy(inputs[key].copy())
    return out


def _flat(tree, prefix):
    """{prefix + 'a/b': numpy} of a nested dict of (D)Tensors, gathered
    whole (a collective for DTensors: every rank calls it)."""
    from torch.distributed.tensor import DTensor

    out = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            if isinstance(value, DTensor):
                value = value.full_tensor()
            out[prefix + key] = value.detach().float().numpy()
    return out


def _config(inputs, **kw):
    c = dict(inputs["config"].item())
    c.update(kw)
    return llama.LlamaConfig.debug(dtype=torch.float32, **c)


def case_gpipe(inputs, out):
    """Loss and grads of loss_fn through the GPipe schedule at pipe=4
    and at pipe=2 x data=2 (plain params, as the reference's test)."""
    params = _params(inputs)
    batch = {"tokens": torch.from_numpy(inputs["tokens"])}
    for name, spec in (("pipe4", MeshSpec(pipe=4)),
                       ("pipe2_data2", MeshSpec(pipe=2, data=2))):
        cfg = _config(inputs, remat=False, pipeline_microbatches=4)
        with use_mesh(build_mesh(spec, "cpu")):
            loss, grads = llama.value_and_grad(params, batch, cfg,
                                               device="cpu")
        out[f"{name}/loss"] = loss.numpy()
        out.update(_flat(grads, f"{name}/g/"))


def case_mesh8(inputs, out):
    """Eight ranks: pipe=4 x data=2 with remat (loss); two train steps
    at pipe=2 x data=2 x fsdp=2 with sharded params; the dense
    dryrun_multichip mesh tensor=2 x fsdp=2 x pipe=2: one train step
    from sharded params (loss, grad norm, the new params)."""
    from ray_tpu_torch.parallel.mesh import mesh_shape

    mesh = MeshSpec(data=2, fsdp=2, tensor=2).build("cpu")
    out["mesh_shape"] = np.array([mesh_shape(mesh)[a] for a in
                                  ("pipe", "data", "fsdp", "expert", "seq",
                                   "tensor")])
    with use_mesh(mesh):
        # A batch dim over (data, fsdp): this rank's shard, held against
        # JAX's shard for the same device position.
        placed = shard_params(
            {"x": torch.arange(8 * 3 * 4, dtype=torch.float32).reshape(
                8, 3, 4)}, {"x": ("batch", None, "heads")})
    out["batch_shard"] = placed["x"].to_local().numpy()
    with use_mesh(MeshSpec(fsdp=4, tensor=2).build("cpu")):
        placed = shard_params({"w": torch.ones(8, 16), "b": torch.ones(16)},
                              {"w": ("embed", "mlp"), "b": (None,)})
    out["shard_w"] = np.array(placed["w"].to_local().shape)
    out["shard_b"] = np.array(placed["b"].to_local().shape)

    params = _params(inputs)
    batch = {"tokens": torch.from_numpy(inputs["tokens"])}
    cfg = _config(inputs, remat=True, pipeline_microbatches=2)
    with use_mesh(build_mesh(MeshSpec(pipe=4, data=2), "cpu")):
        out["pipe4_data2_remat/loss"] = llama.loss_fn(
            params, batch, cfg, device="cpu").detach().numpy()

    for name, spec, n_steps in (
            ("steps_pipe2_data2_fsdp2", MeshSpec(pipe=2, data=2, fsdp=2), 2),
            ("dryrun_tensor2_fsdp2_pipe2",
             MeshSpec(tensor=2, fsdp=2, pipe=2), 1)):
        cfg = _config(inputs, remat=True, pipeline_microbatches=2)
        with use_mesh(build_mesh(spec, "cpu")):
            state = llama.init_train_state(cfg, device="cpu")
            state["params"] = shard_params(
                {k: v.clone() if not isinstance(v, dict) else
                 {kk: vv.clone() for kk, vv in v.items()}
                 for k, v in params.items()},
                llama.param_logical_axes(cfg))
            step = llama.make_train_step(cfg, device="cpu")
            losses, norms = [], []
            for _ in range(n_steps):
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
            out[f"{name}/losses"] = np.array(losses)
            out[f"{name}/norms"] = np.array(norms)
            out.update(_flat(state["params"], f"{name}/p/"))


def case_ring(inputs, out):
    """Ring attention over seq=2 and seq=4 (forward) and the gradients of
    sum(out**2) at seq=4, on meshes that fill the eight ranks."""
    from ray_tpu_torch.ops.ring_attention import ring_attention

    q, k, v = (torch.from_numpy(inputs[n]) for n in ("q", "k", "v"))
    for seq in (2, 4):
        mesh = build_mesh(MeshSpec(seq=seq, data=-1), "cpu")
        with use_mesh(mesh):
            out[f"fwd_seq{seq}"] = ring_attention(q, k, v,
                                                  mesh=mesh).numpy()
    mesh = build_mesh(MeshSpec(seq=4, data=-1), "cpu")
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    with use_mesh(mesh):
        loss = (ring_attention(*ins, mesh=mesh) ** 2).sum()
    grads = torch.autograd.grad(loss, ins)
    for name, g in zip("qkv", grads):
        out[f"grad_{name}"] = g.numpy()


def main():
    case, rank, world, tmp = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), Path(sys.argv[4])
    torch.set_num_threads(1)
    torch.manual_seed(0)
    store = dist.FileStore(str(tmp / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    inputs = np.load(tmp / "inputs.npz", allow_pickle=True)
    out = {}
    globals()[f"case_{case}"](inputs, out)
    np.savez(tmp / f"out_{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    os._exit(0)


def run_ranks(case: str, world: int, tmp: Path, inputs: dict,
              timeout: float = 120.0):
    """Run CASE on ``world`` gloo ranks (one process each) and return
    their outputs, rank by rank.  Every process is joined within
    ``timeout`` seconds; on a failure or a timeout all are killed and the
    failing ranks' stderr is raised."""
    import subprocess
    import time

    tmp = Path(tmp)
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    logs = [tmp / f"err_{r}.txt" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, case, str(r), str(world),
                 str(tmp)], stdout=subprocess.DEVNULL, stderr=err, env=env))
    deadline = time.monotonic() + timeout
    errors = []
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                errors.append(f"rank {r}: no exit within {timeout}s")
                break
            if p.returncode != 0:
                errors.append(f"rank {r} exit {p.returncode}:\n"
                              f"{logs[r].read_text()[-3000:]}")
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [dict(np.load(tmp / f"out_{r}.npz")) for r in range(world)]


if __name__ == "__main__":
    main()

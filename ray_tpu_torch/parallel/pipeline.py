"""Pipeline parallelism: the GPipe microbatch schedule over the ``pipe``
mesh axis (counterpart of ``ray_tpu/parallel/pipeline.py``).

Each pipe rank holds a contiguous block of the stacked layer weights
(the ("layers", "pipe") sharding rule) and runs the same SPMD tick loop
on local tensors, as every device of the reference's ``shard_map`` does:
T = M + P - 1 ticks; at tick t the rank receives its predecessor's
previous output over the pipe ring (``batch_isend_irecv``), stage 0
feeds from the microbatch stream, and the last stage emits microbatch
t - (P - 1).  Autograd through it is the reverse pipeline: the ring's
backward sends each gradient to the previous stage (the transpose of
``ppermute``), so all-forward-then-all-backward per microbatch set,
bubble fraction (P - 1) / (M + P - 1) each way.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import torch

from .mesh import axis_index, mesh_shape
from .spmd import gather_param, ppermute, sum_grads, sum_replicated

PyTree = Any


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Idle fraction of the GPipe schedule (per direction)."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def pipeline_layers(layer_fn: Callable[[torch.Tensor, Dict[str, torch.Tensor]],
                                       torch.Tensor],
                    stacked_params: Dict[str, torch.Tensor],
                    x: torch.Tensor, *, mesh, num_microbatches: int,
                    pipe_axis: str = "pipe",
                    batch_axes: Sequence[str] = ()) -> torch.Tensor:
    """Apply L stacked layers to this rank's ``x`` (B, S, E), layer-split
    into P = the mesh's ``pipe_axis`` size stages with an M-microbatch
    GPipe schedule.  ``layer_fn(h, layer) -> h`` applies ONE layer (any
    remat wrapping included) to a dict of that layer's weights.
    ``stacked_params``: ``{name: (L, ...)}``, DTensors sharded over the
    pipe axis on the layer dim or plain tensors holding every layer.
    ``batch_axes``: the mesh axes ``x``'s batch was split over (data
    parallel composes with pp); the stage weights' gradients are summed
    over them.  Returns the pipeline's output (B, S, E), the same on
    every pipe rank."""
    n_pipe = mesh_shape(mesh).get(pipe_axis, 1)
    M = num_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    L = next(iter(stacked_params.values())).shape[0]
    if L % n_pipe:
        raise ValueError(f"{L} layers not divisible by pipe={n_pipe}")
    idx = axis_index(mesh, pipe_axis)
    last = n_pipe - 1
    names = list(stacked_params)
    local = [gather_param(stacked_params[k], mesh, batch_axes, pipe_axis)
             for k in names]
    layers = [dict(zip(names, ws))
              for ws in zip(*[w.unbind(0) for w in local])]

    def apply_local(h):
        for layer in layers:
            h = layer_fn(h, layer)
        return h

    # x is the same on every pipe rank and only stage 0 reads it: its
    # gradient is summed over the ring.
    x_mb = sum_grads(x.reshape(M, B // M, *x.shape[1:]), mesh, [pipe_axis])
    # Each rank's graph keeps the same shape on every tick (see
    # parallel/spmd.py): the stream and the ring both feed every tick,
    # weighted 1 or 0, and a bubble tick passes zeros on.
    w_stream, w_ring = (1.0, 0.0) if idx == 0 else (0.0, 1.0)
    # Grad-tracked from the start when grad is on, so every tick's
    # ring send has a backward on every rank.
    prev = torch.zeros_like(x_mb[0]).requires_grad_(
        torch.is_grad_enabled())
    outputs = []
    for t in range(M + n_pipe - 1):
        recv = ppermute(prev, mesh, pipe_axis)
        inp = x_mb[min(t, M - 1)] * w_stream + recv * w_ring
        prev = apply_local(inp) if 0 <= t - idx < M else inp * 0.0
        if t >= last:  # the last stage emits microbatch t - (P - 1)
            outputs.append(prev)
    # Only the last stage's outputs are the pipeline's; share them over
    # the ring so the head and loss downstream stay replicated.
    out = torch.stack(outputs) * (1.0 if idx == last else 0.0)
    out = sum_replicated(out, mesh, [pipe_axis])
    return out.reshape(B, *x.shape[1:])

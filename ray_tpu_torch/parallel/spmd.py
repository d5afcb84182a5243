"""Differentiable collectives of the port's manual regions.

The reference writes its model in the global view and lets XLA
partition it; its pipeline and ring schedules are ``shard_map`` regions
where each device holds local arrays.  The port runs every multi-rank
model step as such a region (one process per device): each rank holds
local tensors, the params are gathered from their DTensor shards, and
the layout moves with the collectives below.  Two kinds of value occur:
*replicated* values, the same on every rank of an axis (the gathered
params, the logits that feed the loss), and *local* values, a rank's
slice of one.  Each collective's backward keeps that invariant, so every
rank's autograd graph has the same collectives in the same order and
the gradients are the reference's:

- :func:`local_slice` takes a rank's slice of a replicated value; its
  backward all-gathers the slices' gradients (the replicated input's
  gradient is every slice's);
- :func:`gather_slices` concatenates the slices into a replicated value;
  its backward takes the rank's slice of the (replicated) gradient;
- :func:`sum_replicated` sums over an axis into a value the rest of the
  step uses replicated (the reference's ``psum``): its backward passes
  the replicated gradient through;
- :func:`sum_grads` is the identity, with the gradient summed over an
  axis in the backward: a replicated value of which each rank used a
  part;
- :func:`ppermute` sends to the next rank of an axis's ring and
  receives from the previous one; its backward is the reverse
  permutation (JAX's transpose rule).

Every rank must run the same collectives in the same order, so code in
a region keeps each rank's graph the same shape: a value a rank does not
need is multiplied by zero, not dropped.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.distributed as dist

from .mesh import axis_index, mesh_shape


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def _active(mesh, axes: Sequence[str]) -> List[str]:
    sizes = mesh_shape(mesh)
    return [a for a in axes if sizes.get(a, 1) > 1]


def _all_gather_cat(x: torch.Tensor, mesh, axis: str, dim: int):
    parts = [torch.empty_like(x) for _ in range(mesh_shape(mesh)[axis])]
    dist.all_gather(parts, x.contiguous(), group=_group(mesh, axis))
    return torch.cat(parts, dim=dim)


def _slice(x: torch.Tensor, mesh, axes: Sequence[str], dim: int):
    """The rank's slice along ``dim`` over ``axes`` (first axis major)."""
    for a in axes:
        n = mesh_shape(mesh)[a]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split over {a}={n}")
        x = x.chunk(n, dim=dim)[axis_index(mesh, a)]
    return x


def _gather(x: torch.Tensor, mesh, axes: Sequence[str], dim: int):
    """Inverse of :func:`_slice`: gather the minor axis first."""
    for a in reversed(axes):
        x = _all_gather_cat(x, mesh, a, dim)
    return x


class _LocalSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _slice(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _GatherSlices(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_slice(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), None,
                None, None)


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        out = x.clone()
        for a in axes:
            dist.all_reduce(out, group=_group(mesh, a))
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        for a in ctx.axes:
            dist.all_reduce(g, group=_group(ctx.mesh, a))
        return g, None, None


def _shift(x: torch.Tensor, mesh, axis: str, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` ahead on ``axis``'s ring and return
    what the rank ``step`` behind sent."""
    n = mesh_shape(mesh)[axis]
    group = _group(mesh, axis)
    i = axis_index(mesh, axis)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group,
                                                          (i + step) % n),
                      group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group,
                                                            (i - step) % n),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _shift(x, mesh, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.axis, -1), None, None


def local_slice(x: torch.Tensor, mesh, axes: Sequence[str], dim: int):
    """This rank's slice of replicated ``x`` along ``dim``, split over
    ``axes`` (the first axis major, as a tuple of mesh axes splits in
    JAX).  Axes of size 1 are skipped."""
    axes = _active(mesh, axes)
    if not axes:
        return x
    if not x.requires_grad:
        return _slice(x, mesh, axes, dim)
    return _LocalSlice.apply(x, mesh, tuple(axes), dim)


def gather_slices(x: torch.Tensor, mesh, axes: Sequence[str], dim: int):
    """The replicated concatenation of every rank's ``x`` along ``dim``
    over ``axes`` (inverse of :func:`local_slice`)."""
    axes = _active(mesh, axes)
    if not axes:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        return _gather(x, mesh, axes, dim)
    return _GatherSlices.apply(x, mesh, tuple(axes), dim)


def sum_replicated(x: torch.Tensor, mesh, axes: Sequence[str]):
    """Sum of ``x`` over ``axes``, used replicated downstream (``psum``)."""
    axes = _active(mesh, axes)
    if not axes:
        return x
    return _SumReplicated.apply(x, mesh, tuple(axes))


def sum_grads(x: torch.Tensor, mesh, axes: Sequence[str]):
    """``x`` unchanged; its gradient summed over ``axes`` (a replicated
    value of which each rank used a part)."""
    axes = _active(mesh, axes)
    if not axes or not x.requires_grad:
        return x
    return _SumGrads.apply(x, mesh, tuple(axes))


def ppermute(x: torch.Tensor, mesh, axis: str):
    """``lax.ppermute`` with the ring ``i -> i + 1`` over ``axis``."""
    if mesh_shape(mesh).get(axis, 1) == 1:
        return x
    if not x.requires_grad:
        return _shift(x, mesh, axis, 1)
    return _Ppermute.apply(x, mesh, axis)


def gather_param(p: torch.Tensor, mesh, reduce_axes: Sequence[str],
                 stage_axis: str = None) -> torch.Tensor:
    """A parameter as the local tensor a manual region computes with:
    whole, or, with ``stage_axis``, this rank's block of its leading
    (stacked-layer) dim over that axis.  Its gradient is summed over
    ``reduce_axes`` (the axes the batch is split over) and, with
    ``stage_axis``, lands in the stage's block.

    A DTensor is gathered from its shards (DTensor's redistribute; the
    backward reduces and re-shards to the param's own placements).  A
    plain tensor is a replicated param: it is used as it is and its
    gradient is summed over the same axes (and over the stage axis,
    whose other ranks fill the other blocks)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    sizes = mesh_shape(mesh)
    reduce_axes = _active(mesh, reduce_axes)
    stage = stage_axis if stage_axis and sizes.get(stage_axis, 1) > 1 \
        else None
    if isinstance(p, DTensor):
        names = list(sizes)
        target = [Replicate() for _ in names]
        grads = [Replicate() for _ in names]
        if stage:
            target[names.index(stage)] = Shard(0)
            grads[names.index(stage)] = Shard(0)
        for a in reduce_axes:
            grads[names.index(a)] = Partial()
        return p.redistribute(mesh, target).to_local(grad_placements=grads)
    p = sum_grads(p, mesh, reduce_axes + ([stage] if stage else []))
    if stage:
        p = _slice(p, mesh, [stage], 0)
    return p


def _replicas(t) -> int:
    """How many ranks hold each element of ``t``: for a DTensor the
    product of its non-sharded mesh dims; a plain tensor is held whole
    by every rank."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(t, DTensor):
        mesh = t.device_mesh
        return math.prod(mesh.size(i) for i, pl in enumerate(t.placements)
                         if not isinstance(pl, Shard))
    return dist.get_world_size()


def sharded_global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of ``leaves``
    (DTensors and replicated plain tensors), each element counted once:
    every rank sums its local squares over the element's replica count,
    then one all-reduce over the world."""
    total = torch.zeros((), dtype=torch.float32,
                        device=local_view(leaves[0]).device)
    for t in leaves:
        local = local_view(t).float()
        total = total + local.square().sum() / _replicas(t)
    dist.all_reduce(total)
    return total.sqrt()


def local_view(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (sharing its storage), a plain tensor as
    it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def like_sharded(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (a replicated plain tensor of ``like``'s global shape, or a
    local shard of it) laid out as ``like``: a DTensor with its
    placements when ``like`` is one."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    if tuple(t.shape) == tuple(like.shape):
        return distribute_tensor(t, like.device_mesh, like.placements)
    return DTensor.from_local(t, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())

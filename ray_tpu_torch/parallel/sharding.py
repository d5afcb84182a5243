"""Logical-axis sharding rules (counterpart of
``ray_tpu/parallel/sharding.py``).

Models annotate arrays with *logical* axis names ("batch", "embed",
"heads", ...); a rule table maps those to mesh axes.  Swapping the rule
table re-shards the whole model without touching model code.

The rules and the context (:func:`use_mesh`, :func:`use_sharding_rules`,
:func:`suppress_constraints`) are the reference's.  The device side is
DTensor: a :class:`PartitionSpec` becomes one placement per mesh
dimension (``Shard(dim)`` or ``Replicate()``), :func:`shard_params`
distributes each leaf, and :func:`with_logical_constraint` redistributes
a DTensor.  Inside a manual region (the model's SPMD body, the pipeline
and ring schedules, where each rank holds local tensors and the code
owns the layout, as inside the reference's ``shard_map``) constraints
are suppressed, and a plain tensor passes through unchanged.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import torch

from .mesh import AXIS_ORDER, mesh_shape, mesh_size


class PartitionSpec(tuple):
    """Per-dim mesh axes of an array: a mesh axis name, a tuple of them
    (the dim is split over their product, the first one major), or None
    (replicated); trailing dims may be left out.  The counterpart of
    ``jax.sharding.PartitionSpec`` (a tuple, equal to JAX's with the
    same parts)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# A logical axis maps to: one mesh axis, a tuple of mesh axes (the dim
# is sharded over their product), or None (replicated).
Rule = Tuple[str, Union[str, Tuple[str, ...], None]]


class ShardingRules:
    """Ordered logical-axis -> mesh-axis mapping."""

    def __init__(self, *rules: Rule):
        self._table = dict(rules)

    def mesh_axes(self, logical: Optional[str]):
        if logical is None:
            return None
        return self._table.get(logical)

    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        """PartitionSpec for a tuple of per-dim logical names.

        A mesh axis may appear at most once across the dims of one
        array; later duplicates fall back to replication.
        """
        used = set()
        parts = []
        for name in logical_axes:
            axes = self.mesh_axes(name)
            if axes is None:
                parts.append(None)
                continue
            if isinstance(axes, str):
                axes = (axes,)
            axes = tuple(a for a in axes if a not in used)
            used.update(axes)
            if not axes:
                parts.append(None)
            elif len(axes) == 1:
                parts.append(axes[0])
            else:
                parts.append(axes)
        while parts and parts[-1] is None:
            parts.pop()
        return PartitionSpec(*parts)

    def extended(self, *rules: Rule) -> "ShardingRules":
        new = ShardingRules()
        new._table = {**self._table, **dict(rules)}
        return new


# Default rules for transformer LMs (the reference's):
#  - activations: batch over (data, fsdp); seq over seq (context
#    parallel); heads/mlp over tensor.
#  - weights: embed dim over fsdp (ZeRO-3 gather per use), output
#    feature dims over tensor, experts over expert.
#  - "layers" shards the stacked layer weights over pipe stages.
DEFAULT_RULES = ShardingRules(
    ("batch", ("data", "fsdp")),
    ("seq", "seq"),
    ("act_embed", "tensor"),
    ("heads", "tensor"),
    ("kv_heads", "tensor"),
    ("head_dim", None),
    ("embed", "fsdp"),
    ("mlp", "tensor"),
    ("vocab", "tensor"),
    ("expert", "expert"),
    ("layers", "pipe"),
)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: ShardingRules = DEFAULT_RULES
        self.suppress = False


_ctx = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh):
    prev = _ctx.mesh
    _ctx.mesh = mesh
    try:
        yield mesh
    finally:
        _ctx.mesh = prev


@contextlib.contextmanager
def use_sharding_rules(rules: ShardingRules):
    prev = _ctx.rules
    _ctx.rules = rules
    try:
        yield rules
    finally:
        _ctx.rules = prev


def current_mesh():
    return _ctx.mesh


def current_rules() -> ShardingRules:
    return _ctx.rules


@contextlib.contextmanager
def suppress_constraints():
    """Disable with_logical_constraint within the block: used inside a
    manual region, where each rank holds local tensors and the region's
    code owns the layout."""
    prev = _ctx.suppress
    _ctx.suppress = True
    try:
        yield
    finally:
        _ctx.suppress = prev


def _axes_of(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


class LogicalSharding:
    """A mesh and a PartitionSpec, with the DTensor placements they give
    (the counterpart of ``NamedSharding``).  A dim over a tuple of axes
    splits major to minor in the tuple's order, as JAX does; DTensor
    nests shards over mesh dims in mesh order, so the tuple must follow
    :data:`AXIS_ORDER` (the default rules' ``("data", "fsdp")`` does).
    Axes of size 1 place as ``Replicate()``: the data is the same."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec
        self._sizes = mesh_shape(mesh)
        names = tuple(self._sizes)
        for part in spec:
            axes = _axes_of(part)
            order = [AXIS_ORDER.index(a) for a in axes]
            if order != sorted(order):
                raise NotImplementedError(
                    f"a dim sharded over {axes} must list its mesh axes "
                    f"in mesh order {AXIS_ORDER}")
            for a in axes:
                if a not in names:
                    raise ValueError(f"mesh has no axis {a!r}")
        self.names = names

    @property
    def placements(self):
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate() for _ in self.names]
        for dim, part in enumerate(self.spec):
            for a in _axes_of(part):
                if self._sizes[a] > 1:
                    out[self.names.index(a)] = Shard(dim)
        return tuple(out)

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """The per-rank shard shape of an array of ``global_shape``."""
        out = list(global_shape)
        for dim, part in enumerate(self.spec):
            n = math.prod(self._sizes[a] for a in _axes_of(part))
            if out[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(global_shape)} is not "
                                 f"divisible by {n} ({part})")
            out[dim] //= n
        return tuple(out)

    def __repr__(self):
        return f"LogicalSharding({self.spec!r}, {self._sizes})"


def logical_sharding(logical_axes: Sequence[Optional[str]], mesh=None,
                     rules: Optional[ShardingRules] = None
                     ) -> LogicalSharding:
    mesh = mesh or _ctx.mesh
    if mesh is None:
        raise ValueError("no mesh: pass one or enter use_mesh(...)")
    rules = rules or _ctx.rules
    return LogicalSharding(mesh, rules.spec(logical_axes))


def logical_mesh_axes(logical: str,
                      rules: Optional[ShardingRules] = None
                      ) -> Tuple[str, ...]:
    """The mesh axes a logical axis maps to, as a tuple (major first)."""
    return _axes_of((rules or _ctx.rules).mesh_axes(logical))


def with_logical_constraint(x, *logical_axes: Optional[str],
                            rules: Optional[ShardingRules] = None):
    """Redistribute a DTensor to the layout its logical axes name.

    No-op outside a mesh context, on a mesh of size 1 and under
    suppress_constraints() (as the reference's), and for a plain tensor,
    which is a rank's local value inside a manual region.
    """
    mesh = _ctx.mesh
    if mesh is None or mesh_size(mesh) == 1 or _ctx.suppress:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    sharding = LogicalSharding(x.device_mesh, (rules or _ctx.rules).spec(
        logical_axes))
    return x.redistribute(x.device_mesh, sharding.placements)


def shard_params(params, logical_axes_tree, mesh=None,
                 rules: Optional[ShardingRules] = None):
    """Place a param tree according to a matching tree of logical-axis
    tuples (None leaves replicate): each leaf becomes a DTensor
    distributed from rank 0's values (``distribute_tensor``).  Without a
    mesh the tree is returned as it is; on a one-device mesh each leaf
    stays a plain tensor on the mesh's device (a single shard carries no
    layout, and the kernels take plain tensors)."""
    from torch.distributed.tensor import distribute_tensor

    mesh = mesh or _ctx.mesh
    rules = rules or _ctx.rules
    if mesh is None:
        return params
    device = torch.device(mesh.device_type)

    def place(x, axes):
        if isinstance(x, dict):
            return {k: place(x[k], axes[k]) for k in x}
        x = x.to(device)
        if mesh_size(mesh) == 1:
            return x
        spec = rules.spec(axes) if axes is not None else PartitionSpec()
        return distribute_tensor(x, mesh,
                                 LogicalSharding(mesh, spec).placements)

    return place(params, logical_axes_tree)

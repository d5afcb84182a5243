"""Device-mesh construction with named parallelism axes (counterpart of
``ray_tpu/parallel/mesh.py``).

Parallelism is expressed as a ``torch.distributed`` ``DeviceMesh`` whose
named dimensions carry the strategy, one process per device:

==========  ============================================================
axis        meaning
==========  ============================================================
``data``    pure data parallelism (gradients summed over it)
``fsdp``    data parallelism with parameter/optimizer sharding (ZeRO-3);
            weights are sharded over it and all-gathered per use
``pipe``    pipeline stages (GPipe over point-to-point sends)
``tensor``  tensor-parallel axis of the weights (heads/mlp/vocab)
``seq``     sequence/context parallelism (ring attention axis)
``expert``  MoE expert parallelism
==========  ============================================================

Axis order matters as in the reference: the last axes change fastest
over the ranks, so ``tensor``/``seq`` (the highest-bandwidth
collectives) sit innermost, on neighbouring ranks of one host.

The mesh spans the default process group's ranks; the caller starts
that group (``torch.distributed.init_process_group`` with its own
address, world size and rank).  :func:`local_mesh` starts a one-process
group itself when none exists.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.device import resolve_device

# Outer-to-inner rank ordering (see module docstring).
AXIS_ORDER: Tuple[str, ...] = ("pipe", "data", "fsdp", "expert", "seq",
                               "tensor")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape: one int per parallelism axis.

    ``MeshSpec(fsdp=-1)`` lets one axis absorb all remaining devices
    (like a -1 in a reshape).
    """

    data: int = 1
    fsdp: int = 1
    pipe: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        return {name: getattr(self, name) for name in AXIS_ORDER}

    def resolved(self, n_devices: int) -> "MeshSpec":
        """Resolve a single -1 axis against ``n_devices``."""
        sizes = self.axis_sizes()
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wild}")
        if wild:
            fixed = math.prod(v for v in sizes.values() if v != -1)
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed} ({sizes})")
            sizes[wild[0]] = n_devices // fixed
        total = math.prod(sizes.values())
        if total != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {total} devices, have {n_devices}")
        return MeshSpec(**sizes)

    @property
    def n_devices(self) -> int:
        sizes = self.axis_sizes()
        if any(v == -1 for v in sizes.values()):
            raise ValueError("unresolved -1 axis; call resolved() first")
        return math.prod(sizes.values())

    def build(self, device_type: str = "cuda"):
        return build_mesh(self, device_type)

    @classmethod
    def auto(cls, n_devices: int, *, tensor: int = 1, seq: int = 1,
             pipe: int = 1, expert: int = 1, fsdp: bool = True) -> "MeshSpec":
        """Fill the leftover devices into fsdp (default) or data."""
        spec = cls(tensor=tensor, seq=seq, pipe=pipe, expert=expert,
                   fsdp=-1 if fsdp else 1, data=1 if fsdp else -1)
        return spec.resolved(n_devices)


def build_mesh(spec: MeshSpec, device_type: str = "cuda"):
    """A ``DeviceMesh`` over the default process group's ranks, shaped by
    ``spec`` (a -1 axis absorbs the world size) with dimensions named
    and ordered by :data:`AXIS_ORDER`: rank r sits at the row-major
    position r, so the innermost axes map to neighbouring ranks.  On the
    card (``"cuda"``) unless the caller passes ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    resolve_device(device_type)  # no silent CPU mesh without a card
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs torch.distributed initialized "
            "(init_process_group with its address, world size and rank); "
            "local_mesh() builds a one-process mesh on its own")
    spec = spec.resolved(dist.get_world_size())
    sizes = spec.axis_sizes()
    return init_device_mesh(device_type, tuple(sizes[a] for a in AXIS_ORDER),
                            mesh_dim_names=AXIS_ORDER)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Shape-only mesh (axis names and sizes, no process group): the
    counterpart of ``jax.sharding.AbstractMesh`` for planning shardings
    and shard shapes without devices."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def get_abstract_mesh(spec: MeshSpec,
                      n_devices: Optional[int] = None) -> AbstractMesh:
    """Shape-only mesh.  Pass ``n_devices`` to resolve a -1 wildcard
    axis; otherwise the spec must be fully specified."""
    if n_devices is not None:
        spec = spec.resolved(n_devices)
    sizes = spec.axis_sizes()
    if any(v == -1 for v in sizes.values()):
        raise ValueError("spec has a -1 axis; pass n_devices")
    return AbstractMesh(tuple(sizes[a] for a in AXIS_ORDER), AXIS_ORDER)


def local_mesh(device_type: str = "cuda"):
    """Single-device mesh (all axes size 1): the degenerate case of one
    process on one card (or the CPU when asked).  Starts a one-process
    group over an in-memory store when none is running."""
    if not dist.is_initialized():
        resolve_device(device_type)
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise RuntimeError("local_mesh is the one-process mesh; this "
                           f"group has {dist.get_world_size()} ranks")
    return build_mesh(MeshSpec(), device_type)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)

"""The port's parallelism layer (counterpart of ``ray_tpu/parallel``):

- :class:`MeshSpec`: named device-mesh axes (data/fsdp/pipe/tensor/seq/
  expert) over a ``torch.distributed`` ``DeviceMesh``.
- Logical-axis sharding rules (:mod:`.sharding`) map model-level axis
  names ("batch", "embed", "heads", ...) to mesh axes; params become
  DTensors, ``with_logical_constraint`` redistributes one.
- :mod:`.pipeline`: the GPipe schedule over the pipe axis; :mod:`.spmd`:
  the differentiable collectives of the manual regions.
"""

from .mesh import MeshSpec, build_mesh, get_abstract_mesh, local_mesh
from .sharding import (
    ShardingRules,
    DEFAULT_RULES,
    logical_sharding,
    use_sharding_rules,
    with_logical_constraint,
    shard_params,
    current_mesh,
    use_mesh,
)

__all__ = [
    "MeshSpec",
    "build_mesh",
    "local_mesh",
    "get_abstract_mesh",
    "ShardingRules",
    "DEFAULT_RULES",
    "logical_sharding",
    "use_sharding_rules",
    "with_logical_constraint",
    "shard_params",
    "current_mesh",
    "use_mesh",
]

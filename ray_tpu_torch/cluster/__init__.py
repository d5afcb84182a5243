"""Cluster runtime: multi-process execution over a serialization boundary.

Layers (reference analogues in parentheses):

- ``serialization`` — cloudpickle boundary with out-of-band array
  externs (python/ray/_private/serialization.py).
- ``rpc`` — length-prefixed socket RPC with retry + chaos injection
  (src/ray/rpc/, rpc_chaos.h:23).
- ``head`` — cluster control plane: node/actor/KV/PG registries +
  placement (src/ray/gcs/gcs_server/gcs_server.h:88).
- ``worker`` — per-process task/actor execution server
  (src/ray/raylet/ + core_worker task receiver).
- ``client`` — driver/worker-side cluster attachment: remote task
  push, object fetch, actor routing
  (src/ray/core_worker/transport/normal_task_submitter.h:74).
- ``cluster_utils`` — in-process multi-node test fixture
  (python/ray/cluster_utils.py:135).
"""

from .serialization import deserialize, serialize  # noqa: F401

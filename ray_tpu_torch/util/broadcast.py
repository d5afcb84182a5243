"""Object broadcast: proactively replicate one object to many nodes.

Reference: src/ray/object_manager/push_manager.h:30 — push-based
distribution instead of N pulls hammering one holder; the reference's
release envelope includes 1 GiB broadcast to 50+ nodes
(release/benchmarks/README.md:15-19).  The transport is a fanout tree
(cluster/client.py broadcast_object): the source uploads ``fanout``
copies, recipients relay to their subtrees.  Same-host recipients mmap
the source's /dev/shm flat layout (no bytes move); everyone else gets
a STRIPED, PIPELINED CHUNK STREAM (push_stream_* control RPCs + raw
push sockets, docs/networking.md) whose chunks forward to the next hop
as they arrive — a depth-d relay tree streams at ~line rate instead of
d serial whole-payload store-and-forwards.

Device arrays ride the same path natively: ``torch.Tensor`` leaves
export their raw bytes into the wire layout with a header-only metadata
frame (dtype incl. bfloat16 and float8, shape, device), and each
recipient rebuilds the tensor on that device from its staging buffer —
so weight distribution (model shards, optimizer state) costs one
device→host transfer at the source and one host→device per recipient,
with no pickle round-trip of the bytes in between.

Typical use: ship a big read-only array (tokenizer table, eval set,
model shard) to every node before a task wave, so the wave's
dependency resolution hits local copies instead of serializing pulls.
A severed or dead relay hop raises a typed
:class:`~ray_tpu_torch.exceptions.ChannelError` naming the subtree — never a
hang (the stream read deadline bounds every hop).

For in-place array broadcast *within a collective gang* (every member
gets the value as an array, not an object ref), see
``ray_tpu_torch.collectives.broadcast`` — it pipelines chunks around the
group ring instead of the cluster-wide fanout tree.
"""

from __future__ import annotations

from typing import List, Optional


def broadcast(ref, node_ids: Optional[List[str]] = None,
              timeout: float = 600.0) -> int:
    """Replicate ``ref``'s value onto other nodes' object stores.

    ``node_ids``: target node ids (default: every other alive node).
    Returns the number of nodes that received a copy.  Copies are
    CACHES (plasma foreign entries, no borrower holds at the owner):
    keep the ref alive through the task wave that uses it; idle copies
    are swept.  No-op (returns 0) in local mode.
    """
    from ..core.runtime import get_runtime

    rt = get_runtime()
    if rt.cluster is None:
        return 0
    addresses = None
    if node_ids is not None:
        by_id = {n["node_id"]: n for n in rt.cluster.list_nodes()}
        addresses = [by_id[i]["address"] for i in node_ids if i in by_id]
    return rt.cluster.broadcast_object(ref, addresses, timeout=timeout)


def broadcast_value(value, node_ids: Optional[List[str]] = None,
                    timeout: float = 600.0):
    """``put`` + :func:`broadcast` in one step: seal ``value`` (device
    arrays export zero-copy), replicate it cluster-wide, and return the
    ref for the task wave that consumes it.

    The weight-distribution idiom::

        ref = broadcast_value(params)          # one striped tree push
        ray_tpu_torch.get([load.remote(ref, i) for i in range(n)])
    """
    import ray_tpu_torch

    ref = ray_tpu_torch.put(value)
    broadcast(ref, node_ids, timeout=timeout)
    return ref

"""Placement groups: gang-reserve resource bundles.

Reference semantics: python/ray/util/placement_group.py + GCS two-phase
bundle scheduling (SURVEY.md A.13).  A PG reserves a list of bundles with
a strategy (PACK/SPREAD/STRICT_PACK/STRICT_SPREAD); reserved capacity is
exposed as synthetic per-group resources (``CPU_group_<pgid>``) that
tasks/actors consume via PlacementGroupSchedulingStrategy.

TPU note: STRICT_PACK on a TPU slice means "same ICI domain" — the mesh
builder (ray_tpu_torch.parallel.mesh) consumes PG bundle topology labels to lay
meshes along the torus.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..cluster.rpc import TRANSPORT_ERRORS
from ..core.ids import PlacementGroupID
from ..core.runtime import get_runtime
from ..core.task_spec import PlacementGroupSchedulingStrategy  # re-export

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD",
                    # ICI-topology-aware (core/tpu_topology.py labels):
                    # one gang on one slice / one pipeline stage per
                    # slice.  head._place_pg_by_slice.
                    "SLICE_PACK", "SLICE_SPREAD")

_lock = threading.Lock()
_groups: Dict[PlacementGroupID, "PlacementGroup"] = {}


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]],
                 strategy: str, name: str = ""):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self._ready_event = threading.Event()
        self._removed = False
        # Guards the ready/removed handoff: reservation completes in a
        # background thread, and exactly ONE of {reserver, remover} must
        # tear a completed reservation down.
        self._state_lock = threading.Lock()
        # Cluster mode: {"nodes": [node_id per bundle],
        # "addresses": [addr per bundle]} once reserved.
        self._cluster_assignment: Optional[Dict[str, List[str]]] = None

    # -- lifecycle -----------------------------------------------------------
    def ready(self):
        """Returns an ObjectRef resolving when all bundles are reserved
        (reference: PlacementGroup.ready())."""
        from .. import remote

        @remote
        def _pg_ready(pg_id_hex: str):
            pg = get_placement_group_by_id(
                PlacementGroupID.from_hex(pg_id_hex))
            pg.wait(timeout_seconds=None)
            return pg

        return _pg_ready.remote(self.id.hex())

    def wait(self, timeout_seconds: Optional[float] = 30) -> bool:
        return self._ready_event.wait(timeout_seconds)

    def is_ready(self) -> bool:
        return self._ready_event.is_set()

    # -- resource mapping ----------------------------------------------------
    def group_resource_name(self, base: str, bundle_index: int = -1) -> str:
        if bundle_index >= 0:
            return f"{base}_group_{bundle_index}_{self.id.hex()}"
        return f"{base}_group_{self.id.hex()}"

    def wrap_resources(self, demand: Dict[str, float],
                       bundle_index: int = -1) -> Dict[str, float]:
        """Rewrite a task's demand onto this PG's synthetic resources.

        Single-node mode mints capacity only at the aggregate
        (wildcard) level, so indexed and wildcard consumers draw from one
        pool — on one node every bundle is co-located anyway, and a split
        pool would let the two forms double-spend the reservation.
        Cluster mode mints per-bundle indexed capacity on the node
        holding each bundle (reference: CPU_group_<i>_<pgid> synthetic
        resources, raylet/placement_group_resource_manager.h), so an
        indexed demand lands exactly on its bundle's node.
        """
        if self._removed:
            raise ValueError(f"placement group {self.id!r} was removed")
        if bundle_index >= len(self.bundles):
            raise ValueError(
                f"bundle index {bundle_index} out of range "
                f"(PG has {len(self.bundles)} bundles)")
        if self._cluster_assignment is not None and bundle_index >= 0:
            # Demand BOTH the indexed and the wildcard name (reference:
            # indexed consumers debit the wildcard pool too,
            # placement_group_resource_manager.h) — otherwise an
            # indexed and a wildcard consumer double-spend one bundle.
            out: Dict[str, float] = {}
            for k, v in demand.items():
                out[self.group_resource_name(k, bundle_index)] = v
                out[self.group_resource_name(k)] = v
            return out
        return {self.group_resource_name(k): v for k, v in demand.items()}

    def synthetic_capacity(self) -> Dict[str, float]:
        cap: Dict[str, float] = {}
        for bundle in self.bundles:
            for k, v in bundle.items():
                name = self.group_resource_name(k)
                cap[name] = cap.get(name, 0.0) + v
        return cap

    def bundle_specs(self) -> List[Dict[str, float]]:
        return [dict(b) for b in self.bundles]

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def __reduce__(self):
        return (get_placement_group_by_id, (self.id,))


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "", lifetime: Optional[str] = None
                    ) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty "
                         "resource dicts")
    for b in bundles:
        if any(v < 0 for v in b.values()):
            raise ValueError("bundle resources must be non-negative")
    rt = get_runtime()
    pg = PlacementGroup(PlacementGroupID.from_random(), bundles, strategy,
                        name)
    with _lock:
        _groups[pg.id] = pg

    if rt.cluster is not None:
        threading.Thread(target=_reserve_cluster, args=(rt, pg),
                         daemon=True).start()
        return pg

    # Single node: acquire the aggregate demand locally, then mint
    # synthetic bundle resources (the one-node analogue of the GCS
    # two-phase prepare/commit across raylets).
    total: Dict[str, float] = {}
    for b in bundles:
        for k, v in b.items():
            total[k] = total.get(k, 0.0) + v

    def reserve():
        if not rt.node_resources.can_ever_fit(total):
            return  # infeasible — stays pending forever, like reference
        rt.node_resources.acquire(total)
        with pg._state_lock:
            if not pg._removed:
                rt.node_resources.add_capacity(pg.synthetic_capacity())
                pg._ready_event.set()
                return
        # Removed while we were acquiring: give the resources back.
        rt.node_resources.release(total)

    threading.Thread(target=reserve, daemon=True).start()
    return pg


def bundle_capacity(pg_id_hex: str,
                    bundles: Dict[int, Dict[str, float]]
                    ) -> Dict[str, float]:
    """Synthetic resources a node advertises for the PG bundles it
    hosts: indexed (``CPU_group_<i>_<pgid>``) + wildcard aggregate
    (``CPU_group_<pgid>``) — reference
    raylet/placement_group_resource_manager.h."""
    cap: Dict[str, float] = {}
    for i, bundle in bundles.items():
        for k, v in bundle.items():
            idx = f"{k}_group_{i}_{pg_id_hex}"
            wild = f"{k}_group_{pg_id_hex}"
            cap[idx] = cap.get(idx, 0.0) + v
            cap[wild] = cap.get(wild, 0.0) + v
    return cap


def _reserve_cluster(rt, pg: PlacementGroup) -> None:
    """Cluster reservation: the head assigns each bundle a node
    (strategy-aware, head._create_pg), then every chosen node mints the
    bundle's synthetic resources against its real capacity (the
    two-phase prepare/commit of SURVEY A.13, collapsed to assign+mint
    with per-node rollback on failure)."""
    resp = rt.cluster.mut_call("create_pg", {
        "pg_id": pg.id.hex(), "bundles": pg.bundles,
        "strategy": pg.strategy}, timeout=30.0)
    if not resp.get("ok"):
        return  # infeasible — stays pending, like the reference
    nodes, addrs = resp["nodes"], resp["addresses"]
    by_addr: Dict[str, Dict[int, Dict[str, float]]] = {}
    for i, addr in enumerate(addrs):
        by_addr.setdefault(addr, {})[i] = pg.bundles[i]
    minted: List[str] = []
    for addr, bundles in by_addr.items():
        try:
            r = rt.cluster.pool.get(addr).call(
                "add_pg_capacity",
                {"pg_id": pg.id.hex(), "bundles": bundles}, timeout=60.0)
        except Exception:  # raylint: disable=ft-exception-swallow -- any mint failure (transport or node-side) routes to the same rollback below
            r = {"ok": False}
        if not r.get("ok"):
            for done in minted:  # roll back nodes already minted
                try:
                    rt.cluster.pool.get(done).call(
                        "remove_pg_capacity",
                        {"pg_id": pg.id.hex(),
                         "bundles": by_addr[done]}, timeout=30.0)
                except TRANSPORT_ERRORS:
                    pass  # rollback target died: its capacity died too
            rt.cluster.mut_call("remove_pg", {"pg_id": pg.id.hex()})
            return
        minted.append(addr)
    pg._cluster_assignment = {"nodes": nodes, "addresses": addrs}
    with pg._state_lock:
        if not pg._removed:
            pg._ready_event.set()
            return
    # remove_placement_group ran while we were reserving (it saw
    # not-ready and tore nothing down): undo everything now.
    for addr, bundles in by_addr.items():
        try:
            rt.cluster.pool.get(addr).call(
                "remove_pg_capacity",
                {"pg_id": pg.id.hex(), "bundles": bundles},
                timeout=30.0)
        except TRANSPORT_ERRORS:
            pass  # node gone: nothing left to unmint
    try:
        rt.cluster.mut_call("remove_pg", {"pg_id": pg.id.hex()})
    except TRANSPORT_ERRORS:
        pass  # head unreachable: the PG table entry dies with it


def get_placement_group_by_id(pg_id: PlacementGroupID) -> PlacementGroup:
    with _lock:
        pg = _groups.get(pg_id)
    if pg is None:
        raise ValueError(f"no such placement group: {pg_id!r}")
    return pg


def remove_placement_group(pg: PlacementGroup):
    rt = get_runtime()
    with _lock:
        _groups.pop(pg.id, None)
    with pg._state_lock:
        was_ready = pg.is_ready()
        pg._removed = True
    if was_ready:
        if pg._cluster_assignment is not None:
            by_addr: Dict[str, Dict[int, Dict[str, float]]] = {}
            for i, addr in enumerate(pg._cluster_assignment["addresses"]):
                by_addr.setdefault(addr, {})[i] = pg.bundles[i]
            for addr, bundles in by_addr.items():
                try:
                    rt.cluster.pool.get(addr).call(
                        "remove_pg_capacity",
                        {"pg_id": pg.id.hex(), "bundles": bundles},
                        timeout=30.0)
                except TRANSPORT_ERRORS:
                    pass  # node gone: nothing left to unmint
            try:
                rt.cluster.mut_call("remove_pg", {"pg_id": pg.id.hex()})
            except TRANSPORT_ERRORS:
                pass  # head unreachable: the PG table entry dies with it
        else:
            rt.node_resources.remove_capacity(pg.synthetic_capacity())
            total: Dict[str, float] = {}
            for b in pg.bundles:
                for k, v in b.items():
                    total[k] = total.get(k, 0.0) + v
            rt.node_resources.release(total)


def get_current_placement_group() -> Optional[PlacementGroup]:
    # In-process runtime: tasks don't implicitly capture the parent's PG
    # unless placement_group_capture_child_tasks is set; we expose None
    # outside PG tasks. Cluster mode threads this through TaskContext.
    return None


def placement_group_table() -> List[Dict[str, Any]]:
    with _lock:
        return [
            {"id": pg.id.hex(), "name": pg.name, "strategy": pg.strategy,
             "bundles": pg.bundle_specs(), "ready": pg.is_ready()}
            for pg in _groups.values()
        ]

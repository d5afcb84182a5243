"""Resource accounting.

Reference semantics: src/ray/common/scheduling/ — a node advertises a
total resource set ({"CPU": n, "GPU": m, custom...}); tasks demand
resources which are acquired at dispatch and released at completion.
Nodes can carry placement labels (see NodeLabel scheduling in the
cluster head); they are not auto-detected yet — pass them explicitly at
node start.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class ResourceSet:
    def __init__(self, total: Dict[str, float]):
        self._total = {k: float(v) for k, v in total.items() if v}
        self._available = dict(self._total)
        self._cond = threading.Condition()

    @property
    def total(self) -> Dict[str, float]:
        return dict(self._total)

    def available(self) -> Dict[str, float]:
        with self._cond:
            return dict(self._available)

    def can_ever_fit(self, demand: Dict[str, float]) -> bool:
        return all(self._total.get(k, 0.0) >= v for k, v in demand.items())

    def fits_now(self, demand: Dict[str, float]) -> bool:
        with self._cond:
            return all(self._available.get(k, 0.0) >= v - 1e-9
                       for k, v in demand.items())

    def try_acquire(self, demand: Dict[str, float]) -> bool:
        with self._cond:
            if all(self._available.get(k, 0.0) >= v - 1e-9
                   for k, v in demand.items()):
                for k, v in demand.items():
                    self._available[k] = self._available.get(k, 0.0) - v
                return True
            return False

    def acquire(self, demand: Dict[str, float],
                timeout: Optional[float] = None) -> bool:
        with self._cond:
            ok = self._cond.wait_for(
                lambda: all(self._available.get(k, 0.0) >= v - 1e-9
                            for k, v in demand.items()),
                timeout,
            )
            if not ok:
                return False
            for k, v in demand.items():
                self._available[k] = self._available.get(k, 0.0) - v
            return True

    def release(self, demand: Dict[str, float]):
        with self._cond:
            for k, v in demand.items():
                self._available[k] = min(
                    self._total.get(k, 0.0), self._available.get(k, 0.0) + v
                )
            self._cond.notify_all()

    def add_capacity(self, extra: Dict[str, float]):
        """Used by placement groups to mint bundle resources."""
        with self._cond:
            for k, v in extra.items():
                self._total[k] = self._total.get(k, 0.0) + v
                self._available[k] = self._available.get(k, 0.0) + v
            self._cond.notify_all()

    def remove_capacity(self, extra: Dict[str, float]):
        with self._cond:
            for k, v in extra.items():
                self._total[k] = max(0.0, self._total.get(k, 0.0) - v)
                self._available[k] = max(
                    0.0, self._available.get(k, 0.0) - v)
            self._cond.notify_all()


def detect_node_resources(num_cpus: Optional[float] = None,
                          num_gpus: Optional[float] = None,
                          resources: Optional[Dict[str, float]] = None
                          ) -> Dict[str, float]:
    """Auto-detect this host's resources (reference:
    _private/accelerators/nvidia_gpu.py counts the visible CUDA
    devices).  The count never creates a CUDA context (torch answers
    through NVML or ``cudaGetDeviceCount``): it runs at ``init()``, and
    a context made there would pin memory on every card before any task
    asked for one.  ``CUDA_VISIBLE_DEVICES=""`` or a build of torch
    without CUDA gives 0."""
    import os

    total: Dict[str, float] = {}
    total["CPU"] = float(num_cpus if num_cpus is not None
                         else os.cpu_count() or 1)
    if num_gpus is None:
        import torch

        try:
            num_gpus = float(torch.cuda.device_count())
        except Exception:
            num_gpus = 0.0
    if num_gpus:
        total["GPU"] = float(num_gpus)
    total["memory"] = float(_detect_memory_bytes())
    if resources:
        total.update({k: float(v) for k, v in resources.items()})
    return total


def _detect_memory_bytes() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 * 1024**3

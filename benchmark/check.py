"""What a driver hands back, and the comparisons that decide ``correct``.

Each compared number has a limit of its own (``benchmark/cells/<cell>
.json``, set from the readings recorded there).  A number passes when
it is finite and at most its limit; a run is correct when every number
passes.  A number with no limit never passes.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import sys
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class Number:
    name: str
    value: float
    limit: Optional[float]

    @property
    def ok(self) -> bool:
        return (self.limit is not None and math.isfinite(self.value)
                and self.value <= self.limit)


@dataclasses.dataclass
class Context:
    cell: Any                 # cells.Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float            # time.time() at process start
    log: Callable = lambda *a: print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]
    record: Dict[str, Any]          # what the per-layer readers read;
    #                                 "trace": the traced run's capture
    numbers: List[Number]
    attempted: int
    failed: int
    memory_peak_bytes: int


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keep: Optional[List[str]] = None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf
    and of the median leaf."""
    paths = keep if keep is not None else sorted(ref)
    med = statistics.median(ref[p] for p in paths)
    return max(abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30)
               for p in paths)


def moved_leaves(first_grad: Dict[str, float]) -> List[str]:
    """Leaves whose reference first gradient is at least a thousandth of
    the median leaf's: the others move under Adam by round-off alone and
    are left out of the change."""
    med = statistics.median(first_grad.values())
    return sorted(p for p, g in first_grad.items() if g >= 1e-3 * med)


def limit(cell, name: str) -> Optional[float]:
    entry = cell.limits.get(name)
    return None if entry is None else float(entry["limit"])


def train_numbers(prog: Dict, ref: Dict, cell) -> List[Number]:
    """The training cell's numbers, from the program's readings and the
    reference's (both as ``reference.train.follow`` returns them): the
    worst step's loss gap (nats), the worst step's pre-clip gradient
    norm gap (relative), and by the worst leaf the first clipped
    gradient's and the change's norm gaps."""
    keep = moved_leaves(ref["first_grad"])
    return [
        Number("loss_gap", max(abs(a - b) for a, b in
                               zip(prog["losses"], ref["losses"])),
               limit(cell, "loss_gap")),
        Number("grad_norm_gap", max(abs(a - b) / b for a, b in
                                    zip(prog["grad_norms"],
                                        ref["grad_norms"])),
               limit(cell, "grad_norm_gap")),
        Number("first_grad_gap",
               worst_leaf_gap(prog["first_grad"], ref["first_grad"]),
               limit(cell, "first_grad_gap")),
        Number("change_gap", worst_leaf_gap(prog["change"], ref["change"],
                                            keep),
               limit(cell, "change_gap")),
    ]

"""Find a cell and everything that belongs to it by name.

``BENCHMARK.json`` names the cell's configuration and traffic mix; the
rest is found by file name:

- ``benchmark/configs/<config>.json`` (the file ``BENCHMARK.json``
  gives): the model's sizes as run.
- ``benchmark/traffic/<traffic>.json``: the mix's parameters; its
  ``driver`` names ``benchmark/drivers/<driver>.py``.
- ``benchmark/cells/<cell>.json``: the limits of the numbers that
  decide ``correct``, with the readings each was set from; a number
  that it gives no limit is printed as a reading and not compared.
- ``benchmark/metrics/<metric>.py``: one reader for each per-layer
  metric, ``read(record) -> float | None``.

A cell that brings only new files of these kinds and new entries in
``BENCHMARK.json`` runs without an edit to any file that is here.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path

    @property
    def driver(self) -> str:
        return self.mix["driver"]


def _applies(metric: Dict, cell: str, reported: Optional[set]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load(name: str, root: Path = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` (root: the
    checkout).  Raises KeyError for an unknown cell."""
    root = Path(root) if root is not None else HERE.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    bench_dir = root / Path(cfg_entry["file"]).parts[0]
    mix = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    limits_file = bench_dir / "cells" / f"{name}.json"
    limits = (json.loads(limits_file.read_text())["limits"]
              if limits_file.exists() else {})
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, None)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), config, mix, limits, e2e, per_layer,
                bench_dir)


def reader(cell: Cell, metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = cell.root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(cell: Cell):
    """The module ``drivers/<driver>.py`` (its ``run(ctx)``)."""
    return importlib.import_module(f"benchmark.drivers.{cell.driver}")

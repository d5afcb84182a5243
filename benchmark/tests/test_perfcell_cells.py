"""Cells, configurations, mixes, limits and readers found by name."""

import json
from pathlib import Path

from benchmark import cells
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parent.parent.parent


def test_every_cell_of_the_benchmark_has_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        assert cell.driver in ("train", "serve")
        assert cells.driver(cell).run
        assert cell.limits, w["name"]
        for m in cell.per_layer:
            assert callable(cells.reader(cell, m["name"]))
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
    for m in bench["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()


def test_a_cell_of_new_files_only_is_found_by_name(tmp_path):
    root = tiny.make_tree(tmp_path)
    cell = cells.load("train.tiny.t", root)
    assert cell.config["hidden_size"] == 64
    assert cell.mix["driver"] == "train"
    assert cell.limits["loss_gap"]["limit"] == 1e-4
    assert {m["name"] for m in cell.per_layer} >= {
        "train_step_mfu", "flash_roofline_pct"}
    serve = cells.load("serve.tiny.s", root)
    assert {m["name"] for m in serve.end_to_end} == {
        "serve_ttft_p90_ms", "serve_tpot_p90_ms",
        "serve_output_tokens_per_s", "setup_s"}


def test_limits_carry_the_readings_they_were_set_from():
    for path in (ROOT / "benchmark" / "cells").glob("*.json"):
        data = json.loads(path.read_text())
        for name, entry in data["limits"].items():
            assert "limit" in entry and "lower" in entry, (path, name)
            if entry.get("upper") is not None:
                assert entry["lower"] < entry["limit"] < entry["upper"]

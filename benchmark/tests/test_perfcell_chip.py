"""Short runs of the real cells on the card (marker ``cuda``; they skip
where there is none): every number compared passes, and the result line
carries what the contract asks for.

    python -m pytest -m cuda benchmark/tests/test_perfcell_chip.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,trace", [
    ("train.internlm2-1_8b.s8k", 0), ("train.internlm2-1_8b.s8k", 1),
    ("serve.mistral-7b-v0.3.rag", 0), ("serve.mistral-7b-v0.3.rag", 1)])
def test_cell_runs_correct_on_the_card(cell, trace):
    _card()
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", "2147483777", "--seconds", "30", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "check"
    assert res["device"]["platform"] == "gpu"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for name, m in res["metrics"].items():
            if name.endswith("_roofline_pct") or "mfu" in name:
                assert 0 < m["value"] <= 100, (name, m)

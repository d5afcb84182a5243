"""The import guard: nothing a run executes loads JAX, its libraries or
the JAX package, and the reference loads nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import run

BENCH = Path(__file__).resolve().parent.parent


def test_forbidden_names_are_compared_whole(monkeypatch):
    fake = dict.fromkeys(["ray_tpu_torch", "ray_tpu_torch.models.llama",
                          "jaxtyping", "flaxen", "torch"])
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    fake.update(dict.fromkeys(["jaxlib.xla_client", "ray_tpu.models"]))
    assert run.forbidden_modules() == ["jaxlib", "ray_tpu"]


def test_the_harness_loads_no_jax():
    code = ("import sys, importlib; sys.path.insert(0, %r);"
            "from benchmark import run, cells, controls, sweep, trace;"
            "from benchmark.drivers import train, serve;"
            "from benchmark.reference import model, train as t, serve as s;"
            "import ray_tpu_torch;"
            "from ray_tpu_torch.models import llama;"
            "from ray_tpu_torch.serve import llm;"
            "from ray_tpu_torch import data;"
            "[cells.reader(cells.load(w), m['name']) for w in "
            "('train.internlm2-1_8b.s8k', 'serve.mistral-7b-v0.3.rag') "
            "for m in cells.load(w).per_layer];"
            "print(run.forbidden_modules())" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.lstrip(".").split(".")[0]
            if name.startswith("."):
                assert name in (".", ".model"), (path, name)
                continue
            assert top in ("torch", "typing", "math", "__future__"), \
                (path, name)


def test_no_result_outside_a_checkout(tmp_path):
    # A directory with only BENCHMARK.json and the benchmark: the program
    # is missing, so the run fails and prints no result.
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "train.internlm2-1_8b.s8k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=240)
    assert out.returncode != 0
    assert not out.stdout.strip()

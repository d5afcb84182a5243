"""The port stands alone: no module of ray_tpu_torch, and not
chip_smoke.py, imports jax or anything of ray_tpu; and its entry points
run on the card unless the caller asks for the CPU."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "optax", "ray_tpu")


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_ray_tpu(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig.debug()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.LlamaModel(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMServer(model_preset="debug", warmup=False)
    params = llama.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.forward(params, [[1, 2, 3]], cfg)
    logits = llama.LlamaModel(cfg, params=params, device="cpu")([[1, 2, 3]])
    assert logits.shape == (1, 3, cfg.vocab_size)
    assert logits.device.type == "cpu"

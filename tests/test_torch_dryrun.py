"""The port's driver entry points (``ray_tpu_torch/tools/dryrun.py``)
against the repository's ``__graft_entry__.py``, on the CPU.

- The dense and MoE mesh shapes for n = 1..8 equal the reference's.
- ``entry()`` builds the reference's config and arguments of the same
  shapes (params as shapes only: the 125M forward itself runs in
  chip_smoke phase 26a).
- ``dryrun_multichip(8, device="cpu")`` on 8 gloo CPU ranks prints the
  reference's line, both losses within 1.0 of ln(vocab) at init; a rank
  process starts no ranks of its own; without ``device="cpu"`` a
  machine with fewer cards than ranks raises.
- ``dryrun_cross_pipeline(device="cpu")`` in a fresh interpreter passes
  its own rtol 1e-4 check; in one with a runtime it refuses.
"""

import dataclasses
import math
import re
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

import __graft_entry__ as ref
from _torch_runtime import ray_start_regular  # noqa: F401
from ray_tpu.models import llama as jl
from ray_tpu_torch.core.device import DeviceUnavailableError
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.tools import dryrun

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_specs_equal_the_references(n):
    assert dryrun._mesh_spec_for(n).axis_sizes() == \
        ref._mesh_spec_for(n).axis_sizes()
    assert dryrun._moe_mesh_spec_for(n).axis_sizes() == \
        ref._moe_mesh_spec_for(n).axis_sizes()


def test_entry_config_and_shapes_equal_the_references(monkeypatch):
    seen = {}
    jinit = jl.init_params

    def jax_shapes(key, cfg, *a, **k):
        seen["ref"] = cfg
        return jax.eval_shape(lambda: jinit(key, cfg, *a, **k))

    def port_shapes(cfg, seed=0, dtype=torch.float32, device=None):
        seen["port"] = cfg
        return tl.param_shapes(cfg)

    monkeypatch.setattr(jl, "init_params", jax_shapes)
    monkeypatch.setattr(tl, "init_params", port_shapes)
    _, (jparams, jtokens) = ref.entry()
    _, (tparams, ttokens) = dryrun.entry(device="cpu")
    for f in dataclasses.fields(seen["port"]):
        if f.name != "dtype":
            assert getattr(seen["port"], f.name) == \
                getattr(seen["ref"], f.name), f.name
    assert seen["port"].dtype == torch.bfloat16
    assert tuple(ttokens.shape) == tuple(jtokens.shape) == (4, 512)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == tuple(leaf.shape), path


@pytest.mark.net
def test_dryrun_multichip_on_eight_gloo_ranks(capsys):
    res = dryrun.dryrun_multichip(8, device="cpu")
    assert res["device"] == "cpu"
    line = capsys.readouterr().out.strip().splitlines()[-1]
    dense, moe = ref._mesh_spec_for(8), ref._moe_mesh_spec_for(8)
    pattern = (re.escape(f"dryrun_multichip(8): dense mesh="
                         f"{dense.axis_sizes()} loss=") + r"\d+\.\d{3}"
               + re.escape(f"; moe mesh={moe.axis_sizes()} loss=")
               + r"\d+\.\d{3} ok")
    assert re.fullmatch(pattern, line), line
    uniform = math.log(tl.LlamaConfig.debug().vocab_size)
    for stage in ("dense", "moe"):
        assert abs(res[stage]["loss"] - uniform) < 1.0, res


def test_multichip_needs_a_card_per_rank_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(DeviceUnavailableError,
                       match=r"this machine has 1 card\(s\); pass "
                             r"device='cpu'"):
        dryrun.dryrun_multichip(4)
    with pytest.raises(ValueError, match="unsupported device"):
        dryrun.dryrun_multichip(2, device="mps")


def test_a_rank_starts_no_ranks(monkeypatch):
    monkeypatch.setenv(dryrun._CHILD_ENV, "1")
    with pytest.raises(RuntimeError, match="starts no ranks"):
        dryrun.dryrun_multichip(2)


def test_dryrun_cross_pipeline_in_a_fresh_interpreter():
    probe = ("from ray_tpu_torch.tools import dryrun\n"
             "dryrun.dryrun_cross_pipeline(device='cpu')\n")
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert re.search(r"GPipe loss=\d+\.\d{4} == single-process "
                     r"\d+\.\d{4} ok", r.stdout), r.stdout


def test_dryrun_cross_pipeline_refuses_a_running_runtime(ray_start_regular):
    with pytest.raises(RuntimeError, match="fresh interpreter"):
        dryrun.dryrun_cross_pipeline(device="cpu")

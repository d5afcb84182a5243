"""The port's MFU profiler (``ray_tpu_torch/tools/profile_mfu.py``)
against the repository's ``profile_mfu.py``, on the CPU.

- ``--remat-policy`` offers the model's ``REMAT_POLICIES`` (the twin of
  ``tests/test_models.py::test_remat_policy_registry_consistent``).
- ``run_one`` times each phase at ``debug`` on the CPU (``"device":
  "cpu"``): one JSON line, a positive time, no kernel launched (the
  wrappers run their plain versions on CPU tensors).
- ``run_config`` derives the reference's fields from the same phase
  times and parameter count: every key both results hold is equal
  (``subprocess.run`` and ``_n_params`` replaced in both).
- ``optimizer_update``, which the ``step`` child times alone, gives the
  train step's new state bit for bit (chain and fused).
- The parent imports no jax and never initialises CUDA; ``--attn-block``
  is refused.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import profile_mfu as ref
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.tools import profile_mfu as port

ROOT = Path(__file__).resolve().parent.parent
# Phase times (s) fed to both run_configs, llama_440m-like, and the
# fused variant's step.
TIMES = {"fwd": 0.0812, "grad": 0.2103, "step": 0.2561,
         "attn_flash": 0.0187, "attn_dot": 0.0412, "head": 0.0113}
FUSED_STEP = 0.2391
N_PARAMS = 435_471_360
PEAK = 989e12


def test_remat_policy_choices_are_the_models():
    action = next(a for a in port.build_parser()._actions
                  if a.dest == "remat_policy")
    assert tuple(action.choices) == tl.REMAT_POLICIES
    src = (ROOT / "profile_mfu.py").read_text()
    m = re.search(r"choices=\(([^)]*)\),\s*\n\s*help=\"sweep value", src)
    assert tuple(re.findall(r'"([a-z_]+)"', m.group(1))) == \
        tl.REMAT_POLICIES
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tl._remat_policy(dataclasses.replace(tl.LlamaConfig.debug(),
                                             remat_policy="bogus"))


@pytest.mark.parametrize("phase", port.PHASES)
def test_run_one_times_each_phase_on_the_cpu(phase, capsys):
    port.run_one({"phase": phase, "batch": 2, "seq": 64, "preset": "debug",
                  "device": "cpu", "fused": phase == "step",
                  "cfg": {"attention_impl": "flash", "remat": True,
                          "remat_policy": "attn"}})
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["phase"] == phase and out["s"] > 0
    assert out["launches"] == {}
    assert (out.get("opt_update_s", 0) > 0) == (phase == "step")


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "fused"])
def test_optimizer_update_is_the_steps(fused):
    """The update that ``opt_update_s`` times gives the train step's new
    state, bit for bit, from the step's own gradients."""
    cfg = tl.LlamaConfig.debug(max_seq_len=32)
    state = tl.init_train_state(cfg, seed=0, fused=fused, device="cpu")
    g = torch.Generator()
    g.manual_seed(1)
    b = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32), generator=g)}
    step = tl.make_train_step(cfg, donate=False, fused=fused, device="cpu")
    want, metrics = step(state, b)
    _loss, grads = tl.value_and_grad(state["params"], b, cfg, device="cpu")
    params, opt_state, gnorm = port.optimizer_update(fused)(
        grads, state["opt_state"], state["params"])
    assert torch.equal(gnorm, metrics["grad_norm"])
    for a, w in zip(tl.tree_leaves((params, opt_state)),
                    tl.tree_leaves((want["params"], want["opt_state"]))):
        assert torch.equal(a, w)


def _fake_children(times, fail=()):
    """A subprocess.run that answers each ``--one`` child with its
    phase's time (``fail``: exit 1 with a last stderr line)."""
    def run(cmd, **kwargs):
        spec = json.loads(cmd[cmd.index("--one") + 1])
        phase = spec["phase"]
        if phase in fail:
            return subprocess.CompletedProcess(cmd, 1, "",
                                               "Traceback\nOOM here\n")
        t = FUSED_STEP if phase == "step" and spec["fused"] else times[phase]
        line = {"phase": phase, "s": t, "launches": {}}
        if phase == "step":  # the port's child alone adds this field
            line["opt_update_s"] = 0.0123
        return subprocess.CompletedProcess(cmd, 0, json.dumps(line) + "\n",
                                           "")
    return run


@pytest.mark.parametrize("phases,peak,fail", [
    (port.PHASES, PEAK, ()),
    (["fwd", "grad", "step"], PEAK, ()),
    (port.PHASES, None, ()),
    (port.PHASES, PEAK, ("grad",)),
], ids=["all", "fwd-grad-step", "no-peak", "grad-failed"])
def test_derived_fields_equal_the_references(monkeypatch, capsys, phases,
                                             peak, fail):
    monkeypatch.setattr(subprocess, "run", _fake_children(TIMES, fail))
    for mod in (ref, port):
        monkeypatch.setattr(mod, "_n_params", lambda spec: N_PARAMS)
    got = {}
    for name, mod in (("ref", ref), ("port", port)):
        seed = None
        got[name] = []
        for fused in (False, True):
            spec = {"batch": 8, "seq": 2048, "preset": "llama_440m",
                    "cfg": {}, "fused": fused}
            res = mod.run_config(spec, phases, peak, seed_timings=seed)
            got[name].append(res)
            seed = res
    capsys.readouterr()
    for r, p in zip(got["ref"], got["port"]):
        shared = set(r) & set(p)
        assert {k: r[k] for k in shared} == {k: p[k] for k in shared}
        # The port adds only its launch counts and the update's time.
        assert set(r) <= set(p)
        assert {k for k in set(p) - set(r)} == \
            {k for k in p if k.endswith("_launches")} | \
            ({"opt_update_s"} & set(p))
        assert p.get("opt_update_s", 0.0123) == 0.0123
    fused = got["port"][1]
    if not fail:
        assert "tok_per_s" in fused and "opt_s" in fused
    if peak:
        assert "mfu_6n" in fused and "step_roofline_pct" in fused


def test_parent_imports_no_jax_and_leaves_cuda_alone():
    """The whole parent (its children fail on this machine without a
    card, which the parent records as ``*_err``)."""
    probe = ("import sys, torch\n"
             "from ray_tpu_torch.tools import profile_mfu\n"
             "profile_mfu.main(['--preset', 'debug', '--batch', '2', "
             "'--seq', '64', '--phases', 'fwd', '--optimizer', 'fused'])\n"
             "print('STATE', 'jax' in sys.modules, 'ray_tpu' in "
             "sys.modules, torch.cuda.is_initialized())\n")
    # No card for the parent or its children, also on a machine with one.
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[-1] == "STATE False False False"
    res = json.loads(lines[-2])
    assert res["optimizer"] == "fused" and res["model_params"] > 0
    # The child found no card and failed instead of using the CPU.
    assert "DeviceUnavailableError" in res["fwd_err"]


def test_attn_block_is_refused(capsys):
    with pytest.raises(SystemExit):
        port.main(["--attn-block", "512"])
    assert "attn_block_q" in capsys.readouterr().err

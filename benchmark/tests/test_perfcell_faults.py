"""Whole runs of the tiny cells on the CPU (the look for a card skipped),
sound and with the timed path broken underneath: each fault that a cell
can have turns ``correct`` false."""

import time

import pytest
import torch

from benchmark import cells, run
from benchmark.tests import tiny
from ray_tpu_torch.models import llama
from ray_tpu_torch.serve.llm import LLMServer


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    run.set_environment()
    return tiny.make_tree(tmp_path_factory.mktemp("cells"))


def execute(root, name, seconds=1.5):
    return run.execute(cells.load(name, root), 2 ** 31 + 99, seconds, False,
                       "cpu", time.time())


def test_sound_runs_are_correct(root):
    for name in ("train.tiny.t", "serve.tiny.s"):
        res = execute(root, name)
        assert res["correct"], res["check"]
        assert list(res)[-1] == "check"
        assert res["device"]["platform"] == "cpu"


def test_train_step_returning_its_state_unchanged(root, monkeypatch):
    real = llama.make_train_step

    def frozen(cfg, **kw):
        step = real(cfg, **dict(kw, donate=False))

        def run_(state, batch):
            _new, metrics = step(state, batch)
            return state, metrics
        return run_
    monkeypatch.setattr(llama, "make_train_step", frozen)
    res = execute(root, "train.tiny.t")
    assert not res["correct"]
    assert res["check"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_left_out(root, monkeypatch):
    real = llama.loss_fn

    def half(params, batch, config, device=None):
        tokens = torch.as_tensor(batch["tokens"])
        mask = torch.ones(tokens.shape)
        mask[tokens.shape[0] // 2:] = 0
        return real(params, dict(batch, loss_mask=mask), config, device)
    monkeypatch.setattr(llama, "loss_fn", half)
    res = execute(root, "train.tiny.t")
    assert not res["correct"]


def test_train_loss_altered_where_produced(root, monkeypatch):
    real = llama.make_train_step

    def altered(cfg, **kw):
        step = real(cfg, **kw)

        def run_(state, batch):
            state, metrics = step(state, batch)
            return state, dict(metrics, loss=metrics["loss"] * 1.001)
        return run_
    monkeypatch.setattr(llama, "make_train_step", altered)
    res = execute(root, "train.tiny.t")
    assert not res["correct"]
    assert res["check"]["loss_gap"]["value"] > 1e-3


def test_serve_token_altered_where_produced(root, monkeypatch):
    real = LLMServer._decode_k

    def altered(self, *args):
        toks = real(self, *args)
        toks[toks.shape[0] // 2] = (toks[toks.shape[0] // 2] + 1) \
            % self.cfg.vocab_size
        return toks
    monkeypatch.setattr(LLMServer, "_decode_k", altered)
    res = execute(root, "serve.tiny.s")
    assert not res["correct"]


def test_serve_decode_state_left_unwritten(root, monkeypatch):
    # The decode chunk's K/V never reach the pool: a step that leaves the
    # cache as it found it.
    monkeypatch.setattr(LLMServer, "_scatter", lambda self, *a: None)
    res = execute(root, "serve.tiny.s")
    assert not res["correct"]


def test_a_number_without_a_limit_is_a_reading_only(tmp_path):
    import json

    tree = tiny.make_tree(tmp_path)
    path = tree / "benchmark" / "cells" / "train.tiny.t.json"
    data = json.loads(path.read_text())
    del data["limits"]["loss_gap"]
    path.write_text(json.dumps(data))
    res = execute(tree, "train.tiny.t")
    assert res["correct"], res["check"]
    assert "loss_gap" not in res["check"]
    assert set(res["check"]) == {"grad_norm_gap", "first_grad_gap",
                                 "change_gap"}


def _marked_slice():
    """A capture's events: a kernel between the train driver's two
    marker kernels."""
    def ev(name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "args": {}}
    spin = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    return [ev(spin, 100, 1), ev("gemm", 110, 80), ev(spin, 201, 1)]


def test_traced_train_run_takes_another_capture_when_one_reads_nothing(
        root, monkeypatch):
    from benchmark import trace as tr

    reads = []

    def read(prof):
        reads.append(prof)
        if len(reads) == 1:
            raise tr.CaptureError("the capture holds no kernel")
        return tr.Trace(_marked_slice())
    monkeypatch.setattr(tr, "read_capture", read)
    res = run.execute(cells.load("train.tiny.t", root), 2 ** 31 + 99, 3.0,
                      True, "cpu", time.time())
    assert len(reads) == 2
    assert res["correct"], res["check"]
    assert res["metrics"]["device_idle_pct.train"]["value"] == \
        pytest.approx(20.0)
    assert res["device"]["busy_s"] == pytest.approx(80e-6)


def test_traced_train_run_without_a_readable_capture_fails(root):
    from benchmark import trace as tr

    # No capture on the CPU holds a kernel.
    with pytest.raises(tr.CaptureError, match="no capture of the traced"):
        run.execute(cells.load("train.tiny.t", root), 2 ** 31 + 99, 3.0,
                    True, "cpu", time.time())

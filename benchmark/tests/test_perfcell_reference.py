"""The plain reference against the port at tiny widths on the CPU: the
train step's loss, gradients and update, and the engine's prefill and
decode through the cache.  (This file imports both; the reference
itself imports nothing of the port.)"""

import pytest
import torch

from benchmark import check, traffic, weights
from benchmark.reference import model, serve as ref_serve, train as ref_train
from benchmark.tests import tiny
from ray_tpu_torch.models import llama

CFG = dict(tiny.TINY)
OPT = tiny.TRAIN_MIX["optimizer"]


def port_config(**kw):
    names = {"vocab_size", "hidden_size", "n_layers", "n_heads",
             "n_kv_heads", "head_dim", "intermediate_size", "max_seq_len",
             "rope_theta", "norm_eps", "tie_embeddings", "attention_impl",
             "remat_policy"}
    fields = {k: v for k, v in CFG.items() if k in names}
    fields.update(kw)
    return llama.LlamaConfig(**fields, dtype=torch.float32)


def test_forward_and_loss_agree_with_the_port():
    p = weights.make_params(CFG, 5, torch.float32, "cpu")
    tokens = torch.as_tensor(traffic.train_rows(5, 2, 48, CFG["vocab_size"]))
    lc = port_config()
    want = llama.forward(p, tokens, lc, device="cpu")
    got = model.logits(p, model.hidden(p, tokens, CFG))
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4)
    want_loss = llama.loss_fn(p, {"tokens": tokens}, lc, device="cpu")
    assert float(model.loss(p, tokens, CFG)) == pytest.approx(
        float(want_loss), abs=1e-5)


def test_train_steps_agree_with_the_fused_step():
    p = weights.make_params(CFG, 9, torch.float32, "cpu")
    rows = torch.as_tensor(traffic.train_rows(9, 6, 64, CFG["vocab_size"])
                           ).view(3, 2, 64)
    ref = ref_train.follow(p, rows, CFG, OPT)
    lc = port_config()
    state = llama.init_train_state(lc, fused=True, device="cpu")
    state["params"] = {k: ({kk: vv.clone() for kk, vv in v.items()}
                           if isinstance(v, dict) else v.clone())
                       for k, v in p.items()}
    step = llama.make_train_step(lc, fused=True, device="cpu")
    losses, norms, first = [], [], None
    for i in range(3):
        state, m = step(state, {"tokens": rows[i]})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0:
            first = {path: float(weights.leaf(state["opt_state"].mu, path)
                                 .norm()) / (1 - OPT["b1"])
                     for path, _s, _f in weights.leaf_specs(CFG)}
    change = {path: float((weights.leaf(state["params"], path)
                           - weights.leaf(p, path)).norm())
              for path, _s, _f in weights.leaf_specs(CFG)}
    prog = {"losses": losses, "grad_norms": norms, "first_grad": first,
            "change": change}
    cell = type("C", (), {"limits": {}})()
    nums = {n.name: n.value for n in check.train_numbers(prog, ref, cell)}
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_norm_gap"] < 1e-5
    assert nums["first_grad_gap"] < 1e-5
    assert nums["change_gap"] < 1e-3


def test_engine_prefill_and_decode_agree_with_a_full_forward():
    p = weights.make_params(CFG, 3, torch.float32, "cpu")
    lc = port_config(max_seq_len=128)
    prompt = traffic.train_rows(3, 1, 20, CFG["vocab_size"])[0].tolist()
    # Prefill's last logits.
    tok = torch.tensor([prompt + [0] * 12])
    last, ks, vs = llama.prefill_forward(p, tok, torch.tensor([20]), lc)
    want = model.logits(p, model.hidden(p, torch.tensor([prompt]), CFG))
    assert torch.allclose(last[0], want[0, -1], atol=2e-5, rtol=1e-4)
    # Decode through the slot cache, greedy, then the reference's gaps.
    cache = llama.init_kv_cache(lc, 1, 64, device="cpu")
    llama.insert_prefill(cache, ks, vs, [0])
    served = [int(last[0].argmax())]
    for pos in range(20, 27):
        lg, cache = llama.forward_with_cache(
            p, torch.tensor([[served[-1]]]), torch.tensor([[pos]]), cache, lc)
        served.append(int(lg[0, -1].argmax()))
    gap = ref_serve.served_gap(p, prompt, served, CFG, "cpu")
    assert gap < 1e-4
    # An altered token shows.
    bad = list(served)
    lg = ref_serve.served_logits(p, prompt, served, CFG, "cpu")
    bad[3] = int(lg[3].argmin())
    assert ref_serve.served_gap(p, prompt, bad, CFG, "cpu") > 0.1


def test_the_control_departs_from_the_reference():
    # The control (float8 operands) at the tiny size reads far above the
    # float32 program's gaps.
    p = weights.make_params(CFG, 4, torch.float32, "cpu")
    rows = torch.as_tensor(traffic.train_rows(4, 6, 64, CFG["vocab_size"])
                           ).view(3, 2, 64)
    ref = ref_train.follow(p, rows, CFG, OPT)
    low = ref_train.follow(p, rows, CFG, OPT, fp8=True)
    cell = type("C", (), {"limits": {}})()
    nums = {n.name: n.value for n in check.train_numbers(low, ref, cell)}
    assert nums["loss_gap"] > 1e-3 and nums["first_grad_gap"] > 1e-3
    prompt = traffic.train_rows(4, 1, 60, CFG["vocab_size"])[0].tolist()
    served = [int(x) for x in traffic.train_rows(5, 1, 60, 256)[0]]
    req = {"prompt": prompt, "tokens": served}
    hi = ref_serve.served_logits(p, prompt, served, CFG, "cpu")
    lo = ref_serve.served_logits(p, prompt, served, CFG, "cpu", fp8=True)
    assert float((hi - lo).abs().max()) > 1e-2
    # Where the float8 pass ranks another token first, the float32 one
    # reads a gap; at this size it need not happen at all 60 positions.
    gap = ref_serve.control_gaps(p, [req], CFG, "cpu")[0]
    moved = bool((hi.argmax(-1) != lo.argmax(-1)).any())
    assert (gap > 0) == moved

"""The frozen arithmetic against hand counts of the two configurations."""

import json
from pathlib import Path

import pytest

from benchmark import arith

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_param_counts_match_the_published_models():
    m, i = cfg("mistral-7b-v0.3"), cfg("internlm2-1_8b")
    # Mistral: embed and head 32768 x 4096 each, 32 layers of
    # 4096 x (4096 + 1024 + 1024) + 4096 x 4096 + 3 x 4096 x 14336 and two
    # norms, the final norm.
    layer = 4096 * 6144 + 4096 * 4096 + 3 * 4096 * 14336 + 2 * 4096
    assert layer == 218_112_000
    assert arith.param_count(m) == 2 * 134_217_728 + 32 * layer + 4096 \
        == 7_248_023_552
    assert arith.param_count(i) == 1_889_110_016
    assert m["params"] == arith.param_count(m)
    assert i["params"] == arith.param_count(i)


def test_kv_bytes_and_pool():
    m = cfg("mistral-7b-v0.3")
    assert arith.kv_bytes_per_token(m) == 2 * 32 * 8 * 128 * 2 == 131_072
    rows, by = arith.pool_reckoning(m, 1 + 32 * 256)
    assert rows == 2 * 32 * 16 * 8
    assert by[None] == 8193 * 16 * 131_072
    assert by["int8"] == 8193 * rows * 132


def test_flops_by_hand():
    i = cfg("internlm2-1_8b")
    N = 24 * (2048 * 4096 + 2048 * 2048 + 3 * 2048 * 8192) + 92544 * 2048
    assert arith.flop_params(i) == N
    S = 8192
    attn = 3 * 4 * 2048 * (S * (S + 1) // 2) * 24
    assert arith.train_step_flops(i, 1, S) == 6 * N * S + attn
    m = cfg("mistral-7b-v0.3")
    P = 100
    want = (2 * 32 * (218_112_000 - 2 * 4096) * P
            + 4 * 4096 * (P * (P + 1) // 2) * 32 + 2 * 4096 * 32768)
    assert arith.prefill_flops(m, P) == want


def test_decode_bytes_by_hand():
    m = cfg("mistral-7b-v0.3")
    w = arith.flop_params(m) * 2
    assert arith.decode_step_bytes(m, [10, 20]) == w + 131_072 * 32


def test_attention_copies_match_their_originals():
    # chip_smoke.attention_cost at llama3_8b's GQA shape (1, 32/8, 8192,
    # 128): 4 D-FLOP a causal pair, bound 0.5559 ms (PERF.md kernel table).
    f, b, ms, by = arith.attention_cost(1, 32, 8192, 8192, 128, True,
                                        kv_heads=8)
    assert f == 4.0 * 32 * 128 * (8192 * 8193 // 2)
    assert by == "flops" and ms == pytest.approx(0.5559, abs=1e-4)
    bwd = arith.attention_bwd_cost(8, 8, 2048, 2048, 128, True)
    assert bwd["flash_bwd_dq"][2] == pytest.approx(0.1043, abs=1e-4)
    assert bwd["flash_bwd_dkdv"][2] == pytest.approx(0.1390, abs=1e-4)
    assert arith.f32_bound_ms("flash_fwd_simple", 4, 8, 2048, 128, True) \
        == pytest.approx(0.5131, abs=1e-4)
    assert arith.visible_pairs(5, 5, True) == 15
    assert arith.visible_pairs(7, 5, True) == 15 + 2 * 5


def test_flash_need_counts_ten_products_a_pair_backward():
    need = arith.flash_need_ms(1, 16, 8, 8192, 128)
    pairs = 8192 * 8193 // 2
    assert need["fwd"] == pytest.approx(4 * 16 * 128 * pairs / 989e12 * 1e3)
    assert need["bwd"] == pytest.approx(
        (10 * 16 * 128 * pairs + 2 * 16 * 8192 * 128) / 989e12 * 1e3)


def test_train_reckoning_copy():
    # chip_smoke's docstring: llama3_8b at 7 layers, B=1 x S=8192: the
    # backward 63.95 GB, the update 72.17 GB.
    c = dict(cfg("mistral-7b-v0.3"), vocab_size=128256, n_layers=7)
    n = arith.param_count(c)
    assert n == 2_577_461_248
    _state, bwd, upd = arith.l3_train_reckoning(c, n, 1, 8192)
    assert bwd / 1e9 == pytest.approx(63.95, abs=0.01)
    assert upd / 1e9 == pytest.approx(72.17, abs=0.01)


def test_trace_slice_is_the_window_range_or_between_two_marker_kernels():
    from benchmark import trace as tr

    def ev(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": args}
    ops = [ev("kernel", "void at::cuda::(anonymous namespace)::spin_kernel"
              "(long)", 100, 1),
           ev("kernel", "gemm", 110, 40), ev("kernel", "gemm", 160, 20),
           ev("kernel", "void at::cuda::(anonymous namespace)::spin_kernel"
              "(long)", 201, 1)]
    t = tr.Trace(ops)
    lo, hi = t.window()
    assert (lo, hi) == pytest.approx((101e-6, 201e-6))
    assert t.busy_s(lo, hi) == pytest.approx(60e-6)
    ranged = tr.Trace(ops + [ev("user_annotation", tr.WINDOW, 150, 30)])
    assert ranged.window() == pytest.approx((150e-6, 180e-6))
    with pytest.raises(tr.CaptureError):
        tr.Trace(ops[1:3]).window()

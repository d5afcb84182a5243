"""Paged decode attention (``ray_tpu_torch/ops/paged_attention.py``) and
the paged engine's in-place decode chunk.

On the CPU: the plain version against ``llama._cache_attend`` on the
gathered layout (bit for bit) and against a float64 softmax; the engine's
in-place chunk against the gathered path it replaced (tokens and pool bit
for bit), the blocks it writes, and a quantized pool that still gathers.
On the card (``cuda`` marker, skipped without one): the kernel against its
plain version at the serve cell's shapes.  This file imports neither jax
nor ray_tpu, so on a GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_paged_decode.py
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import llama
from ray_tpu_torch.observability import timeline
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve.kv_cache import NULL_BLOCK
from ray_tpu_torch.serve.llm import LLMServer

# Kernel against its plain version on the same inputs, the output as a
# whole, |got - ref|_2 / |ref|_2.  Both compute f32 scores and softmax;
# the plain version rounds the probabilities to the value dtype before
# the product and the kernel does not, and both round the output to it.
# bf16: one rounding of 2**-8 relative at most per element, twice (the
# probabilities, the output), ~2**-9 on average; f16: 2**-11.  f32: the
# same f32 sums in another order (split across CTAs, stripes, lanes).
TOL_REL = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-5}


def _inputs(B, nb, bs, L, Hkv, G, D, lens, active, dtype, device="cpu",
            n_blocks=None, seed=0):
    """A random pool (N, L, bs, Hkv, D), each slot's query, and tables of
    random blocks (repeats allowed, as prefix sharing makes them), padded
    with the null block past each slot's length."""
    g = torch.Generator().manual_seed(seed)
    N = n_blocks or B * nb + 1
    pool_k = torch.randn((N, L, bs, Hkv, D), generator=g).to(dtype)
    pool_v = torch.randn((N, L, bs, Hkv, D), generator=g).to(dtype)
    q = torch.randn((B, 1, Hkv * G, D), generator=g).to(dtype)
    table = torch.randint(1, N, (B, nb), generator=g)
    for b in range(B):
        used = -(-(int(lens[b]) + 1) // bs)
        table[b, used:] = NULL_BLOCK
    lens = torch.tensor(lens, dtype=torch.long)
    active = torch.tensor(active, dtype=torch.bool)
    return [t.to(device) for t in (q, pool_k, pool_v, table, lens, active)]


def _gathered(pool, layer, table):
    """The dense layout (B, nb * bs, Hkv, D) of ``table``'s blocks, read
    position by position."""
    B, nb = table.shape
    bs = pool.shape[2]
    out = torch.empty((B, nb * bs) + tuple(pool.shape[3:]), dtype=pool.dtype)
    for b in range(B):
        for j in range(nb * bs):
            out[b, j] = pool[table[b, j // bs], layer, j % bs]
    return out


_CASES = [  # (B, nb, bs, Hkv, G, lens, active)
    (4, 3, 16, 2, 4, [15, 16, 17, 40], [True, True, True, True]),
    (4, 3, 16, 4, 1, [15, 16, 17, 0], [True, False, True, True]),
    (3, 2, 8, 2, 4, [3, 20, 9], [False, True, True]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _CASES)
def test_plain_version_is_cache_attend_on_the_gathered_layout(case, dtype):
    """The plain version gives ``_cache_attend``'s output on the gathered
    layout bit for bit for active slots (block-edge lengths 15/16/17, GQA
    4:1 and 1:1, tables padded with the null block, a slot past its
    table's width) and zeros for inactive ones; and it is the softmax of
    keys 0..p, by a float64 computation."""
    B, nb, bs, Hkv, G, lens, active = case
    D, L, layer = 16, 2, 1
    q, pk, pv, table, lens_t, active_t = _inputs(B, nb, bs, L, Hkv, G, D,
                                                 lens, active, dtype)
    scale = D ** -0.5
    got = pa.PagedDecode(pk, pv, table, active_t, Hkv * G, scale)(
        q, layer, lens_t)
    k, v = _gathered(pk, layer, table), _gathered(pv, layer, table)
    want = llama._cache_attend(q, k, v, lens_t[:, None], scale)
    assert got.dtype == dtype and got.shape == q.shape
    for b in range(B):
        if active[b]:
            assert torch.equal(got[b], want[b]), b
        else:
            assert not got[b].any(), b
    # Keys 0..p inside the table's width, in float64.
    for b in range(B):
        if not active[b]:
            continue
        n = min(lens[b] + 1, nb * bs)
        for hq in range(Hkv * G):
            kk = k[b, :n, hq // G].double()
            s = (kk @ q[b, 0, hq].double()) * scale
            ref = torch.softmax(s, 0) @ v[b, :n, hq // G].double()
            err = (got[b, 0, hq].double() - ref).abs().max().item()
            assert err < (2e-6 if dtype == torch.float32 else 2e-2), err


def test_split_plan_covers_the_table_from_host_values():
    """Whole blocks a split, at most 256 keys each, every block covered,
    and more splits while the CTAs of a launch are few; the serve cell's
    32 slots x 8 kv heads at 16-token blocks: 16 splits of 128 keys at
    nb 128, 16 of 256 at nb 256."""
    assert pa.split_plan(32, 8, 128, 16) == (16, 128)
    assert pa.split_plan(32, 8, 256, 16) == (16, 256)
    for slots, kv, nb, bs in [(32, 8, 32, 16), (4, 2, 3, 16), (1, 1, 1, 8),
                              (8, 8, 64, 16), (2, 8, 5, 1000)]:
        splits, split_len = pa.split_plan(slots, kv, nb, bs)
        assert split_len % bs == 0 and splits * split_len >= nb * bs
        assert (splits - 1) * split_len < nb * bs
        assert split_len <= max(256, bs)


_ENGINE = dict(model_preset="debug", max_slots=4, max_len=64,
               prefill_buckets=(16,), decode_chunk=8, prefill_groups=(4,),
               paged=True, block_size=8, device="cpu", warmup=False)


def _chunk_inputs(srv, lens0, tables):
    """Override carries for a chunk: every listed slot active at its
    length, the others inactive, and the tables padded to 8 blocks."""
    B = srv.max_slots
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(3, srv.cfg.vocab_size, (B,), generator=g)
    lens = torch.zeros(B, dtype=torch.long)
    active = torch.zeros(B, dtype=torch.bool)
    bt = torch.full((B, 8), NULL_BLOCK, dtype=torch.long)
    for s, (n, blocks) in enumerate(zip(lens0, tables)):
        if blocks:
            lens[s], active[s] = n, True
            bt[s, :len(blocks)] = torch.tensor(blocks)
    return tok, lens, active.clone(), active, bt


def _fill(srv, seed=0):
    g = torch.Generator().manual_seed(seed)
    for t in srv.pool.values():
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))


def _gathered_chunk(srv, ov_tok, ov_len, ov_mask, active, bt, k):
    """The paged chunk as it was before it read the pool in place: gather
    every table into the dense layout, decode there, scatter back."""
    S = bt.shape[1] * srv.block_size
    cache = {n: srv._gather(n, bt, trash_row=True) for n in ("k", "v")}
    step = srv._make_decode_step(srv.params, cache, active, S)
    toks = srv._decode_k(step, ov_tok, ov_len, ov_mask, k)
    for n in ("k", "v"):
        srv._scatter(n, bt, cache[n])
    return toks


def test_in_place_chunk_equals_the_gathered_chunk(monkeypatch):
    """A bf16 pool's chunk: the same tokens and carries as the gathered
    path, bit for bit, and the same pool outside the null block; it calls
    neither ``_gather`` nor ``_scatter`` and writes only its active slots'
    rows (the positions its steps reach) and the null block."""
    srv = LLMServer(**_ENGINE)
    try:
        assert srv.pool["k"].dtype == torch.bfloat16
        _fill(srv)
        # Slot 0 crosses a block edge; slot 1 is inactive; slot 2 shares
        # slot 3's first block (a prefix neither writes); slot 3 starts a
        # fresh block.  Every table covers the positions its steps write.
        lens0 = [5, 0, 9, 16]
        tables = [[3, 5], [], [9, 7, 13], [9, 11, 12]]
        args = _chunk_inputs(srv, lens0, tables)
        k = srv.decode_chunk
        before = {n: t.clone() for n, t in srv.pool.items()}

        srv._tok_dev.zero_(), srv._len_dev.zero_()
        want = _gathered_chunk(srv, *args, k)
        want_carry = (srv._tok_dev.clone(), srv._len_dev.clone())
        want_pool = {n: t.clone() for n, t in srv.pool.items()}

        for n, t in srv.pool.items():
            t.copy_(before[n])
        srv._tok_dev.zero_(), srv._len_dev.zero_()

        def refuse(*_a, **_k):
            raise AssertionError("the in-place chunk gathered or scattered")
        monkeypatch.setattr(srv, "_gather", refuse)
        monkeypatch.setattr(srv, "_scatter", refuse)
        got = srv._decode_paged(*args, k)
        assert torch.equal(got, want)
        assert torch.equal(srv._tok_dev, want_carry[0])
        assert torch.equal(srv._len_dev, want_carry[1])

        bs = srv.block_size
        written = {(tables[s][p // bs], p % bs)
                   for s, n in enumerate(lens0) if tables[s]
                   for p in range(n, n + k)}
        for n, t in srv.pool.items():
            assert torch.equal(t[1:], want_pool[n][1:]), n
            for blk in range(1, srv.num_blocks):
                for r in range(bs):
                    same = torch.equal(t[blk, :, r], before[n][blk, :, r])
                    assert same == ((blk, r) not in written), (n, blk, r)
    finally:
        srv.shutdown()


def test_quantized_pool_still_gathers(monkeypatch):
    """An int8 pool's chunk gathers (its dequantization lives there) and
    scatters back, and never calls the in-place attention."""
    srv = LLMServer(kv_quant="int8", **_ENGINE)
    calls = []
    try:
        for name in ("_gather", "_scatter"):
            real = getattr(srv, name)
            monkeypatch.setattr(srv, name, lambda *a, _n=name, _r=real,
                                **kw: calls.append(_n) or _r(*a, **kw))

        def refuse(*_a, **_k):
            raise AssertionError("a quantized pool went in place")
        monkeypatch.setattr("ray_tpu_torch.serve.llm.PagedDecode", refuse)
        args = _chunk_inputs(srv, [5, 0, 0, 0], [[3], [], [], []])
        srv._decode_paged(*args, 2)
        assert calls == ["_gather", "_gather", "_scatter", "_scatter"]
    finally:
        srv.shutdown()


@pytest.mark.parametrize("kv_quant,kv", [(None, "pool"), ("int8", "gather")])
def test_decode_chunk_span_names_its_path(kv_quant, kv):
    """Every ``serve.decode_chunk`` span of a paged engine carries ``kv``:
    ``"pool"`` on an unquantized pool, ``"gather"`` on a quantized one."""
    srv = LLMServer(kv_quant=kv_quant, **_ENGINE)
    t0 = time.time() * 1e6  # the timeline's clock, in microseconds

    async def main():
        return await asyncio.gather(*[srv.generate(
            {"prompt": list(range(3, 9 + 4 * i)), "max_new_tokens": 6})
            for i in range(3)])
    try:
        out = asyncio.run(main())
    finally:
        srv.shutdown()
    assert all(len(o["tokens"]) == 6 for o in out)
    chunks = [e for e in timeline.export_timeline(None)
              if e["name"] == "serve.decode_chunk" and e.get("ph") == "X"
              and e["ts"] >= t0]
    assert chunks and all(e["args"]["kv"] == kv for e in chunks)


# --------------------------------------------------------------- the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")


def _rel(got, ref):
    return ((got.float() - ref.float()).norm()
            / ref.float().norm().clamp_min(1e-30)).item()


def _cell_lens(B, nb, bs, seed):
    """Ragged lengths over the whole table width, block edges included,
    about half the slots active."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, nb * bs + 40, B)
    lens[:4] = [bs - 1, bs, bs + 1, nb * bs - 1]
    active = rng.random(B) < 0.55
    active[:4] = True
    return lens.tolist(), active.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("nb", [128, 256])
@pytest.mark.parametrize("split", ["one", "plan", "per_block"])
def test_kernel_matches_plain_version_on_card(dtype, nb, split, monkeypatch):
    """The kernel against its plain version at the serve cell's shapes:
    32 slots, 16-token blocks, tables of 128 and 256 blocks, 8 kv heads of
    128 with 4 query heads each, ragged lengths, inactive slots; one
    split, the plan's splits, and one block a split."""
    _needs_card()
    B, bs, L, Hkv, G, D = 32, 16, 2, 8, 4, 128
    if split == "one":
        monkeypatch.setattr(pa, "split_plan", lambda *a: (1, nb * bs))
    elif split == "per_block":
        monkeypatch.setattr(pa, "split_plan", lambda *a: (nb, bs))
    lens, active = _cell_lens(B, nb, bs, seed=nb)
    q, pk, pv, table, lens_t, active_t = _inputs(
        B, nb, bs, L, Hkv, G, D, lens, active, dtype, device="cuda",
        n_blocks=2049, seed=nb)
    pa.reset_launch_counts()
    got = pa.PagedDecode(pk, pv, table, active_t, Hkv * G, D ** -0.5)(
        q, 1, lens_t)
    torch.cuda.synchronize()
    splits = 1 if split == "one" else 2
    assert pa.launch_counts == {"paged_decode": 1,
                                "paged_decode_combine": int(splits > 1)}
    ref = pa.paged_decode_reference(q, pk, pv, 1, table, lens_t, active_t,
                                    D ** -0.5)
    on = active_t
    assert not got[~on].any()
    err = _rel(got[on], ref[on])
    print(f"paged_decode {dtype} nb={nb} split={split}: rel err {err:.3e}")
    assert err <= TOL_REL[dtype], err

"""The port's paged-KV host side (ray_tpu_torch.serve.kv_cache) and its
KV block quantizers (ray_tpu_torch.models.llama) against the JAX
package's: the allocator, block-table and prefix-cache scenarios of
tests/test_kv_cache.py and tests/test_spec_decode.py run on the port's
copy; the quantizers give the JAX functions' bytes exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import kv_cache as jkv
from ray_tpu_torch.core.metrics import metrics_summary
from ray_tpu_torch.exceptions import BackPressureError
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve.kv_cache import (KV_QUANT_FORMATS, NULL_BLOCK,
                                          BlockTable, KVBlockAllocator,
                                          PrefixCache, blocks_for_bytes,
                                          kv_quant_info)

_QDTYPES = {"int8": (jnp.int8, torch.int8),
            "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(1, 1000, n).tolist()


# ------------------------------------------------------------- allocator
def test_alloc_free_roundtrip_and_gauges():
    a = KVBlockAllocator(num_blocks=8, block_size=4, pool_label="t0")
    blocks = a.alloc(3)
    assert len(blocks) == 3 and NULL_BLOCK not in blocks
    assert a.used_blocks == 3 and a.free_blocks == 4
    assert all(a.refcount(b) == 1 for b in blocks)
    summary = metrics_summary()
    assert summary["ray_tpu_kv_blocks_used"]["t0"] == 3
    assert summary["ray_tpu_kv_blocks_free"]["t0"] == 4
    assert a.free(blocks) == 3
    assert a.used_blocks == 0 and a.free_blocks == 7
    assert metrics_summary()["ray_tpu_kv_blocks_free"]["t0"] == 7


def test_cow_fork_refcounts():
    a = KVBlockAllocator(num_blocks=8, block_size=4)
    shared = a.alloc(2)
    a.fork(shared)
    assert [a.refcount(b) for b in shared] == [2, 2]
    assert a.free(shared) == 0
    assert [a.refcount(b) for b in shared] == [1, 1]
    assert a.free(shared) == 2
    assert a.free_blocks == 7


def test_no_double_free_on_abort():
    a = KVBlockAllocator(num_blocks=8, block_size=4)
    t = BlockTable(a)
    t.ensure(10)  # 3 blocks
    blocks = list(t.blocks)
    t.release()
    t.release()  # idempotent
    assert a.free_blocks == 7
    with pytest.raises(RuntimeError, match="double free"):
        a.free(blocks)
    assert sorted(a.alloc(7)) == list(range(1, 8))


def test_exhaustion_is_typed_backpressure():
    a = KVBlockAllocator(num_blocks=4, block_size=4)
    a.alloc(3)
    with pytest.raises(BackPressureError) as ei:
        a.alloc(1)
    assert ei.value.retry_after_s is not None
    assert a.free_blocks == 0 and a.used_blocks == 3


def test_release_owner_sweeps_holds():
    a = KVBlockAllocator(num_blocks=8, block_size=4)
    mine = a.alloc(2, owner="m1")
    other = a.alloc(1, owner="m2")
    a.fork([other[0]], owner="m1")
    assert a.release_owner("m1") == 2
    assert a.refcount(other[0]) == 1
    assert a.free_blocks == 7 - 1
    assert a.release_owner("m1") == 0
    assert all(a.refcount(b) == 0 for b in mine)


@pytest.mark.parametrize("bad", [dict(num_blocks=1, block_size=4),
                                 dict(num_blocks=8, block_size=0)])
def test_allocator_rejects_bad_geometry(bad):
    with pytest.raises(ValueError):
        KVBlockAllocator(**bad)


# ---------------------------------------------------------- prefix cache
def test_lookup_forks_shared_chain():
    a = KVBlockAllocator(num_blocks=16, block_size=4)
    pc = PrefixCache(a)
    prompt = list(range(1, 13))  # 3 full blocks
    t = BlockTable(a)
    t.ensure(len(prompt))
    pc.insert(prompt, t.blocks)
    assert [a.refcount(b) for b in t.blocks] == [2, 2, 2]
    # Never the final block: the engine needs a suffix to prefill.
    assert pc.lookup(prompt) == t.blocks[:2]
    assert [a.refcount(b) for b in t.blocks] == [3, 3, 2]
    assert pc.lookup(prompt + [99, 98, 97, 96, 95]) == t.blocks[:3]
    assert pc.lookup([7777] * 12) == []
    counts = metrics_summary()
    assert counts["ray_tpu_prefix_cache_hits"]["default"] >= 2
    assert counts["ray_tpu_prefix_cache_misses"]["default"] >= 1


def test_partial_block_never_shared():
    a = KVBlockAllocator(num_blocks=16, block_size=4)
    pc = PrefixCache(a)
    prompt = _tokens(10)
    t = BlockTable(a)
    t.ensure(10)
    pc.insert(prompt, t.blocks)
    assert pc.num_blocks == 2
    assert a.refcount(t.blocks[2]) == 1


def test_insert_keeps_incumbent_on_divergent_chain():
    """Same tokens published from another physical chain (a request that
    prefilled before a concurrent insert won): the incumbent stays and
    the walk stops."""
    a = KVBlockAllocator(num_blocks=16, block_size=4)
    pc = PrefixCache(a)
    prompt = _tokens(12, seed=4)
    t1, t2 = BlockTable(a), BlockTable(a)
    t1.ensure(12)
    t2.ensure(12)
    pc.insert(prompt, t1.blocks)
    pc.insert(prompt, t2.blocks)
    assert pc.num_blocks == 3
    assert all(a.refcount(b) == 1 for b in t2.blocks)
    assert pc.lookup(prompt + [1]) == t1.blocks


def test_evicts_lru_leaf_first():
    a = KVBlockAllocator(num_blocks=16, block_size=2)
    pc = PrefixCache(a)
    for seed in (1, 2, 3):
        toks = _tokens(4, seed=seed)
        t = BlockTable(a)
        t.ensure(4)
        pc.insert(toks, t.blocks)
        t.release()
    assert pc.num_blocks == 6
    pc.lookup(_tokens(4, seed=1) + [5, 5, 5])
    chains = {s: pc.lookup(_tokens(4, seed=s) + [5, 5]) for s in (1, 2, 3)}
    for s in (1, 2, 3):
        a.free(chains[s])
    assert pc.evict(2) == 2
    assert pc.lookup(_tokens(4, seed=2) + [5, 5]) == []
    assert len(pc.lookup(_tokens(4, seed=1) + [5, 5])) == 2


def test_eviction_skips_live_blocks():
    a = KVBlockAllocator(num_blocks=8, block_size=2)
    pc = PrefixCache(a)
    t = BlockTable(a)
    t.ensure(4)
    pc.insert(_tokens(4, seed=9), t.blocks)
    assert pc.evict(5) == 0
    t.release()
    assert pc.evict(5) == 2


def test_exhaustion_reclaims_prefix_cache_before_raising():
    a = KVBlockAllocator(num_blocks=6, block_size=2)
    pc = PrefixCache(a)
    t = BlockTable(a)
    t.ensure(4)
    pc.insert(_tokens(4, seed=3), t.blocks)
    t.release()
    assert a.free_blocks == 3
    assert len(a.alloc(5)) == 5  # the cold chain is reclaimed
    assert pc.num_blocks == 0
    with pytest.raises(BackPressureError):
        a.alloc(1)


def test_drop_releases_everything():
    a = KVBlockAllocator(num_blocks=16, block_size=2)
    pc = PrefixCache(a)
    for seed in (1, 2):
        t = BlockTable(a)
        t.ensure(6)
        pc.insert(_tokens(6, seed=seed), t.blocks)
        t.release()
    assert a.used_blocks == 6
    assert pc.drop() == 6
    assert a.used_blocks == 0 and pc.num_blocks == 0


def test_block_table_trim_unit():
    """Speculative rollback returns owned tail blocks and never trims
    into the COW prefix."""
    a = KVBlockAllocator(num_blocks=16, block_size=4)
    pc = PrefixCache(a)
    shared_tokens = list(range(1, 9))
    t0 = BlockTable(a)
    t0.ensure(8)
    pc.insert(shared_tokens, t0.blocks)
    t0.release()
    shared = pc.lookup(shared_tokens + [9])
    assert len(shared) == 2
    t = BlockTable(a, shared=shared)
    t.ensure(20)  # 2 shared + 3 owned
    owned = list(t.blocks[2:])
    assert t.trim(10) == 2
    assert t.blocks == [shared[0], shared[1], owned[0]]
    assert t.trim(0) == 1
    assert t.blocks == shared and t.num_shared == 2
    assert all(a.refcount(b) == 0 for b in owned)
    assert all(a.refcount(b) == 2 for b in shared)
    t.release()
    assert a.used_blocks == pc.num_blocks == 2


# ------------------------------------------------------ formats, capacity
@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_formats_match_the_reference(name):
    fmt, ref = kv_quant_info(name), jkv.kv_quant_info(name)
    assert (fmt.qmax, fmt.itemsize) == (ref.qmax, ref.itemsize)
    assert str(fmt.dtype) == f"torch.{ref.dtype_name}"
    assert kv_quant_info(None) is None
    with pytest.raises(ValueError, match="unknown kv_quant"):
        kv_quant_info("int4")
    assert set(KV_QUANT_FORMATS) == set(jkv.KV_QUANT_FORMATS)


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("geom", [(12, 64, 6, 128), (24, 16, 8, 128),
                                  (2, 8, 2, 16)])
def test_blocks_for_bytes_matches_reference(kv_quant, geom):
    L, bs, Hkv, D = geom
    kw = dict(n_layers=L, block_size=bs, n_kv_heads=Hkv, head_dim=D,
              kv_quant=kv_quant)
    for budget in (0, 1 << 20, 404_226_048, 1 << 30):
        assert blocks_for_bytes(budget, **kw) == \
            jkv.blocks_for_bytes(budget, **kw)


def test_capacity_math_doubles_blocks():
    kw = dict(n_layers=12, block_size=64, n_kv_heads=6, head_dim=128)
    bf16 = blocks_for_bytes(1 << 30, **kw)
    int8 = blocks_for_bytes(1 << 30, kv_quant="int8", **kw)
    assert int8 >= bf16 * 2 * 128 / 132 * 0.999, (bf16, int8)


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
def test_init_paged_kv_cache_matches_reference(kv_quant):
    cj = jl.LlamaConfig.debug()
    ct = tl.LlamaConfig.debug()
    pj = jl.init_paged_kv_cache(cj, 9, 8, kv_quant=kv_quant)
    pt = tl.init_paged_kv_cache(ct, 9, 8, kv_quant=kv_quant, device="cpu")
    assert set(pt) == set(pj)
    for k in pj:
        assert tuple(pt[k].shape) == pj[k].shape
        assert pt[k].element_size() == pj[k].dtype.itemsize
        assert not pt[k].view(torch.uint8).any()  # zero-filled


# ---------------------------------------------------------- quantizers
def _blocks(seed, shape=(3, 2, 8, 2, 16)):
    """KV-like rows: gaussian with per-row ranges over 0.05..40, a few
    exact ties and a zero row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(0.05, 40, shape[:-1] + (1,))
    x = x.astype(np.float32)
    x[0, 0, 0, 0] = 0.0
    x[0, 0, 1, 0, :4] = x[0, 0, 1, 0].max() / 2  # halfway cases
    return x


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_bitwise_equal_to_reference(name, seed):
    fmt = kv_quant_info(name)
    jd, td = _QDTYPES[name]
    x = _blocks(seed)
    qj, sj = jl.quantize_kv_blocks(jnp.asarray(x), fmt.qmax, jd)
    qt, st = tl.quantize_kv_blocks(torch.from_numpy(x), fmt.qmax, td)
    assert qt.dtype == td and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.view(torch.uint8).numpy(),
                                  np.asarray(qj).view(np.uint8))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    for od_j, od_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        dj = jl.dequantize_kv_blocks(qj, sj, od_j)
        dt = tl.dequantize_kv_blocks(qt, st, od_t)
        np.testing.assert_array_equal(dt.float().numpy(),
                                      np.asarray(dj, np.float32))


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_requantization_is_a_fixed_point(name, dtype):
    """What the scatter-back relies on: blocks written from rows of the
    compute dtype come back byte for byte after a dequantize (to that
    dtype) and requantize, so re-scattering shared blocks never drifts
    and duplicate scatter indices write identical bytes."""
    fmt = kv_quant_info(name)
    x = torch.from_numpy(_blocks(7)).to(dtype)
    q1, s1 = tl.quantize_kv_blocks(x, fmt.qmax, fmt.dtype)
    y1 = tl.dequantize_kv_blocks(q1, s1, dtype)
    q2, s2 = tl.quantize_kv_blocks(y1, fmt.qmax, fmt.dtype)
    assert torch.equal(q2.view(torch.uint8), q1.view(torch.uint8))
    assert torch.equal(s2, s1)
    assert torch.equal(tl.dequantize_kv_blocks(q2, s2, dtype), y1)


@pytest.mark.parametrize("name,row_bound", [("int8", 0.5 / 127),
                                            ("fp8", 1 / 28)])
def test_roundtrip_error_bounded_per_row(name, row_bound):
    """int8: half a step of the row's grid; e4m3: half an ulp at the 448
    binade, relative to the row's amax."""
    fmt = kv_quant_info(name)
    x = torch.from_numpy(_blocks(11))
    q, s = tl.quantize_kv_blocks(x, fmt.qmax, fmt.dtype)
    y = tl.dequantize_kv_blocks(q, s, torch.float32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    err = ((y - x).abs() / amax.clamp_min(1e-30)).max().item()
    assert err <= row_bound + 1e-6, err

"""The port's parallelism layer (ray_tpu_torch.parallel, the GPipe path of
models.llama, models.llama_pipeline) against the JAX package's, on the
CPU.  Multi-device cases run as gloo processes (tests/
_torch_gloo_worker.py, one rank each, a FileStore under tmp_path, every
process joined with a timeout) on the same converted weights and seeded
tokens as the JAX side, which runs on its 8 virtual CPU devices.  All in
f32: loss to 1e-5 relative and gradients to 1e-4 relative (each leaf as
a whole, |got - ref|_2 / |ref|_2), the orders of summation being the
only difference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import _torch_gloo_worker as gloo
from ray_tpu.models import llama as jl
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import build_mesh as jbuild_mesh
from ray_tpu.parallel import logical_sharding as jlogical_sharding
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import llama_pipeline as tlp
from ray_tpu_torch.parallel import (DEFAULT_RULES, MeshSpec, ShardingRules,
                                    get_abstract_mesh, logical_sharding,
                                    use_mesh, with_logical_constraint)
from ray_tpu_torch.parallel.pipeline import bubble_fraction
from ray_tpu_torch.parallel.sharding import P

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# The JAX reference's loss and gradients, jitted (eager dispatch of the
# 4-layer model takes ~5x as long on the CPU).
_jax_value_and_grad = jax.jit(jax.value_and_grad(jl.loss_fn),
                              static_argnums=2)
# The debug model at four layers (two per stage at pipe=2, one at 4).
_CONFIG = dict(n_layers=4)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.update(_flat(tree[key], f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(tree[key], np.float32)
    return out


def _jax_setup(seed=0, tie=True):
    cfg = jl.LlamaConfig.debug(dtype=jnp.float32, remat=False,
                               tie_embeddings=tie, **_CONFIG)
    params = jl.init_params(jax.random.key(seed), cfg)
    tokens = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32)
    return cfg, params, tokens


def _inputs(params, tokens):
    out = {f"p/{k}": v for k, v in _flat(jax.tree.map(np.asarray,
                                                      params)).items()}
    out["tokens"] = tokens.astype(np.int64)
    out["config"] = np.array(dict(_CONFIG), dtype=object)
    return out


# ---------------------------------------------------------------------------
# Mesh and rules (single process: the spec arithmetic, the rules and the
# shape-only mesh; the 8-rank mesh itself is built in test_mesh8_*)
# ---------------------------------------------------------------------------

def test_meshspec_resolve_wildcard():
    spec = MeshSpec(tensor=2, fsdp=-1).resolved(8)
    assert spec.fsdp == 4 and spec.tensor == 2
    assert spec.n_devices == 8


def test_meshspec_bad_shapes():
    with pytest.raises(ValueError):
        MeshSpec(data=3).resolved(8)
    with pytest.raises(ValueError):
        MeshSpec(data=-1, fsdp=-1).resolved(8)


def test_meshspec_auto():
    spec = MeshSpec.auto(8, tensor=2)
    assert spec.fsdp == 4 and spec.tensor == 2


def test_abstract_mesh_matches_jax():
    ours = get_abstract_mesh(MeshSpec(fsdp=-1, tensor=2), 8)
    ref = JMeshSpec(fsdp=-1, tensor=2).resolved(8)
    assert ours.shape == ref.axis_sizes()
    assert ours.axis_names == tuple(ref.axis_sizes())
    assert ours.size == 8


def test_rules_spec_basic():
    rules = DEFAULT_RULES
    assert rules.spec(("batch", "seq", None)) == P(("data", "fsdp"), "seq")
    assert rules.spec(("embed", "heads")) == P("fsdp", "tensor")
    # Trailing Nones trimmed.
    assert rules.spec((None, None)) == P()


def test_rules_match_jax_rules():
    """The port's spec for every logical tuple the model uses equals the
    JAX package's PartitionSpec."""
    from ray_tpu.parallel import DEFAULT_RULES as JRULES

    cfg = jl.LlamaConfig.debug(tie_embeddings=False)
    axes = jax.tree.leaves(jl.param_logical_axes(cfg),
                           is_leaf=lambda x: isinstance(x, tuple))
    axes += [("batch", "seq", None), ("batch", "seq", "heads", "head_dim"),
             ("batch", "seq", "vocab"), ("vocab", None), ("a", "b")]
    for a in axes:
        assert tuple(DEFAULT_RULES.spec(a)) == tuple(JRULES.spec(a)), a


def test_rules_no_duplicate_mesh_axis():
    rules = ShardingRules(("a", "tensor"), ("b", "tensor"))
    # Second use of the same mesh axis falls back to replication.
    assert rules.spec(("a", "b")) == P("tensor")


def test_logical_sharding_placements():
    """A dim over (data, fsdp) shards on both mesh dims, data major;
    size-1 axes replicate."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = get_abstract_mesh(MeshSpec(data=2, fsdp=2, tensor=2))
    sh = logical_sharding(("batch", None, "heads"), mesh=mesh)
    assert sh.spec == P(("data", "fsdp"), None, "tensor")
    assert sh.placements == (Replicate(), Shard(0), Shard(0), Replicate(),
                             Replicate(), Shard(2))
    assert sh.shard_shape((8, 3, 4)) == (2, 3, 2)
    with pytest.raises(NotImplementedError, match="mesh order"):
        logical_sharding(("x",), mesh=mesh,
                         rules=ShardingRules(("x", ("fsdp", "data"))))


def test_with_logical_constraint_noop_outside_mesh():
    x = torch.ones(4, 4)
    assert with_logical_constraint(x, "batch", None) is x
    with use_mesh(get_abstract_mesh(MeshSpec())):
        assert with_logical_constraint(x, "batch", None) is x


def test_llama_param_logical_axes_match_jax():
    for tie in (True, False):
        cj = jl.LlamaConfig.debug(tie_embeddings=tie)
        ct = tl.LlamaConfig.debug(tie_embeddings=tie)
        assert tl.param_logical_axes(ct) == jl.param_logical_axes(cj)


def test_llama3_8b_fsdp8_shard_shapes_match_jax():
    """North-star shape check: every llama3_8b leaf's per-rank shard
    shape over an 8-way fsdp mesh with the production rules equals
    JAX's ``NamedSharding.shard_shape``.  The port's leaves are meta
    tensors: nothing is materialized on either side."""
    cj = jl.LlamaConfig.llama3_8b(max_seq_len=4096, attention_impl="dot")
    ct = tl.LlamaConfig.llama3_8b(max_seq_len=4096)
    shapes = jax.eval_shape(lambda: jl.init_params(jax.random.key(0), cj))
    jmesh = jbuild_mesh(JMeshSpec(fsdp=8), jax.devices()[:8])
    tmesh = get_abstract_mesh(MeshSpec(fsdp=8))
    jaxes = _flat_axes(jl.param_logical_axes(cj))
    taxes = _flat_axes(tl.param_logical_axes(ct))
    assert jaxes == taxes
    leaves = _flat_shapes(shapes)
    assert set(leaves) == set(taxes)
    for key, shape in leaves.items():
        meta = torch.empty(shape, device="meta")
        ours = logical_sharding(taxes[key], mesh=tmesh).shard_shape(
            meta.shape)
        ref = jlogical_sharding(jaxes[key], mesh=jmesh).shard_shape(shape)
        assert ours == tuple(ref), key
    wq = leaves["layers/wq"]
    assert logical_sharding(taxes["layers/wq"], mesh=tmesh).shard_shape(
        wq)[1] == wq[1] // 8


def _flat_axes(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.update(_flat_axes(tree[key], f"{prefix}{key}/"))
        else:
            out[prefix + key] = tuple(tree[key])
    return out


def _flat_shapes(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.update(_flat_shapes(tree[key], f"{prefix}{key}/"))
        else:
            out[prefix + key] = tuple(tree[key].shape)
    return out


def test_bubble_fraction():
    assert bubble_fraction(2, 4) == pytest.approx(1 / 5)
    assert 0 < bubble_fraction(4, 4) < 1


# ---------------------------------------------------------------------------
# GPipe and the multi-rank steps (gloo processes)
# ---------------------------------------------------------------------------

@pytest.mark.net
def test_gpipe_loss_and_grads_match_jax_loss_fn(tmp_path):
    """GPipe over the pipe axis at pipe=4 and at pipe=2 x data=2 (four
    ranks, M=4 microbatches): loss and every gradient against the JAX
    package's loss_fn on one device."""
    cfg, params, tokens = _jax_setup()
    batch = {"tokens": jnp.asarray(tokens)}
    ref_loss, ref_grads = _jax_value_and_grad(params, batch, cfg)
    ref_grads = _flat(jax.tree.map(np.asarray, ref_grads))
    outs = gloo.run_ranks("gpipe", 4, tmp_path, _inputs(params, tokens))
    for out in outs:
        for name in ("pipe4", "pipe2_data2"):
            assert _rel(out[f"{name}/loss"], ref_loss) <= LOSS_RTOL, name
            for key, ref in ref_grads.items():
                err = _rel(out[f"{name}/g/{key}"], ref)
                assert err <= GRAD_RTOL, (name, key, err)


def _port_steps(params_np, tokens, n, **cfg_kw):
    """Single-process port train steps from the same weights: the
    losses, the grad norms and the params after each step."""
    cfg = tl.LlamaConfig.debug(dtype=torch.float32, **{**_CONFIG, **cfg_kw})
    state = tl.init_train_state(cfg, device="cpu")
    state["params"] = convert.from_jax_params(params_np, device="cpu")
    step = tl.make_train_step(cfg, device="cpu")
    losses, norms, stepped = [], [], []
    for _ in range(n):
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        stepped.append(_flat(convert.to_numpy(state["params"])))
    return losses, norms, stepped


def _jax_steps(params, tokens, n, **cfg_kw):
    cfg = jl.LlamaConfig.debug(dtype=jnp.float32, **{**_CONFIG, **cfg_kw})
    state = {**jl.init_train_state(jax.random.key(0), cfg), "params": params}
    step = jl.make_train_step(cfg, donate=False)
    losses, norms = [], []
    for _ in range(n):
        state, m = step(state, {"tokens": jnp.asarray(tokens)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


@pytest.mark.net
def test_mesh8_steps_match_single_process_and_jax(tmp_path):
    """Eight gloo ranks:
    - the mesh's axis sizes and shard_params' local shards: a batch dim
      over (data, fsdp) against JAX's shard at each device position,
      and the shapes of the reference's placement test;
    - pipe=4 x data=2 with remat: the loss of JAX's loss_fn;
    - two train steps at pipe=2 x data=2 x fsdp=2 from sharded params;
    - the dense dryrun_multichip mesh (tensor=2 x fsdp=2 x pipe=2,
      ``__graft_entry__.py:35-48``): one train step from sharded params.
    Losses and grad norms against the single-process port step and the
    JAX step; the stepped params against the single-process port's."""
    cfg, params, tokens = _jax_setup(seed=3)
    params_np = jax.tree.map(np.asarray, params)
    outs = gloo.run_ranks("mesh8", 8, tmp_path, _inputs(params, tokens),
                          timeout=150)
    ref_loss = jl.loss_fn(params, {"tokens": jnp.asarray(tokens)}, cfg)
    # Rank r sits at the mesh's row-major position r, as device r of
    # JAX's build_mesh does: a dim over (data, fsdp) splits data-major.
    jmesh = jbuild_mesh(JMeshSpec(data=2, fsdp=2, tensor=2),
                        jax.devices()[:8])
    x = np.arange(8 * 3 * 4, dtype=np.float32).reshape(8, 3, 4)
    jx = jax.device_put(x, NamedSharding(jmesh, JP(("data", "fsdp"), None,
                                                   "tensor")))
    position = {d: i for i, d in enumerate(jmesh.devices.flatten())}
    for shard in jx.addressable_shards:
        np.testing.assert_array_equal(
            outs[position[shard.device]]["batch_shard"], x[shard.index])
    for out in outs:
        assert out["mesh_shape"].tolist() == [1, 2, 2, 1, 1, 2]
        assert out["shard_w"].tolist() == [2, 8]  # 8/4 x 16/2
        assert out["shard_b"].tolist() == [16]
        assert _rel(out["pipe4_data2_remat/loss"], ref_loss) <= LOSS_RTOL
    # One reference run of two steps serves both cases (the same weights,
    # batch and config; the dryrun case takes one step).
    port_l, port_n, port_p = _port_steps(params_np, tokens, 2, remat=True)
    jax_l, jax_n = _jax_steps(params, tokens, 2, remat=True)
    for name, n in (("steps_pipe2_data2_fsdp2", 2),
                    ("dryrun_tensor2_fsdp2_pipe2", 1)):
        for out in outs:
            for got, want_port, want_jax in zip(out[f"{name}/losses"],
                                                port_l, jax_l):
                assert _rel(got, want_port) <= LOSS_RTOL, name
                assert _rel(got, want_jax) <= LOSS_RTOL, name
            for got, want_port, want_jax in zip(out[f"{name}/norms"],
                                                port_n, jax_n):
                assert _rel(got, want_port) <= GRAD_RTOL, name
                assert _rel(got, want_jax) <= GRAD_RTOL, name
            for key, want in port_p[n - 1].items():
                assert _rel(out[f"{name}/p/{key}"], want) <= GRAD_RTOL, key


# ---------------------------------------------------------------------------
# Pipeline stages (single process)
# ---------------------------------------------------------------------------

def test_llama_pipeline_stages_compose_to_loss_fn():
    """Two stages of an untied debug model: stage 0's forward feeds the
    last stage's forward-and-loss, which equals JAX's loss_fn; the
    stages' recomputing backwards give JAX's gradients."""
    cfg, params, tokens = _jax_setup(seed=5, tie=False)
    ref_loss, ref_grads = _jax_value_and_grad(
        params, {"tokens": jnp.asarray(tokens)}, cfg)
    ref_grads = _flat(jax.tree.map(np.asarray, ref_grads))
    ct = tl.LlamaConfig.debug(dtype=torch.float32, remat=True,
                              tie_embeddings=False, **_CONFIG)
    tlp.check_pipeline_config(ct, 2)
    pt = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                 device="cpu")
    tok = torch.from_numpy(tokens)
    s0, s1 = tlp.stage_slice(pt, 0, 2), tlp.stage_slice(pt, 1, 2)
    fwd0 = tlp.make_stage_fwd(ct, first=True)
    fwd1 = tlp.make_stage_fwd_loss(ct)
    with torch.no_grad():
        h = fwd0(s0, tok)
        loss = fwd1(s1, h, tok)
    assert _rel(loss, ref_loss) <= LOSS_RTOL
    g1, dh = tlp.stage_backward(fwd1, s1, h, torch.ones(()), tok)
    g0, dtok = tlp.stage_backward(fwd0, s0, tok, dh)
    assert dtok is None
    got = {f"layers/{k}": np.concatenate([g0["layers"][k].numpy(),
                                          g1["layers"][k].numpy()])
           for k in g0["layers"]}
    got["embed_tokens"] = g0["embed_tokens"].numpy()
    got["final_norm"] = g1["final_norm"].numpy()
    got["lm_head"] = g1["lm_head"].numpy()
    assert set(got) == set(ref_grads)
    for key, ref in ref_grads.items():
        assert _rel(got[key], ref) <= GRAD_RTOL, key


def test_llama_pipeline_config_checks():
    with pytest.raises(ValueError, match=">= 2 stages"):
        tlp.check_pipeline_config(tl.LlamaConfig.debug(), 1)
    with pytest.raises(ValueError, match="tie_embeddings"):
        tlp.check_pipeline_config(tl.LlamaConfig.debug(), 2)
    with pytest.raises(NotImplementedError, match="ring"):
        tlp.check_pipeline_config(tl.LlamaConfig.debug(
            tie_embeddings=False, attention_impl="ring"), 2)


def test_pipeline_branch_keeps_the_reference_errors():
    """The GPipe branch of forward refuses what the reference's refuses,
    word for word (custom positions, ring inside stages)."""
    mesh = get_abstract_mesh(MeshSpec(pipe=2))
    params = tl.init_params(tl.LlamaConfig.debug(), device="cpu")
    tok = torch.zeros((2, 8), dtype=torch.long)
    with use_mesh(mesh):
        with pytest.raises(NotImplementedError, match="arange position"):
            tl.forward(params, tok, tl.LlamaConfig.debug(
                pipeline_microbatches=2), positions=torch.arange(8)[None]
                .expand(2, 8), device="cpu")
        with pytest.raises(NotImplementedError, match="nest shard_maps"):
            tl.forward(params, tok, tl.LlamaConfig.debug(
                pipeline_microbatches=2, attention_impl="ring"),
                device="cpu")

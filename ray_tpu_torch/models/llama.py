"""Llama-family decoder LM in PyTorch (counterpart of
``ray_tpu/models/llama.py``): forward, loss, train step, KV-cache decode.

- Params are a nested dict of tensors under the JAX package's keys, with
  every per-layer weight stacked on a leading ``(L, ...)`` axis, so
  weights convert 1:1 (``models/convert.py``).  :class:`LlamaModel`
  holds the same tensors as an ``nn.Module``.
- Functions on tensors mirror the JAX ones; a Python loop over layers
  replaces ``lax.scan``.  ``forward`` and ``loss_fn`` are differentiable
  (the train step takes their gradients through autograd, each layer
  under the config's remat policy); the serving functions run under
  ``torch.no_grad()``.
- Numerics follow the reference: matmuls accumulate in f32 and cast,
  norms and softmax run in f32, rope multiplies in x's dtype.  Training
  keeps f32 params and casts them to ``config.dtype`` at each matmul.
- ``attention_impl="flash"`` routes attention through the sm_90a flash
  kernels (``ops/flash_attention.py``: forward, and the dq and dk/dv
  backward behind a ``torch.autograd.Function``); the KV-cache serving
  path uses plain attention, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..core.device import DeviceLike, check_on, resolve_device, to_device
from ..train.optim import (ClipAdamW, apply_updates, fused_adamw_init,
                           fused_adamw_update, fused_hyperparams,
                           global_norm, tree_leaves, tree_unflatten)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # "dot" (plain attention) or "flash" (the CUDA flash kernels).
    attention_impl: str = "dot"
    remat: bool = True
    # Rematerialization policy of the per-layer checkpoint wrapper (one
    # of REMAT_POLICIES; ignored when remat=False or without grad):
    # "full" saves nothing and recomputes the layer in the backward;
    # "dots" saves the outputs of products without batch dims
    # (aten.mm), "dots_saveable" those of aten.bmm too; "attn" keeps only
    # the flash residuals (FLASH_RESIDUAL_NAMES), so the backward never
    # re-runs the flash forward while the FFN is recomputed; "attn_ffn"
    # also keeps silu(gate)*up.
    remat_policy: str = "full"
    tie_embeddings: bool = False
    # Not ported yet; a non-zero value raises (ROADMAP queue A).
    pipeline_microbatches: int = 0
    moe_experts: int = 0

    def __post_init__(self):
        if self.moe_experts > 0:
            raise NotImplementedError(
                "moe_experts > 0: MoE is not ported yet (ROADMAP queue A, "
                "'MoE')")
        if self.pipeline_microbatches > 0:
            raise NotImplementedError(
                "pipeline_microbatches > 0: pipeline parallelism is not "
                "ported yet (ROADMAP queue A, 'Parallelism')")
        if self.attention_impl == "ring":
            raise NotImplementedError(
                "attention_impl='ring' is not ported yet (ROADMAP queue A, "
                "'Ring attention')")
        if self.attention_impl not in ("dot", "flash"):
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r}")

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @classmethod
    def debug(cls, **kw) -> "LlamaConfig":
        """Tiny config for tests (runs on the CPU in well under 1 s)."""
        base = dict(vocab_size=256, hidden_size=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, head_dim=16, intermediate_size=128,
                    max_seq_len=128, rope_theta=10000.0, remat=False,
                    tie_embeddings=True)
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama_125m(cls, **kw) -> "LlamaConfig":
        base = dict(vocab_size=32000, hidden_size=768, n_layers=12,
                    n_heads=6, n_kv_heads=6, head_dim=128,
                    intermediate_size=2048, max_seq_len=2048,
                    rope_theta=10000.0, tie_embeddings=True)
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama_440m(cls, **kw) -> "LlamaConfig":
        """The flash preset: hidden 1024, 24 layers, 8 heads of 128,
        vocab 32000, tied head (~440M params); remat_policy="attn"
        keeps the flash residuals so the backward never re-runs the
        attention forward."""
        base = dict(vocab_size=32000, hidden_size=1024, n_layers=24,
                    n_heads=8, n_kv_heads=8, head_dim=128,
                    intermediate_size=4096, max_seq_len=2048,
                    rope_theta=10000.0, tie_embeddings=True,
                    attention_impl="flash", remat_policy="attn")
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        base = dict(vocab_size=32000, hidden_size=4096, n_layers=32,
                    n_heads=32, n_kv_heads=32, head_dim=128,
                    intermediate_size=11008, max_seq_len=4096,
                    rope_theta=10000.0)
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        base = dict(vocab_size=128256, hidden_size=4096, n_layers=32,
                    n_heads=32, n_kv_heads=8, head_dim=128,
                    intermediate_size=14336, max_seq_len=8192,
                    rope_theta=500000.0)
        base.update(kw)
        return cls(**base)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_dense(gen: torch.Generator, shape, fan_in: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in-scaled initializer."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * fan_in ** -0.5).to(dtype)


def init_params(config: LlamaConfig, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None) -> Params:
    """Stacked-layer params (truncated-normal fan-in init, norms at 1),
    same keys and shapes as the JAX ``init_params``.  Random numbers come
    from a ``torch.Generator`` seeded with ``seed``; they differ from
    ``jax.random``'s, so parity tests carry weights across with
    ``convert.from_jax_params``."""
    c = config
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def dense(shape, fan_in):
        return init_dense(gen, shape, fan_in, dtype, device)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    L, H = c.n_layers, c.hidden_size
    params = {
        "embed_tokens": dense((c.vocab_size, H), H),
        "layers": {
            "attn_norm": ones((L, H)),
            "wq": dense((L, H, c.q_dim), H),
            "wk": dense((L, H, c.kv_dim), H),
            "wv": dense((L, H, c.kv_dim), H),
            "wo": dense((L, c.q_dim, H), c.q_dim),
            "mlp_norm": ones((L, H)),
            "w_gate": dense((L, H, c.intermediate_size), H),
            "w_up": dense((L, H, c.intermediate_size), H),
            "w_down": dense((L, c.intermediate_size, H),
                            c.intermediate_size),
        },
        "final_norm": ones((H,)),
    }
    if not c.tie_embeddings:
        params["lm_head"] = dense((H, c.vocab_size), H)
    return params


def param_count(params: Params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def _layers(params: Params):
    """Every layer's weights as a dict per layer, unbound from the
    stacked ``(L, ...)`` tensors in one op each.  Under autograd this
    matters: the backward of ``w[i]`` writes a zero-filled gradient of
    the whole stack per layer (L x the stack's bytes per weight), the
    backward of one unbind stacks the L gradients once."""
    names = list(params["layers"])
    per_weight = [params["layers"][k].unbind(0) for k in names]
    return [dict(zip(names, ws)) for ws in zip(*per_weight)]


def _head(params: Params, config: LlamaConfig) -> torch.Tensor:
    if config.tie_embeddings:
        return params["embed_tokens"].to(config.dtype).T
    return params["lm_head"].to(config.dtype)


class LlamaModel(torch.nn.Module):
    """The stacked ``(L, ...)`` params as an ``nn.Module`` (keys as in the
    JAX pytree), on ``device`` (the card unless ``"cpu"`` is passed).
    ``model(tokens)`` returns logits."""

    def __init__(self, config: LlamaConfig, params: Optional[Params] = None,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        if params is None:
            params = init_params(config, seed=seed, device=self.device)

        def param(t):
            return torch.nn.Parameter(t.to(self.device), requires_grad=False)

        self.embed_tokens = param(params["embed_tokens"])
        self.layers = torch.nn.ParameterDict(
            {k: param(w) for k, w in params["layers"].items()})
        self.final_norm = param(params["final_norm"])
        self.lm_head = (param(params["lm_head"]) if "lm_head" in params
                        else None)

    def params(self) -> Params:
        out = {"embed_tokens": self.embed_tokens,
               "layers": dict(self.layers.items()),
               "final_norm": self.final_norm}
        if self.lm_head is not None:
            out["lm_head"] = self.lm_head
        return out

    def forward(self, tokens, positions=None) -> torch.Tensor:
        return forward(self.params(), tokens, self.config,
                       positions=positions, device=self.device)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("full", "dots", "dots_saveable", "attn", "attn_ffn")
# The products each selective policy keeps: the counterparts of JAX's
# dots_with_no_batch_dims_saveable and dots_saveable.
_SAVED_PRODUCTS = {"dots": ("mm",), "dots_saveable": ("mm", "bmm")}


def _remat_policy(config: LlamaConfig):
    """Checks ``config.remat_policy``; returns the ``context_fn`` of
    ``torch.utils.checkpoint`` for the selective policies ("dots",
    "dots_saveable": save the listed aten products' outputs, recompute
    the rest), else None ("full" saves nothing; "attn"/"attn_ffn" are
    segments around the flash call, see :func:`_remat_layer`)."""
    if config.remat_policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {config.remat_policy!r} "
            f"(choose from {REMAT_POLICIES})")
    products = _SAVED_PRODUCTS.get(config.remat_policy)
    if products is None:
        return None
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    saved = {getattr(torch.ops.aten, name).default for name in products}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation, in x's dtype.  A bf16 product
    through cuBLAS accumulates in f32 (reduced-precision reductions are
    turned off in core/device.py) and rounds once on output, as the
    reference's preferred_element_type=f32 + cast does."""
    return torch.matmul(x, w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables, shape (..., seq, head_dim/2), float32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # theta enters as a scalar: no host tensor is copied to the card.
    freqs = torch.pow(theta, exps)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x: (batch, seq, heads, head_dim); rotate-half convention, computed
    in x's dtype (the f32 tables are cast before the multiply)."""
    x1, x2 = x.chunk(2, dim=-1)
    sin = sin[:, :, None, :].to(x.dtype)
    cos = cos[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _softmax_attend(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, scale: float) -> torch.Tensor:
    """qg: (B, T, Hkv, G, D); k/v: (B, S, Hkv, D); mask broadcastable to
    (B, Hkv, G, T, S).  f32 scores and softmax; probs cast to v's dtype
    before the PV product; output (B, T, Hkv, G, D) in v's dtype."""
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores * scale
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.to(v.dtype)


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Plain causal attention, GQA via head broadcast.  q: (B, S, Hq, D);
    k/v: (B, S, Hkv, D); causal on absolute ``positions`` (B, S)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    mask = positions[:, None, None, :, None] >= \
        positions[:, None, None, None, :]
    return _softmax_attend(qg, k, v, mask, D ** -0.5).reshape(B, S, Hq, D)


def _cache_attend(q, ck, cv, q_positions, scale):
    """q: (B, T, Hq, D); ck/cv: (B, S, Hkv, D); q_positions: (B, T).
    Key j is visible to a query at position p iff j <= p."""
    B, T, Hq, D = q.shape
    S, Hkv = ck.shape[1], ck.shape[2]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, D)
    key_pos = torch.arange(S, device=q.device)
    mask = key_pos[None, None, None, None, :] <= \
        q_positions[:, None, None, :, None]
    return _softmax_attend(qg, ck, cv, mask, scale).reshape(B, T, Hq, D)


def _get_attention_fn(config) -> Callable:
    """Resolve a config (or bare impl name) to the attention callable."""
    impl = config if isinstance(config, str) else config.attention_impl
    if impl == "dot":
        return dot_attention
    if impl == "flash":
        from ..ops.flash_attention import flash_attention_causal
        return flash_attention_causal
    if impl == "ring":
        raise NotImplementedError(
            "attention_impl='ring' is not ported yet (ROADMAP queue A)")
    raise ValueError(f"unknown attention_impl {impl!r}")


def _qkv_rope(x: torch.Tensor, layer: Dict[str, torch.Tensor], sin, cos,
              config: LlamaConfig):
    """Shared by the forward and the KV-cache decode path."""
    c = config
    B, S, _ = x.shape
    dt = c.dtype
    h = rms_norm(x, layer["attn_norm"], c.norm_eps)
    q = matmul(h, layer["wq"].to(dt)).reshape(B, S, c.n_heads, c.head_dim)
    k = matmul(h, layer["wk"].to(dt)).reshape(B, S, c.n_kv_heads,
                                              c.head_dim)
    v = matmul(h, layer["wv"].to(dt)).reshape(B, S, c.n_kv_heads,
                                              c.head_dim)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _attn_out_act(x: torch.Tensor, attn: torch.Tensor,
                  layer: Dict[str, torch.Tensor], config: LlamaConfig):
    """Output projection, residual, and the FFN activation
    ``silu(gate) * up`` (the reference's ``ffn_act``); returns both."""
    c = config
    B, S, _ = x.shape
    dt = c.dtype
    x = x + matmul(attn.reshape(B, S, c.q_dim), layer["wo"].to(dt))
    h = rms_norm(x, layer["mlp_norm"], c.norm_eps)
    gate = matmul(h, layer["w_gate"].to(dt))
    up = matmul(h, layer["w_up"].to(dt))
    return x, F.silu(gate) * up


def _ffn_down(x: torch.Tensor, ffn_act: torch.Tensor,
              layer: Dict[str, torch.Tensor],
              config: LlamaConfig) -> torch.Tensor:
    return x + matmul(ffn_act, layer["w_down"].to(config.dtype))


def _attn_out_mlp(x: torch.Tensor, attn: torch.Tensor,
                  layer: Dict[str, torch.Tensor],
                  config: LlamaConfig) -> torch.Tensor:
    """Output projection + MLP half of the block."""
    x, ffn_act = _attn_out_act(x, attn, layer, config)
    return _ffn_down(x, ffn_act, layer, config)


def decoder_layer(x, layer, sin, cos, positions, config, attention_fn):
    q, k, v = _qkv_rope(x, layer, sin, cos, config)
    attn = attention_fn(q, k, v, positions)
    return _attn_out_mlp(x, attn, layer, config)


def _remat_layer(x, layer, sin, cos, positions, config, attention_fn):
    """``decoder_layer`` under ``config.remat_policy``, each checkpointed
    segment recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant).  "attn"/"attn_ffn" on the flash path checkpoint the
    parts before and after the flash call and leave the call between
    them: ``_FlashCore`` keeps its five residuals in its ctx, which is
    what the reference's policy saves by name, so the backward never
    re-runs the flash forward.  (Selective checkpointing alone cannot do
    this: it does not see inside an autograd Function.)  "attn_ffn" also
    keeps ``silu(gate)*up``: the down projection runs outside any
    segment, so autograd saves its input.  Without flash there is no
    flash residual to keep: "attn" is then "full", as in the reference,
    and so is "attn_ffn", which recomputes ``silu(gate)*up`` too (the
    reference keeps it; the math is the same)."""
    c = config
    policy = c.remat_policy
    context_fn = _remat_policy(c)

    def ckpt(fn, *args):
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)

    if policy in ("attn", "attn_ffn") and c.attention_impl == "flash":
        q, k, v = ckpt(_qkv_rope, x, layer, sin, cos, c)
        attn = attention_fn(q, k, v, positions)
        if policy == "attn":
            return ckpt(_attn_out_mlp, x, attn, layer, c)
        x, ffn_act = ckpt(_attn_out_act, x, attn, layer, c)
        return _ffn_down(x, ffn_act, layer, c)
    return ckpt(decoder_layer, x, layer, sin, cos, positions, c,
                attention_fn)


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------

def _tokens_on(tokens, params: Params, device: DeviceLike) -> torch.Tensor:
    device = resolve_device(device)
    check_on(params["embed_tokens"], device, "params")
    return torch.as_tensor(tokens, device=device).long()


def forward(params: Params, tokens, config: LlamaConfig,
            positions=None, device: DeviceLike = None) -> torch.Tensor:
    """Logits (B, S, V) for next-token prediction.  tokens: (B, S) ints.
    Runs on ``device`` (the card unless ``"cpu"``); params must be there.
    Differentiable: with ``config.remat``, a call whose layer weights
    require grad runs each layer under the remat policy
    (:func:`_remat_layer`)."""
    c = config
    if positions is not None and c.attention_impl != "dot":
        # The flash kernel masks on the raw row index, not positions —
        # packed or offset sequences would attend across boundaries.
        raise NotImplementedError(
            f"custom positions require attention_impl='dot' "
            f"(got {c.attention_impl!r})")
    tokens = _tokens_on(tokens, params, device)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device
                                 ).expand(tokens.shape)
        # Default layout: flash needs no positions (and checking them on
        # the card would sync once per layer).
        attn_positions = positions if c.attention_impl == "dot" else None
    else:
        positions = torch.as_tensor(positions, device=tokens.device)
        attn_positions = positions
    attention_fn = _get_attention_fn(c)
    layer_fn = decoder_layer
    if c.remat:
        _remat_policy(c)  # an unknown policy raises before any work
        # Only a differentiated call has anything to save or recompute;
        # an inference call skips the checkpoint machinery's host cost.
        if torch.is_grad_enabled() and any(
                w.requires_grad for w in params["layers"].values()):
            layer_fn = _remat_layer
    x = params["embed_tokens"].to(c.dtype)[tokens]
    sin, cos = rope_table(positions, c.head_dim, c.rope_theta)
    for layer in _layers(params):
        x = layer_fn(x, layer, sin, cos, attn_positions, c, attention_fn)
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    return matmul(x, _head(params, c))


def loss_fn(params: Params, batch: Dict[str, Any], config: LlamaConfig,
            device: DeviceLike = None) -> torch.Tensor:
    """Mean next-token cross-entropy.  batch: tokens (B, S), optional
    positions and loss_mask (B, S)."""
    tokens = _tokens_on(batch["tokens"], params, device)
    positions = batch.get("positions")
    if positions is None:
        # Full-length forward, then drop the last position's logits (the
        # reference keeps S a multiple of the flash tile this way).
        logits = forward(params, tokens, config, device=tokens.device)
        logits = logits[:, :-1]
    else:
        # Packed/offset positions: slice to S-1 so the last raw token
        # never becomes a key.
        positions = torch.as_tensor(positions, device=tokens.device)
        logits = forward(params, tokens[:, :-1], config,
                         positions=positions[:, :-1], device=tokens.device)
    targets = tokens[:, 1:]
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None]).squeeze(-1)
    nll = logz - gold
    mask = batch.get("loss_mask")
    if mask is None:
        return nll.mean()
    mask = torch.as_tensor(mask, device=tokens.device)[:, 1:].float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def default_optimizer(learning_rate: float = 3e-4):
    """The reference's optax chain ``clip_by_global_norm(1.0)`` then
    ``adamw(learning_rate, weight_decay=0.1)``, as
    ``train.optim.ClipAdamW``."""
    return ClipAdamW(learning_rate, weight_decay=0.1, clip_norm=1.0)


def _reject_optimizer_with_fused(optimizer, fused: bool) -> None:
    if fused and optimizer is not None:
        raise ValueError("fused=True replaces the optax chain; pass "
                         "hyperparameters, not an optimizer")


def init_train_state(config: LlamaConfig, seed: int = 0, optimizer=None,
                     fused: bool = False,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """``{"params", "opt_state", "step"}`` on ``device`` (the card unless
    ``"cpu"``).  Params are ``init_params(config, seed)`` in f32, as the
    reference keeps them (matmuls cast to ``config.dtype``).
    ``fused=True`` pairs with ``make_train_step(fused=True)``: the
    opt_state is a ``FusedAdamWState`` instead of the chain's state (same
    contents: a count and two moment trees)."""
    _reject_optimizer_with_fused(optimizer, fused)
    dev = resolve_device(device)
    params = init_params(config, seed=seed, dtype=torch.float32, device=dev)
    if fused:
        opt_state = fused_adamw_init(params)
    else:
        opt_state = (optimizer or default_optimizer()).init(params)
    return {"params": params, "opt_state": opt_state,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def value_and_grad(params: Params, batch: Dict[str, Any],
                   config: LlamaConfig, device: DeviceLike = None):
    """``(loss, grads)`` of :func:`loss_fn` through autograd; grads is a
    tree like ``params`` (the counterpart of ``jax.value_and_grad``)."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), batch, config,
                       device=device)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(config: LlamaConfig, optimizer=None,
                    donate: bool = True, fused: bool = False,
                    learning_rate: float = 3e-4,
                    device: DeviceLike = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``, metrics
    ``{"loss", "grad_norm", "step"}`` as device tensors (no host sync).

    The default updates with the optax chain's counterpart
    (``default_optimizer``); ``fused=True`` with the fused AdamW
    (``train/optim.py``: the same hyperparameters and clip semantics,
    fewer passes over the params).  ``donate=True`` updates params,
    moments and step IN PLACE (the counterpart of buffer donation: the
    input state must not be used again); ``donate=False`` leaves the
    input state untouched and returns new tensors.  The step runs on
    ``device`` (the card unless ``"cpu"``); the state must be there."""
    _reject_optimizer_with_fused(optimizer, fused)
    dev = resolve_device(device)
    if fused:
        hp = fused_hyperparams(learning_rate)
    elif optimizer is None:
        optimizer = default_optimizer(learning_rate)

    def step(state, batch):
        params = state["params"]
        check_on(params["embed_tokens"], dev, "state params")
        loss, grads = value_and_grad(params, batch, config, device=dev)
        if fused:
            params, opt_state, gnorm = fused_adamw_update(
                grads, state["opt_state"], params, inplace=donate, **hp)
        else:
            gnorm = global_norm(grads)
            updates, opt_state = optimizer.update(
                grads, state["opt_state"], params, inplace=donate)
            params = apply_updates(params, updates, inplace=donate)
        count = state["step"].add_(1) if donate else state["step"] + 1
        new_state = {"params": params, "opt_state": opt_state,
                     "step": count}
        return new_state, {"loss": loss, "grad_norm": gnorm,
                           "step": count.clone()}

    return _AnnotatedStep(step)


class _AnnotatedStep:
    """Runs each train step under ``torch.profiler.record_function(
    "train.step")``, so a profiler trace taken mid-training shows one
    ``train.step`` range per step (the counterpart of the reference's
    device annotation)."""

    __slots__ = ("_step",)

    def __init__(self, step: Callable):
        self._step = step

    def __call__(self, state, batch):
        with record_function("train.step"):
            return self._step(state, batch)


# ---------------------------------------------------------------------------
# KV-cache decode (serving path)
# ---------------------------------------------------------------------------

def init_kv_cache(config: LlamaConfig, batch: int, max_len: int,
                  dtype: Optional[torch.dtype] = None,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Slot-structured KV cache: (L, B, S, Hkv, D) per tensor."""
    c = config
    shape = (c.n_layers, batch, max_len, c.n_kv_heads, c.head_dim)
    dev = resolve_device(device)
    dt = dtype or c.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


@torch.no_grad()
def prefill_forward(params: Params, tokens: torch.Tensor,
                    lengths: torch.Tensor, config: LlamaConfig):
    """Causal forward over right-padded prompts for cache insertion.

    tokens: (G, P) right-padded prompts; lengths: (G,) real lengths.
    Plain attention within each prompt (no cache read).  Returns
    (last_logits (G, V) at each prompt's last real token, ks, vs) with
    ks/vs (L, G, P, Hkv, D).  K/V rows past a prompt's length are
    garbage that decode overwrites before it first attends them."""
    c = config
    G, P = tokens.shape
    dt = c.dtype
    x = params["embed_tokens"].to(dt)[tokens]
    positions = torch.arange(P, device=tokens.device).expand(G, P)
    sin, cos = rope_table(positions, c.head_dim, c.rope_theta)
    ks, vs = [], []
    for layer in _layers(params):
        q, k, v = _qkv_rope(x, layer, sin, cos, c)
        x = _attn_out_mlp(x, dot_attention(q, k, v, positions), layer, c)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    idx = (lengths.long() - 1).clamp_min(0)
    last = x[torch.arange(G, device=x.device), idx][:, None]  # (G, 1, H)
    last_logits = matmul(last, _head(params, c))[:, 0]
    return last_logits, torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def insert_prefill(cache: Dict[str, torch.Tensor], ks: torch.Tensor,
                   vs: torch.Tensor, slots) -> Dict[str, torch.Tensor]:
    """Write prefilled rows [0, P) of each group member into its slot.
    slots: (G,) ints; a negative slot drops that member (partial-group
    padding).  Writes the cache IN PLACE (a copy of the whole cache per
    prefill would double its memory traffic) and returns it."""
    P = ks.shape[2]
    slots = torch.as_tensor(slots).cpu().long()
    keep = (slots >= 0).nonzero().flatten()
    if keep.numel():
        dst = to_device(slots[keep], cache["k"].device)
        src = to_device(keep, ks.device)
        cache["k"][:, dst, :P] = ks[:, src].to(cache["k"].dtype)
        cache["v"][:, dst, :P] = vs[:, src].to(cache["v"].dtype)
    return cache


@torch.no_grad()
def forward_with_cache(params: Params, tokens: torch.Tensor,
                       positions: torch.Tensor,
                       cache: Dict[str, torch.Tensor], config: LlamaConfig):
    """Run T new tokens per slot against the cache.  tokens/positions:
    (B, T); a slot's new rows land at positions[:, 0] .. +T-1 (the start
    clamped so the T rows fit, as dynamic_update_slice does).  Writes the
    cache IN PLACE and returns (logits (B, T, V), cache)."""
    c = config
    B, T = tokens.shape
    dt = c.dtype
    S = cache["k"].shape[2]
    x = params["embed_tokens"].to(dt)[tokens]
    sin, cos = rope_table(positions, c.head_dim, c.rope_theta)
    scale = c.head_dim ** -0.5
    rows = positions[:, :1].long().clamp(0, S - T) + \
        torch.arange(T, device=tokens.device)
    bidx = torch.arange(B, device=tokens.device)[:, None]
    for i, layer in enumerate(_layers(params)):
        q, k, v = _qkv_rope(x, layer, sin, cos, c)
        ck, cv = cache["k"][i], cache["v"][i]
        ck[bidx, rows] = k.to(ck.dtype)
        cv[bidx, rows] = v.to(cv.dtype)
        attn = _cache_attend(q, ck, cv, positions, scale)
        x = _attn_out_mlp(x, attn, layer, c)
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    return matmul(x, _head(params, c)), cache

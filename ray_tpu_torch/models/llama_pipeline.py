"""Per-stage Llama functions for cross-process pipeline parallelism
(counterpart of ``ray_tpu/models/llama_pipeline.py``).

The GPipe schedule of ``parallel/pipeline.py`` runs all stages as one
SPMD program over a mesh.  Pipelines across processes (a stage per
process, activations over the wire) need the stage-local math alone:

- ``stage_slice(params, stage, n)``: the stage's parameter subtree
  (embedding on stage 0, an L/n block of layers each, norm and head on
  the last).
- ``make_stage_fwd`` / ``make_stage_fwd_loss``: the stage programs.
- :func:`stage_backward`: the backward recomputes at stage granularity:
  the stage re-runs its forward under autograd from the saved stage
  input, so only the *input* is kept per in-flight microbatch (GPipe
  memory M x input, not M x activations), as the reference's ``jax.vjp``
  at backward time does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from ..train.optim import tree_leaves, tree_unflatten
from .llama import (LlamaConfig, _get_attention_fn, _layers, _remat_layer,
                    _remat_policy, decoder_layer, matmul, rms_norm,
                    rope_table)

PyTree = Any


def check_pipeline_config(config: LlamaConfig, n_stages: int):
    if n_stages < 2:
        raise ValueError("cross-process pipeline needs >= 2 stages")
    if config.n_layers % n_stages:
        raise ValueError(
            f"{config.n_layers} layers not divisible by {n_stages} stages")
    if config.tie_embeddings:
        raise ValueError(
            "tie_embeddings shares one parameter between stage 0 "
            "(embedding) and the last stage (head); untie for "
            "cross-process pipeline")
    if config.moe_experts > 0:
        raise NotImplementedError(
            "MoE layers in cross-process pipeline stages: route the "
            "aux loss through the activation protocol first")
    if config.attention_impl == "ring":
        raise NotImplementedError(
            "ring attention needs a seq mesh axis inside the stage "
            "program; compose it via the stage mesh_spec instead")


def stage_slice(params: PyTree, stage: int, n_stages: int) -> PyTree:
    """The parameter subtree stage ``stage`` owns (views of ``params``).

    Slicing a fully-initialized tree keeps init numerics identical to
    the single-process model (parity tests depend on it).
    """
    L = next(iter(params["layers"].values())).shape[0]
    per = L // n_stages
    lo, hi = stage * per, (stage + 1) * per
    out: Dict[str, Any] = {
        "layers": {k: w[lo:hi] for k, w in params["layers"].items()}}
    if stage == 0:
        out["embed_tokens"] = params["embed_tokens"]
    if stage == n_stages - 1:
        out["final_norm"] = params["final_norm"]
        out["lm_head"] = params["lm_head"]
    return out


def _run_layers(x: torch.Tensor, layers: PyTree, config: LlamaConfig):
    """The stage's stacked layers over ``x`` (B, S, E), each under the
    config's remat policy when it has something to save."""
    c = config
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    sin, cos = rope_table(positions, c.head_dim, c.rope_theta)
    attn_positions = positions if c.attention_impl == "dot" else None
    layer_fn = decoder_layer
    if c.remat:
        _remat_policy(c)
        if torch.is_grad_enabled() and any(
                w.requires_grad for w in layers.values()):
            layer_fn = _remat_layer
    attention_fn = _get_attention_fn(c)
    for layer in _layers({"layers": layers}):
        x = layer_fn(x, layer, sin, cos, attn_positions, c, attention_fn)
    return x


def make_stage_fwd(config: LlamaConfig, first: bool) -> Callable:
    """``fwd(stage_params, inp) -> h_out``; inp is tokens (B, S) ints on
    stage 0, hidden states (B, S, E) downstream."""

    def fwd(sl: PyTree, inp: torch.Tensor) -> torch.Tensor:
        x = (sl["embed_tokens"].to(config.dtype)[inp.long()]
             if first else inp.to(config.dtype))
        return _run_layers(x, sl["layers"], config)

    return fwd


def make_stage_fwd_loss(config: LlamaConfig) -> Callable:
    """Last stage: ``fwd_loss(stage_params, h_in, tokens) -> loss``.

    Mirrors llama.loss_fn's full-length-forward-then-slice convention so
    pipeline loss == single-process loss.
    """
    c = config

    def fwd_loss(sl: PyTree, h_in: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
        x = _run_layers(h_in.to(c.dtype), sl["layers"], c)
        x = rms_norm(x, sl["final_norm"], c.norm_eps)
        logits = matmul(x, sl["lm_head"].to(c.dtype))[:, :-1]
        targets = tokens[:, 1:].long()
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None]).squeeze(-1)
        return (logz - gold).mean()

    return fwd_loss


def stage_backward(fwd: Callable, stage_params: PyTree,
                   inp: torch.Tensor, cotangent: torch.Tensor,
                   *extra: Any) -> Tuple[PyTree, torch.Tensor]:
    """The stage's backward by recomputation: re-run ``fwd(stage_params,
    inp, *extra)`` under autograd from the saved input and pull
    ``cotangent`` back.  Returns ``(param grads like stage_params, grad
    of inp)`` (None for integer tokens); for the loss stage pass
    ``cotangent = torch.ones(())``."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(stage_params)]
    x = inp.detach()
    if x.is_floating_point():
        x.requires_grad_()
    wrt: Sequence[torch.Tensor] = leaves + ([x] if x.requires_grad else [])
    with torch.enable_grad():
        out = fwd(tree_unflatten(stage_params, leaves), x, *extra)
        grads = torch.autograd.grad(out, wrt, cotangent)
    g_params = tree_unflatten(stage_params, list(grads[:len(leaves)]))
    return g_params, (grads[-1] if x.requires_grad else None)

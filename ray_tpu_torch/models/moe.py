"""Mixture-of-Experts FFN (counterpart of ``ray_tpu/models/moe.py``): a
GShard/Switch FFN with f32 softmax top-k routing, token-order expert
capacity and the Switch load-balancing loss.

The reference dispatches through a dense one-hot ``(T, E, C)`` tensor and
einsums, its TPU formulation.  At ``llama_moe_1b``'s train shape (T =
16,384 tokens, E = 8, C = 5,120) that tensor has 671 M elements, and its
dispatch and combine einsums do 2.7x the expert GEMMs' own work only to
copy rows.  :func:`moe_ffn` computes the same function by index: every
kept (token, k) owns one slot ``e * C + pos`` of the ``(E, C, D)`` expert
buffer, the dispatch copies each token's row into its slots and the
combine reads the rows back.  A one-hot product with f32 accumulation
returns each row exactly, so the expert inputs are the reference's bit
for bit, and the combine sums the same K nonzero products.  The one-hot
form stays as :func:`_moe_ffn_onehot`, the plain version the tests and
``chip_smoke.py`` hold :func:`moe_ffn` against; nothing else calls it.

Inside a model's manual region (``parallel/spmd.py``; ``region`` below)
the function keeps the reference's global view: capacity and positions
count the tokens of every batch rank, the expert buffer is summed over
the batch axes, each rank runs only its block of experts, and the aux
loss takes global means.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.device import DeviceLike, resolve_device
from ..parallel.mesh import mesh_shape
from ..parallel.spmd import (Region, gather_slices, local_slice,
                             rank_offset, sum_grads, sum_replicated)

Params = Dict[str, Any]
EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    hidden_size: int
    intermediate_size: int
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16


def init_moe_params(config: MoEConfig, seed: int = 0,
                    dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None) -> Params:
    """Router ``(D, E)`` and experts ``(E, D, H)`` / ``(E, H, D)``, the
    reference's shapes and truncated-normal fan-in init (``jax.random``'s
    numbers differ from ``torch``'s: parity tests carry weights across
    with ``convert.from_jax_params``)."""
    from .llama import init_dense

    c = config
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    E, D, H = c.n_experts, c.hidden_size, c.intermediate_size

    def dense(shape, fan_in):
        return init_dense(gen, shape, fan_in, dtype, device)

    return {"router": dense((D, E), D),
            "w_gate": dense((E, D, H), D),
            "w_up": dense((E, D, H), D),
            "w_down": dense((E, H, D), H)}


def moe_param_logical_axes() -> Dict[str, Tuple]:
    return {
        "router": (None, "expert"),
        "w_gate": ("expert", "embed", "mlp"),
        "w_up": ("expert", "embed", "mlp"),
        "w_down": ("expert", "mlp", "embed"),
    }


def capacity(n_tokens: int, config: MoEConfig) -> int:
    """Slots per expert for ``n_tokens`` tokens: the reference's
    expression, Python's ``round`` (half to even) included."""
    c = config
    return int(max(1, round(n_tokens * c.top_k / c.n_experts
                            * c.capacity_factor)))


def _route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """f32 softmax routing and renormalised top-k gates, shared by every
    form so they cannot drift.  Top-k orders as ``jax.lax.top_k`` does:
    by falling probability, the lower expert index first among equal
    ones (a stable sort).  The indices carry no gradient; the gates do."""
    logits = torch.matmul(xt.float(), router.float())
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    expert_idx = torch.sort(probs.detach(), dim=-1, descending=True,
                            stable=True).indices[:, :k]       # (T, K)
    gate_vals = probs.gather(-1, expert_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_idx


def _positions(expert_idx: torch.Tensor, n_experts: int):
    """Each (token, k)'s position in its expert's buffer: the count of
    earlier assignments to the same expert in the flat order ``t*K + k``
    (token order, not all first choices before second ones).  Returns
    the positions (T*K,) and the assignments per expert (E,)."""
    flat = expert_idx.reshape(-1)
    # Expert-major (E, T*K), so that each expert's count runs along a
    # contiguous last dim: a scan down the (T*K, E) one-hot's rows is E
    # threads long (6 ms a layer on an H100 at T*K = 32,768).
    onehot = (flat[None, :] == torch.arange(
        n_experts, device=flat.device)[:, None]).long()
    before = onehot.cumsum(1) - onehot
    return before.gather(0, flat[None, :])[0], onehot.sum(1)


def _expert_ffn(expert_in: torch.Tensor, params: Params,
                dt: torch.dtype) -> torch.Tensor:
    """The experts' SwiGLU on their buffers: (E, C, D) -> (E, C, D), each
    product accumulated in f32 and rounded to ``dt``."""
    h = torch.bmm(expert_in, params["w_gate"].to(dt))
    u = torch.bmm(expert_in, params["w_up"].to(dt))
    return torch.bmm(F.silu(h) * u, params["w_down"].to(dt))


def moe_ffn(x: torch.Tensor, params: Params, config: MoEConfig,
            region: Optional[Region] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux scalar f32), by index dispatch.

    aux is the Switch load-balancing loss ``E * sum_e frac_e * mean_prob_e``
    (``frac_e``: the share of tokens whose first choice is e, before
    drops); the model adds it to the loss scaled by ``moe_aux_weight``.
    A (token, k) past its expert's capacity is dropped: its gate weight
    is 0, and a token dropped in both choices gets 0 (the residual
    carries it).

    With ``region``, x holds this rank's rows of the batch (a contiguous
    block of the global token order), the router is whole and the expert
    weights hold this rank's block of experts; out is this rank's rows
    and aux the global one, the same on every rank."""
    out, aux, _ = _moe_ffn(x, params, config, region)
    return out, aux


def _moe_ffn(x, params, config, region=None):
    """:func:`moe_ffn`, also returning the expert inputs (E, C, D) (this
    rank's block of them in a region)."""
    c = config
    B, S, D = x.shape
    T = B * S
    E, K, dt = c.n_experts, c.top_k, c.dtype
    xt = x.reshape(T, D).to(dt)

    probs, gate_vals, expert_idx = _route(xt, params["router"], K)
    flat_idx = expert_idx.reshape(-1)
    pos, per_expert = _positions(expert_idx, E)
    first = F.one_hot(expert_idx[:, 0], E).float().sum(0)     # (E,)
    prob_sum = probs.sum(0)
    n_tokens = T
    if region is not None:
        mesh, batch = region.mesh, region.batch_axes
        sizes = mesh_shape(mesh)
        n_tokens = T * math.prod(sizes[a] for a in batch)
        pos = pos + rank_offset(per_expert, mesh, batch)[flat_idx]
        first = sum_replicated(first, mesh, batch)
        prob_sum = sum_replicated(prob_sum, mesh, batch)
    C = capacity(n_tokens, c)
    keep = pos < C
    slot = torch.where(keep, flat_idx * C + pos, E * C)

    # Dispatch: every kept (token, k) row into its slot; the dropped
    # ones into one spare row past the buffer, which is discarded.
    buf = xt.new_zeros(E * C + 1, D).index_copy(
        0, slot, xt.repeat_interleave(K, dim=0))
    expert_in = buf[:E * C].view(E, C, D)
    if region is not None:
        expert_in = local_slice(sum_replicated(expert_in, mesh, batch),
                                mesh, region.expert_axes, 0)
    n_local = params["w_gate"].shape[0]
    if n_local != expert_in.shape[0]:
        raise ValueError(f"{n_local} experts in the weights, "
                         f"{expert_in.shape[0]} in this rank's block")
    expert_out = _expert_ffn(expert_in, params, dt)
    if region is not None:
        expert_out = sum_grads(gather_slices(expert_out, mesh,
                                             region.expert_axes, 0),
                               mesh, batch)

    # Combine: each (token, k) reads its slot (a dropped one reads slot 0
    # at weight 0, as the one-hot combine weights every slot), the gate
    # weight rounded to dt as the reference's combine.astype(dt), the K
    # products summed in f32 and rounded once.
    rows = expert_out.reshape(E * C, D).index_select(
        0, torch.where(keep, slot, 0)).view(T, K, D)
    w = (gate_vals * keep.view(T, K)).to(dt)
    out = (w.float()[..., None] * rows.float()).sum(1).to(dt)
    aux = E * torch.sum(first / n_tokens * (prob_sum / n_tokens))
    return out.reshape(B, S, D).to(x.dtype), aux, expert_in


def _moe_ffn_onehot(x: torch.Tensor, params: Params, config: MoEConfig):
    """Line for line the reference's dense dispatch: a one-hot ``(T, E,
    C)`` dispatch tensor, the combine tensor beside it and einsums, on
    one device.  The plain version of :func:`moe_ffn`, for the tests and
    ``chip_smoke.py`` only.  Returns (out, aux, expert inputs (E, C, D)).
    Each einsum's operands share one dtype, and the product accumulates
    in f32 and is rounded to it, as the reference's ``_einsum``
    (``core/device.py`` turns off TF32 and reduced-precision reductions
    on the card)."""
    c = config
    B, S, D = x.shape
    T = B * S
    E, K = c.n_experts, c.top_k
    dt = c.dtype
    xt = x.reshape(T, D).to(dt)

    probs, gate_vals, expert_idx = _route(xt, params["router"], K)

    capacity_ = capacity(T, c)

    onehot = F.one_hot(expert_idx, E)                         # (T, K, E)
    flat = onehot.reshape(T * K, E)
    pos_in_expert = (flat.cumsum(0) - flat).reshape(T, K, E)
    pos = (pos_in_expert * onehot).sum(-1)                    # (T, K)
    keep = pos < capacity_

    dispatch = torch.zeros((T, E, capacity_), dtype=torch.float32,
                           device=x.device)
    t_idx = torch.arange(T, device=x.device)[:, None].expand(T, K)
    dispatch = dispatch.index_put(
        (t_idx.reshape(-1), expert_idx.reshape(-1),
         pos.clamp(0, capacity_ - 1).reshape(-1)),
        keep.float().reshape(-1), accumulate=True)
    gate_te = torch.zeros((T, E), dtype=torch.float32,
                          device=x.device).index_put(
        (t_idx.reshape(-1), expert_idx.reshape(-1)),
        (gate_vals * keep).reshape(-1), accumulate=True)
    combine = dispatch * gate_te[:, :, None]

    expert_in = torch.einsum("tec,td->ecd", dispatch.to(dt), xt)

    h = torch.einsum("ecd,edh->ech", expert_in, params["w_gate"].to(dt))
    u = torch.einsum("ecd,edh->ech", expert_in, params["w_up"].to(dt))
    act = F.silu(h) * u
    expert_out = torch.einsum("ech,ehd->ecd", act, params["w_down"].to(dt))

    out = torch.einsum("tec,ecd->td", combine.to(dt), expert_out)

    top1 = F.one_hot(expert_idx[:, 0], E).float()
    frac_tokens = top1.mean(0)
    mean_prob = probs.mean(0)
    aux = E * torch.sum(frac_tokens * mean_prob)
    return out.reshape(B, S, D).to(x.dtype), aux, expert_in


def moe_ffn_reference(x: torch.Tensor, params: Params, config: MoEConfig
                      ) -> torch.Tensor:
    """No-drop oracle for parity tests at small shapes: every token
    visits its top-k experts."""
    c = config
    B, S, D = x.shape
    dt = c.dtype
    xt = x.reshape(-1, D).to(dt)
    _probs, gate_vals, expert_idx = _route(xt, params["router"], c.top_k)

    def per_expert(e):
        h = xt @ params["w_gate"][e].to(dt)
        u = xt @ params["w_up"][e].to(dt)
        return (F.silu(h) * u) @ params["w_down"][e].to(dt)

    all_out = torch.stack([per_expert(e) for e in range(c.n_experts)])
    out = torch.zeros_like(xt, dtype=torch.float32)
    rows = torch.arange(xt.shape[0], device=x.device)
    for k in range(c.top_k):
        picked = all_out[expert_idx[:, k], rows]
        out = out + gate_vals[:, k:k + 1] * picked.float()
    return out.reshape(B, S, D).to(x.dtype)

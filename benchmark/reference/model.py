"""The plain reference: a decoder-only transformer as Mistral-7B-v0.3 and
InternLM2 publish it (RMSNorm, rotary position embedding with the
rotate-half convention, grouped-query causal attention, SwiGLU, no
biases, an untied head), in float32 with TF32 off.

It imports nothing of the program and calls none of its kernels: plain
``torch`` operations only.  Attention runs in blocks of query rows, so
that a long sequence never holds its whole score matrix.  Weights come
as the harness's ``weights.make_params`` makes them ((in, out) matrices
stacked on a leading layer axis); a layer's weights are cast to float32
when it runs.

``fp8=True`` is the control: every matmul of the layers and the head
reads operands rounded to float8 e4m3 (one scale per row of the input
and per column of the weight), the step below the bfloat16 that the
configurations state.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def set_precision() -> None:
    """float32 means float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale along ``dim``, back in
    float32 (the gradient passes straight through)."""
    scale = t.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) \
        / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


def mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        x, w = round_fp8(x, -1), round_fp8(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, heads, D); pos: (S,) absolute positions."""
    D = x.shape[-1]
    inv = theta ** (-torch.arange(0, D // 2, dtype=torch.float32,
                                  device=x.device) / (D // 2))
    ang = pos.float()[:, None] * inv
    sin, cos = ang.sin()[None, :, None], ang.cos()[None, :, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, block: int = 1024) -> torch.Tensor:
    """Causal grouped-query attention.  q: (B, S, Hq, D); k, v: (B, S,
    Hkv, D); query rows in blocks, each against the keys it may see."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)  # B Hkv G S D
    kt = k.permute(0, 2, 1, 3)                               # B Hkv S D
    vt = v.permute(0, 2, 1, 3)
    outs = []
    for i0 in range(0, S, block):
        i1 = min(S, i0 + block)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg[:, :, :, i0:i1],
                         kt[:, :, :i1]) * D ** -0.5
        rows = torch.arange(i0, i1, device=q.device)[:, None]
        cols = torch.arange(i1, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        outs.append(torch.einsum("bhgqk,bhkd->bhgqd", s.softmax(-1),
                                 vt[:, :, :i1]))
    o = torch.cat(outs, dim=3)                               # B Hkv G S D
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq * D)


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: Dict,
          pos: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    B, S, _ = x.shape
    Hq, Hkv, D = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    h = rms_norm(x, w["attn_norm"], eps)
    q = rope(mm(h, w["wq"], fp8).reshape(B, S, Hq, D), pos, theta)
    k = rope(mm(h, w["wk"], fp8).reshape(B, S, Hkv, D), pos, theta)
    v = mm(h, w["wv"], fp8).reshape(B, S, Hkv, D)
    x = x + mm(attention(q, k, v), w["wo"], fp8)
    h = rms_norm(x, w["mlp_norm"], eps)
    a = torch.nn.functional.silu(mm(h, w["w_gate"], fp8)) \
        * mm(h, w["w_up"], fp8)
    return x + mm(a, w["w_down"], fp8)


def layer_weights(params: Dict, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights in float32 (each leaf is either stacked
    (L, ...) or a list of per-layer tensors)."""
    return {k: v[i].float() for k, v in params["layers"].items()}


def hidden(params: Dict, tokens: torch.Tensor, cfg: Dict,
           fp8: bool = False, remat: bool = False) -> torch.Tensor:
    """The final-normed hidden states (B, S, H) of ``tokens`` (B, S).
    ``remat`` recomputes each layer in the backward (memory for time)."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = params["embed_tokens"][tokens].float()
    for i in range(cfg["n_layers"]):
        w = layer_weights(params, i)
        if remat:
            x = checkpoint(layer, x, w, cfg, pos, fp8, use_reentrant=False)
        else:
            x = layer(x, w, cfg, pos, fp8)
    return rms_norm(x, params["final_norm"].float(), cfg["norm_eps"])


def logits(params: Dict, h: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    return mm(h, params["lm_head"].float(), fp8)


def loss(params: Dict, tokens: torch.Tensor, cfg: Dict, fp8: bool = False,
         mask: Optional[torch.Tensor] = None, remat: bool = True,
         rows: int = 2048) -> torch.Tensor:
    """Mean next-token cross-entropy over the (B, S-1) targets (over the
    targets where ``mask`` is True, if given), the head and the softmax
    in blocks of ``rows`` positions."""
    h = hidden(params, tokens, cfg, fp8, remat)[:, :-1]
    targets = tokens[:, 1:]
    total = h.new_zeros(())
    for i0 in range(0, h.shape[1], rows):
        lg = logits(params, h[:, i0:i0 + rows], fp8)
        nll = torch.logsumexp(lg, -1) - lg.gather(
            -1, targets[:, i0:i0 + rows, None])[..., 0]
        if mask is not None:
            nll = nll * mask[:, i0:i0 + rows]
        total = total + nll.sum()
    count = mask.sum() if mask is not None else targets.numel()
    return total / count

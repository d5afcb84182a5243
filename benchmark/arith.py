"""The benchmark's yardstick arithmetic, frozen here so that no later
change to the program can move it: peaks of one H100, parameter and
byte counts of a configuration, model FLOPs of a train step and of a
prefill, the least bytes of a decode step, and the flash kernels'
operation counts.

Each function that is a copy names its original.  The copies keep the
originals' arithmetic; they take the configuration as a plain dict (the
file under ``benchmark/configs/``), not as the program's config class.
"""

from __future__ import annotations

from typing import Dict, Tuple

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates (the program's
# ``observability/device.py`` ``peak_bf16_flops`` gives the same 989e12).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12
HBM_BYTES = 80e9


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS,
          bw: float = PEAK_HBM_BYTES_S) -> Tuple[float, str]:
    """The least time (ms) of a call that needs ``flops`` and ``nbytes``,
    and which of the two bounds it (copy of ``chip_smoke.py`` ``bound``'s
    rule: the larger of operations over peak and bytes over bandwidth)."""
    t_flops = flops / peak * 1e3
    t_bytes = nbytes / bw * 1e3
    return (t_flops, "flops") if t_flops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------- params

def layer_matmul_params(cfg: Dict) -> int:
    """Matmul weights of one dense decoder layer: q, k, v, o and the
    SwiGLU gate, up and down projections."""
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    q_dim = cfg["n_heads"] * cfg["head_dim"]
    kv_dim = cfg["n_kv_heads"] * cfg["head_dim"]
    return H * q_dim + 2 * H * kv_dim + q_dim * H + 3 * H * I


def param_count(cfg: Dict) -> int:
    """Every parameter: embedding, per layer the matmuls and two norm
    scales, the final norm, and the head unless it is tied."""
    H, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["n_layers"]
    head = 0 if cfg.get("tie_embeddings") else V * H
    return V * H + L * (layer_matmul_params(cfg) + 2 * H) + H + head


def flop_params(cfg: Dict) -> int:
    """Parameters that a token's forward multiplies through: the layers'
    matmul weights and the LM head (the embedding is a lookup, the
    norms are elementwise)."""
    return (cfg["n_layers"] * layer_matmul_params(cfg)
            + cfg["vocab_size"] * cfg["hidden_size"])


def kv_bytes_per_token(cfg: Dict, elem: int = 2) -> int:
    """K and V of every layer for one token, ``elem`` bytes a value."""
    return 2 * cfg["n_layers"] * cfg["n_kv_heads"] * cfg["head_dim"] * elem


def pool_reckoning(cfg: Dict, n_blocks: int, block_size: int = 16):
    """Copy of ``chip_smoke.py`` ``pool_reckoning``: the paged pool from
    the config, K and V, every layer, bf16 values, or 8-bit values plus
    one f32 scale a row.  Returns (rows a block, {kv_quant: bytes})."""
    rows = 2 * cfg["n_layers"] * block_size * cfg["n_kv_heads"]
    return rows, {None: n_blocks * rows * cfg["head_dim"] * 2,
                  "int8": n_blocks * rows * (cfg["head_dim"] + 4),
                  "fp8": n_blocks * rows * (cfg["head_dim"] + 4)}


def l3_train_reckoning(cfg: Dict, n_params: int, B: int, S: int):
    """Copy of ``chip_smoke.py`` ``l3_train_reckoning``: bytes the dense
    train step (fused AdamW, remat "attn", bf16 compute, f32 params and
    moments) should need at its peak.  Returns (state, backward, update)
    bytes."""
    T, H = B * S, cfg["hidden_size"]
    q_dim = cfg["n_heads"] * cfg["head_dim"]
    kv_dim = cfg["n_kv_heads"] * cfg["head_dim"]
    layer_params = n_params - 2 * cfg["vocab_size"] * H - H
    state = 16 * n_params
    kept = cfg["n_layers"] * T * (4 * H + 2 * (2 * q_dim + 2 * kv_dim)
                                  + 4 * cfg["n_heads"])
    ffn = 2 * 4 * 2 * T * cfg["intermediate_size"]
    head = T * cfg["vocab_size"] * (2 + 4 + 4 + 2)
    backward = state + 4 * layer_params + kept + ffn + head
    return state, backward, state + 12 * n_params


# ------------------------------------------------------------- attention

def causal_pairs(S: int) -> int:
    """(row, key) pairs causal attention over S positions needs."""
    return S * (S + 1) // 2


def visible_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """Copy of ``chip_smoke.py`` ``visible_pairs`` (closed form)."""
    if not causal:
        return Sq * Sk
    if Sq <= Sk:
        return causal_pairs(Sq)
    return causal_pairs(Sk) + (Sq - Sk) * Sk


def attention_cost(B, Hq, Sq, Sk, D, causal, elem=2,
                   peak=PEAK_BF16_FLOPS, kv_heads=None):
    """Copy of ``chip_smoke.py`` ``attention_cost``: FLOP and bytes one
    flash forward call needs (q, k, v read once, o and lse written
    once), and its bound (ms, "flops"|"bytes") at ``peak``."""
    Hkv = kv_heads or Hq
    flops = 4.0 * B * Hq * D * visible_pairs(Sq, Sk, causal)
    nbytes = (elem * B * D * (2 * Hq * Sq + 2 * Hkv * Sk)
              + 4.0 * B * Hq * Sq)
    return (flops, nbytes) + bound(flops, nbytes, peak)


def attention_bwd_cost(B, H, Sq, Sk, D, causal, elem=2,
                       peak=PEAK_BF16_FLOPS, suffix=""):
    """Copy of ``chip_smoke.py`` ``attention_bwd_cost``: FLOP and bytes
    of what the dq kernel (with its delta pre-pass, 6 D-products a pair)
    and the dk/dv kernel (8) compute.  {name: (flops, bytes, ms, by)}."""
    pairs = visible_pairs(Sq, Sk, causal)
    out = {}
    flops = 6.0 * B * H * D * pairs + 2.0 * B * H * Sq * D
    nbytes = (elem * B * H * D * (3 * Sq + 2 * Sk) + 4.0 * B * H * Sq * 2
              + 4.0 * B * H * Sq * D)
    out["flash_bwd_dq" + suffix] = (flops, nbytes) + bound(flops, nbytes,
                                                           peak)
    flops = 8.0 * B * H * D * pairs
    nbytes = (elem * B * H * D * (2 * Sq + 2 * Sk) + 4.0 * B * H * Sq * 2
              + 8.0 * B * H * Sk * D)
    out["flash_bwd_dkdv" + suffix] = (flops, nbytes) + bound(flops, nbytes,
                                                             peak)
    return out


def f32_bound_ms(kernel, B, H, S, D, causal):
    """Copy of ``tools/kernel_ab.py`` ``f32_bound_ms``: the simple
    family's least time at the f32 peak (4, 6 + delta, 8 D-products a
    pair for B1s, B2s, B3s)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    units = {"flash_fwd_simple": 4, "flash_bwd_dq_simple": 6,
             "flash_bwd_dkdv_simple": 8}[kernel]
    flops = units * B * H * D * pairs + (
        2 * B * H * S * D if kernel == "flash_bwd_dq_simple" else 0)
    return flops / PEAK_F32_FLOPS * 1e3


def flash_need_ms(B, Hq, Hkv, S, D) -> Dict[str, float]:
    """The least time (ms) of one causal flash forward and of one causal
    flash backward (the dq and dk/dv kernels together) at 989 TFLOP/s or
    3.35 TB/s, whichever is larger.  The backward needs five products a
    visible pair, 10 D-FLOP (S recomputed, dP, dV, dQ, dK): what the
    inputs need, not the 14 that the two kernels compute between them
    (``attention_bwd_cost`` counts those), so a backward that stops
    computing S and dP twice shows as a gain."""
    pairs = visible_pairs(S, S, True)
    fwd = attention_cost(B, Hq, S, S, D, True, kv_heads=Hkv)[2]
    bwd_flops = 10.0 * B * Hq * D * pairs + 2.0 * B * Hq * S * D
    # q, k, v, o, do, lse read once; dq, dk, dv written once (bf16 in,
    # gradients at the inputs' width).
    bwd_bytes = 2.0 * B * D * (3 * Hq * S + 2 * Hkv * S) + 4.0 * B * Hq * S \
        + 2.0 * B * D * (Hq * S + 2 * Hkv * S)
    return {"fwd": fwd, "bwd": bound(bwd_flops, bwd_bytes)[0]}


# ------------------------------------------------------------ model FLOPs

def train_step_flops(cfg: Dict, B: int, S: int) -> float:
    """Model FLOPs of one train step over a (B, S) batch: 6 FLOP a token
    for each matmul parameter and the head, and causal attention at 3 x
    the forward's 4 D-FLOP a visible pair and query head.  Nothing that
    remat recomputes is counted."""
    q_dim = cfg["n_heads"] * cfg["head_dim"]
    attn_fwd = 4.0 * q_dim * causal_pairs(S) * cfg["n_layers"]
    return 6.0 * flop_params(cfg) * B * S + 3.0 * attn_fwd * B


def prefill_flops(cfg: Dict, P: int) -> float:
    """Model FLOPs of prefilling one prompt of P real tokens: the layers'
    matmuls for every token, causal attention over the prompt, and the
    head for its last token only (what the engine computes logits for)."""
    q_dim = cfg["n_heads"] * cfg["head_dim"]
    H, V = cfg["hidden_size"], cfg["vocab_size"]
    layers = 2.0 * cfg["n_layers"] * layer_matmul_params(cfg) * P
    attn = 4.0 * q_dim * causal_pairs(P) * cfg["n_layers"]
    return layers + attn + 2.0 * H * V


def decode_step_bytes(cfg: Dict, contexts, elem: int = 2) -> float:
    """Least bytes of one decode step: every matmul weight and the head
    read once (``elem`` bytes), and for each active request the K/V of
    the positions it attends (``contexts``: keys attended per request)
    read once and its new K/V row written once."""
    weights = flop_params(cfg) * elem
    kv = kv_bytes_per_token(cfg, elem)
    return weights + kv * (sum(contexts) + len(contexts))


def decode_step_flops(cfg: Dict, contexts) -> float:
    q_dim = cfg["n_heads"] * cfg["head_dim"]
    return sum(2.0 * flop_params(cfg) + 4.0 * q_dim * c * cfg["n_layers"]
               for c in contexts)

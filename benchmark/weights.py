"""Weights from the run's seed, made on the device in a few large calls.

The same function hands the weights to the program and, after the
window, makes them again for the plain reference: the reference takes
nothing that the program made.  Leaves follow the layout the program
takes (``embed_tokens`` (V, H); each layer weight stacked on a leading
L axis, stored as (in, out) so that ``x @ w`` applies it; the norm
scales at one; an untied ``lm_head`` (H, V)).  A weight is normal with
standard deviation fan_in ** -0.5, drawn in the dtype it is served in
by a ``torch.Generator`` on the device.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

# Per-layer leaves: (name, shape after L, fan-in or None for a norm).
_LAYER = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up",
          "w_down")


def leaf_specs(cfg: Dict) -> Iterator[Tuple[str, tuple, int]]:
    """(path, shape, fan_in) of every leaf in the order they are drawn;
    fan_in 0 marks a norm scale (ones)."""
    H, V, L, I = (cfg["hidden_size"], cfg["vocab_size"], cfg["n_layers"],
                  cfg["intermediate_size"])
    q = cfg["n_heads"] * cfg["head_dim"]
    kv = cfg["n_kv_heads"] * cfg["head_dim"]
    shapes = {"attn_norm": ((H,), 0), "wq": ((H, q), H), "wk": ((H, kv), H),
              "wv": ((H, kv), H), "wo": ((q, H), q), "mlp_norm": ((H,), 0),
              "w_gate": ((H, I), H), "w_up": ((H, I), H),
              "w_down": ((I, H), I)}
    yield "embed_tokens", (V, H), H
    for name in _LAYER:
        shape, fan_in = shapes[name]
        yield f"layers.{name}", (L, *shape), fan_in
    yield "final_norm", (H,), 0
    if not cfg.get("tie_embeddings"):
        yield "lm_head", (H, V), H


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def iter_leaves(cfg: Dict, seed: int, dtype: torch.dtype, device
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Each leaf in turn, drawn from one generator: a caller may keep
    them or drop each one after use."""
    g = generator(seed, device)
    for path, shape, fan_in in leaf_specs(cfg):
        if fan_in == 0:
            yield path, torch.ones(shape, dtype=dtype, device=device)
            continue
        t = torch.empty(shape, dtype=dtype, device=device)
        t.normal_(0.0, fan_in ** -0.5, generator=g)
        yield path, t


def make_params(cfg: Dict, seed: int, dtype: torch.dtype, device) -> Dict:
    """Every leaf, nested as the program takes them."""
    params: Dict = {"layers": {}}
    for path, t in iter_leaves(cfg, seed, dtype, device):
        if path.startswith("layers."):
            params["layers"][path[len("layers."):]] = t
        else:
            params[path] = t
    return params


def leaf(params: Dict, path: str) -> torch.Tensor:
    if path.startswith("layers."):
        return params["layers"][path[len("layers."):]]
    return params[path]

"""Carry weights between the JAX package and the port, through numpy.

``from_jax_params`` takes the JAX params pytree (nested dicts of arrays,
e.g. ``jax.tree.map(np.asarray, params)``) and returns the same nested
dict of torch tensors: same keys, same stacked ``(L, ...)`` layout, same
values bit for bit.  ``to_numpy`` goes back.  ``jax.random`` and
``torch`` give different numbers from one seed, so the parity tests
initialise once in JAX and convert.

bf16 arrays (numpy's ``bfloat16`` extension dtype) are carried by their
bit pattern.  numpy has no bf16 of its own, so ``to_numpy`` widens a
bf16 tensor to float32, which is exact.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device

_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


def _to_tensor(x: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unsupported array dtype {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_params(tree: Any, device: DeviceLike = None) -> Any:
    """JAX/numpy pytree (nested dicts) -> the same nesting of tensors on
    ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _to_tensor(node, dev)

    return walk(tree)


def to_numpy(params: Any) -> Any:
    """Nested dict of tensors -> the same nesting of numpy arrays on the
    host (bf16 widened to float32)."""
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()

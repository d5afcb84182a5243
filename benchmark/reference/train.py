"""The reference's training steps: the plain model's loss and gradients
(``model.loss``, autograd, each layer recomputed in the backward) and
AdamW after a clip by global norm, as the configurations' optimizer
states it: ``g /= max(1, |g| / clip)``; ``mu = b1 mu + (1 - b1) g``;
``nu = b2 nu + (1 - b2) g^2``; ``p -= lr (mu / (1 - b1^t) /
(sqrt(nu / (1 - b2^t)) + eps) + wd p)`` on every leaf.

It follows the program's first steps from the same weights (made again
from the seed) and the same rows, and reports what the harness compares:
each step's loss and pre-clip gradient norm, each leaf's norm of the
first clipped gradient, and each leaf's norm of the change after the
steps.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from . import model

Leaves = Dict[str, List[torch.Tensor]]


def _trainable(params: Dict) -> Dict:
    """The weights as float32 leaves that take gradients, each layer
    weight as a list of per-layer tensors."""
    out = {"layers": {}}
    for k, v in params.items():
        if k == "layers":
            for name, stack in v.items():
                out["layers"][name] = [
                    t.float().clone().requires_grad_() for t in stack.unbind(0)]
        else:
            out[k] = v.float().clone().requires_grad_()
    return out


def leaf_paths(params: Dict) -> Dict[str, List[torch.Tensor]]:
    """Leaf path -> its tensors (one, or a layer weight's L)."""
    out = {}
    for k, v in params.items():
        if k == "layers":
            for name, ts in v.items():
                out[f"layers.{name}"] = list(ts)
        else:
            out[k] = [v]
    return out


def norm(ts: List[torch.Tensor]) -> float:
    return math.sqrt(sum(float(t.detach().double().square().sum())
                         for t in ts))


def follow(params: Dict, rows: torch.Tensor, cfg: Dict, opt: Dict,
           fp8: bool = False, mask: Optional[torch.Tensor] = None) -> Dict:
    """``len(rows)`` steps, one row batch each (``rows``: (steps, B, S)
    token ids on the device).  ``params`` are the initial weights (kept
    unchanged).  ``mask`` (B, S-1) restricts the loss to some targets
    (a planted fault)."""
    model.set_precision()
    p = _trainable(params)
    leaves = leaf_paths(p)
    flat = [t for ts in leaves.values() for t in ts]
    mu = [torch.zeros_like(t) for t in flat]
    nu = [torch.zeros_like(t) for t in flat]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd, clip = opt["learning_rate"], opt["weight_decay"], opt["clip_norm"]
    losses, gnorms, first = [], [], None
    for t, batch in enumerate(rows, start=1):
        for x in flat:
            x.grad = None
        loss = model.loss(p, batch, cfg, fp8=fp8, mask=mask)
        loss.backward()
        g = [x.grad for x in flat]
        gnorm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(x) for x in g]))
        div = torch.clamp(gnorm / clip, min=1.0)
        g = [x.div_(div) for x in g]
        losses.append(float(loss.detach()))
        gnorms.append(float(gnorm))
        if t == 1:
            it = iter(g)
            first = {path: norm([next(it) for _ in ts])
                     for path, ts in leaves.items()}
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        with torch.no_grad():
            for x, gi, m, v in zip(flat, g, mu, nu):
                m.mul_(b1).add_(gi, alpha=1 - b1)
                v.mul_(b2).addcmul_(gi, gi, value=1 - b2)
                u = (m / c1) / ((v / c2).sqrt() + eps) + wd * x
                x.sub_(lr * u)
        del g, loss
    with torch.no_grad():
        change = {}
        for path, ts in leaves.items():
            start = (params["layers"][path[len("layers."):]].unbind(0)
                     if path.startswith("layers.") else [params[path]])
            change[path] = norm([a - b.float() for a, b in zip(ts, start)])
    return {"losses": losses, "grad_norms": gnorms, "first_grad": first,
            "change": change}

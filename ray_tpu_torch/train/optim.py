"""AdamW for the port's train step (counterpart of
``ray_tpu/train/optim.py`` and of the optax chain that
``models.llama.default_optimizer`` builds).

Two optimizers with the same math, over params that are nested dicts of
tensors (the JAX pytree's layout), with ``torch._foreach_*`` ops over
the leaves:

- :class:`ClipAdamW` is the optax chain ``clip_by_global_norm(clip_norm)``
  then ``adamw(learning_rate, weight_decay)``, transformation by
  transformation in optax's order: clip, scale by Adam, add decayed
  weights, scale by ``-learning_rate``; :func:`apply_updates` adds the
  updates to the params.
- :func:`fused_adamw_update` is the reference's fused step: the chain's
  math (one shared body, :func:`_adamw_direction`) with the scale by
  ``-learning_rate`` folded into the params' update, one pass fewer.

Both keep optax's semantics exactly: the clip scales only when the
global norm is at or above ``clip_norm`` (a select of the divisor, not a
``min``), the count is an int32 tensor, bias correction is
``1 - b**count``, weight decay is decoupled and applied to the old
params, and the reported grad norm is the pre-clip one.  With
``inplace=True`` moments and params are updated in place (the train
step's counterpart of buffer donation); otherwise the inputs are left
untouched and new tensors are returned.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple

import torch

Tree = Any


# ---------------------------------------------------------------------------
# Trees of tensors: nested dicts (leaves in sorted-key order, as JAX's),
# lists and tuples (NamedTuples included)
# ---------------------------------------------------------------------------

def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_unflatten(like: Tree, leaves: List[Any]) -> Tree:
    """The structure of ``like`` with ``leaves`` (in tree_leaves order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[build(n) for n in node])
        if isinstance(node, (list, tuple)):
            return type(node)(build(n) for n in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree: Tree) -> Tree:
    return tree_unflatten(tree, [fn(t) for t in tree_leaves(tree)])


def _norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    norms = torch._foreach_norm([t.float() for t in leaves])
    return torch.linalg.vector_norm(torch.stack(norms))


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (optax's)."""
    return _norm(tree_leaves(tree))


def _zeros_like(params: Tree) -> Tree:
    return tree_map(torch.zeros_like, params)


def _count_zero(params: Tree) -> torch.Tensor:
    device = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def _clip(grads: List[torch.Tensor], clip_norm: float):
    """optax.clip_by_global_norm: ``g / (norm / clip_norm)`` when the norm
    is at or above ``clip_norm``, ``g`` untouched below it (the divisor
    is selected, so an unclipped step divides by exactly 1).  Returns
    (new leaves, pre-clip norm)."""
    gnorm = _norm(grads)
    divisor = torch.where(gnorm < clip_norm, torch.ones_like(gnorm),
                          gnorm / clip_norm)
    return torch._foreach_div(grads, divisor), gnorm


def _moments(g, mu, nu, b1, b2, inplace):
    """mu = b1*mu + (1-b1)*g, nu = b2*nu + (1-b2)*g**2."""
    if not inplace:
        mu = [t.clone() for t in mu]
        nu = [t.clone() for t in nu]
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, g, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
    return mu, nu


def _bias_corrections(count: torch.Tensor, b1: float, b2: float):
    c = count.float()
    return 1.0 - torch.pow(b1, c), 1.0 - torch.pow(b2, c)


def _adamw_direction(grads: Tree, state, params: Tree, b1: float, b2: float,
                     eps: float, weight_decay: float, clip_norm: float,
                     inplace: bool):
    """The AdamW step before the learning rate, in optax's order (clip,
    scale_by_adam, add_decayed_weights):

        g   = clip(g)                        (one global reduction)
        mu  = b1*mu + (1-b1)*g
        nu  = b2*nu + (1-b2)*g**2
        u   = mu/c1 / (sqrt(nu/c2) + eps) + wd*p

    Returns ``(u, new_state, grad_norm)``: ``u`` as leaves, the new state
    of ``state``'s type, and the PRE-clip norm."""
    g, gnorm = _clip(tree_leaves(grads), clip_norm)
    mu, nu = _moments(g, tree_leaves(state.mu), tree_leaves(state.nu), b1,
                      b2, inplace)
    count = state.count.add_(1) if inplace else state.count + 1
    c1, c2 = _bias_corrections(count, b1, b2)
    denom = torch._foreach_div(nu, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    u = torch._foreach_div(mu, c1)
    torch._foreach_div_(u, denom)
    torch._foreach_add_(u, tree_leaves(params), alpha=weight_decay)
    new_state = type(state)(count=count, mu=tree_unflatten(state.mu, mu),
                            nu=tree_unflatten(state.nu, nu))
    return u, new_state, gnorm


# ---------------------------------------------------------------------------
# The optax chain: clip_by_global_norm -> adamw
# ---------------------------------------------------------------------------

class ClipAdamWState(NamedTuple):
    count: torch.Tensor  # int32 step counter (optax's ScaleByAdamState)
    mu: Tree
    nu: Tree


class ClipAdamW:
    """``init(params)`` / ``update(grads, state, params)`` like an optax
    GradientTransformation; :func:`apply_updates` applies the result."""

    def __init__(self, learning_rate: float = 3e-4, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, clip_norm: float = 1.0):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params: Tree) -> ClipAdamWState:
        return ClipAdamWState(count=_count_zero(params),
                              mu=_zeros_like(params),
                              nu=_zeros_like(params))

    def update(self, grads: Tree, state: ClipAdamWState, params: Tree,
               inplace: bool = False):
        """Returns ``(updates, new_state)``; ``inplace`` updates the
        state's moments in place."""
        u, new_state, _ = _adamw_direction(
            grads, state, params, self.b1, self.b2, self.eps,
            self.weight_decay, self.clip_norm, inplace)
        torch._foreach_mul_(u, -self.learning_rate)  # scale_by_learning_rate
        return tree_unflatten(grads, u), new_state


def apply_updates(params: Tree, updates: Tree,
                  inplace: bool = False) -> Tree:
    """optax.apply_updates: params + updates (in place if asked)."""
    p, u = tree_leaves(params), tree_leaves(updates)
    if inplace:
        torch._foreach_add_(p, u)
        return params
    return tree_unflatten(params, torch._foreach_add(p, u))


# ---------------------------------------------------------------------------
# The fused step
# ---------------------------------------------------------------------------

class FusedAdamWState(NamedTuple):
    count: torch.Tensor  # int32 step counter (optax-compatible semantics)
    mu: Tree
    nu: Tree


def fused_adamw_init(params: Tree) -> FusedAdamWState:
    return FusedAdamWState(count=_count_zero(params),
                           mu=_zeros_like(params), nu=_zeros_like(params))


def fused_adamw_update(grads: Tree, state: FusedAdamWState, params: Tree,
                       *, learning_rate: float = 3e-4, b1: float = 0.9,
                       b2: float = 0.999, eps: float = 1e-8,
                       weight_decay: float = 0.1, clip_norm: float = 1.0,
                       inplace: bool = False) -> tuple:
    """One fused step; returns ``(new_params, new_state, grad_norm)``
    (grad_norm is the PRE-clip norm, matching the train-step metric): the
    chain's math, with the learning-rate scale folded into the params'
    update, ``p -= lr * u`` (see :func:`_adamw_direction`)."""
    u, new_state, gnorm = _adamw_direction(grads, state, params, b1, b2,
                                           eps, weight_decay, clip_norm,
                                           inplace)
    p = tree_leaves(params)
    if inplace:
        torch._foreach_add_(p, u, alpha=-learning_rate)
        new_params = params
    else:
        new_params = tree_unflatten(
            params, torch._foreach_add(p, u, alpha=-learning_rate))
    return new_params, new_state, gnorm


def fused_hyperparams(learning_rate: float = 3e-4) -> Dict[str, float]:
    """The hyperparameters matching ``models.llama.default_optimizer``
    (the parity baseline the fused step must reproduce)."""
    return dict(learning_rate=learning_rate, b1=0.9, b2=0.999,
                eps=1e-8, weight_decay=0.1, clip_norm=1.0)

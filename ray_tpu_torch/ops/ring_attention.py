"""Ring attention: sequence/context parallelism over the ``seq`` mesh
axis (counterpart of ``ray_tpu/ops/ring_attention.py``).

Blockwise ring attention: the sequence is split over the ``seq`` axis;
K/V chunks rotate around the ring while each shard computes flash
attention of its resident Q against them, merging the partial results
with a streaming (log-sum-exp) accumulator.  The backward is its own
ring: dK/dV accumulators travel with their K/V chunks and arrive home
after a full revolution.

Causality with contiguous sequence sharding: step 0 is the diagonal
(causal flash); step s > 0 sees chunk (idx - s) mod n, fully visible iff
its index is below ours, else masked out through lse = -1e30 at the
merge.  As in the reference the ring is a fixed schedule: every
off-diagonal step is computed, and the masked ones contribute nothing.

Each step calls the flash kernels' wrappers directly (``_fwd`` and
``_bwd_impl`` of :mod:`ray_tpu_torch.ops.flash_attention`): the sm_90a
kernels on the card, their plain versions on the CPU.

The ring body works on the shards one process holds, with the rotation
as an argument: :func:`ring_attention` holds one shard per rank and
rotates over point-to-point sends on the ``seq`` group;
:func:`_ring_chunks` holds every shard of one sequence on one device
and rotates a list (the schedule's on-device check).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from .flash_attention import (NEG_INF, _bwd_impl, _check_default_positions,
                              _fwd, flash_attention)

# Rotation of the ring: ``rotate(shards)`` takes one list of tensors per
# held shard and returns, for each held shard, the lists its ring
# predecessor held (shard i receives from shard i - 1).
Rotate = Callable[[List[List[torch.Tensor]]], List[List[torch.Tensor]]]


def _merge(o_acc, lse_acc, o_c, lse_c):
    """Merge two normalized partial attention results.
    o: (B, H, S, D) f32; lse: (B, H, S, 1) f32."""
    m = torch.maximum(lse_acc, lse_c)
    a = torch.exp(lse_acc - m)
    b = torch.exp(lse_c - m)
    denom = a + b
    o = (o_acc * a + o_c * b) / denom
    return o, m + torch.log(denom)


def _rotate(shards: List[List[torch.Tensor]], mesh,
            axis_name: str) -> List[List[torch.Tensor]]:
    """The distributed rotation (one held shard): send every tensor to
    the next rank of ``axis_name``'s ring, receive the previous rank's
    (``lax.ppermute`` with perm i -> i + 1)."""
    import torch.distributed as dist

    from ..parallel.mesh import axis_index, mesh_shape

    (xs,) = shards
    n = mesh_shape(mesh)[axis_name]
    group = mesh.get_group(axis_name)
    i = axis_index(mesh, axis_name)
    dst = dist.get_global_rank(group, (i + 1) % n)
    src = dist.get_global_rank(group, (i - 1) % n)
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    ops = [dist.P2POp(dist.isend, x, dst, group) for x in xs]
    ops += [dist.P2POp(dist.irecv, o, src, group) for o in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [outs]


def _rotate_list(shards: List[List[torch.Tensor]]
                 ) -> List[List[torch.Tensor]]:
    """The on-device rotation: every shard of the ring is held here."""
    return shards[-1:] + shards[:-1]


def _ring_fwd_impl(qs, ks, vs, idxs: Sequence[int], n: int,
                   rotate: Rotate):
    """Shard-local q/k/v: lists (one per held shard) of (B, S_loc, H, D).
    Runs the forward ring; returns the outputs and the residuals."""
    D = qs[0].shape[-1]
    scale = torch.tensor(D ** -0.5, dtype=qs[0].dtype)
    qt = [(q * scale).transpose(1, 2) for q in qs]
    kt = [k.transpose(1, 2) for k in ks]
    vt = [v.transpose(1, 2) for v in vs]
    acc = []
    for j in range(len(qs)):
        o, lse = _fwd(qt[j], kt[j], vt[j], True)
        acc.append([o.float(), lse])
    kv = [[kt[j], vt[j]] for j in range(len(qs))]
    for step in range(1, n):
        kv = rotate(kv)
        for j, idx in enumerate(idxs):
            src = (idx - step) % n
            o_c, lse_c = _fwd(qt[j], kv[j][0], kv[j][1], False)
            if not src < idx:
                lse_c = torch.full_like(lse_c, NEG_INF)
            acc[j] = list(_merge(acc[j][0], acc[j][1], o_c.float(), lse_c))
    outs, res = [], []
    for j, q in enumerate(qs):
        o = acc[j][0].to(q.dtype)
        outs.append(o.transpose(1, 2))
        res.append((qt[j], kt[j], vt[j], o, acc[j][1]))
    return outs, res


def _ring_bwd(res, gs, idxs: Sequence[int], n: int, rotate: Rotate):
    """The backward ring: gradients of every held shard's q, k, v."""
    h = len(res)
    B, Hq, S, D = res[0][0].shape
    Hkv = res[0][1].shape[1]
    group = Hq // Hkv
    scale = D ** -0.5
    do = [g.transpose(1, 2) for g in gs]
    dq = [torch.zeros((B, Hq, S, D), dtype=torch.float32,
                      device=gs[0].device) for _ in range(h)]
    # Per held shard: the K/V chunk visiting it and its dK/dV
    # accumulators, which travel together.
    state = [[r[1], r[2],
              torch.zeros((B, Hkv, S, D), dtype=torch.float32,
                          device=gs[0].device),
              torch.zeros((B, Hkv, S, D), dtype=torch.float32,
                          device=gs[0].device)] for r in res]
    for step in range(n):
        if step > 0:
            state = rotate(state)
        for j, idx in enumerate(idxs):
            qt, _, _, o, lse = res[j]
            k_rot, v_rot, dk_rot, dv_rot = state[j]
            src = (idx - step) % n
            k_full, v_full = k_rot, v_rot
            if group > 1:
                k_full = k_rot.repeat_interleave(group, dim=1)
                v_full = v_rot.repeat_interleave(group, dim=1)
            dq_c, dk_c, dv_c = _bwd_impl(qt, k_full, v_full, o.to(qt.dtype),
                                         lse, do[j], step == 0)
            if group > 1:
                dk_c = dk_c.reshape(B, Hkv, group, S, D).sum(dim=2)
                dv_c = dv_c.reshape(B, Hkv, group, S, D).sum(dim=2)
            if step == 0 or src < idx:
                dq[j] = dq[j] + dq_c
                state[j][2] = dk_rot + dk_c
                state[j][3] = dv_rot + dv_c
    # One more hop brings every dK/dV accumulator back to its home shard
    # (total rotations = n).
    home = rotate([[s[2], s[3]] for s in state])
    out = []
    for j in range(h):
        qt, kt, vt = res[j][:3]
        out.append(((dq[j] * scale).to(qt.dtype).transpose(1, 2),
                    home[j][0].to(kt.dtype).transpose(1, 2),
                    home[j][1].to(vt.dtype).transpose(1, 2)))
    return out


class _Ring(torch.autograd.Function):
    """The ring's custom VJP (the reference's ``_ring``): the forward
    ring, and :func:`_ring_bwd` as its backward.  Takes the held shards'
    q's, then k's, then v's."""

    @staticmethod
    def forward(ctx, idxs, n, rotate, *qkv):
        h = len(idxs)
        qs, ks, vs = qkv[:h], qkv[h:2 * h], qkv[2 * h:]
        outs, res = _ring_fwd_impl(qs, ks, vs, idxs, n, rotate)
        ctx.idxs, ctx.n, ctx.rotate = idxs, n, rotate
        ctx.save_for_backward(*[t for r in res for t in r])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        res = [saved[5 * j:5 * j + 5] for j in range(len(ctx.idxs))]
        grads = _ring_bwd(res, gs, ctx.idxs, ctx.n, ctx.rotate)
        return (None, None, None, *[g[0] for g in grads],
                *[g[1] for g in grads], *[g[2] for g in grads])


def _ring_chunks(qs, ks, vs) -> List[torch.Tensor]:
    """Ring attention over shards that one device holds: the ring's
    schedule (its kernel launches and merges) without a process group.
    qs/ks/vs: lists of n shards (B, S/n, H, D) of one sequence, in
    order; returns the n output shards."""
    n = len(qs)
    return list(_Ring.apply(tuple(range(n)), n, _rotate_list,
                            *qs, *ks, *vs))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis_name: str = "seq", mesh=None) -> torch.Tensor:
    """Causal ring attention over the mesh's ``axis_name`` axis.

    q: (B, S, Hq, D); k/v: (B, S, Hkv, D), S = the *whole* sequence, the
    same on every rank of the axis.  Each rank runs the ring on its
    contiguous shard of S and the shards are gathered back, so the
    result is again the same on every rank.  Falls back to single-device
    flash attention when there is no mesh or the seq axis is trivial.
    """
    from ..parallel.mesh import axis_index, mesh_shape
    from ..parallel.sharding import current_mesh
    from ..parallel.spmd import gather_slices, local_slice

    mesh = mesh or current_mesh()
    if mesh is None or mesh_shape(mesh).get(axis_name, 1) == 1:
        return flash_attention(q, k, v, causal=True)
    n = mesh_shape(mesh)[axis_name]
    q_l, k_l, v_l = (local_slice(t, mesh, [axis_name], 1) for t in (q, k, v))
    (out,) = _Ring.apply((axis_index(mesh, axis_name),), n,
                         lambda shards: _rotate(shards, mesh, axis_name),
                         q_l, k_l, v_l)
    return gather_slices(out, mesh, [axis_name], 1)


def ring_attention_causal(q, k, v, positions: Optional[torch.Tensor] = None):
    """Drop-in for ``models.llama.dot_attention`` (contiguous positions)."""
    _check_default_positions(positions, q.shape[1], "ring_attention_causal")
    return ring_attention(q, k, v)

"""Flash attention for the port (counterpart of
``ray_tpu/ops/flash_attention.py``): forward and backward, GQA-aware.

- :func:`_fwd` is the forward kernel's wrapper: on a CUDA tensor it
  launches the hand-written sm_90a kernel ``csrc/flash_fwd.cu`` (built
  at first use, bound with ctypes) or raises; on a CPU tensor it runs
  the plain PyTorch version :func:`_fwd_reference`, which computes the
  same ``(o, lse)``.
- :func:`_bwd_impl` is the backward's wrapper, with the reference's
  contract: on a CUDA tensor it computes ``delta = rowsum(do * o)`` and
  launches the dq and dk/dv kernels of ``csrc/flash_bwd.cu`` or raises;
  on a CPU tensor it runs :func:`_bwd_reference`.  It is public so that
  ring attention can call it per ring step.
- :class:`_FlashCore` is the ``torch.autograd.Function`` that mirrors the
  reference's ``_flash_core`` custom VJP: its forward launches the
  forward kernel and saves the five residuals named in
  :data:`FLASH_RESIDUAL_NAMES`; its backward runs :func:`_bwd_impl`.
- :func:`flash_attention` / :func:`flash_attention_causal` take the
  model's ``(B, S, H, D)`` layout and scale q by ``D**-0.5`` in q's
  dtype, as the JAX wrappers do.  They hand the kernels ``(B, H, S, D)``
  views of those tensors: the kernels read through their strides, so no
  transposed copy is made.

No wrapper falls back from the card to a plain version.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
# The JAX wrapper pads causal self-attention up to a multiple of 128 (its
# TPU lane width) when S is not one.  The CUDA kernels mask ragged edges
# themselves, but the pad path is kept so both packages compute the same
# padded problem: padded keys sit above every valid row's diagonal and
# padded rows are sliced off, so the result is exact either way.
_PAD_MULTIPLE = 128
_SUPPORTED_D = (16, 32, 48, 64, 80, 96, 112, 128)

# Launches of each kernel, counted by its wrapper where it launches.
launch_counts = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkdv": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
# Library -> (sources under csrc/: its .cu file and the headers that file
# includes, {C function: (restype, argtypes)}).  Pointers, the int64
# strides array and the stream are c_void_p.
_LIBS = {
    "flash_fwd": (["flash_fwd.cu", "hopper.cuh"], {
        # q, k, v, o, lse; B, Hq, Hkv, Sq, Sk, D, causal; strides[12]
        # (q, k, v, o); stream.
        "flash_fwd_bf16": (_I, [_P] * 5 + [_I] * 7 + [_P] * 2),
    }),
    "flash_bwd": (["flash_bwd.cu", "hopper.cuh"], {
        # q, k, v, do, o, lse, delta (written), dq; B, H, Sq, Sk, D,
        # causal; strides[15] (q, k, v, do, o); stream.
        "flash_bwd_dq_bf16": (_I, [_P] * 8 + [_I] * 6 + [_P] * 2),
        # q, k, v, do, o, lse, delta (read), dk, dv; the same ints;
        # strides; stream.
        "flash_bwd_dkdv_bf16": (_I, [_P] * 9 + [_I] * 6 + [_P] * 2),
    }),
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _lib(name: str):
    sources, signatures = _LIBS[name]
    return _build.load(name, sources, signatures)


def build_kernels():
    """Build (if needed) every kernel library of this module, one nvcc
    per source, all started together, then load them; returns
    ``{name: lib}``."""
    with ThreadPoolExecutor(len(_LIBS)) as pool:
        list(pool.map(lambda name: _build.build(name, _LIBS[name][0]),
                      _LIBS))
    return {name: _lib(name) for name in _LIBS}


def _fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool):
    """Plain PyTorch version of the kernel: same inputs, same
    ``(o, lse)``.  q: (B, Hq, Sq, D) pre-scaled; k/v: (B, Hkv, Sk, D).
    Scores in f32 from the input-precision q and k; p is rounded to v's
    dtype before the PV product, as the kernel and the reference do.  A
    fully masked row gives o = 0 and lse = -1e30."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if Sk == 0:  # every row fully masked
        return (torch.zeros_like(q),
                torch.full((B, Hq, Sq, 1), NEG_INF, device=q.device))
    group = Hq // Hkv
    qg = q.reshape(B, Hkv, group, Sq, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    live = m > float("-inf")
    p = torch.exp(s - torch.where(live, m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    o = torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros_like(o))
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-37)),
                      torch.full_like(l, NEG_INF))
    return (o.reshape(B, Hq, Sq, D).to(q.dtype),
            lse.reshape(B, Hq, Sq, 1))


def _fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool):
    """q: (B, Hq, Sq, D) pre-scaled; k/v: (B, Hkv, Sk, D).  Returns
    ``o`` (B, Hq, Sq, D) in q's dtype and ``lse`` (B, Hq, Sq, 1) f32.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16, D a multiple of 16 up to 128, D contiguous, the other strides
    multiples of 8, 16-byte aligned) or raise.  ``o`` takes q's strides,
    so a ``(B, S, H, D)``-backed q gives an o of that layout."""
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if q.device.type == "cpu":
        return _fwd_reference(q, k, v, causal)
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v)):
        raise ValueError(f"flash_fwd: tensors on {q.device}, {k.device}, "
                         f"{v.device}; expected one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"flash_fwd kernel takes bf16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if D not in _SUPPORTED_D:
        raise ValueError(f"flash_fwd kernel takes D in {_SUPPORTED_D}, "
                         f"got {D}")
    o = torch.empty_like(q)  # q's strides where q is dense
    strides = [t.stride(i) for t in (q, k, v, o) for i in range(3)]
    if any(t.stride(3) != 1 or t.data_ptr() % 16 for t in (q, k, v, o)) \
            or any(st % 8 for st in strides):
        raise ValueError("flash_fwd kernel takes q, k, v with D "
                         "contiguous, the other strides multiples of 8 "
                         "and 16-byte aligned data")
    lse = torch.empty((B, Hq, Sq, 1), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _lib("flash_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    c_strides = (ctypes.c_int64 * 12)(*strides)
    rc = lib.flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), B, Hq, Hkv, Sq,
                            Sk, D, int(bool(causal)),
                            ctypes.addressof(c_strides), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {rc}")
    launch_counts["flash_fwd"] += 1
    return o, lse


def _bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   causal: bool):
    """Plain PyTorch version of the backward kernels: the contract of the
    reference's ``_bwd_impl``.  q, o, do: (B, Hq, Sq, D); k, v:
    (B, Hq, Sk, D), already at q's heads; lse: (B, Hq, Sq, 1) f32.
    Returns ``(dq, dk, dv)`` in f32 at q-head granularity, dq with
    respect to the pre-scaled q.  Products run in f32 from the
    input-precision operands; p is rounded to do's dtype for dv, ds to
    q's dtype for dk and to k's dtype for dq, as the kernels do.  Masked
    scores are -1e30 and p = exp(s - lse)."""
    f32 = torch.float32
    Sq, Sk = q.shape[2], k.shape[2]
    delta = (do.to(f32) * o.to(f32)).sum(dim=-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), k.to(f32))
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    p = torch.exp(s - lse)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(f32), v.to(f32))
    ds = p * (dp - delta)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).to(f32), do.to(f32))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).to(f32), q.to(f32))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).to(f32), k.to(f32))
    return dq, dk, dv


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernels can read it through its strides (D
    contiguous, the other strides multiples of 8, 16-byte aligned), else
    a contiguous copy: e.g. the zero-stride ``do`` that autograd hands
    over after a ``sum()``."""
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 \
            and all(st % 8 == 0 for st in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _bwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool):
    """The backward with the reference's ``_bwd_impl`` contract (see
    :func:`_bwd_reference`).  CPU tensors take the plain version; CUDA
    tensors launch the dq kernel, which also computes delta =
    rowsum(do * o) for the dk/dv kernel, then the dk/dv kernel (bf16 q,
    k, v, o, do; D a multiple of 16 up to 128), or raise."""
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    if (k.shape != v.shape or tuple(k.shape) != (B, Hq, Sk, D)
            or o.shape != q.shape or do.shape != q.shape
            or tuple(lse.shape) != (B, Hq, Sq, 1)):
        raise ValueError(
            f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} o{tuple(o.shape)} lse{tuple(lse.shape)} "
            f"do{tuple(do.shape)}; k/v must be at q's heads")
    if q.device.type == "cpu":
        return _bwd_reference(q, k, v, o, lse, do, causal)
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (k, v, o, lse, do)):
        raise ValueError("flash_bwd: expected every tensor on one CUDA "
                         "device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, o, do)) \
            or lse.dtype != torch.float32:
        raise TypeError(f"flash_bwd kernels take bf16 q, k, v, o, do and "
                        f"f32 lse, got {q.dtype}, {k.dtype}, {v.dtype}, "
                        f"{o.dtype}, {do.dtype}, {lse.dtype}")
    if D not in _SUPPORTED_D:
        raise ValueError(f"flash_bwd kernels take D in {_SUPPORTED_D}, "
                         f"got {D}")
    if q.numel() == 0 or k.numel() == 0:  # nothing attends: zero sums
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                torch.zeros(k.shape, dtype=torch.float32, device=q.device),
                torch.zeros(k.shape, dtype=torch.float32, device=q.device))
    args = _BwdArgs(q, k, v, o, lse, do, causal)
    dq, delta = _bwd_dq(args)
    dk, dv = _bwd_dkdv(args, delta)
    return dq, dk, dv


class _BwdArgs:
    """The backward kernels' operands, checked by :func:`_bwd_impl`: q,
    k, v, do and o readable through their strides (else contiguous
    copies), lse contiguous, and the C arguments built once for both
    launches."""

    def __init__(self, q, k, v, o, lse, do, causal):
        B, Hq, Sq, D = q.shape
        self.device = q.device
        self.q_shape = (B, Hq, Sq, D)
        self.k_shape = tuple(k.shape)
        self.tensors = [_kernel_operand(t) for t in (q, k, v, do, o)]
        self.tensors.append(lse.contiguous())
        self.strides = (ctypes.c_int64 * 15)(*[
            t.stride(i) for t in self.tensors[:5] for i in range(3)])
        self.dims = (B, Hq, Sq, k.shape[2], D, int(bool(causal)))

    def call(self, fn, name, *outs):
        """Launch ``fn`` (q, k, v, do, o, lse, *outs, dims, strides,
        stream) on the current stream; count it or raise."""
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = fn(*[t.data_ptr() for t in self.tensors],
                *[t.data_ptr() for t in outs], *self.dims,
                ctypes.addressof(self.strides), stream)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
        launch_counts[name] += 1


def _bwd_dq(args: _BwdArgs):
    """B2: returns ``(dq, delta)``; delta (B, H, Sq) f32 = rowsum(do * o),
    which the dq kernel computes first for the dk/dv kernel."""
    B, Hq, Sq, _ = args.q_shape
    dq = torch.empty(args.q_shape, dtype=torch.float32, device=args.device)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=args.device)
    args.call(_lib("flash_bwd").flash_bwd_dq_bf16, "flash_bwd_dq", delta, dq)
    return dq, delta


def _bwd_dkdv(args: _BwdArgs, delta: torch.Tensor):
    """B3: returns ``(dk, dv)``, reading the delta that B2 wrote."""
    dk = torch.empty(args.k_shape, dtype=torch.float32, device=args.device)
    dv = torch.empty_like(dk)
    args.call(_lib("flash_bwd").flash_bwd_dkdv_bf16, "flash_bwd_dkdv",
              delta, dk, dv)
    return dk, dv


# What _FlashCore saves for its backward, in order: the scaled q and the
# k, v it was given (B, H, S, D views), o and the width-1 lse.  The
# reference names these so that the "attn" remat policy can keep them;
# here they are the saved tensors of _FlashCore's ctx, which a
# checkpointed segment around the call would otherwise recompute.
FLASH_RESIDUAL_NAMES = ("flash_q", "flash_k", "flash_v", "flash_o",
                        "flash_lse")


class _FlashCore(torch.autograd.Function):
    """Counterpart of the reference's ``_flash_core`` custom VJP.
    qt: (B, Hq, Sq, D) pre-scaled; kt, vt: (B, Hkv, Sk, D).  The
    forward launches the forward kernel and returns o; the backward
    expands k/v to q's heads only when Hq > Hkv, runs :func:`_bwd_impl`,
    group-sums dk/dv back to Hkv and returns dq, dk, dv in the inputs'
    dtypes.  dq is with respect to the pre-scaled qt: the caller's
    ``q * scale`` applies the scale to it."""

    @staticmethod
    def forward(ctx, qt, kt, vt, causal):
        o, lse = _fwd(qt, kt, vt, causal)
        ctx.causal = causal
        ctx.save_for_backward(qt, kt, vt, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        qt, kt, vt, o, lse = ctx.saved_tensors
        B, Hq, _, D = qt.shape
        Hkv = kt.shape[1]
        group = Hq // Hkv
        k_full, v_full = kt, vt
        if group > 1:
            k_full = kt.repeat_interleave(group, dim=1)
            v_full = vt.repeat_interleave(group, dim=1)
        dq, dk, dv = _bwd_impl(qt, k_full, v_full, o, lse, do, ctx.causal)
        if group > 1:
            dk = dk.reshape(B, Hkv, group, -1, D).sum(dim=2)
            dv = dv.reshape(B, Hkv, group, -1, D).sum(dim=2)
        return dq.to(qt.dtype), dk.to(kt.dtype), dv.to(vt.dtype), None


def _flash(q, k, v, causal):
    D = q.shape[-1]
    # The scale rounded to q's dtype, as a 0-dim CPU tensor: PyTorch
    # passes it to the multiply as a scalar (no copy to the card, no
    # host sync).  The multiply stays outside _FlashCore, so autograd
    # applies the scale to dq, as the reference's qt = q * scale does.
    scale = torch.tensor(D ** -0.5, dtype=q.dtype)
    o = _FlashCore.apply((q * scale).transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal)
    return o.transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention.  q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) with
    Hq % Hkv == 0 (GQA).  Softmax scale D**-0.5 (applied inside)."""
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    if Hq % k.shape[2]:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={k.shape[2]}")
    if causal and Sq == Sk and Sq % _PAD_MULTIPLE:
        pad = -Sq % _PAD_MULTIPLE
        widen = (0, 0, 0, 0, 0, pad)  # pad dim 1 (sequence) at the end
        out = _flash(torch.nn.functional.pad(q, widen),
                     torch.nn.functional.pad(k, widen),
                     torch.nn.functional.pad(v, widen), causal)
        return out[:, :Sq]
    return _flash(q, k, v, causal)


def flash_attention_causal(q, k, v, positions: Optional[torch.Tensor] = None):
    """Drop-in for ``models.llama.dot_attention`` in the standard causal
    layout; packed/offset positions must use the dot path."""
    _check_default_positions(positions, q.shape[1], "flash_attention_causal")
    return flash_attention(q, k, v, causal=True)


def _check_default_positions(positions, seq_len, name):
    """The kernel masks on the raw row index, i.e. assumes positions ==
    arange(seq).  Packed/offset positions would attend wrongly, so they
    are rejected instead of ignored."""
    if positions is None:
        return
    pos = torch.as_tensor(positions)
    if pos.ndim == 2:
        pos = pos[0]
    default = torch.arange(seq_len, device=pos.device)
    if pos.shape == default.shape and bool(torch.equal(
            pos.to(default.dtype), default)):
        return
    raise NotImplementedError(
        f"{name} only supports the standard causal layout "
        "(positions == arange(seq_len)); use the dot-attention path "
        "for packed or offset positions")

"""Flash attention forward for the port (counterpart of
``ray_tpu/ops/flash_attention.py``), forward only.

- :func:`_fwd` is the kernel's wrapper: on a CUDA tensor it launches the
  hand-written sm_90a kernel ``csrc/flash_fwd.cu`` (built at first use,
  bound with ctypes) or raises; on a CPU tensor it runs the plain
  PyTorch version :func:`_fwd_reference`, which computes the same
  ``(o, lse)``.  There is no fallback from the card to the plain
  version.
- :func:`flash_attention` / :func:`flash_attention_causal` take the
  model's ``(B, S, H, D)`` layout and scale q by ``D**-0.5`` in q's
  dtype, as the JAX wrappers do.  They hand the kernel ``(B, H, S, D)``
  views of those tensors: it reads and writes through their strides, so
  no transposed copy is made.

Gradients (the dq and dk/dv kernels behind a ``torch.autograd.Function``)
are not ported yet: a call whose inputs require grad raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
# The JAX wrapper pads causal self-attention up to a multiple of 128 (its
# TPU lane width) when S is not one.  The CUDA kernel masks ragged edges
# itself, but the pad path is kept so both packages compute the same
# padded problem: padded keys sit above every valid row's diagonal and
# padded rows are sliced off, so the result is exact either way.
_PAD_MULTIPLE = 128
_SUPPORTED_D = (16, 32, 48, 64, 80, 96, 112, 128)

# Launches of each kernel, counted by its wrapper where it launches.
launch_counts = {"flash_fwd": 0}

_SIGNATURES = {
    # q, k, v, o, lse; B, Hq, Hkv, Sq, Sk, D, causal; int64 strides[12];
    # stream.
    "flash_fwd_bf16": (ctypes.c_int, [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2),
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build_kernels():
    """Build (if needed) and load the kernel library; returns it."""
    return _build.load("flash_fwd", ["flash_fwd.cu"], _SIGNATURES)


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


def _check_no_grad(*ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "flash attention backward is not ported yet (ROADMAP queue B: "
            "B2/B3 behind a torch.autograd.Function); call under "
            "torch.no_grad()")


def _fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool):
    """q: (B, Hq, Sq, D) pre-scaled; k/v: (B, Hkv, Sk, D).  Returns
    ``o`` (B, Hq, Sq, D) in q's dtype and ``lse`` (B, Hq, Sq, 1) f32.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16, D a multiple of 16 up to 128, D contiguous, the other strides
    multiples of 8, 16-byte aligned) or raise.  ``o`` takes q's strides,
    so a ``(B, S, H, D)``-backed q gives an o of that layout."""
    _check_no_grad(q, k, v)
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
    lib = build_kernels()
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


def _flash(q, k, v, causal):
    D = q.shape[-1]
    # The scale rounded to q's dtype, as a 0-dim CPU tensor: PyTorch
    # passes it to the multiply as a scalar (no copy to the card, no
    # host sync).
    scale = torch.tensor(D ** -0.5, dtype=q.dtype)
    o, _lse = _fwd((q * scale).transpose(1, 2), k.transpose(1, 2),
                   v.transpose(1, 2), causal)
    return o.transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention.  q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) with
    Hq % Hkv == 0 (GQA).  Softmax scale D**-0.5 (applied inside)."""
    _check_no_grad(q, k, v)
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

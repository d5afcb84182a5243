"""Paged decode attention: the decode step's attention read in place from
the paged KV pool through the block tables.

- :class:`PagedDecode` is one decode chunk's attention: made from the
  pool ``(N, L, bs, Hkv, D)`` of K and of V, the tables (B, nb), the
  active mask (B,), the query heads and the scale, it is called at every
  layer of every step with the query ``q`` (B, 1, Hq, D), the layer and
  each query's position ``lens`` (B,).  An active slot's query at
  position p attends keys 0..p of its own table (those inside its nb
  blocks), with GQA grouping as ``models/llama.py`` ``_softmax_attend``
  does: f32 scores times ``scale``, f32 softmax, output in q's dtype.
  An inactive slot's output is zero.  On CUDA tensors it launches the
  hand-written kernel of ``csrc/paged_decode.cu`` (built at first use,
  bound with ctypes), plus its combine pass where the sequence is split,
  or raises; on CPU tensors it runs the plain version
  :func:`paged_decode_reference`.
- The plain version reads each slot's blocks of the layer through its
  table into the dense layout and calls ``llama._cache_attend``, the
  function the gathered path calls, so the CPU engine's tokens are those
  of the gathered path bit for bit.  The kernel keeps probabilities in
  f32 where the plain version rounds them to the value dtype before the
  product.
- It replaces no Pallas kernel: the JAX package's paged decode gathers
  with plain ``jnp``.  It is bound by the live K/V bytes (~4 FLOP a byte);
  the note at the head of the CUDA source says what its design does
  about that.
- :data:`launch_counts` counts the launches of each kernel: one
  ``paged_decode`` a call, and one ``paged_decode_combine`` a call whose
  sequence is split.

Nothing falls back from the card to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Element-type codes of the C interface.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# What the kernel is instantiated for: head dims and query heads a kv
# head.
KERNEL_D = (64, 128, 256)
KERNEL_G = (1, 2, 4, 8)
# Keys a split holds at most, and the CTAs the split plan aims for before
# it stops halving: 16 a streaming multiprocessor of an H100's 132 (four
# are resident at once), counted over every slot of the table, active or
# not; a serving engine's slots are often half idle.  On an H100 at the
# serve cell's shapes (14 of 32 slots at ~1,700 keys, tables of 128
# blocks) 128-key splits ran 0.0602 ms against 0.0652 for 256; all 32
# slots at 4,096 (256 blocks) ran 0.2314 ms at 256 against 0.2429 at 128.
_SPLIT_KEYS = 256
_TARGET_CTAS = 16 * 132

launch_counts = {"paged_decode": 0, "paged_decode_combine": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIBS = {
    "paged_decode": (["paged_decode.cu"], {
        # dtype, G, D; q, pool_k, pool_v, table, lens, active, out,
        # part_o, part_ml; B, Hkv, layer, L, bs, nb, splits, split_len;
        # scale; stream.
        "paged_decode": (_I, [_I] * 3 + [_P] * 9 + [_I] * 8
                         + [ctypes.c_float, _P]),
        # dtype; part_o, part_ml, lens, active, out; B, Hq, D, nb, bs,
        # splits, split_len; stream.
        "paged_decode_combine": (_I, [_I] + [_P] * 5 + [_I] * 7 + [_P]),
    }),
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _lib():
    sources, signatures = _LIBS["paged_decode"]
    return _build.load("paged_decode", sources, signatures)


def build_kernels():
    """Build (if needed) and load the kernel library; returns
    ``{name: lib}``."""
    return {"paged_decode": _lib()}


def split_plan(slots: int, kv_heads: int, nb: int, block_size: int):
    """``(splits, split_len)`` of a launch over tables of ``nb`` blocks:
    splits of whole blocks, at most :data:`_SPLIT_KEYS` keys each (one
    block where a block is longer), halved while ``slots x kv_heads x
    splits`` CTAs stay under :data:`_TARGET_CTAS`.  From these host
    values alone: the launch reads no length back."""
    per = max(1, _SPLIT_KEYS // block_size)  # blocks a split
    while per > 1 and slots * kv_heads * -(-nb // per) < _TARGET_CTAS:
        per //= 2
    per = min(per, nb)
    return -(-nb // per), per * block_size


def paged_decode_reference(q, pool_k, pool_v, layer, block_table, lens,
                           active, scale):
    """Plain PyTorch version of the kernel, with its contract (see the
    module docstring): the slots' blocks of ``layer`` gathered through
    their tables into (B, nb * bs, Hkv, D) and attended by
    ``llama._cache_attend``; inactive slots get zeros."""
    from ..models import llama

    B, nb = block_table.shape
    _N, _L, bs, Hkv, D = pool_k.shape
    flat = block_table.reshape(-1)
    k = pool_k[:, layer].index_select(0, flat).view(B, nb * bs, Hkv, D)
    v = pool_v[:, layer].index_select(0, flat).view(B, nb * bs, Hkv, D)
    out = llama._cache_attend(q, k, v, lens[:, None], scale)
    return torch.where(active[:, None, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


class PagedDecode:
    """The attention of one decode chunk, set up once and called at every
    layer of every step: the pools, the tables, the active mask, the query
    heads and the scale are fixed for a chunk; each call gives the query,
    the layer and the positions.  Everything a call does not change is
    checked here, the split plan made and the split scratch allocated, so
    that a call on the card is one or two launches (the engine's decode
    step is paced by the host).  CPU tensors take the plain version."""

    def __init__(self, pool_k, pool_v, block_table, active, n_heads: int,
                 scale: float):
        _N, L, bs, Hkv, D = pool_k.shape
        B = active.shape[0] if active.ndim == 1 else -1
        if pool_v.shape != pool_k.shape or n_heads % Hkv:
            raise ValueError(f"paged_decode takes pools (N, L, bs, Hkv, D) "
                             f"of one shape and Hq a multiple of Hkv, got "
                             f"k{tuple(pool_k.shape)} "
                             f"v{tuple(pool_v.shape)}, Hq={n_heads}")
        if block_table.ndim != 2 or block_table.shape[0] != B:
            raise ValueError(f"tables (B, nb) and active (B,), got "
                             f"{tuple(block_table.shape)}, "
                             f"{tuple(active.shape)}")
        self.pools, self.block_table, self.active = ((pool_k, pool_v),
                                                     block_table, active)
        self.scale, self.n_layers = scale, L
        self.q_shape = (B, 1, n_heads, D)
        self.cpu = pool_k.device.type == "cpu"
        if self.cpu:
            return
        dev = pool_k.device
        if dev.type != "cuda" or any(t.device != dev for t in
                                     (pool_v, block_table, active)):
            raise ValueError("paged_decode: expected every tensor on one "
                             "CUDA device")
        G = n_heads // Hkv
        if pool_k.dtype not in _DTYPES or pool_v.dtype != pool_k.dtype:
            raise TypeError(f"paged_decode takes pools of one of f32, bf16, "
                            f"f16, got {pool_k.dtype}, {pool_v.dtype}")
        if D not in KERNEL_D or G not in KERNEL_G:
            raise ValueError(f"paged_decode is built for D in {KERNEL_D} "
                             f"and Hq/Hkv in {KERNEL_G}, got D={D}, "
                             f"{n_heads}/{Hkv}")
        if block_table.dtype != torch.int64 or active.dtype != torch.bool:
            raise TypeError("paged_decode takes int64 tables and a bool "
                            "active mask")
        if not all(t.is_contiguous() for t in (pool_k, pool_v, block_table,
                                               active)):
            raise ValueError("paged_decode reads contiguous pools, tables "
                             "and active mask")
        nb = block_table.shape[1]
        self.splits, self.split_len = split_plan(B, Hkv, nb, bs)
        self.dtype, self.device = pool_k.dtype, dev
        if self.splits > 1:
            part_o = torch.empty((B, n_heads, self.splits, D),
                                 dtype=torch.float32, device=dev)
            part_ml = torch.empty((B, n_heads, self.splits, 2),
                                  dtype=torch.float32, device=dev)
        else:  # unused by a launch of one split
            part_o = part_ml = torch.empty(0, device=dev)
        self._scratch = (part_o, part_ml)
        lib = _lib()
        self._fn, self._combine = lib.paged_decode, lib.paged_decode_combine
        code = _DTYPES[self.dtype]
        self._args = (code, G, D, None, pool_k.data_ptr(),
                      pool_v.data_ptr(), block_table.data_ptr(), None,
                      active.data_ptr(), None, part_o.data_ptr(),
                      part_ml.data_ptr(), B, Hkv, None, L, bs, nb,
                      self.splits, self.split_len, float(scale))
        self._combine_args = (code, part_o.data_ptr(), part_ml.data_ptr(),
                              None, active.data_ptr(), None, B, n_heads, D,
                              nb, bs, self.splits, self.split_len)

    def __call__(self, q, layer: int, lens):
        """``(B, 1, Hq, D)`` in q's dtype: q (B, 1, Hq, D) at the
        positions ``lens`` (B,) int64 attends its slots' tables at
        ``layer``."""
        if tuple(q.shape) != self.q_shape or tuple(lens.shape) != \
                self.q_shape[:1] or not 0 <= layer < self.n_layers:
            raise ValueError(f"paged_decode: q{tuple(q.shape)} (expected "
                             f"{self.q_shape}), lens{tuple(lens.shape)}, "
                             f"layer {layer} of {self.n_layers}")
        if self.cpu:
            return paged_decode_reference(q, *self.pools, layer,
                                          self.block_table, lens, self.active,
                                          self.scale)
        if q.dtype != self.dtype or lens.dtype != torch.int64 \
                or q.device != self.device or lens.device != self.device:
            raise TypeError(f"paged_decode takes q of the pools' dtype "
                            f"{self.dtype} and int64 lens on {self.device}, "
                            f"got {q.dtype} on {q.device}, {lens.dtype} on "
                            f"{lens.device}")
        if not q.is_contiguous() or q.data_ptr() % 16:
            q = q.clone(memory_format=torch.contiguous_format)
        lens = lens.contiguous()
        out = torch.empty(self.q_shape, dtype=self.dtype, device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        a = list(self._args)
        a[3], a[7], a[9], a[14] = (q.data_ptr(), lens.data_ptr(),
                                   out.data_ptr(), int(layer))
        rc = self._fn(*a, stream)
        if rc != 0:
            raise RuntimeError(f"paged_decode kernel launch failed: "
                               f"cudaError {rc}")
        launch_counts["paged_decode"] += 1
        if self.splits > 1:
            c = list(self._combine_args)
            c[3], c[5] = lens.data_ptr(), out.data_ptr()
            rc = self._combine(*c, stream)
            if rc != 0:
                raise RuntimeError(f"paged_decode_combine kernel launch "
                                   f"failed: cudaError {rc}")
            launch_counts["paged_decode_combine"] += 1
        return out


"""The serialization boundary.

Reference semantics: python/ray/_private/serialization.py — every value
crossing a task/object boundary is serialized (cloudpickle) so consumers
get their own copy; numpy arrays are stored out-of-band and returned as
zero-copy READ-ONLY views (plasma semantics); mutating a ``get`` result
never aliases the producer's copy.

``torch.Tensor`` leaves take the place of the reference's ``jax.Array``
leaves, but a tensor is mutable and has no read-only view, so sharing it
by reference would let one consumer's in-place write reach the producer
and every other consumer.  The promise is kept by copying on the
tensor's own device (no host round trip): one clone at seal time (as
numpy leaves are frozen copies) and one clone per read.  A CUDA tensor
therefore costs two device-to-device copies of its bytes per put/get
pair.

Implementation: a cloudpickle Pickler with ``persistent_id`` hooks pulls
array leaves out of the payload into an extern table:

- in-process: externs are kept live (numpy copies frozen read-only,
  tensors cloned, both at seal time).
- on the wire (the spill path of ``core/plasma.py`` and any process
  boundary): externs travel as raw bytes behind a header-only metadata
  frame ``(kind, dtype, shape, nbytes, device)``.  A tensor travels
  through a ``uint8`` view of its bytes, so every dtype torch has
  (bfloat16, float16, int8, the float8 types) crosses without numpy
  having to know it, and comes back on the device it left.
"""

from __future__ import annotations

import io
import pickle
import struct
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

try:
    import cloudpickle
except ImportError:  # vendored in most environments; stdlib fallback
    cloudpickle = None


class _ExternPickler((cloudpickle.CloudPickler if cloudpickle is not None
                      else pickle.Pickler)):
    """Pickles everything by value (cloudpickle: lambdas, closures,
    local classes) except array leaves, which become extern handles."""

    def __init__(self, file, externs: List[Any]):
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self._externs = externs

    def persistent_id(self, obj):
        if type(obj) is torch.Tensor:
            # Clone at seal time, on the tensor's own device: the
            # producer may write into its tensor after put(); consumers
            # must not see that.  (A Parameter reduces to its plain
            # ``.data`` tensor, which lands here.)
            frozen = obj.detach().clone(
                memory_format=torch.contiguous_format)
            if obj.requires_grad:
                frozen.requires_grad_(True)
            self._externs.append(("torch", frozen))
            return len(self._externs) - 1
        if type(obj) is np.ndarray:
            # Freeze a copy at seal time: the producer may mutate its
            # array after put(); consumers must not see that.
            frozen = obj.copy()
            frozen.flags.writeable = False
            self._externs.append(("np", frozen))
            return len(self._externs) - 1
        return None


class _WireTensor:
    """A received tensor extern staged as its host bytes; the tensor is
    rebuilt on its device at every *consume* (deserialize), which is the
    per-read copy.  Relay hops and chunk serving read only ``host``
    (zero-copy out of the staging buffer), so forwarding never touches
    a device."""

    __slots__ = ("host", "dtype", "shape", "device")

    def __init__(self, host: np.ndarray, dtype: str, shape: tuple,
                 device: str):
        self.host = host  # flat uint8
        self.dtype = dtype
        self.shape = tuple(shape)
        self.device = device

    @property
    def nbytes(self) -> int:
        return int(self.host.nbytes)

    def materialize(self) -> torch.Tensor:
        u8 = torch.from_numpy(self.host.copy())
        t = u8.view(_parse_torch_dtype(self.dtype)).reshape(self.shape)
        return t.to(self.device)


class _ExternUnpickler(pickle.Unpickler):
    def __init__(self, file, externs: List[Tuple[str, Any]]):
        super().__init__(file)
        self._externs = externs

    def persistent_load(self, pid):
        kind, arr = self._externs[pid]
        if isinstance(arr, _WireTensor):
            return arr.materialize()
        if kind == "torch":
            # Every read gets its own clone (the promise above).
            out = arr.detach().clone()
            if arr.requires_grad:
                out.requires_grad_(True)
            return out
        return arr


class Serialized:
    """A sealed value: payload bytes + live extern array table."""

    __slots__ = ("payload", "externs")

    def __init__(self, payload: bytes, externs: List[Tuple[str, Any]]):
        self.payload = payload
        self.externs = externs

    @property
    def size_bytes(self) -> int:
        n = len(self.payload)
        for _kind, arr in self.externs:
            n += getattr(arr, "nbytes", 0)
        return int(n)


def serialize(value: Any) -> Serialized:
    """Seal ``value`` for the object store.  Raises TypeError for
    unserializable values (matches reference: you cannot put a lock)."""
    buf = io.BytesIO()
    externs: List[Any] = []
    p = _ExternPickler(buf, externs)
    try:
        p.dump(value)
    except (pickle.PicklingError, TypeError, AttributeError) as e:
        raise TypeError(
            f"value of type {type(value).__name__} cannot cross the "
            f"task/object boundary (serialization failed: {e})") from e
    return Serialized(buf.getvalue(), externs)


def deserialize(sealed: Serialized) -> Any:
    """Rebuild a fresh copy of the value.  Container structure is a new
    copy per call; numpy leaves are shared (frozen read-only), tensor
    leaves are cloned per call."""
    return _ExternUnpickler(io.BytesIO(sealed.payload),
                            sealed.externs).load()


# ---------------------------------------------------------------------------
# Host export of extern leaves
# ---------------------------------------------------------------------------
#
# Every process-boundary path below needs array leaves as C-contiguous
# HOST memory.  numpy leaves: ``ascontiguousarray`` is a no-op view for
# the common (already contiguous) case.  Tensor leaves: their bytes as a
# flat ``uint8`` array — zero-copy for a contiguous CPU tensor, one
# device-to-host copy for a CUDA tensor.
#
# Extern wire metadata is ``(kind, dtype, shape, nbytes, device)``: a
# header-only frame the receiver can preallocate from.  ``device`` is
# None for numpy leaves.


def _export_host(kind: str, arr) -> np.ndarray:
    """C-contiguous host ndarray of an extern leaf (flat uint8 for a
    tensor), copying only when the leaf is not already one."""
    if isinstance(arr, _WireTensor):
        return arr.host
    if kind == "torch":
        flat = arr.detach().contiguous().reshape(-1).view(torch.uint8)
        return flat.cpu().numpy()
    return np.ascontiguousarray(arr)


def _u8_view(host: np.ndarray) -> memoryview:
    """Flat uint8 memoryview over a contiguous host array."""
    return memoryview(host.reshape(-1).view(np.uint8))


def _extern_wire_entry(kind: str, arr) -> Tuple[tuple, np.ndarray]:
    """((kind, dtype, shape, nbytes, device), host_view) for one extern
    leaf."""
    host = _export_host(kind, arr)
    if kind == "torch":
        if isinstance(arr, _WireTensor):
            dtype, shape, device = arr.dtype, arr.shape, arr.device
        else:
            dtype, shape = str(arr.dtype), tuple(arr.shape)
            device = str(arr.device)
        return (kind, dtype, shape, int(host.nbytes), device), host
    return ((kind, str(host.dtype), tuple(host.shape),
             int(host.nbytes), None), host)


def _unpack_extern(entry):
    """(kind, dtype, shape, nbytes, device) from a 4- or 5-tuple
    (4-tuple metas round-trip as device=None)."""
    kind, dtype, shape, nbytes = entry[:4]
    device = entry[4] if len(entry) > 4 else None
    return kind, dtype, shape, nbytes, device


def _extern_from_bytes(entry, raw) -> Tuple[str, Any]:
    """One extern rebuilt from its wire entry over the raw bytes ``raw``
    (a read-only buffer): numpy leaves as zero-copy read-only views,
    tensor leaves staged as :class:`_WireTensor`."""
    kind, dtype, shape, nbytes, device = _unpack_extern(entry)
    if kind == "torch":
        host = np.frombuffer(raw, dtype=np.uint8, count=nbytes)
        return "torch", _WireTensor(host, dtype, shape, device)
    arr = np.frombuffer(raw, dtype=_parse_dtype(dtype),
                        count=int(np.prod(shape, dtype=np.int64))
                        ).reshape(shape)
    return "np", arr  # frombuffer is read-only


def _parse_torch_dtype(name: str) -> torch.dtype:
    """``"torch.bfloat16"`` -> ``torch.bfloat16``."""
    dtype = getattr(torch, name.rpartition(".")[2], None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"unknown torch dtype {name!r}")
    return dtype


# ---------------------------------------------------------------------------
# Wire format (process boundary)
# ---------------------------------------------------------------------------
#
# v2 flat frame: ``RTW2 || u64 header_len || pickle(header) || payload
# || extern bytes...`` — the header is metadata only (payload length +
# extern entries), so building the frame copies each array exactly once
# (into the output buffer) and parsing it builds zero-copy views over
# the received bytes.

_WIRE_MAGIC = b"RTW2"
_WIRE_LEN = struct.Struct(">Q")


def to_wire(sealed: Serialized) -> bytes:
    """Flatten payload + externs into one bytes blob (v2 frame)."""
    entries = []
    views: List[memoryview] = []
    for kind, arr in sealed.externs:
        entry, host = _extern_wire_entry(kind, arr)
        entries.append(entry)
        if host.nbytes:
            views.append(_u8_view(host))
    header = pickle.dumps((len(sealed.payload), entries),
                          protocol=pickle.HIGHEST_PROTOCOL)
    return b"".join([_WIRE_MAGIC, _WIRE_LEN.pack(len(header)), header,
                     sealed.payload, *views])


def from_wire(data) -> Serialized:
    view = memoryview(data)
    if not view.readonly:
        view = view.toreadonly()
    if bytes(view[:4]) != _WIRE_MAGIC:
        raise ValueError("not a wire frame (bad magic)")
    (hlen,) = _WIRE_LEN.unpack(view[4:12])
    off = 12 + hlen
    payload_len, entries = pickle.loads(view[12:off])
    payload = bytes(view[off:off + payload_len])
    off += payload_len
    externs: List[Tuple[str, Any]] = []
    for entry in entries:
        nbytes = _unpack_extern(entry)[3]
        externs.append(_extern_from_bytes(entry, view[off:off + nbytes]))
        off += nbytes
    return Serialized(payload, externs)


def _parse_dtype(name: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError:
        # bfloat16 & friends register with numpy via ml_dtypes.
        import ml_dtypes  # noqa: F401

        return np.dtype(name)


# ---------------------------------------------------------------------------
# Flat wire layout (chunked object plane)
# ---------------------------------------------------------------------------
#
# The chunk protocol (reference: object_manager.h:117 chunked push/pull,
# object_buffer_pool.h) needs a byte-addressable view of a sealed object.
# Layout: ``payload || extern0 || extern1 || ...`` where each extern is its
# C-contiguous raw bytes.  ``wire_layout`` builds zero-copy views for host
# numpy externs (a CUDA tensor pays exactly one device→host transfer);
# ``sealed_from_flat`` rebuilds a Serialized from one contiguous buffer with
# zero-copy ``np.frombuffer`` views per extern.


def wire_layout(sealed: Serialized) -> Tuple[dict, List[memoryview]]:
    """(meta, buffers) describing ``sealed`` as a flat byte stream.

    ``meta`` pickles small and is all a receiver needs to rebuild the
    object from the flat bytes.  ``buffers`` hold references to the live
    arrays, so the layout stays valid even if the store entry is freed
    mid-transfer."""
    bufs = [memoryview(sealed.payload)]
    externs = []
    for kind, arr in sealed.externs:
        entry, host = _extern_wire_entry(kind, arr)
        externs.append(entry)
        if host.nbytes:
            bufs.append(_u8_view(host))
    meta = {"payload": len(sealed.payload), "externs": externs}
    return meta, bufs


def wire_size(meta: dict) -> int:
    return meta["payload"] + sum(e[3] for e in meta["externs"])


def read_layout_pieces(bufs: List[memoryview], offset: int,
                       length: int) -> List[memoryview]:
    """Zero-copy memoryview pieces covering [offset, offset+length) of
    the virtual concatenation (the raw object stream sendmsg's them
    directly from the live buffers)."""
    pieces = []
    taken = 0
    for b in bufs:
        n = len(b)
        if offset >= n:
            offset -= n
            continue
        take = min(length - taken, n - offset)
        pieces.append(b[offset:offset + take])
        taken += take
        offset = 0
        if taken >= length:
            break
    return pieces


def read_layout_chunk(bufs: List[memoryview], offset: int, length: int):
    """Read ``length`` bytes at ``offset`` of the virtual concatenation.
    A chunk that falls inside one buffer is returned as a zero-copy
    memoryview (the RPC layer sends bytes-like payloads raw)."""
    pieces = read_layout_pieces(bufs, offset, length)
    if len(pieces) == 1:
        return pieces[0]
    return b"".join(pieces)


def sealed_from_flat(meta: dict, buf) -> Serialized:
    """Rebuild a Serialized from a flat buffer laid out by wire_layout.
    Extern arrays are zero-copy read-only views into ``buf`` (tensors
    are rebuilt from them on their device at each read)."""
    view = memoryview(buf)
    if not view.readonly:
        view = view.toreadonly()
    off = meta["payload"]
    payload = bytes(view[:off])
    externs: List[Tuple[str, Any]] = []
    for entry in meta["externs"]:
        nbytes = _unpack_extern(entry)[3]
        externs.append(_extern_from_bytes(entry, view[off:off + nbytes]))
        off += nbytes
    return Serialized(payload, externs)


def dumps(value: Any) -> bytes:
    """One-shot: value → wire bytes."""
    return to_wire(serialize(value))


def loads(data: bytes) -> Any:
    """One-shot: wire bytes → value."""
    return deserialize(from_wire(data))

"""Node-local object plane: primary copies, spill to disk, chunk serving.

Reference semantics:
- Plasma store (src/ray/object_manager/plasma/store.h:55,
  object_lifecycle_manager.h): a per-node store of sealed immutable
  objects.  *Primary* copies are pinned — the owner's reference keeps
  them alive until an explicit free (free_primary RPC) — mirroring the
  raylet pinning the primary copy while the owner holds a reference.
- Spill/restore (src/ray/raylet/local_object_manager.h:41): above a
  capacity watermark (``object_store_memory_bytes`` ×
  ``object_spilling_threshold``), least-recently-used entries are
  written to disk in their flat wire layout and dropped from memory;
  reads restore them transparently, and remote chunk reads are served
  straight from the file without rehydrating.
- Chunk serving (object_manager.h:117, object_buffer_pool.h): remote
  pulls address fixed-size chunks over the object's flat wire layout
  (cluster.serialization.wire_layout).

Values are stored as ``Serialized`` (payload bytes + live array
externs).  Same-process consumers share numpy externs at zero cost and
clone tensor externs on their device; building the wire layout is
zero-copy for host numpy externs and pays exactly one device→host
transfer for a CUDA tensor extern, cached for the lifetime of the
entry.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from .config import GLOBAL_CONFIG
from .ids import ObjectID


class _Entry:
    __slots__ = ("sealed", "meta", "bufs", "size", "spill_path",
                 "last_access", "primary", "shm_path", "_mm")

    def __init__(self, sealed, size: int, primary: bool):
        self.sealed = sealed
        self.meta = None            # flat-layout meta (built lazily)
        self.bufs = None            # List[memoryview] over live arrays
        self.size = size
        self.spill_path: Optional[str] = None
        self.last_access = time.monotonic()
        self.primary = primary
        # Shared-memory backing (plasma proper, store.h:55): primary
        # copies live as flat layouts in a /dev/shm file; same-host
        # pullers mmap it instead of copying bytes over loopback.
        self.shm_path: Optional[str] = None
        self._mm = None


_FOREIGN_IDLE_S = 120.0  # serving-cache entries swept after this idle time


class LocalObjectStore:
    """Thread-safe sealed-object table with pinning, spill, and chunked
    reads.  One per node process."""

    def __init__(self, spill_dir: Optional[str] = None):
        self._lock = threading.RLock()
        self._entries: Dict[ObjectID, _Entry] = {}
        self._mem_bytes = 0
        self._spill_dir = spill_dir
        self._spilled_bytes = 0
        self._shm_bytes = 0
        self._num_spilled = 0
        self._num_restored = 0

    # ----------------------------------------------------------- config
    def _capacity(self) -> int:
        return int(GLOBAL_CONFIG.object_store_memory_bytes())

    def _watermark(self) -> float:
        return (self._capacity()
                * float(GLOBAL_CONFIG.object_spilling_threshold()))

    def _spill_path(self) -> str:
        if self._spill_dir is None:
            configured = GLOBAL_CONFIG.object_spilling_directory()
            self._spill_dir = configured or tempfile.mkdtemp(
                prefix="ray_tpu_spill_")
            os.makedirs(self._spill_dir, exist_ok=True)
        return self._spill_dir

    # ------------------------------------------------------------ write
    def put_primary(self, oid: ObjectID, sealed) -> None:
        """Pin a primary copy on this node.  The entry stays (in memory
        or spilled) until ``free`` — the owner's out-of-scope hook.

        Big values are re-homed into SHARED MEMORY (store.h:55 — the
        plasma design proper): the flat wire layout is written to a
        /dev/shm file once at seal time, the entry's arrays become
        zero-copy views into the mapping, and a same-host puller mmaps
        the file instead of copying a gigabyte over loopback TCP.
        Same-node consumers see numpy views (a device array extern pays
        its device→host transfer here, where the copy already happens
        for serving)."""
        with self._lock:
            if oid in self._entries:
                return  # immutable: double-seal keeps the first copy
        entry = _Entry(sealed, sealed.size_bytes, primary=True)
        shm = None
        if (sealed.size_bytes
                >= int(GLOBAL_CONFIG.object_shm_min_bytes()) > 0):
            # Copy into tmpfs OUTSIDE the lock (gigabyte memcpy).
            shm = self._build_shm(oid, sealed)
        with self._lock:
            if oid in self._entries:
                # Lost a double-seal race after the copy: drop our file.
                if shm is not None:
                    self._discard_shm(shm)
                return
            if shm is not None:
                self._commit_shm_locked(entry, shm)
                # shm entries live on the tmpfs budget, not the store's
                # heap watermark — counting them would permanently
                # saturate it and spill every non-shm object on sight.
                self._shm_bytes += entry.size
            else:
                self._mem_bytes += entry.size
            self._entries[oid] = entry
            self._maybe_spill(exclude=oid)

    def _build_shm(self, oid: ObjectID, sealed):
        """Write ``sealed``'s flat layout into a /dev/shm file; returns
        (path, mm, meta) or None on failure (tiny container tmpfs)."""
        import mmap

        from ..cluster.serialization import wire_layout, wire_size

        shm_dir = GLOBAL_CONFIG.object_shm_directory()
        if not shm_dir or not os.path.isdir(shm_dir):
            return None
        path = os.path.join(
            shm_dir, f"ray_tpu-{os.getpid()}-{oid.hex()[:24]}")
        try:
            meta, bufs = wire_layout(sealed)
            total = wire_size(meta)
            with open(path, "wb+") as f:
                # Sequential write(), NOT fallocate + mmap fill: write()
                # lands user bytes straight into fresh tmpfs pages (one
                # pass of page traffic), where fallocate zero-commits
                # every page first and the memcpy re-dirties it — 3x
                # slower measured at 256 MB.  Running out of /dev/shm
                # mid-copy stays a catchable ENOSPC (write reserves as
                # it goes), never the SIGBUS a sparse truncate+store
                # would be.
                for b in bufs:
                    f.write(b)
                f.flush()
                mm = mmap.mmap(f.fileno(), total)
            return (path, mm, meta)
        except OSError:
            try:
                os.unlink(path)
            except OSError:
                pass
            return None

    @staticmethod
    def _discard_shm(shm) -> None:
        path, mm, _meta = shm
        try:
            mm.close()
        except (OSError, BufferError):
            pass
        try:
            os.unlink(path)
        except OSError:
            pass

    @staticmethod
    def _commit_shm_locked(entry: _Entry, shm) -> None:
        """Swap the entry onto its shm backing — a handful of reference
        assignments, safe under the lock."""
        from ..cluster.serialization import sealed_from_flat

        path, mm, meta = shm
        mv = memoryview(mm)
        entry.sealed = sealed_from_flat(meta, mv.toreadonly())
        entry.meta = meta
        entry.bufs = [mv]
        entry.shm_path = path
        entry._mm = mm

    def serve_foreign(self, oid: ObjectID, sealed) -> dict:
        """Cache a *non-primary* sealed value (e.g. the owner's own
        memory-store copy) for chunk serving; returns its wire meta.
        Foreign entries are dropped (not spilled) under pressure and
        swept when idle — the real value lives elsewhere."""
        with self._lock:
            entry = self._entries.get(oid)
            if entry is None:
                entry = _Entry(sealed, sealed.size_bytes, primary=False)
                self._entries[oid] = entry
                self._mem_bytes += sealed.size_bytes
                self._maybe_spill(exclude=oid)
            return self._wire_meta_locked(oid, entry)

    # ------------------------------------------------------------- read
    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._entries

    def get_sealed(self, oid: ObjectID):
        """The sealed value, restoring from disk if spilled."""
        with self._lock:
            entry = self._entries.get(oid)
            if entry is None:
                return None
            entry.last_access = time.monotonic()
            if entry.sealed is None:
                self._restore_locked(oid, entry)
            return entry.sealed

    def wire_meta(self, oid: ObjectID) -> Optional[dict]:
        """{"meta": layout_meta, "size": total_bytes} for chunk pulls."""
        with self._lock:
            entry = self._entries.get(oid)
            if entry is None:
                return None
            entry.last_access = time.monotonic()
            return self._wire_meta_locked(oid, entry)

    def _wire_meta_locked(self, oid: ObjectID, entry: _Entry) -> dict:
        from ..cluster.serialization import wire_layout, wire_size

        if entry.meta is None or (entry.bufs is None
                                  and entry.sealed is not None):
            if entry.sealed is None:
                raise RuntimeError(f"{oid!r} spilled without meta")
            entry.meta, entry.bufs = wire_layout(entry.sealed)
        self._sweep_foreign_locked()
        return {"meta": entry.meta,
                "size": wire_size(entry.meta)}

    def read_chunk(self, oid: ObjectID, offset: int,
                   length: int) -> Optional[bytes]:
        """Serve ``length`` bytes of the flat layout.  Spilled entries
        are read from the file (no rehydration)."""
        from ..cluster.serialization import read_layout_chunk

        with self._lock:
            entry = self._entries.get(oid)
            if entry is None:
                return None
            entry.last_access = time.monotonic()
            if entry.spill_path is not None and entry.sealed is None:
                path = entry.spill_path
            else:
                if entry.bufs is None:
                    self._wire_meta_locked(oid, entry)
                return read_layout_chunk(entry.bufs, offset, length)
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                return f.read(length)
        except OSError:
            # Restored (file unlinked) between the lock release and the
            # open: serve from memory on a second pass.
            with self._lock:
                entry = self._entries.get(oid)
                if entry is None:
                    return None
                if entry.sealed is None:
                    self._restore_locked(oid, entry)
                if entry.bufs is None:
                    self._wire_meta_locked(oid, entry)
                return read_layout_chunk(entry.bufs, offset, length)

    def ensure_shm(self, oid: ObjectID) -> Optional[str]:
        """Re-home an existing entry (primary or foreign) to shared
        memory if it qualifies; returns the shm path if backed.  The
        tmpfs copy happens outside the lock (a gigabyte memcpy under it
        would stall every concurrent chunk read)."""
        with self._lock:
            entry = self._entries.get(oid)
            if entry is None or entry.sealed is None:
                return None
            qualifies = (entry.size
                         >= int(GLOBAL_CONFIG.object_shm_min_bytes()) > 0)
            if entry.shm_path is not None or not qualifies:
                return entry.shm_path
            sealed = entry.sealed
        shm = self._build_shm(oid, sealed)
        with self._lock:
            cur = self._entries.get(oid)
            if cur is None or cur.sealed is None:
                if shm is not None:
                    self._discard_shm(shm)
                return None
            if cur.shm_path is None and shm is not None:
                self._commit_shm_locked(cur, shm)
                # Move the bytes from the heap budget to the shm one.
                self._mem_bytes -= cur.size
                self._shm_bytes += cur.size
            elif shm is not None and cur.shm_path != shm[0]:
                self._discard_shm(shm)
            return cur.shm_path

    def shm_path_of(self, oid: ObjectID) -> Optional[str]:
        """The /dev/shm backing file, if this entry was re-homed —
        same-host pullers mmap it instead of pulling bytes."""
        with self._lock:
            entry = self._entries.get(oid)
            return entry.shm_path if entry is not None else None

    def read_chunk_pieces(self, oid: ObjectID, offset: int, length: int):
        """Zero-copy memoryview pieces of the flat layout for the raw
        object stream (cluster/client.py ObjectStreamServer) — sendmsg
        ships them without assembling a bytes copy.  Spilled entries
        fall back to one file-read piece."""
        from ..cluster.serialization import read_layout_pieces

        with self._lock:
            entry = self._entries.get(oid)
            if entry is None:
                return None
            entry.last_access = time.monotonic()
            if not (entry.spill_path is not None and entry.sealed is None):
                if entry.bufs is None:
                    self._wire_meta_locked(oid, entry)
                return read_layout_pieces(entry.bufs, offset, length)
        data = self.read_chunk(oid, offset, length)
        return None if data is None else [memoryview(data)]

    # ------------------------------------------------------------- free
    def free(self, oid: ObjectID) -> None:
        with self._lock:
            entry = self._entries.pop(oid, None)
            if entry is None:
                return
            if entry.sealed is not None:
                if entry.shm_path is not None:
                    self._shm_bytes -= entry.size
                else:
                    self._mem_bytes -= entry.size
            if entry.spill_path is not None:
                self._spilled_bytes -= entry.size
                try:
                    os.unlink(entry.spill_path)
                except OSError:
                    pass
            if entry.shm_path is not None:
                # Unlink only: pullers holding the mapping keep the
                # pages alive (POSIX); fresh pulls fall back to TCP.
                try:
                    os.unlink(entry.shm_path)
                except OSError:
                    pass

    # ---------------------------------------------------------- spilling
    def _maybe_spill(self, exclude: Optional[ObjectID] = None) -> None:
        """Called under the lock after a write.  Spill (primaries) or
        drop (foreign) LRU entries until under the watermark."""
        watermark = self._watermark()
        if self._mem_bytes <= watermark:
            return
        candidates = sorted(
            ((oid, e) for oid, e in self._entries.items()
             if e.sealed is not None and oid != exclude
             # shm-backed entries are exempt: mappings may be shared
             # with same-host pullers, and tmpfs pages are already the
             # OS's to reclaim via swap.
             and e.shm_path is None),
            key=lambda kv: kv[1].last_access)
        for oid, entry in candidates:
            if self._mem_bytes <= watermark:
                break
            if entry.primary:
                self._spill_one_locked(oid, entry)
            else:
                self._entries.pop(oid, None)
                self._mem_bytes -= entry.size

    def _spill_one_locked(self, oid: ObjectID, entry: _Entry) -> None:
        from ..cluster.serialization import wire_layout

        if entry.meta is None or entry.bufs is None:
            entry.meta, entry.bufs = wire_layout(entry.sealed)
        path = os.path.join(self._spill_path(),
                            f"{oid.hex()}.obj")
        with open(path, "wb") as f:
            for b in entry.bufs:
                f.write(b)
        entry.spill_path = path
        entry.sealed = None
        entry.bufs = None
        self._mem_bytes -= entry.size
        self._spilled_bytes += entry.size
        self._num_spilled += 1

    def _restore_locked(self, oid: ObjectID, entry: _Entry) -> None:
        from ..cluster.serialization import sealed_from_flat

        with open(entry.spill_path, "rb") as f:
            raw = f.read()
        entry.sealed = sealed_from_flat(entry.meta, raw)
        entry.bufs = None  # rebuilt lazily over the restored arrays
        try:
            os.unlink(entry.spill_path)
        except OSError:
            pass
        entry.spill_path = None
        self._spilled_bytes -= entry.size
        self._mem_bytes += entry.size
        self._num_restored += 1
        self._maybe_spill(exclude=oid)

    def _sweep_foreign_locked(self) -> None:
        cutoff = time.monotonic() - _FOREIGN_IDLE_S
        stale = [oid for oid, e in self._entries.items()
                 if not e.primary and e.last_access < cutoff]
        for oid in stale:
            entry = self._entries.pop(oid)
            if entry.sealed is not None:
                self._mem_bytes -= entry.size

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "num_objects": len(self._entries),
                "mem_bytes": self._mem_bytes,
                "spilled_bytes": self._spilled_bytes,
                "shm_bytes": self._shm_bytes,
                "num_spilled": self._num_spilled,
                "num_restored": self._num_restored,
            }

    def destroy(self) -> None:
        with self._lock:
            paths = [e.spill_path for e in self._entries.values()
                     if e.spill_path]
            paths += [e.shm_path for e in self._entries.values()
                      if e.shm_path]
            self._entries.clear()
            self._mem_bytes = 0
            self._spilled_bytes = 0
            self._shm_bytes = 0
        for p in paths:
            try:
                os.unlink(p)
            except OSError:
                pass

"""Paged KV-cache management for the continuous-batching decode loop
(the port's copy of ``ray_tpu/serve/kv_cache.py``; the port imports
nothing of ``ray_tpu``).

vLLM (SOSP '23) showed that a dense per-slot KV region — memory
``max_slots x max_len`` regardless of live occupancy — is the wrong
shape for production serving: most slots are short, identical system
prompts are recomputed and stored per request, and a long request
reserves its worst-case footprint up front.  This module is the HOST
side of the paged design:

- :class:`KVBlockAllocator` — the physical pool's bookkeeping: fixed
  ``block_size``-token blocks, a free list, per-block refcounts.
  Exhaustion raises a typed :class:`BackPressureError` (admission
  control, never an OOM) after asking the reclaimer (prefix-cache LRU
  eviction) for blocks.
- :class:`BlockTable` — one request's logical->physical mapping.  The
  table's flat block-id list IS the gather index the paged attention
  read uses (block ``i`` holds positions ``[i*bs, (i+1)*bs)``), so the
  gathered layout equals the dense layout position-for-position and
  decode stays bit-identical to the dense path.
- :class:`PrefixCache` — a hash trie over block-granular token chunks
  with copy-on-write sharing: a request whose prompt starts with an
  already-cached block chain maps those positions to the SHARED
  refcounted blocks (fork = incref, no copy) and only computes/stores
  the suffix.  Full prompt blocks are published back into the trie;
  eviction under memory pressure walks leaves in LRU order and only
  frees blocks nobody else references.

The device side (block-gathering attention, scatter-back writes,
static block-count buckets) lives in ``serve/llm.py``.  The occupancy
and prefix-cache series go to the metrics plane
(``observability/metrics.py``) under the reference's names.

Thread-safety: every public method takes the allocator lock; the
prefix cache shares its allocator's lock so a lookup's incref and an
eviction's free can't interleave.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..observability.metrics import kv_cache_counters
from ..exceptions import BackPressureError

# Block 0 is the NULL block: never allocated, used as the gather/
# scatter sink for block-table padding (padding gathers garbage that
# attention masks out; padding scatters land there and are never read
# unmasked).
NULL_BLOCK = 0


# ---------------------------------------------------------------------------
# Quantized block formats
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KVQuantFormat:
    """One reduced-precision KV block layout.

    Blocks store ``dtype`` values plus ONE float32 scale per KV
    ROW — (block, layer, position, kv_head) — mapping that row's amax
    onto ``qmax``, so dequantization is ``stored * scale``.  Row (not
    block-wide) scaling matters: K rows after rope sweep
    position-dependent dynamic ranges that differ by >10x across
    heads and positions, and a single block-wide scale wastes most of
    the 8-bit grid on the loudest row.  The scale tensor is
    ``num_blocks x L x block_size x Hkv`` f32 = ``4/head_dim`` of the
    stored bytes (~3% at head_dim 128), counted by the capacity math
    below.
    """

    name: str
    dtype: torch.dtype  # torch.int8 / torch.float8_e4m3fn
    qmax: float         # the value amax maps to (127 int8, 448 e4m3)
    itemsize: int       # bytes per stored element


KV_QUANT_FORMATS: Dict[str, KVQuantFormat] = {
    "int8": KVQuantFormat("int8", torch.int8, 127.0, 1),
    "fp8": KVQuantFormat("fp8", torch.float8_e4m3fn, 448.0, 1),
}


def kv_quant_info(name: Optional[str]) -> Optional[KVQuantFormat]:
    """Resolve a quant-format name (None → full-precision pool)."""
    if name is None:
        return None
    fmt = KV_QUANT_FORMATS.get(name)
    if fmt is None:
        raise ValueError(
            f"unknown kv_quant {name!r} "
            f"(choose from {sorted(KV_QUANT_FORMATS)})")
    return fmt


def blocks_for_bytes(pool_bytes: int, n_layers: int, block_size: int,
                     n_kv_heads: int, head_dim: int,
                     kv_quant: Optional[str] = None,
                     dtype_bytes: int = 2) -> int:
    """How many usable blocks a byte budget buys (the capacity math
    behind the quantized-KV bench: same pool bytes, int8 blocks carry
    ~2x the tokens bf16 blocks do).  Counts K+V and, for quantized
    formats, the per-row (block, layer, position, head) f32
    scales."""
    fmt = kv_quant_info(kv_quant)
    per_elem = fmt.itemsize if fmt else dtype_bytes
    block_bytes = 2 * n_layers * block_size * n_kv_heads * head_dim \
        * per_elem
    if fmt:
        # Per-row f32 scales: 4/head_dim of the stored bytes.
        block_bytes += 2 * n_layers * block_size * n_kv_heads * 4
    return max(0, int(pool_bytes) // block_bytes)


class KVBlockAllocator:
    """Refcounted free-list allocator over a pool of ``num_blocks``
    fixed-size blocks (ids ``1..num_blocks-1``; block 0 is reserved as
    the null/padding block).

    ``owner`` tags (e.g. a multiplexed model id) let a whole owner's
    holds be released in one call (``release_owner``) when the model
    multiplexer evicts a model — without it, evicting a model leaks
    its prefix-cache blocks until process exit.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 pool_label: str = "default",
                 reclaim: Optional[Callable[[int], int]] = None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.pool_label = pool_label
        self._lock = threading.RLock()
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref = [0] * num_blocks
        # owner -> {block_id: holds} (one owner may hold a block more
        # than once: N requests of one model sharing a prefix block).
        self._owner_holds: Dict[str, Dict[int, int]] = {}
        # Called (under the lock) when allocation comes up short:
        # should free up to N blocks and return how many it freed
        # (wired to PrefixCache.evict by the engine).
        self._reclaim = reclaim
        self._publish()

    # ------------------------------------------------------------- stats
    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_blocks(self) -> int:
        with self._lock:
            return (self.num_blocks - 1) - len(self._free)

    def _publish(self) -> None:
        m = kv_cache_counters()
        tags = {"pool": self.pool_label}
        m["blocks_used"].set(
            (self.num_blocks - 1) - len(self._free), tags=tags)
        m["blocks_free"].set(len(self._free), tags=tags)

    def set_reclaimer(self, reclaim: Callable[[int], int]) -> None:
        with self._lock:
            self._reclaim = reclaim

    # -------------------------------------------------------- allocation
    def alloc(self, n: int, owner: str = "") -> List[int]:
        """Allocate ``n`` fresh blocks (refcount 1 each) or raise a
        typed ``BackPressureError`` — the pool being full is an
        admission-control signal the serving plane sheds/requeues on,
        never an OOM.  All-or-nothing: a partial grab is rolled back so
        a failed admission can't strand blocks."""
        if n <= 0:
            return []
        with self._lock:
            short = n - len(self._free)
            if short > 0 and self._reclaim is not None:
                self._reclaim(short)
            if n > len(self._free):
                raise BackPressureError(
                    f"KV block pool exhausted: need {n}, "
                    f"{len(self._free)} free of {self.num_blocks - 1}",
                    retry_after_s=0.05,
                    context={"pool": self.pool_label,
                             "block_size": self.block_size})
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
                if owner:
                    self._hold(owner, b)
            self._publish()
            return out

    def _hold(self, owner: str, block: int) -> None:
        holds = self._owner_holds.setdefault(owner, {})
        holds[block] = holds.get(block, 0) + 1

    def _unhold(self, owner: str, block: int) -> None:
        holds = self._owner_holds.get(owner)
        if not holds:
            return
        left = holds.get(block, 0) - 1
        if left <= 0:
            holds.pop(block, None)
            if not holds:
                self._owner_holds.pop(owner, None)
        else:
            holds[block] = left

    def fork(self, blocks: Sequence[int], owner: str = "") -> None:
        """Copy-on-write share: a new reader of ``blocks`` increments
        each refcount.  No bytes move — the paged read gathers the same
        physical blocks for every sharer, and writes never target a
        shared block (a request only writes its own tail blocks)."""
        with self._lock:
            for b in blocks:
                self._check_live(b, "fork")
                self._ref[b] += 1
                if owner:
                    self._hold(owner, b)

    def free(self, blocks: Sequence[int], owner: str = "") -> int:
        """Drop one reference per block; blocks reaching refcount 0
        return to the free list.  Freeing an unallocated block raises
        (double-free guard: an aborted request must not free its table
        twice).  Returns how many blocks became free."""
        freed = 0
        with self._lock:
            for b in blocks:
                self._check_live(b, "free")
                self._ref[b] -= 1
                if owner:
                    self._unhold(owner, b)
                if self._ref[b] == 0:
                    self._free.append(b)
                    freed += 1
            if freed:
                self._publish()
        return freed

    def _check_live(self, b: int, op: str) -> None:
        if not (0 < b < self.num_blocks):
            raise ValueError(f"{op}: block id {b} out of range "
                             f"(1..{self.num_blocks - 1})")
        if self._ref[b] <= 0:
            raise RuntimeError(
                f"{op} of unallocated block {b} (double free?)")

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref[block]

    def release_owner(self, owner: str) -> int:
        """Free every hold ``owner`` still has (multiplexed-model
        eviction: the model's prefix trie and any straggler tables go
        back to the pool in one sweep).  Returns blocks freed."""
        with self._lock:
            holds = self._owner_holds.pop(owner, None)
            if not holds:
                return 0
            freed = 0
            for b, n in holds.items():
                for _ in range(n):
                    if self._ref[b] > 0:
                        self._ref[b] -= 1
                        if self._ref[b] == 0:
                            self._free.append(b)
                            freed += 1
            if freed:
                self._publish()
            return freed


class BlockTable:
    """One request's ordered physical block list.  ``blocks[i]`` holds
    token positions ``[i*block_size, (i+1)*block_size)``; the first
    ``num_shared`` entries are COW blocks forked from the prefix cache
    (read-only for this request — its writes start past them)."""

    __slots__ = ("allocator", "blocks", "num_shared", "owner", "_freed")

    def __init__(self, allocator: KVBlockAllocator,
                 shared: Sequence[int] = (), owner: str = ""):
        self.allocator = allocator
        self.blocks: List[int] = list(shared)
        self.num_shared = len(self.blocks)
        self.owner = owner
        self._freed = False

    @property
    def capacity_tokens(self) -> int:
        return len(self.blocks) * self.allocator.block_size

    def ensure(self, num_tokens: int) -> None:
        """Grow the table to cover ``num_tokens`` positions, allocating
        fresh (owned) blocks as needed.  Raises ``BackPressureError``
        if the pool can't supply them (caller sheds or preempts)."""
        bs = self.allocator.block_size
        need = (num_tokens + bs - 1) // bs - len(self.blocks)
        if need > 0:
            self.blocks.extend(
                self.allocator.alloc(need, owner=self.owner))

    def trim(self, num_tokens: int) -> int:
        """Speculative-decode rollback: release owned tail blocks past
        what ``num_tokens`` ACCEPTED positions need.  A verify pass
        grows the table for the full k-token proposal; rejected
        suffixes must hand those blocks straight back so pool pressure
        reflects only accepted tokens.  Never trims into the COW
        prefix (``num_shared`` blocks are forked references whose
        positions are part of the prompt).  Returns blocks released
        back to the allocator's refcounting (not necessarily freed —
        the prefix cache may still hold them)."""
        bs = self.allocator.block_size
        keep = max((num_tokens + bs - 1) // bs, self.num_shared)
        if keep >= len(self.blocks):
            return 0
        tail = self.blocks[keep:]
        del self.blocks[keep:]
        self.allocator.free(tail, owner=self.owner)
        return len(tail)

    def release(self) -> None:
        """Return every reference this table holds (idempotent: the
        abort path and the finish path may both reach it)."""
        if self._freed:
            return
        self._freed = True
        blocks, self.blocks = self.blocks, []
        self.allocator.free(blocks, owner=self.owner)

    def __len__(self) -> int:
        return len(self.blocks)


class _TrieNode:
    __slots__ = ("key", "block", "children", "parent", "last_used")

    def __init__(self, key: Optional[Tuple[int, ...]], block: int,
                 parent: Optional["_TrieNode"]):
        self.key = key
        self.block = block
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    """Hash trie over block-granular prompt chunks.

    A node at depth ``d`` is keyed by the tuple of tokens in the d-th
    block of some previously-seen prompt and owns one reference on the
    physical block holding that chunk's K/V.  Identical system prompts
    therefore map to ONE shared block chain: ``lookup`` forks
    (increfs) the matched chain for the caller and returns it, so the
    engine prefills only the remaining suffix.

    Eviction is leaf-first LRU over nodes whose block nobody but the
    cache references — wired as the allocator's reclaimer, so a full
    pool sheds cold cached prefixes before rejecting admissions.
    """

    def __init__(self, allocator: KVBlockAllocator, owner: str = ""):
        self.allocator = allocator
        self.owner = owner + ":prefix" if owner else "prefix"
        self._lock = allocator._lock  # one lock: incref vs evict races
        self._root = _TrieNode(None, NULL_BLOCK, None)
        self._clock = 0
        self._nodes = 0
        allocator.set_reclaimer(self.evict)

    # ------------------------------------------------------------ stats
    @property
    def num_blocks(self) -> int:
        with self._lock:
            return self._nodes

    def _count(self, name: str) -> None:
        kv_cache_counters()[name].inc(
            tags={"pool": self.allocator.pool_label})

    # ----------------------------------------------------------- lookup
    def lookup(self, tokens: Sequence[int],
               owner: str = "") -> List[int]:
        """Longest cached block-chain prefix of ``tokens`` (complete
        blocks only — a partial block is never shared because its tail
        positions still get written).  Matched blocks are COW-forked
        for the caller (incref'd under the shared lock) and returned in
        position order; the caller's BlockTable owns releasing them."""
        bs = self.allocator.block_size
        # Never match the ENTIRE prompt: the engine needs at least one
        # suffix token to prefill so the first generated token has a
        # query position (and the last block keeps being written).
        usable = max(0, (len(tokens) - 1) // bs)
        matched: List[int] = []
        with self._lock:
            node = self._root
            self._clock += 1
            for i in range(usable):
                key = tuple(tokens[i * bs:(i + 1) * bs])
                child = node.children.get(key)
                if child is None:
                    break
                child.last_used = self._clock
                matched.append(child.block)
                node = child
            if matched:
                self.allocator.fork(matched, owner=owner)
        self._count("prefix_hits" if matched else "prefix_misses")
        return matched

    def insert(self, tokens: Sequence[int],
               blocks: Sequence[int]) -> None:
        """Publish a prompt's complete blocks into the trie.  Chunks
        already present keep their existing (shared) block; new chunks
        take one cache-owned reference on the request's block so it
        outlives the request."""
        bs = self.allocator.block_size
        full = min(len(tokens) // bs, len(blocks))
        with self._lock:
            node = self._root
            self._clock += 1
            for i in range(full):
                key = tuple(tokens[i * bs:(i + 1) * bs])
                child = node.children.get(key)
                if child is None:
                    child = _TrieNode(key, blocks[i], node)
                    self.allocator.fork([blocks[i]], owner=self.owner)
                    node.children[key] = child
                    self._nodes += 1
                elif child.block != blocks[i]:
                    # The chain diverges from the cached copy (same
                    # tokens, different physical block — the request
                    # prefilled before a concurrent insert won).  Keep
                    # the incumbent; deeper chunks would describe
                    # positions in OUR blocks against ITS chain, so
                    # stop rather than mix the two.
                    child.last_used = self._clock
                    break
                child.last_used = self._clock
                node = child

    # ---------------------------------------------------------- eviction
    def evict(self, want: int) -> int:
        """Free up to ``want`` blocks by dropping trie leaves in LRU
        order, skipping any block still referenced outside the cache
        (an active request reads it).  Runs under the allocator lock
        (it IS the allocator's reclaimer) — so it is ONE DFS plus a
        heap, not a rescan per freed block: dropping a leaf may expose
        its parent, which joins the heap with its own recency."""
        import heapq

        freed = 0
        with self._lock:
            heap = []  # (last_used, tiebreak, node)
            tie = 0
            stack = [self._root]
            while stack:
                n = stack.pop()
                if not n.children and n is not self._root:
                    if self.allocator.refcount(n.block) == 1:
                        heap.append((n.last_used, tie, n))
                        tie += 1
                else:
                    stack.extend(n.children.values())
            heapq.heapify(heap)
            while freed < want and heap:
                _lu, _t, victim = heapq.heappop(heap)
                if victim.children or victim.parent is None:
                    continue  # stale entry (shouldn't happen)
                self._drop_node(victim)
                freed += 1
                parent = victim.parent
                if (parent is not self._root and not parent.children
                        and self.allocator.refcount(parent.block)
                        == 1):
                    tie += 1
                    heapq.heappush(heap,
                                   (parent.last_used, tie, parent))
        return freed

    def _drop_node(self, node: _TrieNode) -> None:
        node.parent.children.pop(node.key, None)
        self._nodes -= 1
        self.allocator.free([node.block], owner=self.owner)

    def drop(self) -> int:
        """Release the whole trie (model eviction / engine shutdown):
        every cache-held reference goes back to the allocator.  Blocks
        still forked by in-flight requests stay alive until those
        tables release.  Returns blocks freed."""
        with self._lock:
            stack = list(self._root.children.values())
            self._root.children.clear()
            dropped = 0
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                n.children.clear()
                self.allocator.free([n.block], owner=self.owner)
                dropped += 1
            self._nodes = 0
            return dropped


def release_model_kv(model, model_id: str = "") -> bool:
    """Best-effort KV release hook for multiplexed-model eviction
    (called by ``serve.multiplexed``'s LRU before ``unload``): a model
    exposing ``release_kv_cache()`` frees its paged-KV holds (block
    tables, prefix trie) back to the shared allocator.  Returns True
    if the model had the hook."""
    fn = getattr(model, "release_kv_cache", None)
    if not callable(fn):
        return False
    try:
        fn()
    except Exception:
        pass
    return True

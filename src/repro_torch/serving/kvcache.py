"""Paged-KV block bookkeeping: a ref-counted, content-addressed page pool.

In paged mode (Engine(paged=True)) the BlockManager IS the serving memory
system: the block ids it hands out index the workers' shared page pools,
prefill/decode write through them, admission reserves against
``free_blocks``/``blocks_needed`` (Engine._can_admit), and §6.2
KV-migration gathers exactly ``blocks_of`` the in-flight requests
("query the cache block manager to obtain the blocks used by existing
requests"). In the slot-contiguous layout it remains the paged
*accounting* twin of the contiguous caches and quotes migration byte
costs.

With ``prefix_cache=True`` the pool is additionally *content-addressed*
(vLLM-style automatic prefix caching):

  * every **full** block whose KV has actually been computed is
    registered under a token-chain hash (sha256 over the block's tokens
    chained with the previous block's hash, so a block id stands for a
    whole prefix, not a bag of tokens);
  * ``allocate`` matches a new request's prompt against the index and
    shares the longest cached prefix — shared blocks just gain a
    reference, only the suffix needs fresh blocks (and fresh compute);
  * a fully-cached prompt still recomputes its last token (the engine
    needs logits to sample from), so the last matched block is
    **copied-on-write**: the match keeps a private copy and the shared
    page is never written through;
  * ``free`` keeps registered blocks around at refcount zero as an LRU
    cache instead of returning them to the free list; ``allocate`` /
    ``extend`` evict those cold blocks LRU-first when the free list runs
    dry, so cached prefixes never cause admission to defer.

Registration is **engine-driven** (``commit``): blocks enter the index
only once their KV has been written by a prefill chunk or decode step —
a half-prefilled request never exposes garbage pages to other requests.

``blocks_of`` / ``migration_bytes`` are dedup-aware: a block shared by
several in-flight requests is reported (and shipped by §6.2
consolidation) exactly once.

**Notifications** (``commit_hooks`` / ``evict_hooks``): every index
mutation is observable. A commit hook fires when a chain hash enters the
index (engine commit or host-tier restore); an evict hook fires when one
leaves it (LRU eviction in ``_take_block``, consolidation's
``drop_unreferenced_cache``) — *before* the block id is handed out for
reuse, so a listener can still read the page content (the engine's
HBM→host KV spill) or drop the hash from an external residency index
(the router's per-replica warm-prefix map) without ever going stale.

**Multi-tier restore** (``kv_tier``): when a lower KV tier is attached
(see repro_torch/router/kvtier.py), ``allocate``'s prefix match does not stop
at the first HBM index miss — a chain block whose hash the tier holds is
assigned a *fresh* block, registered in the index, and queued on
``pending_restores``; the engine drains the queue
(``Engine._apply_restores``) by copying the spilled page bytes back into
the worker pools and accounting the transfer as a measured flow. A
restored block is indistinguishable from a committed one afterwards:
prefill skips it, followers share it, eviction spills it again.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class KVInvariantError(RuntimeError):
    """A KV-lifecycle invariant was violated (refcount underflow, short
    token chain, payload/pipeline mismatch, ...). Raised explicitly — not
    via ``assert`` — so ``python -O`` cannot strip the guard."""


def _chain_hash(prev: bytes, block_tokens: Sequence[int]) -> bytes:
    """Hash of a full block's token ids chained onto its prefix's hash."""
    h = hashlib.sha256(prev)
    h.update(np.asarray(list(block_tokens), np.int64).tobytes())
    return h.digest()


@dataclass
class BlockTable:
    request_id: int
    blocks: List[int] = field(default_factory=list)
    length: int = 0                  # tokens written
    tokens: Optional[List[int]] = None   # token-id chain (None: not hashable)
    cached_tokens: int = 0           # prefix tokens served from the cache
    restored_tokens: int = 0         # ...of which came from a lower KV tier
    _n_hashed: int = 0               # full blocks whose chain hash is known
    _chain: bytes = b""              # running chain hash over those blocks


class BlockManager:
    def __init__(self, n_blocks: int, block_size: int,
                 bytes_per_token: int, prefix_cache: bool = False):
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.bytes_per_token = bytes_per_token
        self.prefix_cache = prefix_cache
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._ref: List[int] = [0] * n_blocks
        self.tables: Dict[int, BlockTable] = {}
        # content-addressing state (prefix_cache only)
        self._index: Dict[bytes, int] = {}       # chain hash -> block id
        self._hash_of: Dict[int, bytes] = {}     # block id -> chain hash
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # LRU, ref==0
        self.pending_copies: List[Tuple[int, int]] = []  # COW (src, dst)
        # index-mutation notifications: fired with (block_id, chain_hash)
        # when a hash enters / leaves the index. Evict hooks fire BEFORE
        # the block id is reused, while its page content is still intact.
        self.commit_hooks: List[Callable[[int, bytes], None]] = []
        self.evict_hooks: List[Callable[[int, bytes], None]] = []
        # lower KV tier consulted by allocate's prefix match (duck-typed:
        # needs only .has(hash)); restores queued for the engine to apply
        self.kv_tier = None
        self.pending_restores: List[Tuple[bytes, int]] = []  # (hash, dst)
        # correctness tracer (analysis/sanitizer.py). None in production —
        # every call site is guarded, so the sanitize-off path runs the
        # exact pre-instrumentation code with a single attribute test.
        self.tracer = None
        # stats
        self.cache_queries = 0
        self.cache_hit_tokens = 0
        self.evictions = 0
        self.restores = 0
        self.preempt_releases = 0

    # ------------------------------------------------------ notifications
    def _fire_commit(self, blk: int, h: bytes):
        for cb in self.commit_hooks:
            cb(blk, h)

    def _fire_evict(self, blk: int, h: bytes):
        for cb in self.evict_hooks:
            cb(blk, h)

    # ------------------------------------------------------------ alloc
    def blocks_needed(self, n_tokens: int) -> int:
        """Blocks required to hold ``n_tokens`` cache rows (ceil div)."""
        return -(-n_tokens // self.block_size)

    def can_allocate(self, n_tokens: int) -> bool:
        """Convenience query for external callers. The engine's admission
        control does NOT use this — it reserves worst-case decode tails
        across all residents in one check (Engine._can_admit)."""
        return self.free_blocks >= self.blocks_needed(n_tokens)

    def _take_block(self) -> int:
        """Pop a free block, evicting the LRU cached (refcount-zero)
        block when the free list is dry. Callers check ``free_blocks``.
        The evict hooks fire before the block id is returned — the page
        content is still intact when listeners (KV spill, residency
        index) observe the eviction."""
        if self._free:
            return self._free.pop()
        blk, _ = self._cached.popitem(last=False)      # least recently used
        h = self._hash_of.pop(blk)
        if self._index.get(h) == blk:
            del self._index[h]
            self._fire_evict(blk, h)
        self.evictions += 1
        return blk

    def _ref_block(self, blk: int):
        self._ref[blk] += 1
        self._cached.pop(blk, None)   # a referenced block is not evictable

    def _unref_block(self, blk: int):
        self._ref[blk] -= 1
        if self._ref[blk] < 0:
            raise KVInvariantError(f"refcount underflow on block {blk}")
        if self._ref[blk] > 0:
            return
        h = self._hash_of.get(blk)
        if h is not None and self._index.get(h) == blk:
            self._cached[blk] = None          # keep content, LRU tail
            self._cached.move_to_end(blk)
        else:
            self._hash_of.pop(blk, None)
            self._free.append(blk)

    def allocate(self, request_id: int, n_tokens: int,
                 tokens: Optional[Sequence[int]] = None) -> BlockTable:
        """Build a block table for a request of ``n_tokens`` prompt rows.

        When the pool is content-addressed and ``tokens`` are given, the
        longest indexed prefix (full blocks only) is shared instead of
        re-allocated; ``BlockTable.cached_tokens`` tells the engine how
        many prompt tokens need no prefill compute. A fully-cached prompt
        is capped at ``n_tokens - 1`` and the block holding the final
        token is copied-on-write (see ``drain_copies``).

        With a ``kv_tier`` attached the match keeps walking past HBM
        misses: a chain block the tier holds is *restored* — it takes a
        fresh block (registered in the index immediately; the engine
        writes the spilled bytes before anything reads them) and counts
        toward ``cached_tokens`` (``BlockTable.restored_tokens`` says how
        much of that prefix rode the transfer network instead of HBM).
        """
        tr = self.tracer
        if tr is not None:
            n_pr0 = len(self.pending_restores)
            n_pc0 = len(self.pending_copies)
        t = BlockTable(request_id,
                       tokens=list(tokens) if tokens is not None else None)
        # matched chain prefix: (hash, block-or-None); None = host restore
        matched: List[Tuple[bytes, Optional[int]]] = []
        n_hbm = 0
        chain = b""
        if self.prefix_cache and tokens is not None:
            if len(tokens) < n_tokens:
                raise KVInvariantError("token chain shorter than prompt")
            self.cache_queries += 1
            h = b""
            for i in range(n_tokens // self.block_size):
                h = _chain_hash(h, tokens[i * self.block_size:
                                          (i + 1) * self.block_size])
                blk = self._index.get(h)
                if blk is None and not (self.kv_tier is not None
                                        and self.kv_tier.has(h)):
                    break
                matched.append((h, blk))
                n_hbm += blk is not None
                chain = h
        # always recompute >= 1 prompt token (the engine samples from the
        # last prefill logit), so a full-prompt hit is capped at n-1
        cached = min(len(matched) * self.block_size, max(n_tokens - 1, 0))
        # ref the HBM prefix first: a resident matched block must not be
        # LRU-evicted by the _take_block calls that follow
        for h, blk in matched:
            if blk is not None:
                self._ref_block(blk)
        cow = cached < len(matched) * self.block_size
        # fresh blocks: restored prefix blocks + the suffix, plus a
        # private copy of the COW block
        need = self.blocks_needed(n_tokens) - n_hbm + (1 if cow else 0)
        if len(self._free) + len(self._cached) < need:
            for h, blk in matched:            # roll back the prefix refs
                if blk is not None:
                    self._unref_block(blk)
            raise MemoryError("out of KV blocks")
        blocks: List[int] = []
        for h, blk in matched:
            if blk is None:                   # host-tier restore
                blk = self._take_block()
                self._ref[blk] += 1
                self._index[h] = blk
                self._hash_of[blk] = h
                self.pending_restores.append((h, blk))
                self.restores += 1
                self._fire_commit(blk, h)
                t.restored_tokens += self.block_size
            else:
                pass                          # already ref'd above
            blocks.append(blk)
        if cow:
            src = blocks.pop()                # stays pinned via its ref
            dst = self._take_block()
            self._ref[dst] += 1
            self.pending_copies.append((src, dst))
            blocks.append(dst)
        for _ in range(self.blocks_needed(n_tokens) - len(matched)):
            blk = self._take_block()
            self._ref[blk] += 1
            blocks.append(blk)
        t.blocks = blocks
        t.length = n_tokens
        t.cached_tokens = cached
        t._n_hashed = len(matched)            # chain covers the COW block too
        t._chain = chain
        self.cache_hit_tokens += cached
        self.tables[request_id] = t
        if tr is not None:
            tr.on_alloc(request_id, list(t.blocks), n_tokens,
                        shared=[b for _, b in matched if b is not None],
                        restored=list(self.pending_restores[n_pr0:]),
                        cow=list(self.pending_copies[n_pc0:]),
                        cached=cached)
        return t

    def drain_copies(self) -> List[Tuple[int, int]]:
        """Hand the engine the pending COW ``(src, dst)`` page copies and
        release the source pins. The caller must apply the copies to the
        worker pools before the next ``allocate``/``extend`` call (which
        may evict a released source)."""
        out, self.pending_copies = self.pending_copies, []
        if self.tracer is not None:
            self.tracer.on_drain_copies(list(out))
        for src, _ in out:
            self._unref_block(src)
        return out

    def drain_restores(self) -> List[Tuple[bytes, int]]:
        """Hand the engine the pending ``(chain_hash, dst_block)`` host-
        tier restores queued by ``allocate``. The caller must write the
        spilled page bytes into the worker pools before anything reads
        the blocks — and before ``drain_copies`` is applied, since a COW
        source may itself be a restored block."""
        out, self.pending_restores = self.pending_restores, []
        return out

    def extend(self, request_id: int, n_tokens: int = 1,
               token: Optional[int] = None):
        t = self.tables[request_id]
        new_len = t.length + n_tokens
        need = self.blocks_needed(new_len) - len(t.blocks)
        if need > self.free_blocks:
            raise MemoryError("out of KV blocks")
        for _ in range(need):
            blk = self._take_block()
            self._ref[blk] += 1
            t.blocks.append(blk)
        t.length = new_len
        if self.tracer is not None:
            self.tracer.on_extend(request_id,
                                  t.blocks[-need:] if need > 0 else [],
                                  new_len)
        if t.tokens is not None:
            if token is not None and n_tokens == 1:
                t.tokens.append(token)
            else:                 # chain broken: stop hashing this table
                t.tokens = None
        return t

    def commit(self, request_id: int, n_valid: int):
        """Register full blocks whose KV is materialized through row
        ``n_valid`` in the prefix index. Engine-driven: called after each
        prefill chunk / decode write, so the index never points at pages
        that have not been computed yet."""
        if self.tracer is not None:
            self.tracer.on_commit(request_id, n_valid)
        if not self.prefix_cache:
            return
        t = self.tables.get(request_id)
        if t is None or t.tokens is None:
            return
        bs = self.block_size
        limit = min(n_valid, len(t.tokens), t.length)
        while (t._n_hashed + 1) * bs <= limit:
            i = t._n_hashed
            h = _chain_hash(t._chain, t.tokens[i * bs:(i + 1) * bs])
            blk = t.blocks[i]
            if h not in self._index:          # first writer wins; duplicate
                self._index[h] = blk          # content is simply unshared
                self._hash_of[blk] = h
                self._fire_commit(blk, h)
            t._chain = h
            t._n_hashed += 1

    def free(self, request_id: int):
        t = self.tables.pop(request_id, None)
        if self.tracer is not None:
            self.tracer.on_free(request_id, list(t.blocks) if t else None)
        if t:
            for blk in reversed(t.blocks):
                self._unref_block(blk)

    def release_for_preempt(self, request_id: int) -> int:
        """Release a *preempted* request's blocks back to the pool.

        Mechanically this unrefs the same way ``free`` does, but the
        semantics differ: the request is suspended, not finished, and it
        WILL come back. With the prefix cache on, every committed full
        block stays registered in the hash index (refcount-zero, LRU-
        evictable like any cached block), so the request's re-admission
        matches its own prefix and re-prefills only the tail that was
        never committed — or was evicted in the meantime. Preemption-by-
        recompute is therefore O(uncached tail), not O(prompt + output).
        Without the prefix cache the release is a plain free and resume
        recomputes the whole chain. Returns the number of block
        references released (0 if the request held no table).
        """
        t = self.tables.pop(request_id, None)
        if self.tracer is not None:
            self.tracer.on_release(request_id,
                                   list(t.blocks) if t else None)
        if t is None:
            return 0
        for blk in reversed(t.blocks):
            self._unref_block(blk)
        self.preempt_releases += 1
        return len(t.blocks)

    def drop_unreferenced_cache(self):
        """Forget every refcount-zero cached block (index entries and
        all). Used at §6.2 consolidation: the gather only ships blocks of
        live requests, so cold cached pages would dangle in the new
        pool."""
        for blk in self._cached:
            h = self._hash_of.pop(blk, None)
            if h is not None and self._index.get(h) == blk:
                del self._index[h]
                self._fire_evict(blk, h)
            self._free.append(blk)
        self._cached.clear()

    # ---------------------------------------------------------- queries
    def blocks_of(self, request_ids) -> List[int]:
        """Unique blocks backing these requests; a block shared by several
        requests (prefix cache) appears exactly once."""
        out: Dict[int, None] = {}
        for rid in request_ids:
            t = self.tables.get(rid)
            if t:
                for blk in t.blocks:
                    out[blk] = None
        return list(out)

    def migration_bytes(self, request_ids, n_layers: int) -> int:
        """Bytes to move when migrating these requests' KV (all layers).
        Dedup-aware: each shared block is counted once."""
        blocks = self.blocks_of(request_ids)
        return len(blocks) * self.block_size * self.bytes_per_token * n_layers

    @property
    def free_blocks(self) -> int:
        """Blocks obtainable right now: truly free plus evictable cached."""
        return len(self._free) + len(self._cached)

    @property
    def n_cached(self) -> int:
        """Refcount-zero blocks currently held by the prefix cache."""
        return len(self._cached)

    def indexed_hashes(self) -> List[bytes]:
        """Chain hashes currently registered in the prefix index — the
        ground truth an external residency index must mirror."""
        return list(self._index)

    def refcount(self, block: int) -> int:
        return self._ref[block]

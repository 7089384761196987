"""KV-lifecycle sanitizer: a shadow BlockManager that audits the pool.

The sanitizer mirrors every KV lifecycle event — allocate / extend /
commit / free / evict / spill / restore / migrate — through the
``tracer`` instrumentation points in ``serving/kvcache.py``,
``serving/runner.py``, ``serving/worker.py``, ``router/kvtier.py`` and
``serving/migration.py``, plus the BlockManager's existing
commit/evict hook channel, and cross-checks each event against its own
shadow state:

  * **use-after-free reads** — a page read (`worker.read_page`, decode,
    ragged forward) of a block no live table references, that is not in
    the prefix index, and that is not inside the evict-notification
    window (the spill hook's legitimate read-at-evict);
  * **reads of unwritten / uncommitted pages** — attention over rows no
    prefill/decode/restore ever materialized, or an index registration
    (``commit``) claiming rows that were never written;
  * **double-free** — ``free`` / ``release_for_preempt`` of a request id
    whose table was already dropped;
  * **refcount drift / leaks** — the shadow per-block refcounts are
    compared against ``BlockManager.refcount`` at every free and (via
    :meth:`check_idle`) at quiescence, when every block must be back to
    refcount zero;
  * **evict-before-notify** — a block handed out
    for reuse while the shadow index still maps it: the eviction either
    never fired its hook or fired it after the block id escaped;
  * **byte-accounting drift** — every spill/restore payload and §6.2
    migration gather is measured against the
    ``paged_kv_token_bytes``-derived expectation, and spill→restore
    round trips are content-digest checked (a digest mismatch means the
    spilled bytes were read after the page was reused).

Zero overhead when off: every instrumentation site guards on
``tracer is not None`` and the attribute defaults to ``None`` — the
sanitize-off path executes the exact pre-instrumentation code.

Enable with ``Engine(sanitize=True)`` or ``REPRO_SANITIZE=1``. Findings
accumulate on :attr:`KVSanitizer.findings`; ``strict=True`` raises
``KVInvariantError`` at the first finding instead.

The port of ``src/repro/analysis/sanitizer.py``: the shadow state and every
check are the reference's. Spill payloads here are host (CPU) torch
tensors (``StageWorker.read_page``), so the content digest hashes each
leaf's dtype, shape and raw bytes as ``store.manifest.raw_leaf`` gives
them (bfloat16 as its 16-bit words), the bytes the segment tier keeps.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.serving.kvcache import KVInvariantError
from repro_torch.store.manifest import raw_leaf

__all__ = ["Finding", "KVSanitizer"]


@dataclass(frozen=True)
class Finding:
    """One detected lifecycle violation."""
    kind: str          # e.g. "double-free", "evict-before-notify"
    message: str

    def __str__(self):
        return f"[{self.kind}] {self.message}"


def _leaf_bytes(t: torch.Tensor) -> bytes:
    """A tensor's dtype, shape and raw bytes (any dtype, bfloat16 too)."""
    raw, dtype, shape = raw_leaf(t)
    return f"{dtype}{shape}".encode() + raw


def _payload_digest(payload) -> bytes:
    """Content digest of a spill payload (order- and leaf-stable)."""
    h = hashlib.sha256()
    for entry in payload:
        h.update(str(entry[0]).encode())
        h.update(_leaf_bytes(entry[1]))
        h.update(_leaf_bytes(entry[2]))
        if len(entry) > 3:
            for leaf in sorted(entry[3]):
                h.update(leaf.encode())
                h.update(_leaf_bytes(entry[3][leaf]))
    return h.digest()


def _payload_nbytes(payload) -> int:
    """Independent byte count of a spill payload (not the store's own)."""
    n = 0
    for entry in payload:
        n += int(entry[1].nbytes) + int(entry[2].nbytes)
        if len(entry) > 3:
            n += sum(int(a.nbytes) for a in entry[3].values())
    return n


class KVSanitizer:
    """Shadow BlockManager; install with :meth:`install`."""

    def __init__(self, n_blocks: int, block_size: int, *,
                 expected_block_bytes: Optional[int] = None,
                 strict: bool = False):
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.expected_block_bytes = expected_block_bytes
        self.strict = strict
        self.findings: List[Finding] = []
        self.events = 0
        # ---- shadow state
        self.ref = [0] * n_blocks               # expected refcounts
        self.written = [0] * n_blocks           # materialized rows (high-water)
        self.owner: Dict[int, List[int]] = {}   # rid -> blocks (live tables)
        self.lengths: Dict[int, int] = {}       # rid -> token rows held
        self.freed: Set[int] = set()            # rids free()'d (finished)
        self.released: Set[int] = set()         # rids released for preempt
        self.indexed: Dict[bytes, int] = {}     # prefix-index mirror
        self.indexed_blocks: Dict[int, bytes] = {}
        self.restore_pending: Set[int] = set()  # registered, bytes not landed
        self.grace: Set[int] = set()            # evict-notified, pre-reuse
        self.slot_rows: Dict[int, List[int]] = {}
        self.spill_digests: Dict[bytes, bytes] = {}
        self.last_migration: Optional[Tuple[int, Optional[int]]] = None
        self._bm = None                         # BlockManager, for drift cmp

    # ------------------------------------------------------------ install
    @classmethod
    def install(cls, engine) -> "KVSanitizer":
        """Attach a fresh sanitizer to an engine: shadow the BlockManager
        (tracer + commit/evict hook subscriptions), the runner, every
        stage worker, and the KV tier if one is attached."""
        bm = engine.block_mgr
        san = cls(bm.n_blocks, bm.block_size,
                  expected_block_bytes=(bm.block_size * bm.bytes_per_token
                                        * engine.n_attn_layers()))
        san._bm = bm
        bm.tracer = san
        bm.commit_hooks.append(san._on_index_add)
        bm.evict_hooks.append(san._on_index_drop)
        san.rebind(engine)
        return san

    def rebind(self, engine):
        """Point a successor engine's tracer endpoints at this sanitizer
        (§6.2 consolidation: the shared BlockManager already carries the
        tracer and hooks; the runner/workers/tier are new objects)."""
        self._bm = engine.block_mgr
        engine.block_mgr.tracer = self
        engine.runner.tracer = self
        for w in engine.runner.workers:
            w.tracer = self
        if engine.kv_tier is not None:
            engine.kv_tier.tracer = self

    # ------------------------------------------------------------ reports
    def _find(self, kind: str, message: str):
        f = Finding(kind, message)
        self.findings.append(f)
        if self.strict:
            raise KVInvariantError(str(f))

    def report(self) -> str:
        if not self.findings:
            return f"kv-sanitizer: clean ({self.events} events audited)"
        lines = [f"kv-sanitizer: {len(self.findings)} finding(s) over "
                 f"{self.events} events:"]
        lines += [f"  {f}" for f in self.findings]
        return "\n".join(lines)

    def raise_if_findings(self):
        if self.findings:
            raise KVInvariantError(self.report())

    # --------------------------------------------------- index hook channel
    def _on_index_add(self, blk: int, h: bytes):
        self.events += 1
        old = self.indexed_blocks.get(blk)
        if old is not None and old != h:
            # the block was reused under a new hash while the shadow index
            # still mapped it: its eviction never notified
            self._find("evict-before-notify",
                       f"block {blk} re-registered under a new chain hash "
                       f"while still indexed — eviction was not notified")
            self.indexed.pop(old, None)
        self.indexed[h] = blk
        self.indexed_blocks[blk] = h
        self.grace.discard(blk)
        if self.ref[blk] >= 1:
            # engine-driven commit: the rows must already be materialized
            if self.written[blk] < self.block_size \
                    and blk not in self.restore_pending:
                self._find("uncommitted-commit",
                           f"block {blk} entered the prefix index with only "
                           f"{self.written[blk]}/{self.block_size} rows "
                           f"written")
        else:
            # allocate-time restore registration: bytes land later via
            # write_page (Engine._apply_restores) — reads before that are
            # flagged by the written-rows checks
            self.restore_pending.add(blk)
            self.written[blk] = 0

    def _on_index_drop(self, blk: int, h: bytes):
        self.events += 1
        if self.indexed.get(h) == blk:
            del self.indexed[h]
        if self.indexed_blocks.get(blk) == h:
            del self.indexed_blocks[blk]
        # the evict-notification window: the spill hook may still read the
        # page until the block id is handed out again
        self.grace.add(blk)

    # --------------------------------------------------- BlockManager events
    def _acquire_fresh(self, blk: int, what: str):
        """A block id was handed out for new content."""
        if blk in self.indexed_blocks:
            self._find("evict-before-notify",
                       f"block {blk} handed out as {what} while the shadow "
                       f"index still maps it (hash "
                       f"{self.indexed_blocks[blk].hex()[:12]}…) — eviction "
                       f"did not notify before reuse")
            h = self.indexed_blocks.pop(blk)
            self.indexed.pop(h, None)
        self.ref[blk] += 1
        self.written[blk] = 0
        self.restore_pending.discard(blk)
        self.grace.discard(blk)

    def on_alloc(self, rid: int, blocks: List[int], n_tokens: int, *,
                 shared: Sequence[int], restored: Sequence[Tuple[bytes, int]],
                 cow: Sequence[Tuple[int, int]], cached: int):
        self.events += 1
        if rid in self.owner:
            self._find("alloc-live-rid",
                       f"allocate for request {rid} whose table is still "
                       f"live")
        restored_dst = {b for _, b in restored}
        cow_dst = {d for _, d in cow}
        for b in shared:
            if b not in self.indexed_blocks and b not in restored_dst:
                self._find("share-unindexed",
                           f"request {rid} shares block {b} that the shadow "
                           f"prefix index does not map")
            elif (self.written[b] < self.block_size
                  and b not in self.restore_pending):
                self._find("share-unwritten",
                           f"request {rid} shares block {b} with only "
                           f"{self.written[b]}/{self.block_size} rows "
                           f"written")
            self.ref[b] += 1
            self.grace.discard(b)
        for _, b in restored:
            # registered via the commit hook during allocate; the +1 here
            # mirrors the manager's own ref for the new table
            self.ref[b] += 1
            self.grace.discard(b)
        for _, d in cow:
            self._acquire_fresh(d, "a COW destination")
        seen = set(shared) | restored_dst | cow_dst
        for b in blocks:
            if b not in seen:
                self._acquire_fresh(b, "a fresh block")
        self.owner[rid] = list(blocks)
        self.lengths[rid] = n_tokens
        self.freed.discard(rid)
        self.released.discard(rid)

    def on_extend(self, rid: int, new_blocks: List[int], new_len: int):
        self.events += 1
        t = self.owner.get(rid)
        if t is None:
            self._find("extend-unknown-rid",
                       f"extend for request {rid} with no live table")
            return
        for b in new_blocks:
            self._acquire_fresh(b, "an extend block")
            t.append(b)
        self.lengths[rid] = new_len

    def on_commit(self, rid: int, n_valid: int):
        """Check — not mark: ``commit`` *claims* rows [0, n_valid) are
        materialized; the shadow written-rows state was built from the
        actual compute/copy/restore traces, so a claim the traces don't
        back is exactly the uncommitted-page bug."""
        self.events += 1
        t = self.owner.get(rid)
        if t is None:
            return
        bs = self.block_size
        limit = min(n_valid, self.lengths.get(rid, 0))
        for i in range(limit // bs):
            b = t[i]
            if self.written[b] < bs and b not in self.restore_pending:
                self._find("uncommitted-commit",
                           f"commit({rid}, {n_valid}) covers block {b} "
                           f"(chain index {i}) with only {self.written[b]}"
                           f"/{bs} rows written")

    def _release(self, rid: int, blocks: Optional[List[int]], verb: str,
                 registry: Set[int]):
        self.events += 1
        if blocks is None:
            if rid in self.freed or rid in self.released:
                self._find("double-free",
                           f"{verb} of request {rid} whose table was "
                           f"already dropped")
            else:
                self._find("free-unknown",
                           f"{verb} of request {rid} that never held a "
                           f"table")
            return
        expect = self.owner.pop(rid, None)
        self.lengths.pop(rid, None)
        if expect is not None and list(blocks) != expect:
            self._find("table-mismatch",
                       f"{verb} of request {rid} returns blocks {blocks} "
                       f"but the shadow table held {expect}")
        for b in blocks:
            if self._bm is not None and self._bm.refcount(b) != self.ref[b]:
                self._find("refcount-drift",
                           f"block {b} refcount {self._bm.refcount(b)} != "
                           f"shadow {self.ref[b]} at {verb} of request "
                           f"{rid}")
            self.ref[b] -= 1
            if self.ref[b] < 0:
                self._find("refcount-underflow",
                           f"{verb} of request {rid} drops block {b} below "
                           f"refcount zero")
                self.ref[b] = 0
        registry.add(rid)

    def on_free(self, rid: int, blocks: Optional[List[int]]):
        self._release(rid, blocks, "free", self.freed)

    def on_release(self, rid: int, blocks: Optional[List[int]]):
        self._release(rid, blocks, "release_for_preempt", self.released)

    def on_drain_copies(self, pairs: List[Tuple[int, int]]):
        self.events += 1
        for src, _dst in pairs:
            self.ref[src] -= 1
            if self.ref[src] < 0:
                self._find("refcount-underflow",
                           f"COW drain drops source block {src} below "
                           f"refcount zero")
                self.ref[src] = 0

    # ------------------------------------------------------- runner events
    def on_set_row(self, slot: int, blocks: List[int]):
        self.events += 1
        for b in blocks:
            if self.ref[b] <= 0:
                self._find("row-dead-block",
                           f"slot {slot} block-table row names block {b} "
                           f"with shadow refcount {self.ref[b]}")
        self.slot_rows[slot] = list(blocks)

    def on_clear_row(self, slot: int):
        self.events += 1
        self.slot_rows.pop(slot, None)

    def _check_span(self, slot: int, pos0: int, n: int, what: str):
        """Rows [0, pos0) of the slot's chain must be materialized (the
        forward attends to them); rows [pos0, pos0+n) become written."""
        blocks = self.slot_rows.get(slot)
        if blocks is None:
            self._find("compute-dead-slot",
                       f"{what} on slot {slot} with no block-table row")
            return
        bs = self.block_size
        if pos0 + n > len(blocks) * bs:
            self._find("compute-past-table",
                       f"{what} on slot {slot} writes rows "
                       f"[{pos0}, {pos0 + n}) past its {len(blocks)}-block "
                       f"table")
            return
        for i in range((pos0 + bs - 1) // bs):
            b = blocks[i]
            need = min(bs, pos0 - i * bs)
            if self.written[b] < need:
                kind = ("use-after-free-read" if self.ref[b] <= 0
                        and b not in self.indexed_blocks
                        else "unwritten-read")
                self._find(kind,
                           f"{what} on slot {slot} attends rows of block "
                           f"{b} with {self.written[b]}/{need} rows "
                           f"written")
        for p in range(pos0, pos0 + n):
            b = blocks[p // bs]
            self.written[b] = max(self.written[b], p % bs + 1)
            self.restore_pending.discard(b)

    def on_prefill(self, slot: int, start: int, n: int):
        self.events += 1
        self._check_span(slot, start, n, "prefill")

    def on_decode(self, slots_pos: List[Tuple[int, int]],
                  skip_slots: List[int]):
        self.events += 1
        for slot, pos in slots_pos:
            self._check_span(slot, pos, 1, "decode")

    def on_forward_batch(self, segments: List[Tuple[int, int, int]]):
        self.events += 1
        for slot, n, pos0 in segments:
            self._check_span(slot, pos0, n, "ragged forward")

    # ------------------------------------------------------- worker events
    def on_page_read(self, name: str, blk: int, stage: int):
        self.events += 1
        if (self.ref[blk] <= 0 and blk not in self.indexed_blocks
                and blk not in self.grace):
            self._find("use-after-free-read",
                       f"page read of block {blk} ({name}, stage {stage}) "
                       f"that no table, index entry, or evict notification "
                       f"covers")
        elif self.written[blk] < self.block_size \
                and blk not in self.restore_pending:
            self._find("uncommitted-read",
                       f"page read of block {blk} ({name}, stage {stage}) "
                       f"with only {self.written[blk]}/{self.block_size} "
                       f"rows written")

    def on_page_write(self, name: str, blk: int, stage: int):
        self.events += 1
        if self.ref[blk] <= 0 and blk not in self.indexed_blocks:
            self._find("write-unowned",
                       f"page write to block {blk} ({name}, stage {stage}) "
                       f"that no table or index entry owns")
        self.written[blk] = self.block_size
        self.restore_pending.discard(blk)

    def on_copy_pages(self, src: int, dst: int, stage: int):
        self.events += 1
        if self.ref[src] <= 0 and src not in self.indexed_blocks:
            self._find("use-after-free-read",
                       f"COW copy reads source block {src} (stage {stage}) "
                       f"that no table or index entry covers")
        if self.ref[dst] <= 0:
            self._find("write-unowned",
                       f"COW copy writes block {dst} (stage {stage}) with "
                       f"shadow refcount {self.ref[dst]}")
        self.written[dst] = max(self.written[dst], self.written[src])

    # ------------------------------------------------------ KV tier events
    def on_spill(self, h: bytes, payload):
        self.events += 1
        nbytes = _payload_nbytes(payload)
        if (self.expected_block_bytes is not None
                and nbytes != self.expected_block_bytes):
            self._find("byte-drift",
                       f"spill of {h.hex()[:12]}… measured {nbytes} B, "
                       f"paged_kv_token_bytes expects "
                       f"{self.expected_block_bytes} B/block")
        digest = _payload_digest(payload)
        prev = self.spill_digests.get(h)
        if prev is not None and prev != digest:
            self._find("use-after-free-spill",
                       f"re-spill of {h.hex()[:12]}… carries different "
                       f"bytes than its first spill — the page was read "
                       f"after its block id was reused")
        self.spill_digests[h] = digest

    def on_restore_take(self, h: bytes, payload, nbytes: int):
        self.events += 1
        if (self.expected_block_bytes is not None
                and nbytes != self.expected_block_bytes):
            self._find("byte-drift",
                       f"restore of {h.hex()[:12]}… charged {nbytes} B, "
                       f"paged_kv_token_bytes expects "
                       f"{self.expected_block_bytes} B/block")
        prev = self.spill_digests.get(h)
        if prev is not None and _payload_digest(payload) != prev:
            self._find("restore-corruption",
                       f"restore of {h.hex()[:12]}… returns different "
                       f"bytes than were spilled")

    # ------------------------------------------------------ migration event
    def on_migration_gather(self, moved: int, live_blocks: Optional[list],
                            n_stages: int):
        self.events += 1
        self.last_migration = (moved,
                               len(live_blocks)
                               if live_blocks is not None else None)

    def check_migration(self, moved: int, expected: int):
        """§6.2 gather vs ``BlockManager.migration_bytes`` quote."""
        self.events += 1
        if moved != expected:
            self._find("migration-drift",
                       f"§6.2 gather moved {moved} B but the BlockManager "
                       f"quoted {expected} B")

    # --------------------------------------------------------- final audit
    def check_idle(self, bm=None) -> List[Finding]:
        """Quiescence audit — call when the engine reports no work left:
        every table must be gone and every block back at refcount zero,
        in both the shadow and (when given) the real BlockManager."""
        bm = bm if bm is not None else self._bm
        for rid, blocks in self.owner.items():
            self._find("refcount-leak",
                       f"request {rid} still holds blocks {blocks} at "
                       f"quiescence")
        for b in range(self.n_blocks):
            if self.ref[b] != 0:
                self._find("refcount-leak",
                           f"block {b} has shadow refcount {self.ref[b]} "
                           f"at quiescence")
            if bm is not None and bm.refcount(b) != self.ref[b]:
                self._find("refcount-drift",
                           f"block {b} refcount {bm.refcount(b)} != shadow "
                           f"{self.ref[b]} at quiescence")
        return self.findings

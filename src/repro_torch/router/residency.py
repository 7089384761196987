"""Residency index: per-replica map of committed block-chain hashes.

The KV-aware router needs to know, *without touching the engines*, how
much of an incoming prompt each replica already holds in HBM. The
``ResidencyIndex`` keeps one hash set per registered replica and stays
exactly in sync with that replica's ``BlockManager`` through the
commit/evict notifications (serving/kvcache.py): a hash enters the set
when the engine commits the block (or restores it from a lower tier) and
leaves it the moment the LRU evicts it — *before* the block id is
reused, so the index can never claim residency for a page that has been
overwritten.

``match(name, tokens)`` mirrors ``BlockManager.allocate``'s prefix walk
(full blocks only, chain-hashed, continuing past an HBM miss when the
attached KV tier holds the hash) and reports the warm and restorable
block counts — the router's scoring input.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.serving.kvcache import BlockManager, _chain_hash

__all__ = ["ResidencyIndex"]


class ResidencyIndex:
    """Hash-set-per-replica mirror of the engines' prefix indexes."""

    def __init__(self, kv_tier=None):
        self.kv_tier = kv_tier
        self._resident: Dict[str, Set[bytes]] = {}
        # name -> (block_mgr, commit hook, evict hook) for detach
        self._attached: Dict[str, Tuple[BlockManager, object, object]] = {}

    # ------------------------------------------------------- membership
    def attach(self, name: str, block_mgr: BlockManager):
        """Start mirroring a replica's BlockManager. Seeds from the
        current index contents, then stays in sync via the hooks — a
        replica registered mid-flight is immediately accurate."""
        if name in self._attached:
            raise ValueError(f"replica {name!r} already attached")
        resident: Set[bytes] = set(block_mgr.indexed_hashes())
        self._resident[name] = resident

        def on_commit(blk: int, h: bytes):
            resident.add(h)

        def on_evict(blk: int, h: bytes):
            resident.discard(h)

        block_mgr.commit_hooks.append(on_commit)
        block_mgr.evict_hooks.append(on_evict)
        self._attached[name] = (block_mgr, on_commit, on_evict)

    def detach(self, name: str):
        """Stop mirroring (replica scaled to zero / torn down)."""
        bm, on_commit, on_evict = self._attached.pop(name)
        bm.commit_hooks.remove(on_commit)
        bm.evict_hooks.remove(on_evict)
        del self._resident[name]

    def replicas(self) -> List[str]:
        return list(self._resident)

    def resident_hashes(self, name: str) -> Set[bytes]:
        return self._resident[name]

    def block_size_of(self, name: str) -> int:
        return self._attached[name][0].block_size

    # ---------------------------------------------------------- queries
    def chain_hashes(self, name: str,
                     tokens: Sequence[int]) -> List[bytes]:
        """The prompt's full-block chain hashes for this replica's block
        size (the granularity residency is tracked at)."""
        bs = self.block_size_of(name)
        out, h = [], b""
        for i in range(len(tokens) // bs):
            h = _chain_hash(h, tokens[i * bs:(i + 1) * bs])
            out.append(h)
        return out

    def match(self, name: str, tokens: Sequence[int]) -> Tuple[int, int]:
        """(warm_blocks, restorable_blocks) for this prompt on this
        replica: the same walk ``BlockManager.allocate`` will do at
        admission — the chain is followed while each block is either in
        the replica's HBM index (warm) or in the attached KV tier
        (restorable); the first block in neither ends the prefix."""
        resident = self._resident[name]
        warm = restorable = 0
        for h in self.chain_hashes(name, tokens):
            if h in resident:
                warm += 1
            elif self.kv_tier is not None and self.kv_tier.has(h):
                restorable += 1
            else:
                break
        return warm, restorable

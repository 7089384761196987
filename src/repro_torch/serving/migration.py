"""KV-cache migration (§6.2): gather per-stage caches to a single worker.

The gather is a period-axis concatenation of the stage caches (paper:
blocks collected with a gather primitive and 'placed at different layers,
according to which worker it comes from'). With the paged layout it is
*block-granular* for the attention page pools: only the pages named by the
block manager's tables for in-flight requests are shipped, and
``gather_stage_caches_with_bytes`` reports exactly the bytes moved — the
ground truth the block manager's ``migration_bytes`` estimate must match.
Every other leaf (recurrent states, slot-contiguous K/V) moves whole and
is not counted, as in the reference; ``gather_stage_caches`` gathers whole
caches and reports no bytes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def gather_stage_caches_with_bytes(
        stage_caches: List[dict], live_blocks: Sequence[int],
        target_stage: int = 0, tracer=None) -> Tuple[dict, int]:
    """Concatenate stage cache trees along the leading (period) axis. Page
    pools (slots with ``k_pages``) move at block granularity: each stage
    ships only its ``live_blocks`` pages, which land at the *same* page ids
    in a fresh, zero-filled target pool (block ids are global — the
    engine's BlockManager is shared by every stage). Returns (gathered
    cache, KV bytes that cross the network): the ``target_stage`` already
    holds its own pages, so only the other stages' live pages count.
    Non-page leaves are concatenated whole and not counted."""
    out: dict = {}
    moved = 0
    live = None
    for name in stage_caches[0].keys():
        sub = [c[name] for c in stage_caches]
        if "k_pages" not in sub[0]:
            out[name] = {leaf: torch.cat([c[leaf] for c in sub], dim=0)
                         for leaf in sub[0]}
            continue
        merged = {}
        for leaf_name, first in sub[0].items():
            if live is None:
                live = torch.tensor(sorted(live_blocks), dtype=torch.long,
                                    device=first.device)
            parts = [c[leaf_name][:, live] for c in sub]
            moved += sum(p.numel() * p.element_size()
                         for i, p in enumerate(parts) if i != target_stage)
            stacked = torch.cat(parts, dim=0)
            pool = torch.zeros((stacked.shape[0],) + tuple(first.shape[1:]),
                               dtype=first.dtype, device=first.device)
            pool[:, live] = stacked
            merged[leaf_name] = pool
        out[name] = merged
    if tracer is not None:
        tracer.on_migration_gather(moved, list(live_blocks),
                                   len(stage_caches))
    return out, moved


def gather_stage_caches(stage_caches: List[dict]) -> dict:
    """Concatenate whole stage cache trees along the leading (period) axis
    (the slot-contiguous layout: every slot's strip moves, live or not)."""
    return {name: {leaf: torch.cat([c[name][leaf] for c in stage_caches],
                                   dim=0)
                   for leaf in stage_caches[0][name]}
            for name in stage_caches[0]}

"""Multi-tier KV block store: the tiers *below* the HBM page pool.

HydraServe's serving engines keep KV in a paged HBM pool
(serving/kvcache.py). Under pool pressure refcount-zero cached blocks
are LRU-evicted — historically the bytes were simply lost and a later
prefix hit re-prefilled them. ``KVBlockStore`` catches those evictions
instead (the engine's spill hook reads the page content *at* the evict
notification, before the block id is reused) and keeps them in two
further tiers:

  * **host** — live host (CPU) torch tensors under a bounded block
    budget, restore charged at PCIe class bandwidth;
  * **segment** — a serialized ``KVSegmentStore`` (repro_torch/store/) the
    host tier demotes its own LRU overflow into, restore charged at
    remote class bandwidth.

Every restore is accounted as a **measured flow** on the shared
``FetchSchedule`` — the same Alg. 2 contention-fair machinery model
fetches use — so a KV restore racing a cold start on one server divides
the NIC exactly like two stage fetches would, and
``restore_estimate`` quotes the modeled transfer time a router can hold
against the cost of re-prefilling the same tokens.

The store is **content-addressed by block-chain hash** and therefore
shareable across all replicas of one model: a block spilled by replica
A restores into replica B's pool bit-exactly (payloads are keyed by
global attention period, independent of the engines' pipeline shapes —
a block spilled by a 2-stage engine restores into its consolidated
1-stage successor).

The port of ``src/repro/router/kvtier.py``: the tiers, their accounting
and the flows are the reference's; the host tier holds CPU torch tensors
(the engine's spill hook reads pages to the host synchronously, so the
bytes are on the host before the evicted block id is reused).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.store.kvsegment import KVSegmentStore
from repro_torch.store.store import FetchFlow, FetchSchedule

__all__ = ["KVBlockStore"]

# Payload: ordered (cache_slot_name, k_pages, v_pages) triples; the page
# tensors are (n_attn_periods_total, block_size, n_kv_heads, head_dim),
# concatenated over the pipeline in stage order. Quantized (int8) pools
# append a 4th element: a dict of the per-row scale/zero leaves
# (attention.KV_QUANT_LEAVES), each (n_attn_periods_total, block_size,
# n_kv_heads) f32 — their bytes count toward every spill/restore flow.
Payload = List[Tuple]


def _entry_nbytes(entry) -> int:
    """Exact bytes of one payload entry, auxiliary quant leaves included."""
    n = int(entry[1].nbytes) + int(entry[2].nbytes)
    if len(entry) > 3:
        n += sum(int(a.nbytes) for a in entry[3].values())
    return n


def payload_nbytes(payload: Payload) -> int:
    return sum(_entry_nbytes(e) for e in payload)


def _on_host(a) -> torch.Tensor:
    """A payload leaf as a CPU tensor (no copy when it already is one)."""
    return torch.as_tensor(a, device="cpu")

HOST_BW = 12e9                       # PCIe class (matches ServerSpec default)


class KVBlockStore:
    """Host + segment KV tiers for spilled page-pool blocks.

    ``put`` (the engine spill hook's sink) inserts at the host tier and
    demotes the host LRU into the segment store past
    ``host_capacity_blocks``. ``take`` moves a block's payload back out
    (single-copy semantics — the block is about to be re-registered in
    an HBM index) and returns the measured ``FetchFlow`` its transfer
    was accounted as. ``now`` is the simulated clock restores are
    admitted at; its callers (FleetFrontend, benches) advance it."""

    def __init__(self, schedule: Optional[FetchSchedule] = None,
                 server_id: str = "local", *,
                 host_capacity_blocks: Optional[int] = None,
                 host_bw: float = HOST_BW,
                 segment_store: Optional[KVSegmentStore] = None,
                 segment_bw: Optional[float] = None):
        self.schedule = schedule or FetchSchedule.single(host_bw, server_id)
        self.server_id = server_id
        self.host_bw = float(host_bw)
        self.host_capacity_blocks = host_capacity_blocks
        self.segments = segment_store if segment_store is not None else \
            KVSegmentStore(**({} if segment_bw is None
                              else {"bandwidth": segment_bw}))
        self.now = 0.0
        self._host: "OrderedDict[bytes, Payload]" = OrderedDict()
        self._host_nbytes: Dict[bytes, int] = {}
        # counters
        self.spills = 0
        self.demotions = 0
        self.restores = 0
        self.spilled_bytes = 0
        self.restored_bytes = 0
        self.restore_flows: List[FetchFlow] = []
        self._fid = 0
        # correctness tracer (analysis/sanitizer.py); None in production
        self.tracer = None

    # ------------------------------------------------------------ queries
    def has(self, h: bytes) -> bool:
        return h in self._host or self.segments.has(h)

    def tier_of(self, h: bytes) -> Optional[str]:
        if h in self._host:
            return "host"
        if self.segments.has(h):
            return "segment"
        return None

    def __len__(self) -> int:
        return len(self._host) + len(self.segments)

    @property
    def host_blocks(self) -> int:
        return len(self._host)

    @property
    def host_bytes(self) -> int:
        return sum(self._host_nbytes.values())

    def bytes_of(self, h: bytes) -> int:
        if h in self._host:
            return self._host_nbytes[h]
        return self.segments.bytes_of(h)

    # ------------------------------------------------------------- tiers
    def put(self, h: bytes, payload: Payload):
        """Spill one evicted block's pages into the host tier (demoting
        the host LRU to the segment store when over budget). Re-spilling
        a hash refreshes its recency; content is identical by
        construction (same chain hash = same computed KV)."""
        if self.tracer is not None:
            self.tracer.on_spill(h, payload)
        if h in self._host:
            self._host.move_to_end(h)
            return
        if self.segments.has(h):          # already demoted: keep one copy
            return
        nbytes = payload_nbytes(payload)
        host = []
        for entry in payload:
            e = (entry[0], _on_host(entry[1]), _on_host(entry[2]))
            if len(entry) > 3:
                e += ({l: _on_host(a) for l, a in entry[3].items()},)
            host.append(e)
        self._host[h] = host
        self._host_nbytes[h] = nbytes
        self.spills += 1
        self.spilled_bytes += nbytes
        cap = self.host_capacity_blocks
        while cap is not None and len(self._host) > cap:
            old_h, old_payload = self._host.popitem(last=False)
            self.segments.put(old_h, old_payload)
            del self._host_nbytes[old_h]
            self.demotions += 1

    def take(self, h: bytes,
             now: Optional[float] = None) -> Tuple[Payload, FetchFlow]:
        """Move a spilled block's payload back toward HBM, accounting the
        transfer as a measured flow capped at the source tier's bandwidth
        on this store's server NIC."""
        now = self.now if now is None else now
        if h in self._host:
            payload = self._host.pop(h)
            nbytes = self._host_nbytes.pop(h)
            cap = self.host_bw
        else:
            payload = self.segments.pop(h)
            nbytes = payload_nbytes(payload)
            cap = self.segments.bandwidth
        flow = self.schedule.transfer(
            self.server_id, f"kvrestore{self._fid}", nbytes,
            now=now, cap=cap)
        self._fid += 1
        self.restores += 1
        self.restored_bytes += nbytes
        self.restore_flows.append(flow)
        if self.tracer is not None:
            self.tracer.on_restore_take(h, payload, nbytes)
        return payload, flow

    def drop(self, h: bytes):
        """Forget a spilled block without restoring it."""
        if self._host.pop(h, None) is not None:
            del self._host_nbytes[h]
        else:
            self.segments.discard(h)

    # ---------------------------------------------------------- modeling
    def restore_rate(self, h: Optional[bytes] = None,
                     now: Optional[float] = None) -> float:
        """Modeled restore bandwidth right now: min(source tier cap,
        Alg. 2 fair share of this server's NIC) — what a restore flow
        admitted at ``now`` would actually get."""
        now = self.now if now is None else now
        if h is None or h in self._host:
            cap = self.host_bw
        elif self.segments.has(h):
            cap = self.segments.bandwidth
        else:
            return 0.0
        share = self.schedule.tracker.node_bandwidth(self.server_id, now)
        if share <= 0.0:                  # Eq. 3 would defer a new flow
            return 0.0
        return min(cap, share)

    def restore_estimate(self, hashes: List[bytes],
                         now: Optional[float] = None) -> float:
        """Modeled seconds to restore these blocks under the current
        contention — the router's restore-vs-reprefill input. inf when
        the NIC cannot admit a flow right now."""
        total = 0.0
        for h in hashes:
            rate = self.restore_rate(h, now)
            if rate <= 0.0:
                return math.inf
            total += self.bytes_of(h) / rate
        return total

    def stats(self) -> dict:
        return {
            "host_blocks": len(self._host),
            "host_bytes": self.host_bytes,
            "segment_blocks": len(self.segments),
            "segment_bytes": self.segments.total_bytes,
            "spills": self.spills,
            "demotions": self.demotions,
            "restores": self.restores,
            "spilled_bytes": self.spilled_bytes,
            "restored_bytes": self.restored_bytes,
        }

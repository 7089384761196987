"""Content-addressed KV *segment* tier — the bottom of the multi-tier
KV cache (HBM page pool → host tier → segment store).

The host tier (``router/kvtier.py`` ``KVBlockStore``) holds spilled
pages as live host tensors under a bounded block budget; when it
overflows, the LRU entry is *demoted* here. This tier is the KV
analogue of the model ``ModelStore``: payloads are **serialized** to raw
bytes (each leaf's bytes with its torch dtype name and shape, as the
model store's chunks are written — bfloat16 as its raw 16-bit words), so
a segment surviving a demote/restore cycle is bit-exact by construction,
and reads are charged at the tier's configured bandwidth — typically the
remote/registry class, an order of magnitude under the host tier's PCIe
class — on the same contention-fair ``FetchSchedule`` as every other
transfer in the system.

The port of ``src/repro/store/kvsegment.py``; ``get`` rebuilds CPU torch
tensors where the reference rebuilds numpy arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.serving.kvcache import KVInvariantError
from repro_torch.store.manifest import raw_leaf
from repro_torch.store.store import REMOTE_BW

__all__ = ["KVSegmentStore"]


def _deserialize(raw: bytes, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor bit for bit the one ``raw_leaf`` was given."""
    flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return flat.view(getattr(torch, dtype)).reshape(shape)


class KVSegmentStore:
    """Serialized KV segments keyed by block-chain hash.

    A *segment* is one spilled KV block's payload: an ordered list of
    ``(cache_slot_name, k_pages, v_pages)`` triples covering every
    attention period of the model (pipeline-shape independent — see
    ``KVBlockStore``). ``put`` serializes the tensors; ``get``
    reconstructs them bit-exactly. Transfer-time accounting belongs to
    the caller (``KVBlockStore`` charges ``bytes_of`` at
    ``bandwidth``)."""

    def __init__(self, bandwidth: float = REMOTE_BW):
        self.bandwidth = float(bandwidth)
        # hash -> list of (name, (k bytes, v bytes), dtype str, shape,
        # aux) where aux is None or serialized quant leaves
        self._segs: Dict[bytes, List[Tuple]] = {}
        self._nbytes: Dict[bytes, int] = {}

    # --------------------------------------------------------------- api
    def has(self, h: bytes) -> bool:
        return h in self._segs

    def __len__(self) -> int:
        return len(self._segs)

    @property
    def total_bytes(self) -> int:
        return sum(self._nbytes.values())

    def bytes_of(self, h: bytes) -> int:
        return self._nbytes[h]

    def put(self, h: bytes, payload: List[Tuple]):
        seg = []
        nbytes = 0
        for entry in payload:
            name, k, v = entry[0], entry[1], entry[2]
            kb, kdt, kshape = raw_leaf(k)
            vb, vdt, vshape = raw_leaf(v)
            if kshape != vshape or kdt != vdt:
                raise KVInvariantError(
                    f"segment K/V mismatch: {kshape}/{kdt} vs "
                    f"{vshape}/{vdt}")
            aux = None
            if len(entry) > 3:
                # quantized pools: serialize the scale/zero leaves too —
                # they are part of the block's content and its byte count
                aux = []
                for leaf, a in entry[3].items():
                    ab, adt, ashape = raw_leaf(a)
                    aux.append((leaf, ab, adt, ashape))
                    nbytes += len(ab)
            seg.append((name, (kb, vb), kdt, kshape, aux))
            nbytes += len(kb) + len(vb)
        self._segs[h] = seg
        self._nbytes[h] = nbytes

    def get(self, h: bytes) -> List[Tuple]:
        out = []
        for name, (kb, vb), dtype, shape, aux in self._segs[h]:
            k = _deserialize(kb, dtype, shape)
            v = _deserialize(vb, dtype, shape)
            if aux is None:
                out.append((name, k, v))
            else:
                d = {leaf: _deserialize(ab, adt, ashp)
                     for leaf, ab, adt, ashp in aux}
                out.append((name, k, v, d))
        return out

    def pop(self, h: bytes) -> List[Tuple]:
        out = self.get(h)
        del self._segs[h]
        del self._nbytes[h]
        return out

    def discard(self, h: Optional[bytes]):
        self._segs.pop(h, None)
        self._nbytes.pop(h, None)

"""Cold-start data plane: chunked model store + streamed stage loading
(the port of the reference's ``store`` package).

``manifest``  — per-tensor chunk files + stage byte ranges per degree;
``store``     — tiered byte sources (local/peer/remote) and the
                contention-aware simulated-clock ``FetchSchedule``;
``loader``    — ``StreamedStageLoader``: materializes stage params
                tensor-by-tensor onto the device with a measured
                ``WorkerTimeline``;
``validate``  — measured-vs-analytic cross-checks;
``kvsegment`` — serialized KV *segment* tier: the bottom of the
                multi-tier KV cache (HBM → host → store), backing the
                router's ``KVBlockStore`` overflow.
"""

from repro_torch.store.kvsegment import KVSegmentStore  # noqa: F401

from repro_torch.store.loader import (ColdStartReport,  # noqa: F401
                                      StageLoadRecord, StreamedStageLoader,
                                      TensorSpan)
from repro_torch.store.manifest import (ChunkRecord, Manifest,  # noqa: F401
                                        StageChunk, build_manifest,
                                        load_manifest, save_model)
from repro_torch.store.store import (AliasTier, DiskTier,  # noqa: F401
                                     FetchFlow, FetchSchedule, MemoryTier,
                                     ModelStore, StoreTier)
from repro_torch.store.validate import (StageCrossCheck,  # noqa: F401
                                        assert_within, crosscheck_stages)

__all__ = [
    "ChunkRecord", "Manifest", "StageChunk", "build_manifest",
    "load_manifest", "save_model",
    "AliasTier", "DiskTier", "FetchFlow", "FetchSchedule", "MemoryTier",
    "ModelStore", "StoreTier",
    "ColdStartReport", "StageLoadRecord", "StreamedStageLoader",
    "TensorSpan", "KVSegmentStore",
    "StageCrossCheck", "assert_within", "crosscheck_stages",
]

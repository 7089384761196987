"""The paper's primary contribution: pipeline-parallel cold starts
(Alg. 1 size selection, Alg. 2 contention-aware placement, worker-level
overlapping, pipeline consolidation). Pure Python, copied from the
reference's ``core`` package with only the imports changed."""

from repro_torch.core.coldstart import (OverlapFlags, group_tpot,  # noqa: F401
                                        group_ttft, worker_timeline)
from repro_torch.core.consolidation import (ConsolidationPlan,  # noqa: F401
                                            ConsolidationPolicy,
                                            SlidingWindowPredictor)
from repro_torch.core.controller import CentralController  # noqa: F401
from repro_torch.core.parallelism import (predict_tpot,  # noqa: F401
                                          predict_ttft,
                                          predict_ttft_overlapped,
                                          select_scheme)
from repro_torch.core.placement import ContentionTracker  # noqa: F401
from repro_torch.core.types import (GB, Gbps, ColdStartScheme,  # noqa: F401
                                    ModelProfile, ServerSpec, SLO,
                                    TimingProfile)

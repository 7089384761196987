"""Stable serving endpoints (§6.2).

HydraServe's client-facing abstraction is the *serving endpoint*: pipeline
groups consolidate and scale behind it, clients never see the swap. A
``ServingEndpoint`` is that stable handle — it owns the backing
``Engine``(s), proxies the request-lifecycle API (serving/api.py), and
performs consolidation / scale-up *in place*: the handle the caller holds
keeps working, in-flight requests continue bit-exactly, and the retired
source engine raises on use instead of silently corrupting block tables
it no longer owns.

The reference's ``ServerlessFrontend`` (Alg. 1 planning plus streamed
stage loading from the model store) needs ``core/`` and ``store/`` and is
not ported yet.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.api import SamplingParams, StepOutput, TokenEvent
from repro_torch.serving.engine import Engine, GenRequest


class ServingEndpoint:
    """Stable handle over a (possibly re-forming) engine. All serving
    traffic goes through the endpoint; ``consolidate``/``scale_up`` swap
    the backing engine without invalidating the handle."""

    def __init__(self, engine: Engine):
        self._engine = engine

    # -------------------------------------------------------- delegation
    @property
    def engine(self) -> Engine:
        """The live backing engine (raw-engine escape hatch)."""
        return self._engine

    @property
    def cfg(self) -> ModelConfig:
        return self._engine.cfg

    @property
    def paged(self) -> bool:
        return self._engine.paged

    @property
    def policy(self):
        """The live engine's ``SchedulingPolicy`` (survives swaps)."""
        return self._engine.policy

    @property
    def n_stages(self) -> int:
        return len(self._engine.workers)

    @property
    def finished(self) -> List[GenRequest]:
        return self._engine.finished

    @property
    def last_migration_bytes(self) -> Optional[int]:
        return self._engine.last_migration_bytes

    def active(self) -> List[GenRequest]:
        return self._engine.active()

    def has_work(self) -> bool:
        """True while any request is resident, waiting, or preempted —
        use this (not ``active() or queue``) to drive a step loop."""
        return self._engine.has_work()

    def stats(self) -> dict:
        """Cheap saturation snapshot of the live engine (waiting depth,
        free slots/blocks, preemptions...) — the KV-aware router's
        overflow input; survives engine swaps."""
        return self._engine.stats()

    def submit(self, prompt: Sequence[int],
               params: Union[SamplingParams, int, None] = None, *,
               max_new: Optional[int] = None,
               prefix_embeds=None) -> GenRequest:
        return self._engine.submit(prompt, params, max_new=max_new,
                                   prefix_embeds=prefix_embeds)

    def step(self) -> StepOutput:
        return self._engine.step()

    def run(self, max_steps: int = 10_000) -> List[StepOutput]:
        return self._engine.run(max_steps)

    def generate(self, prompt: Sequence[int],
                 params: Union[SamplingParams, int, None] = None, *,
                 prefix_embeds=None,
                 max_steps: int = 10_000) -> Iterator[TokenEvent]:
        return self._engine.generate(prompt, params,
                                     prefix_embeds=prefix_embeds,
                                     max_steps=max_steps)

    # ------------------------------------------------- elastic membership
    def consolidate(self, full_params: dict) -> "ServingEndpoint":
        """§6.2 scale-down behind the handle: gather KV/state onto one
        standalone worker, swap it in, retire the pipeline-group engine.
        In-flight requests (and ``last_migration_bytes``) carry over, and
        so do the scheduling policy and the waiting/preempted pools — a
        consolidation changes the endpoint's capacity, not its scheduling
        behaviour."""
        src = self._engine
        self._engine = src.consolidated(full_params)
        src.retire()
        return self

    def scale_up(self, full_params: dict) -> List["ServingEndpoint"]:
        """§6.2 scale-up: each stage becomes a standalone replica. This
        handle keeps the consolidated engine (in-flight requests continue);
        the fresh replicas come back as new endpoints. Returns all
        endpoints, this one first."""
        src = self._engine
        engines = src.scale_up(full_params)
        src.retire()
        self._engine = engines[0]
        return [self] + [ServingEndpoint(e) for e in engines[1:]]

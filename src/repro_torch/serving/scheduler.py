"""Policy-driven request scheduling for the serving engine.

The engine (serving/engine.py) is split into three layers:

  * **Scheduler** (this module) — owns the request queues (*waiting* /
    *running* / *preempted*) and all admission / ordering / preemption
    decisions. Every engine step it emits an explicit ``ScheduleBatch``
    plan: which requests are admitted, which prompt rows each prefill
    forward covers under the step's token budget, which residents decode,
    and which residents are preempted to make room.
  * **ModelRunner** (serving/runner.py) — purely executes a plan against
    the StageWorker pipeline and returns logits. No queue or policy
    state.
  * **Engine** — composes the two, applies sampling / finish semantics,
    and keeps the public ``submit/step/run/generate`` surface.

Scheduling is pluggable through ``SchedulingPolicy``:

  * ``fcfs`` (default) — strict submission order, head-of-line blocking,
    never preempts: **bit-exact** with the pre-split monolithic engine.
  * ``priority`` — orders admission by ``SamplingParams.priority``
    (higher first, FCFS within a level) and may preempt a lower-priority
    resident when a higher-priority request cannot be admitted.
  * ``slo`` — earliest-deadline-first over per-request TTFT/TPOT budgets
    (``SamplingParams.slo``, an :class:`repro_torch.core.types.SLO` whose
    fields are interpreted in scheduler steps). A request with no SLO is
    background work (deadline = +inf) and is the first preemption victim.

Preemption frees the victim's slot and KV blocks
(``BlockManager.release_for_preempt``) but — with the prefix cache on —
leaves its committed full blocks registered in the hash index, so the
resume re-prefills only the uncached tail and then continues its token
stream bit-exactly (no token is ever re-emitted: the resume prefill's
logits are discarded and decode restarts from the last emitted token).
"""

from __future__ import annotations

import collections
import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.serving.api import (FinishReason, RequestMetrics,
                                     RequestOutput, SamplingParams)
from repro_torch.serving.kvcache import BlockManager


@dataclass
class GenRequest:
    """Opaque per-request handle returned by ``submit`` — callers read
    ``generated``/``done``/``finish_reason``/``metrics`` and call
    ``output()``; everything else is scheduler/engine-internal."""
    rid: int
    prompt: List[int]
    params: SamplingParams
    prefix_embeds: Optional[np.ndarray] = None
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    finish_reason: Optional[FinishReason] = None
    metrics: RequestMetrics = field(default_factory=RequestMetrics)
    prefilled: int = 0          # rows with KV computed (incl. cached)
    prefill_upto: Optional[int] = None   # rows this admission must prefill

    @property
    def max_new(self) -> int:
        return self.params.max_new

    @property
    def priority(self) -> int:
        return self.params.priority

    @property
    def prompt_total(self) -> int:
        """Prompt tokens incl. any prefix embeddings."""
        return len(self.prompt) + (0 if self.prefix_embeds is None
                                   else self.prefix_embeds.shape[0])

    @property
    def prefill_target(self) -> int:
        """Rows the current admission must materialize before decoding.
        Fresh requests prefill the whole prompt; a preempted request that
        already emitted g tokens re-prefills prompt + g - 1 rows (the
        last emitted token is re-fed by decode, not prefill)."""
        return (self.prefill_upto if self.prefill_upto is not None
                else self.prompt_total)

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= self.prefill_target

    @property
    def pos_next(self) -> int:
        """Cache position of the next token to feed."""
        return self.prompt_total + len(self.generated) - 1

    def chain(self) -> List[int]:
        """The token rows a (re-)prefill must feed: the prompt, plus —
        after a preemption — every emitted token except the last (which
        decode re-feeds). Prefix-embed rows are not part of the chain."""
        if not self.generated:
            return list(self.prompt)
        return list(self.prompt) + self.generated[:-1]

    def output(self) -> RequestOutput:
        return RequestOutput(self.rid, tuple(self.prompt),
                             tuple(self.generated), self.finish_reason,
                             dataclasses.replace(self.metrics))


# --------------------------------------------------------------- policies
class SchedulingPolicy:
    """Admission ordering + preemption victim selection. Stateless."""

    name = "base"

    def sort_key(self, req: GenRequest, step: int):
        """Admission order over waiting+preempted (ascending). Must be a
        stable total order; ties always fall back to rid."""
        raise NotImplementedError

    def victim(self, running: Sequence[GenRequest], incoming: GenRequest,
               step: int) -> Optional[GenRequest]:
        """The resident to preempt so ``incoming`` can be admitted, or
        None to keep deferring. ``running`` is pre-filtered to eligible
        victims (fully prefilled, no prefix embeddings)."""
        return None


class FCFSPolicy(SchedulingPolicy):
    """Strict submission order, never preempts — bit-exact with the
    pre-split engine's head-of-line behaviour."""

    name = "fcfs"

    def sort_key(self, req, step):
        return req.rid


class PriorityPolicy(SchedulingPolicy):
    """Higher ``SamplingParams.priority`` first (FCFS within a level);
    preempts the lowest-priority (then newest) resident when it is
    strictly less important than the incoming request."""

    name = "priority"

    def sort_key(self, req, step):
        return (-req.priority, req.rid)

    def victim(self, running, incoming, step):
        cands = [r for r in running if r.priority < incoming.priority]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.priority, -r.rid))


class SLOPolicy(SchedulingPolicy):
    """Earliest-deadline-first over per-request SLO budgets, in steps.

    A request that has not emitted yet is due at ``submit + slo.ttft``;
    once streaming, its next token is due at ``last_token + slo.tpot``.
    Requests without an SLO are background (deadline +inf): they are
    admitted last and preempted first. A resident is only preempted for
    an incoming request with a strictly earlier deadline."""

    name = "slo"

    @staticmethod
    def deadline(req: GenRequest) -> float:
        slo = req.params.slo
        if slo is None:
            return math.inf
        if req.metrics.last_token_step is None:
            return req.metrics.submit_step + slo.ttft
        return req.metrics.last_token_step + slo.tpot

    def sort_key(self, req, step):
        return (self.deadline(req), req.rid)

    def victim(self, running, incoming, step):
        d_in = self.deadline(incoming)
        cands = [r for r in running if self.deadline(r) > d_in]
        if not cands:
            return None
        return max(cands, key=lambda r: (self.deadline(r), r.rid))


POLICIES = {p.name: p for p in (FCFSPolicy, PriorityPolicy, SLOPolicy)}


def make_policy(policy: Union[str, SchedulingPolicy]) -> SchedulingPolicy:
    if isinstance(policy, SchedulingPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown scheduling policy {policy!r}: "
                         f"want one of {sorted(POLICIES)} or a "
                         f"SchedulingPolicy instance") from None


# ------------------------------------------------------------------ plans
@dataclass(frozen=True)
class PrefillAssignment:
    """One prefill forward: rows [start, start+n) of ``req``'s chain."""
    req: GenRequest
    start: int
    n: int


@dataclass(frozen=True)
class ScheduleBatch:
    """One explicit scheduling decision, executed by the ModelRunner:
    requests newly admitted (blocks + slot already assigned), the prefill
    forwards to run (residents first in rid order, then admissions in
    policy order), the residents preempted to make room (with the slot
    each vacated), and the decode set (slot order). The engine may ask
    the scheduler for several batches within one step — a request that
    finishes at prefill frees its slot for a same-step admission — and
    the decode set of the final (empty-prefill) batch is authoritative."""
    admitted: Tuple[GenRequest, ...]
    prefills: Tuple[PrefillAssignment, ...]
    preempted: Tuple[Tuple[GenRequest, int], ...]
    decodes: Tuple[GenRequest, ...]

    @property
    def idle(self) -> bool:
        """No prefill work and no preemption — scheduling has converged
        for this step and ``decodes`` is final."""
        return not self.prefills and not self.preempted


# -------------------------------------------------------------- scheduler
class Scheduler:
    """Owns the waiting / running / preempted queues and emits
    ``ScheduleBatch`` plans. Mutates only scheduling state (queues, slot
    assignment, BlockManager accounting) — model compute and page-pool
    writes belong to the ModelRunner."""

    def __init__(self, block_mgr: BlockManager, max_batch: int,
                 policy: Union[str, SchedulingPolicy] = "fcfs",
                 prefix_cache: bool = False):
        self.block_mgr = block_mgr
        self.policy = make_policy(policy)
        self.prefix_cache = prefix_cache
        self.slots: List[Optional[GenRequest]] = [None] * max_batch
        self.waiting: collections.deque = collections.deque()
        self.preempted: List[GenRequest] = []
        self.n_preemptions = 0
        self._step = 0
        self._budget: float = math.inf

    # ----------------------------------------------------------- queues
    def submit(self, req: GenRequest):
        self.waiting.append(req)

    def running(self) -> List[GenRequest]:
        return [r for r in self.slots if r is not None]

    def num_queued(self) -> int:
        """Requests not holding a slot: waiting plus preempted."""
        return len(self.waiting) + len(self.preempted)

    def has_work(self) -> bool:
        return bool(self.waiting or self.preempted or self.running())

    def clear(self):
        """Drop all scheduling state (engine retirement)."""
        self.slots = [None] * len(self.slots)
        self.waiting = collections.deque()
        self.preempted = []

    def adopt(self, other: "Scheduler", block_mgr: BlockManager):
        """Take over another scheduler's request population across a
        §6.2 engine swap: slots are copied, the waiting/preempted pools
        are shared (the retired engine clears its own references)."""
        self.slots = list(other.slots)
        self.waiting = other.waiting
        self.preempted = other.preempted
        self.n_preemptions = other.n_preemptions
        self.block_mgr = block_mgr

    # --------------------------------------------------------- planning
    def begin_step(self, step: int, budget: float):
        """Arm the per-step prefill token budget before plan requests."""
        self._step = step
        self._budget = budget

    def _can_admit(self, req: GenRequest) -> bool:
        """Admission control, one authoritative BlockManager check: the
        pool must cover this request's worst-case total (prompt + decode
        tail — which subsumes the prompt itself) on top of the worst-case
        tails already reserved by in-flight requests, so ``extend`` can
        never fail mid-flight. Deliberately conservative under the prefix
        cache: a hit only means *fewer* fresh blocks are taken. A resumed
        request's worst case is unchanged — its emitted tokens count
        against the same ``prompt + max_new`` bound."""
        bm = self.block_mgr
        reserved = 0
        for r in self.running():
            held = len(bm.tables[r.rid].blocks)
            reserved += max(0, bm.blocks_needed(r.prompt_total + r.max_new)
                            - held)
        need = bm.blocks_needed(req.prompt_total + req.max_new)
        return bm.free_blocks - reserved >= need

    def _plan_prefill(self, req: GenRequest) -> PrefillAssignment:
        """Charge the budget for this request's next prefill forward.
        Monolithic engines (budget inf) take the whole remainder; chunked
        engines stop at the budget and resume next step. Prefix-embed
        prompts prefill monolithically (their embeds are not re-sliceable
        per chunk) but still charge the budget so co-resident prefills
        stay bounded."""
        remaining = req.prefill_target - req.prefilled
        n = remaining if req.prefix_embeds is not None \
            else int(min(remaining, self._budget))
        self._budget -= n
        return PrefillAssignment(req, req.prefilled, n)

    def _allocate(self, req: GenRequest):
        """Build the request's block table for (re-)admission. Fresh
        requests cover the prompt; resumed requests cover prompt + all
        emitted tokens but the last. With the prefix cache on, the chain
        is matched against the index: shared blocks need no prefill
        compute (``prefilled`` starts past them) — on a resume this is
        what turns recompute from O(prompt + output) into O(tail)."""
        target = req.prompt_total if not req.generated \
            else req.prompt_total + len(req.generated) - 1
        tokens = None
        if self.prefix_cache and req.prefix_embeds is None:
            # prefix embeddings are not part of the token chain — those
            # requests prefill from scratch
            tokens = req.chain()
        table = self.block_mgr.allocate(req.rid, target, tokens=tokens)
        req.prefill_upto = target
        req.prefilled = table.cached_tokens
        req.metrics.cached_tokens = table.cached_tokens
        req.metrics.restored_tokens = table.restored_tokens

    def _victim_pool(self) -> List[GenRequest]:
        """Residents eligible for preemption: fully prefilled (a mid-
        prefill request's chunk may already be planned this step) and
        token-addressable (prefix-embed requests cannot be re-prefilled
        from a token chain, so they are never evicted)."""
        return [r for r in self.running()
                if r.prefill_done and r.prefix_embeds is None]

    def _do_preempt(self, req: GenRequest) -> int:
        """Evict a resident: vacate its slot, release its blocks (the
        committed prefix stays in the hash index — see
        ``BlockManager.release_for_preempt``), move it to the preempted
        pool. Returns the vacated slot so the engine can clear the
        runner's table row and the worker's recurrent state."""
        slot = req.slot
        self.slots[slot] = None
        req.slot = None
        req.prefilled = 0
        req.prefill_upto = None
        req.metrics.preemptions += 1
        self.n_preemptions += 1
        self.block_mgr.release_for_preempt(req.rid)
        self.preempted.append(req)
        return slot

    def force_preempt(self, req: GenRequest) -> int:
        """Policy-independent preemption (tests, capacity changes around
        §6.2 consolidation). Same mechanics as a policy-driven eviction."""
        if req.slot is None or self.slots[req.slot] is not req:
            raise ValueError(f"request {req.rid} is not running")
        if req.prefix_embeds is not None:
            raise ValueError("prefix-embed requests cannot be preempted: "
                             "their rows are not re-prefillable from a "
                             "token chain")
        return self._do_preempt(req)

    def release(self, req: GenRequest):
        """A request finished: free its slot and blocks."""
        self.slots[req.slot] = None
        self.block_mgr.free(req.rid)

    def _head_candidate(self) -> Optional[GenRequest]:
        """The next request in policy order across waiting + preempted.
        Only the head is ever consumed per batch, so this is a single
        O(n) min, not a sort; every policy's key ties-breaks on rid, so
        the head is unique and deterministic."""
        pool = self.preempted + list(self.waiting)
        if not pool:
            return None
        return min(pool, key=lambda r: self.policy.sort_key(r, self._step))

    def schedule(self) -> ScheduleBatch:
        """Emit one ScheduleBatch under the remaining step budget.

        Plan order (preserving the pre-split engine's event order under
        FCFS): (1) half-prefilled residents continue, oldest first;
        (2) admissions in policy order — the head candidate either fits
        (slot free and blocks coverable), or the policy names preemption
        victims until it does, or planning stops (head-of-line
        deferral). The decode set is every fully-prefilled resident, in
        slot order, after admissions and preemptions have settled.

        Victim evictions apply as they are named: through the Engine
        (whose pool covers ``max_batch`` worst-case requests) evicting
        enough victims always makes the head admissible, so no eviction
        is wasted. A directly-constructed undersized pool can exhaust
        the victim pool with the head still inadmissible — the evicted
        residents then wait in ``preempted`` behind the same head until
        it fits, which is exactly the policy's strict-order contract."""
        prefills: List[PrefillAssignment] = []
        admitted: List[GenRequest] = []
        preempted: List[Tuple[GenRequest, int]] = []
        # 1. resident continuations (admission order = rid order)
        for r in sorted(self.running(), key=lambda r: r.rid):
            if self._budget <= 0:
                break
            if not r.prefill_done:
                prefills.append(self._plan_prefill(r))
        # 2. at most ONE admission per batch: the engine executes (and
        #    commits) this request's prefill before the next candidate
        #    allocates, so a same-step follower matches the leader's
        #    freshly committed prefix exactly as the pre-split engine did
        if self._budget > 0:
            req = self._head_candidate()
            if req is not None:
                admissible = self._admissible(req)
                while not admissible:
                    v = self.policy.victim(self._victim_pool(), req,
                                           self._step)
                    if v is None:
                        break             # defer until capacity frees up
                    preempted.append((v, self._do_preempt(v)))
                    admissible = self._admissible(req)
                if admissible:
                    if req in self.preempted:
                        self.preempted.remove(req)
                    else:
                        self.waiting.remove(req)
                    free = [i for i, s in enumerate(self.slots)
                            if s is None]
                    req.slot = free[0]
                    self.slots[req.slot] = req
                    self._allocate(req)
                    prefills.append(self._plan_prefill(req))
                    admitted.append(req)
        decodes = tuple(r for r in self.slots
                        if r is not None and r.prefill_done)
        return ScheduleBatch(tuple(admitted), tuple(prefills),
                             tuple(preempted), decodes)

    def _admissible(self, req: GenRequest) -> bool:
        return any(s is None for s in self.slots) and self._can_admit(req)

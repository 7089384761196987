"""Continuous-batching serving engine over a pipeline-parallel worker group.

The port of the reference engine (``src/repro/serving/engine.py``): real
PyTorch compute on the card (or the CPU when asked), real KV caches, real
§6.2 consolidation. ``submit(prompt, SamplingParams)`` returns a request
handle, every ``step()`` returns a ``StepOutput`` whose ``TokenEvent``s
let callers stream, requests finish with a ``FinishReason`` and carry
``RequestMetrics`` in scheduler steps.

The Engine composes two layers it drives each step:

  * ``Scheduler`` (serving/scheduler.py) owns the waiting / running /
    preempted queues and all policy decisions behind a pluggable
    ``SchedulingPolicy`` — ``fcfs`` (default), ``priority``, or ``slo``.
  * ``ModelRunner`` (serving/runner.py) executes those plans against the
    ``StageWorker`` pipeline and returns logits.

The Engine applies sampling, finish semantics, and block-accounting side
effects. KV layouts (``paged`` flag):

  * paged (``paged=True``, and the port's default ``paged=None``):
    attention KV lives in a shared page pool addressed through the
    BlockManager's per-request block tables; ``prefix_cache=True`` shares
    cached prompt prefixes, ``prefill_chunk=N`` interleaves prefill chunks
    with decode, ``fused=True`` serves each step with at most two ragged
    launches, and ``kv_dtype`` ("float16" or "int8") sets the pool storage
    (int8 is served fused only).
  * slot-contiguous (``paged=False``): per-slot (B, Smax) caches; a prefill
    runs one whole prompt through ``flash_attention``, a decode step runs
    every slot through ``decode_attention``. The options above need the
    paged layout and are refused, as in the reference.

The port serves the reference's decoder families: attention (GQA, dense
or sparse-expert MLPs), rwkv and the hybrid of attention and mamba; the
encoder-decoder family is refused at the stage worker (as in the
reference, which has no engine forward for it; ``Model.prefill`` and
``decode_step`` serve it). Recurrent mixer states
(rwkv's, mamba's) are slot-indexed on either layout: a model with one
prefills one whole prompt at batch 1 (on the paged layout its attention
K/V go into the pools through the slot's table row), and the
attention-only options (prefix cache, chunked prefill, the fused step,
int8 pages) are refused, as in the reference.

The reference's ``paged=None`` follows its ``REPRO_DECODE_MODE`` switch
(default: slot-contiguous); the port has no such switch and takes None to
mean the paged layout, so callers ask for ``paged=False``.

Paged engines with the prefix cache also take the reference's
multi-tier KV (``kv_tier``, a ``router.KVBlockStore``): LRU-evicted cached
blocks spill to the host tier through a synchronous host read of their
pages, made before the block id is reused, and a later prefix hit restores
them. ``sanitize=True`` (or ``sanitize=None`` under ``REPRO_SANITIZE=1``)
installs the KV-lifecycle sanitizer (``analysis/sanitizer.py``) on a
paged engine. ``submit(prefix_embeds=...)`` takes a VLM's image patch
embeddings (P, d) before the prompt on every non-fused engine: such a
request is prefilled whole in one forward of the workers (never the
ragged step, never chunked), never enters the prefix cache and is never
preempted. The fused step refuses it with ``ValueError`` before anything
is admitted (its token axis carries token ids only), as in the
reference.

Most callers should not hold an Engine directly: ``ServingEndpoint``
(serving/endpoint.py) is the stable handle that swaps engines in place
across §6.2 consolidation / scale-up.
"""

from __future__ import annotations

import itertools
import math
from typing import Iterator, List, Optional, Sequence, Union

import torch

from repro_torch import telemetry
from repro_torch.analysis.sanitizer import KVSanitizer
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ragged_attention import check_page_size
from repro_torch.models.attention import paged_kv_token_bytes
from repro_torch.models.common import as_dtype
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.serving.api import (FinishReason, SamplingParams,
                                     StepOutput, TokenEvent, sample_token)
from repro_torch.serving.kvcache import BlockManager, KVInvariantError
from repro_torch.serving.migration import (gather_stage_caches,
                                           gather_stage_caches_with_bytes)
from repro_torch.serving.runner import ModelRunner
from repro_torch.serving.scheduler import (GenRequest, PrefillAssignment,
                                           Scheduler, SchedulingPolicy)

__all__ = ["Engine", "GenRequest"]


class Engine:
    @telemetry.spanned("engine.build")
    def __init__(self, cfg: ModelConfig, stage_params: Sequence[dict],
                 max_batch: int = 4, max_seq: int = 128,
                 block_size: int = 16, paged: Optional[bool] = None,
                 prefix_cache: bool = False,
                 prefill_chunk: Optional[int] = None,
                 policy: Union[str, SchedulingPolicy] = "fcfs",
                 kv_tier=None, kv_dtype=None,
                 fused: Optional[bool] = None,
                 sanitize: Optional[bool] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = Model(cfg)
        if paged is None:
            paged = True
        self.paged = paged
        attn_only = transformer.attn_only(cfg)
        if prefix_cache or prefill_chunk is not None:
            if not paged:
                raise ValueError("prefix_cache / prefill_chunk need the "
                                 "paged KV layout (Engine(paged=True))")
            if not attn_only:
                raise ValueError(
                    "prefix_cache / prefill_chunk need an attention-only "
                    "decoder: recurrent mixer state is not block-shareable "
                    f"({cfg.name})")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if kv_dtype is not None and not paged:
            raise ValueError("kv_dtype overrides the *paged* pool storage "
                             "dtype (Engine(paged=True))")
        quantized = (kv_dtype is not None
                     and as_dtype(kv_dtype) == torch.int8)
        if fused is None:
            fused = quantized
        if fused:
            if not paged:
                raise ValueError("the fused ragged step needs the paged KV "
                                 "layout (Engine(paged=True))")
            if not attn_only:
                raise ValueError(
                    "the fused ragged step needs an attention-only decoder: "
                    f"recurrent mixers can't share one token axis "
                    f"({cfg.name})")
        if quantized and not fused:
            raise ValueError("int8 KV pages are only served by the fused "
                             "ragged kernel (fused=True)")
        if self.device.type == "cuda" and paged and attn_only:
            # the ragged kernel serves every prefill here: refuse a page
            # size its tensor-core body does not take before anything is
            # built or admitted
            check_page_size(block_size, as_dtype(cfg.dtype),
                            as_dtype(cfg.dtype if kv_dtype is None
                                     else kv_dtype),
                            cfg.n_heads // cfg.n_kv_heads)
        self.kv_dtype = kv_dtype
        self.fused = fused
        self.prefix_cache = prefix_cache
        self.prefill_chunk = prefill_chunk
        self.max_batch = max_batch
        self.max_seq = max_seq
        # single source of truth for KV bytes/token (attention.py): with
        # kv_dtype=None this is the legacy 2*Hkv*hd*itemsize(compute dtype)
        # formula; int8 adds the per-row f32 scale/zero leaves
        kv_per_tok = paged_kv_token_bytes(cfg, kv_dtype)
        n_blocks = max_batch * (max_seq // block_size + 1)
        self.block_mgr = BlockManager(
            n_blocks=n_blocks, block_size=block_size,
            bytes_per_token=max(kv_per_tok, 1), prefix_cache=prefix_cache)
        self.scheduler = Scheduler(self.block_mgr, max_batch, policy,
                                   prefix_cache=prefix_cache)
        self.runner = ModelRunner(cfg, stage_params, max_batch, max_seq,
                                  paged=paged, n_blocks=n_blocks,
                                  block_size=block_size, kv_dtype=kv_dtype,
                                  device=self.device)
        self._rid = itertools.count()
        self.finished: List[GenRequest] = []
        self.steps = 0
        self.retired = False
        self.last_migration_bytes: Optional[int] = None
        self._step_prefill_tokens: int = 0
        # multi-tier KV (router/kvtier.py): LRU-evicted cached blocks
        # spill HBM -> host tier and are restored on a later prefix hit
        self.kv_tier = kv_tier
        self._spill_hook = None
        if kv_tier is not None:
            if not prefix_cache:
                raise ValueError("kv_tier needs prefix_cache=True: spilled "
                                 "blocks are content-addressed by chain "
                                 "hash")
            self.block_mgr.kv_tier = kv_tier
            self._install_spill_hook()
        # KV-lifecycle sanitizer (analysis/sanitizer.py). Explicit
        # sanitize=True demands the paged layout; env-driven enabling
        # (REPRO_SANITIZE=1) silently no-ops on non-paged engines so one
        # env var can cover a whole mixed test matrix.
        self.sanitizer = None
        if sanitize is None:
            sanitize = ops.sanitize_mode() and paged
        elif sanitize and not paged:
            raise ValueError("sanitize=True needs the paged KV layout "
                             "(Engine(paged=True))")
        if sanitize:
            self.sanitizer = KVSanitizer.install(self)

    # -------------------------------------------------- multi-tier KV
    def _install_spill_hook(self):
        """Catch BlockManager evictions: read the page content (the hook
        fires before the block id is reused) and spill it to the host
        tier. ``read_pages`` copies to the host synchronously, so the
        bytes are read before any later kernel can overwrite the page.
        The closure binds THIS engine's runner — a consolidation successor
        must rebind (``consolidated`` does)."""

        def _spill(blk: int, h: bytes):
            self.kv_tier.put(h, self.runner.read_pages(blk))

        self._spill_hook = _spill
        self.block_mgr.evict_hooks.append(_spill)

    def _remove_spill_hook(self):
        if self._spill_hook is not None:
            self.block_mgr.evict_hooks.remove(self._spill_hook)
            self._spill_hook = None

    def _apply_restores(self, admitted):
        """Write spilled page bytes back into the worker pools for every
        host-tier restore the last allocation queued, charging the
        measured transfer to the (single) admitted request. Must run
        before ``_apply_copies``: a COW source may itself be a restored
        block."""
        pending = self.block_mgr.drain_restores()
        if not pending:
            return
        if self.kv_tier is None:
            raise KVInvariantError(
                "restores pending but no kv_tier attached")
        seconds = 0.0
        for h, dst in pending:
            payload, flow = self.kv_tier.take(h)
            self.runner.write_pages(dst, payload)
            seconds += flow.seconds
        for req in admitted:              # at most one per ScheduleBatch
            req.metrics.restore_seconds += seconds

    # ------------------------------------------------------- delegation
    @property
    def policy(self) -> SchedulingPolicy:
        return self.scheduler.policy

    @property
    def workers(self):
        return self.runner.workers

    @property
    def queue(self):
        """The waiting (never-admitted) pool; preempted requests live in
        ``scheduler.preempted``."""
        return self.scheduler.waiting

    @property
    def slots(self):
        return self.scheduler.slots

    def active(self) -> List[GenRequest]:
        return self.scheduler.running()

    def has_work(self) -> bool:
        """True while any request is resident, waiting, OR preempted —
        the condition drive-your-own-step loops should poll. (Checking
        ``active() or queue`` misses the preempted pool: a preempted
        request is in neither until it is re-admitted.)"""
        return self.scheduler.has_work()

    def stats(self) -> dict:
        """Cheap saturation snapshot — the router's overflow input and a
        fleet-bench observable. Pure reads, no compute."""
        self._check_live()
        bm = self.block_mgr
        return {
            "waiting": len(self.scheduler.waiting),
            "preempted": len(self.scheduler.preempted),
            "running": len(self.active()),
            "slots": self.max_batch,
            "free_slots": sum(s is None for s in self.scheduler.slots),
            "free_blocks": bm.free_blocks,
            "total_blocks": bm.n_blocks,
            "cached_blocks": bm.n_cached,
            "preemptions": self.scheduler.n_preemptions,
            "evictions": bm.evictions,
            "restores": bm.restores,
            "steps": self.steps,
        }

    def _check_live(self):
        if self.retired:
            raise RuntimeError(
                "Engine has been retired: its ServingEndpoint swapped in a "
                "consolidated successor that owns the block tables — use "
                "the endpoint handle, not the stale engine")

    # ------------------------------------------------------------- submit
    def submit(self, prompt: Sequence[int],
               params: Union[SamplingParams, int, None] = None, *,
               max_new: Optional[int] = None,
               prefix_embeds=None) -> GenRequest:
        self._check_live()
        if isinstance(params, int):       # legacy submit(prompt, max_new)
            params = SamplingParams(max_new=params)
        if max_new is not None:           # legacy submit(..., max_new=n)
            if params is not None:
                raise TypeError("pass either SamplingParams or max_new")
            params = SamplingParams(max_new=max_new)
        if params is None:
            params = SamplingParams()
        if prefix_embeds is not None and self.fused:
            raise ValueError("prefix_embeds (vision prefixes) are not "
                             "supported on the fused ragged step: the "
                             "flattened token axis carries token ids only")
        req = GenRequest(next(self._rid), list(prompt), params,
                         prefix_embeds)
        req.metrics.submit_step = self.steps
        req.metrics.submit_t = telemetry.now()
        if req.prompt_total + params.max_new > self.max_seq:
            raise ValueError(
                f"request needs {req.prompt_total + params.max_new} cache "
                f"slots (prompt {req.prompt_total} + max_new "
                f"{params.max_new}) > max_seq={self.max_seq}")
        self.scheduler.submit(req)
        return req

    # -------------------------------------------------------------- step
    def _finish_reason(self, req: GenRequest,
                       token: int) -> Optional[FinishReason]:
        sp = req.params
        if sp.eos_token is not None and token == sp.eos_token:
            return FinishReason.EOS
        if token in sp.stop_tokens:
            return FinishReason.STOP_TOKEN
        if len(req.generated) >= sp.max_new:
            return FinishReason.LENGTH
        return None

    def _emit(self, req: GenRequest, token: int,
              events: List[TokenEvent]) -> Optional[FinishReason]:
        req.generated.append(token)
        req.metrics.n_tokens = len(req.generated)
        req.metrics.last_token_step = self.steps
        reason = self._finish_reason(req, token)
        events.append(TokenEvent(req.rid, token, reason))
        return reason

    def _extend(self, req: GenRequest, token: int):
        """Grow the request's block table by one row (the token just fed
        or about to be fed) and mirror any new block into the runner's
        cached table row."""
        t = self.block_mgr.tables[req.rid]
        held = len(t.blocks)
        self.block_mgr.extend(req.rid, token=token)
        if len(t.blocks) != held:
            self.runner.set_row(req.slot, t.blocks)

    def _apply_copies(self):
        """Apply prefix-cache COW page copies queued by the scheduler's
        allocations to the worker pools — before anything reads (or a
        later allocation evicts) the released source pages."""
        for src, dst in self.block_mgr.drain_copies():
            self.runner.copy_pages(src, dst)

    def _exec_prefill(self, pa: PrefillAssignment,
                      events: List[TokenEvent]):
        """Run one planned prefill forward and apply its lifecycle
        effects. A fresh request that completes its prompt emits its
        first token here (and may finish outright — max_new=1, eos); a
        *resumed* request re-materializes KV for tokens it already
        emitted, so its final logits are discarded and decode simply
        restarts from the last emitted token."""
        req = pa.req
        if req.prefix_embeds is not None:
            if pa.start != 0 or pa.n != req.prompt_total:
                raise KVInvariantError(
                    "prefix_embeds prefill must cover the whole prompt in "
                    f"one chunk (got [{pa.start}, {pa.start + pa.n}) of "
                    f"{req.prompt_total})")
            tok = req.prompt
        else:
            tok = req.chain()[pa.start:pa.start + pa.n]
        h = self.runner.prefill(req.slot, tok, pa.start, pa.n,
                                prefix_embeds=req.prefix_embeds)
        req.prefilled = pa.start + pa.n
        self._step_prefill_tokens += pa.n
        first = None
        if req.prefill_done and not req.generated:
            with telemetry.span("engine.sample"):
                first = sample_token(h[0, 0], req.params, 0)
        with telemetry.span("engine.emit"):
            self.block_mgr.commit(req.rid, req.prefilled)
            if not req.prefill_done:
                return
            if first is not None:         # first admission: emit token 0
                self._emit_first(req, first, events)
            else:                         # resume: decode re-feeds the tail
                self._extend(req, req.generated[-1])

    def _emit_first(self, req: GenRequest, first: int,
                    events: List[TokenEvent]):
        """A fresh request's first token, at the end of its prefill."""
        req.metrics.admit_step = self.steps
        req.metrics.first_token_t = telemetry.now()
        reason = self._emit(req, first, events)
        self._extend(req, first)
        if reason is not None:
            self._finish(req, reason)

    def _plan(self, preempted_rids: List[int]):
        """One plan of a step's loop, applied to the runner: preempted
        rows cleared, admitted rows written, restores and copy-on-write
        copies made. Returns the plan."""
        plan = self.scheduler.schedule()
        for req, slot in plan.preempted:
            preempted_rids.append(req.rid)
            self.runner.clear_row(slot)
            self.runner.clear_slot(slot)
        for req in plan.admitted:
            if req.metrics.admitted_t is None:
                req.metrics.admitted_t = telemetry.now()
            self.runner.set_row(req.slot,
                                self.block_mgr.tables[req.rid].blocks)
        self._apply_restores(plan.admitted)
        self._apply_copies()
        return plan

    def _emit_decodes(self, reqs: Sequence[GenRequest], tokens: List[int],
                      events: List[TokenEvent]):
        """Each decoding request's sampled token emitted, its fed token's
        KV committed, its table extended, and finished where it ends."""
        for r, nxt in zip(reqs, tokens):
            r.metrics.decode_steps += 1
            reason = self._emit(r, nxt, events)
            # the fed token's KV is now material through pos_next + 1
            self.block_mgr.commit(
                r.rid, r.prompt_total + len(r.generated) - 1)
            self._extend(r, nxt)
            if reason is not None:
                self._finish(r, reason)

    def step(self) -> StepOutput:
        """One scheduler iteration: ask the Scheduler for ScheduleBatch
        plans (half-prefilled residents resume, then policy-ordered
        admissions, preempting on pressure where the policy allows) and
        execute them until the plan is idle — a request finishing at
        prefill frees its slot for a same-step admission — then one
        batched decode over the final plan's decode set. A *mixed* step
        is one where chunked prefill and decode coexist. Returns the
        step's newly emitted token events (streaming). The step's phases
        are ``telemetry`` spans: schedule, inputs, forward, sample, emit.

        ``fused=True`` engines route through :meth:`_step_fused`: the
        same plans, but every forward of the step collapses into (at
        most) two fused ragged launches."""
        if self.fused:
            return self._step_fused()
        self._check_live()
        self.steps += 1
        events: List[TokenEvent] = []
        n_done = len(self.finished)
        self._step_prefill_tokens = 0
        sched = self.scheduler
        sched.begin_step(self.steps,
                         math.inf if self.prefill_chunk is None
                         else self.prefill_chunk)
        preempted_rids: List[int] = []
        while True:
            with telemetry.span("engine.schedule"):
                plan = self._plan(preempted_rids)
            for pa in plan.prefills:
                self._exec_prefill(pa, events)
            if plan.idle:
                break
        reqs = list(plan.decodes)
        if reqs:
            skip = [r.slot for r in sched.running() if not r.prefill_done]
            h = self.runner.decode(reqs, skip_slots=skip)
            with telemetry.span("engine.sample"):
                greedy = None
                if any(r.params.greedy for r in reqs):
                    telemetry.count("host_sync")
                    greedy = torch.argmax(h[:, 0], dim=-1).tolist()
                toks = [int(greedy[r.slot]) if r.params.greedy
                        else sample_token(h[r.slot, 0], r.params,
                                          len(r.generated))
                        for r in reqs]
            with telemetry.span("engine.emit"):
                self._emit_decodes(reqs, toks, events)
        return StepOutput(self.steps, tuple(events),
                          tuple(r.rid for r in self.finished[n_done:]),
                          len(self.active()), sched.num_queued(),
                          prefill_tokens=self._step_prefill_tokens,
                          preempted=tuple(preempted_rids))

    def _step_fused(self) -> StepOutput:
        """One scheduler iteration on the fused ragged path. The plan loop
        runs exactly as in :meth:`step` but *defers the compute*: prefill
        assignments only advance ``req.prefilled`` (so later plans see the
        right resume/decode sets) and queue their chunks. Then:

          * launch 1 — ONE fused ragged forward over every pending
            prefill chunk plus every request that was already decoding
            (``plan.decodes`` minus the requests still completing prefill
            this step);
          * launch 2 — the requests that *completed* prefill this step:
            fresh ones need their first token sampled (from launch 1's
            logits) before they can decode it, resumed ones re-feed their
            last emitted token.

        Block commits move after launch 1 (a same-step follower misses
        sharing a chunk prefilled this very step and recomputes it —
        streams are unchanged); emission order matches the legacy step
        exactly (prefill first-tokens in plan order, then decode tokens in
        ``plan.decodes`` order), so greedy token streams are bit-exact
        with a non-fused engine."""
        self._check_live()
        self.steps += 1
        events: List[TokenEvent] = []
        n_done = len(self.finished)
        self._step_prefill_tokens = 0
        sched = self.scheduler
        sched.begin_step(self.steps,
                         math.inf if self.prefill_chunk is None
                         else self.prefill_chunk)
        preempted_rids: List[int] = []
        pending: List[PrefillAssignment] = []
        with telemetry.span("engine.schedule"):
            while True:
                plan = self._plan(preempted_rids)
                # a deferred chunk whose request just lost its slot and
                # blocks must not execute: the launch would write into
                # freed (possibly re-allocated) pages
                lost = {req.rid for req, _ in plan.preempted}
                pending = [pa for pa in pending if pa.req.rid not in lost]
                for pa in plan.prefills:
                    pa.req.prefilled = pa.start + pa.n
                    pending.append(pa)
                if plan.idle:
                    break

            # ---- launch 1: pending chunks + already-decoding requests
            # merge a request's chunks (contiguous by construction) into
            # one segment; keep first-assignment order for emission parity
            chunks = {}                   # rid -> [req, tokens, start]
            order: List[int] = []
            for pa in pending:
                tok = list(pa.req.chain()[pa.start:pa.start + pa.n])
                self._step_prefill_tokens += pa.n
                if pa.req.rid in chunks:
                    ent = chunks[pa.req.rid]
                    if ent[2] + len(ent[1]) != pa.start:
                        raise KVInvariantError(
                            f"non-contiguous fused prefill chunks for "
                            f"request {pa.req.rid}: have [{ent[2]}, "
                            f"{ent[2] + len(ent[1])}), next starts "
                            f"{pa.start}")
                    ent[1].extend(tok)
                else:
                    chunks[pa.req.rid] = [pa.req, tok, pa.start]
                    order.append(pa.req.rid)
            pending_rids = set(order)
            decs = list(plan.decodes)
            old_decodes = [r for r in decs if r.rid not in pending_rids]
            segments = []
            seg_of = {}
            for rid in order:
                req, tok, start = chunks[rid]
                seg_of[rid] = len(segments)
                segments.append((req.slot, tok, start))
            for r in old_decodes:
                seg_of[r.rid] = len(segments)
                segments.append((r.slot, [r.generated[-1]], r.pos_next))
        h1 = self.runner.forward_batch(segments) if segments else None

        # ---- prefill lifecycle effects, in plan order
        fresh = [chunks[rid][0] for rid in order]
        fresh = [r for r in fresh if r.prefill_done and not r.generated]
        with telemetry.span("engine.sample"):
            firsts = {r.rid: sample_token(h1[seg_of[r.rid]], r.params, 0)
                      for r in fresh}
        with telemetry.span("engine.emit"):
            for rid in order:
                req = chunks[rid][0]
                self.block_mgr.commit(req.rid, req.prefilled)
                if not req.prefill_done:
                    continue
                if rid in firsts:         # first admission: emit token 0
                    self._emit_first(req, firsts[rid], events)
                else:                     # resume: decode re-feeds the tail
                    self._extend(req, req.generated[-1])

        # ---- launch 2: requests whose prefill completed this step decode
        # their freshly sampled / re-fed token
        new_decodes = [r for r in decs
                       if r.rid in pending_rids and not r.done]
        h2 = None
        idx2 = {}
        if new_decodes:
            segs2 = []
            for i, r in enumerate(new_decodes):
                idx2[r.rid] = i
                segs2.append((r.slot, [r.generated[-1]], r.pos_next))
            h2 = self.runner.forward_batch(segs2)

        # ---- decode emissions, in plan.decodes order (legacy parity)
        live = [r for r in decs if not r.done]
        with telemetry.span("engine.sample"):
            toks = [sample_token(h2[idx2[r.rid]] if r.rid in pending_rids
                                 else h1[seg_of[r.rid]], r.params,
                                 len(r.generated))
                    for r in live]
        with telemetry.span("engine.emit"):
            self._emit_decodes(live, toks, events)
        return StepOutput(self.steps, tuple(events),
                          tuple(r.rid for r in self.finished[n_done:]),
                          len(self.active()), sched.num_queued(),
                          prefill_tokens=self._step_prefill_tokens,
                          preempted=tuple(preempted_rids))

    def _finish(self, req: GenRequest, reason: FinishReason):
        slot = req.slot
        req.done = True
        req.finish_reason = reason
        req.metrics.finish_step = self.steps
        req.metrics.finish_t = telemetry.now()
        self.scheduler.release(req)
        self.runner.clear_row(slot)
        self.runner.clear_slot(slot)
        self.finished.append(req)

    def preempt(self, req: GenRequest):
        """Forcibly evict a running request regardless of policy — the
        same mechanics a pressure-driven preemption uses. Its blocks are
        released (committed prefix stays cached under ``prefix_cache``),
        it rejoins the admission queue, and its token stream continues
        bit-exactly after re-admission."""
        self._check_live()
        slot = self.scheduler.force_preempt(req)
        self.runner.clear_row(slot)
        self.runner.clear_slot(slot)

    def run(self, max_steps: int = 10_000) -> List[StepOutput]:
        self._check_live()
        outs = []
        while self.has_work() and max_steps:
            outs.append(self.step())
            max_steps -= 1
        return outs

    def generate(self, prompt: Sequence[int],
                 params: Union[SamplingParams, int, None] = None, *,
                 prefix_embeds=None,
                 max_steps: int = 10_000) -> Iterator[TokenEvent]:
        """Submit one request (eagerly, before the first ``next()``) and
        drive the engine until it finishes, yielding its TokenEvents as
        they are emitted. Other in-flight requests advance normally but
        their events are not yielded — for multiplexed streaming, drive
        ``step()`` yourself and demux ``StepOutput.events`` by rid."""
        req = self.submit(prompt, params, prefix_embeds=prefix_embeds)

        def _drive() -> Iterator[TokenEvent]:
            for _ in range(max_steps):
                if req.done:
                    return
                out = self.step()
                for ev in out.events:
                    if ev.rid == req.rid:
                        yield ev
            if not req.done:
                raise RuntimeError(f"request {req.rid} not finished after "
                                   f"{max_steps} steps (admission starved?)")

        return _drive()

    # ---------------------------------------------------- consolidation
    def n_attn_layers(self, migrated_only: bool = False) -> int:
        """Attention layers across the pipeline. ``migrated_only`` counts
        only the layers whose KV crosses the network in a scale-down —
        every stage except the surviving target (worker 0) — i.e. the
        `n_layers` the BlockManager's migration_bytes quote refers to."""
        per_period = sum(1 for m in self.cfg.mixer_pattern if m == "attn")
        workers = self.runner.workers[1:] if migrated_only \
            else self.runner.workers
        return per_period * sum(p1 - p0 for p0, p1 in
                                (w.periods for w in workers))

    def consolidated(self, full_params: dict) -> "Engine":
        """Scale-down: gather the distributed KV/state to one standalone
        worker holding the full model; in-flight requests continue —
        including half-prefilled ones, whose allocated blocks are live and
        move with them. In paged mode the gather is block-granular (§6.2:
        only the blocks the BlockManager reports live move, each shared
        block exactly once) and ``last_migration_bytes`` is the exact byte
        count gathered; the slot-contiguous layout gathers whole caches and
        leaves it None. Refcount-zero prefix-cache blocks are dropped from
        the index rather than shipped — correctness needs only the live
        set (a preempted request therefore re-prefills from scratch after
        a consolidation; its stream is still bit-exact). The scheduling
        policy and the waiting/preempted pools carry over."""
        self._check_live()
        eng = Engine(self.cfg, [full_params], self.max_batch, self.max_seq,
                     self.block_mgr.block_size, paged=self.paged,
                     prefix_cache=self.prefix_cache,
                     prefill_chunk=self.prefill_chunk,
                     policy=self.scheduler.policy,
                     kv_dtype=self.kv_dtype, fused=self.fused,
                     sanitize=False,   # the successor adopts OUR sanitizer
                     device=self.device)
        stage_caches = [w.cache for w in self.runner.workers]
        # the successor's own fresh caches go before the gather allocates
        # the merged one, so the card never holds three copies
        eng.runner.workers[0].cache = None
        if self.paged:
            self.block_mgr.drop_unreferenced_cache()
            live_rids = [r.rid for r in self.active()]
            live = self.block_mgr.blocks_of(live_rids)
            cache, moved = gather_stage_caches_with_bytes(
                stage_caches, live_blocks=live, target_stage=0,
                tracer=self.block_mgr.tracer)
            if self.sanitizer is not None:
                self.sanitizer.check_migration(
                    moved, self.block_mgr.migration_bytes(
                        live_rids,
                        self.n_attn_layers(migrated_only=True)))
            self.last_migration_bytes = moved
            eng.last_migration_bytes = moved
        else:
            cache = gather_stage_caches(stage_caches)
        eng.runner.workers[0].cache = cache
        eng.block_mgr = self.block_mgr
        eng.scheduler.adopt(self.scheduler, self.block_mgr)
        if self.sanitizer is not None:
            # rebind the tracer endpoints (runner / workers; the shared
            # BlockManager already carries bm.tracer) BEFORE rebuild_rows
            # so the successor's row writes are observed
            eng.sanitizer = self.sanitizer
            self.sanitizer.rebind(eng)
        eng.runner.rebuild_rows(eng.active(), self.block_mgr.tables)
        eng._rid = self._rid
        eng.finished = self.finished
        eng.steps = self.steps            # keep step metrics continuous
        if self.kv_tier is not None:
            # the shared BlockManager carries the hook list across the
            # swap, but our hook closes over the runner being retired —
            # rebind the spill path to the successor. (The cold cached
            # pages dropped above already spilled through OUR runner,
            # which was still live — a consolidation demotes the prefix
            # cache to the host tier instead of discarding it.)
            self._remove_spill_hook()
            eng.kv_tier = self.kv_tier
            eng._install_spill_hook()
        return eng

    def scale_up(self, full_params: dict) -> List["Engine"]:
        """Scale-up: every stage becomes a standalone engine; in-flight
        requests (with gathered cache) stay on the first."""
        first = self.consolidated(full_params)
        others = []
        for _ in range(1, len(self.runner.workers)):
            others.append(Engine(self.cfg, [full_params], self.max_batch,
                                 self.max_seq, self.block_mgr.block_size,
                                 paged=self.paged,
                                 prefix_cache=self.prefix_cache,
                                 prefill_chunk=self.prefill_chunk,
                                 policy=self.scheduler.policy,
                                 kv_tier=self.kv_tier,
                                 kv_dtype=self.kv_dtype,
                                 fused=self.fused,
                                 sanitize=self.sanitizer is not None,
                                 device=self.device))
        return [first] + others

    def retire(self):
        """Mark this engine unusable after a ServingEndpoint swapped in
        its consolidated successor. The successor aliases this engine's
        block manager, queues, and slots — clear our references and drop
        worker caches so any stale use raises (``_check_live``) instead of
        silently corrupting block tables it no longer owns."""
        self.retired = True
        self._remove_spill_hook()         # closure binds the dead runner
        self.scheduler.clear()
        self.runner.retire()

"""Request-lifecycle types for the serving API (§6.2 endpoint abstraction).

Everything a caller needs to drive a generation without reaching into the
engine: ``SamplingParams`` describe *how* to decode, ``TokenEvent`` /
``StepOutput`` stream *what* was decoded, ``FinishReason`` says *why* a
request stopped, and ``RequestMetrics`` records the per-request lifecycle
in scheduler steps (the engine's time unit), with four wall-clock stamps
beside them (``telemetry.now()``).

Determinism contract: :func:`sample_token` keys its generator only on
``(seed, token_index)``, never on batch position, slot, KV layout, or
engine identity — so a request's token stream survives continuous-batching
reshuffles and §6.2 consolidation bit-exactly, and ``temperature=0``
reduces to plain ``argmax`` (first index on ties, as ``jnp.argmax``).
Seeded sampling draws from a ``torch.Generator``, which cannot reproduce
the reference's ``jax.random`` draws: sampled streams are held within the
port only, greedy streams across both packages.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch import telemetry
from repro_torch.core.types import SLO


class FinishReason(str, enum.Enum):
    LENGTH = "length"            # hit SamplingParams.max_new
    EOS = "eos"                  # emitted SamplingParams.eos_token
    STOP_TOKEN = "stop_token"    # emitted one of SamplingParams.stop_tokens


@dataclass(frozen=True)
class SamplingParams:
    """Decode policy for one request. The default is greedy argmax with
    length-only termination — the legacy engine behaviour, bit-exact.

    ``priority`` and ``slo`` are *scheduling* hints, consumed by the
    engine's ``SchedulingPolicy`` (serving/scheduler.py): priority is an
    integer where larger means more important (the priority policy admits
    high before low and may preempt low for high); ``slo`` carries
    per-request TTFT/TPOT budgets, interpreted in **scheduler steps** by
    the SLO-deadline (EDF) policy. Both are ignored by the default FCFS
    policy, so plain requests behave exactly as before.
    """
    max_new: int = 16
    temperature: float = 0.0     # <= 0 means greedy argmax
    top_k: int = 0               # 0 means the full vocab
    seed: int = 0                # PRNG seed for temperature > 0
    eos_token: Optional[int] = None
    stop_tokens: Tuple[int, ...] = ()
    priority: int = 0            # scheduling priority (higher wins)
    slo: Optional[SLO] = None    # TTFT/TPOT budgets in scheduler steps

    def __post_init__(self):
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


@dataclass
class RequestMetrics:
    """Lifecycle counters in scheduler steps.

    ``ttft_steps`` is submit -> first token (1 for a request admitted at
    the very next step); ``queue_steps`` is the waiting part of that TTFT
    (deferred admission, plus prefill-chunk steps under chunked prefill);
    ``tpot_steps`` is the decode-steps-per-generated-token proxy (1.0
    when the request decoded every step it was resident);
    ``cached_tokens`` is the prompt prefix served from the paged prefix
    cache — tokens whose KV was reused instead of recomputed (on a
    preempted request it is refreshed at re-admission, so it also shows
    how much of the resume was served from the retained prefix blocks);
    ``preemptions`` counts how many times the scheduler evicted this
    request from its slot to make room for higher-value work.
    ``restored_tokens`` is the part of ``cached_tokens`` that was not in
    HBM at admission but restored from a lower KV tier
    (router/kvtier.py); ``restore_seconds`` is the modeled wall time of
    those transfers on the contention-fair ``FetchSchedule``.

    The ``*_t`` fields are wall-clock stamps, ``telemetry.now()`` (seconds
    of ``time.perf_counter``), set beside the step stamps: ``submit_t`` at
    submit, ``admitted_t`` when the scheduler's plan first gives the
    request a slot, ``first_token_t`` at its first token, ``finish_t`` when
    it finishes; None until then.
    """
    submit_step: int = 0
    admit_step: Optional[int] = None      # step of the first token
    finish_step: Optional[int] = None
    decode_steps: int = 0                 # decode passes it took part in
    n_tokens: int = 0                     # tokens emitted so far
    cached_tokens: int = 0                # prompt tokens hit in prefix cache
    restored_tokens: int = 0              # ...restored from a lower KV tier
    restore_seconds: float = 0.0          # modeled restore transfer time
    preemptions: int = 0                  # times evicted from a slot
    last_token_step: Optional[int] = None  # step of the latest token
    submit_t: Optional[float] = None
    admitted_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None

    @property
    def ttft_steps(self) -> Optional[int]:
        if self.admit_step is None:
            return None
        return self.admit_step - self.submit_step

    @property
    def queue_steps(self) -> Optional[int]:
        ttft = self.ttft_steps
        return None if ttft is None else ttft - 1

    @property
    def tpot_steps(self) -> Optional[float]:
        if self.n_tokens <= 1:
            return None
        return self.decode_steps / (self.n_tokens - 1)


@dataclass(frozen=True)
class TokenEvent:
    """One newly emitted token. ``finish_reason`` is set on a request's
    final token (the token itself is still part of the output)."""
    rid: int
    token: int
    finish_reason: Optional[FinishReason] = None


@dataclass(frozen=True)
class StepOutput:
    """What one ``Engine.step()`` produced, in emission order: prefill
    tokens of newly admitted requests first (admission order), then one
    decode token per resident request (slot order). Under chunked prefill
    a step can make prefill progress without emitting a prefill token —
    ``prefill_tokens`` counts the prompt tokens computed this step, so a
    mixed step shows both ``prefill_tokens > 0`` and decode events.
    ``preempted`` lists the requests the scheduler evicted this step;
    they re-enter the admission queue and resume later (no events are
    emitted for a preemption — the stream just pauses)."""
    step: int
    events: Tuple[TokenEvent, ...]
    finished: Tuple[int, ...]             # rids that finished this step
    num_active: int                       # residents after the step
    num_queued: int                       # waiting + preempted, pre-admission
    prefill_tokens: int = 0               # prompt tokens prefilled this step
    preempted: Tuple[int, ...] = ()       # rids preempted this step


@dataclass(frozen=True)
class RequestOutput:
    """Immutable summary of a finished (or in-flight) request."""
    rid: int
    prompt: Tuple[int, ...]
    token_ids: Tuple[int, ...]
    finish_reason: Optional[FinishReason]
    metrics: RequestMetrics

    @property
    def done(self) -> bool:
        return self.finish_reason is not None


def _generator(seed: int, token_index: int) -> torch.Generator:
    """A CPU generator keyed on ``(seed, token_index)`` only."""
    key = (int(seed) * 0x9E3779B97F4A7C15 + int(token_index)) % (1 << 63)
    return torch.Generator(device="cpu").manual_seed(key)


def sample_token(logits, params: SamplingParams, token_index: int) -> int:
    """Pick the next token from 1-D ``logits``.

    Greedy (``temperature <= 0``) is plain ``argmax``. Otherwise:
    temperature-scaled, optionally top-k truncated, seeded categorical
    whose generator depends only on ``(params.seed, token_index)`` (see
    module docstring). The draw runs on the CPU, so it does not depend on
    the device the logits came from. Either way the host reads the logits
    (one ``host_sync``).
    """
    telemetry.count("host_sync")
    if params.greedy:
        return int(torch.argmax(logits))
    scaled = logits.detach().to("cpu", torch.float32) / params.temperature
    if params.top_k and params.top_k < scaled.shape[-1]:
        kth = torch.topk(scaled, params.top_k).values[-1]
        scaled = torch.where(scaled >= kth, scaled,
                             torch.full_like(scaled, -torch.inf))
    probs = torch.softmax(scaled, dim=-1)
    return int(torch.multinomial(probs, 1, generator=_generator(
        params.seed, token_index)))

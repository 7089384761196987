"""What a run records, for the metric readers: requests with their
scheduled arrivals and token times, the engine's steps, the cold starts,
the attention calls and model tokens (traced runs), and the device's
intervals from the profiler (traced runs). Times are host seconds
(``time.perf_counter``), with the window's opening at ``t_open``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class ReqRec:
    idx: int
    arrival: float                    # scheduled, host seconds
    prompt_len: int
    max_new: int
    cold: bool = False
    rid: Optional[int] = None         # the engine's id
    token_times: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    done_at: Optional[float] = None
    failed: bool = False


@dataclass
class StepRec:
    t0: float
    t1: float
    num_queued: int
    decode_events: int
    prefill_tokens: int
    kv_blocks: int = 0                # pages of the KV pool held after it


@dataclass
class ColdRec:
    t_arrival: float
    t_begin_end: float
    t_finish_end: float
    materialize_s: float = 0.0        # traced runs: synchronised wall time
    bytes: int = 0
    t_first_token: Optional[float] = None


@dataclass
class Record:
    t_start: float                    # process start
    t_open: float = 0.0
    t_close: float = 0.0
    requests: List[ReqRec] = field(default_factory=list)
    steps: List[StepRec] = field(default_factory=list)
    cold: List[ColdRec] = field(default_factory=list)
    # host spans (label, t0, t1): submit, step, wait, begin, materialize,
    # finish, drop
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    # traced runs: per attention call (t_host, kernel family, bytes, flops)
    calls: List[Tuple[float, str, float, float]] = field(default_factory=list)
    # traced runs: (t_host, model flops) per forward
    model_flops: List[Tuple[float, float]] = field(default_factory=list)
    # traced runs: device activity mapped onto the host clock
    device_events: List[Tuple[str, float, float]] = field(
        default_factory=list)            # (name, start, end)
    busy: List[Tuple[float, float]] = field(default_factory=list)  # merged
    traced: bool = False
    extra: Dict[str, float] = field(default_factory=dict)
    # what the deployment holds on the card (bytes): weights, the KV pool
    # as reserved, and the K/V of the pages held at the window's fullest
    # step
    memory: Dict[str, int] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def in_window(self, t: float) -> bool:
        return self.t_open <= t < self.t_close

"""The two drivers of a window, through the entry points the port's users
call: an open loop over a ``ServingEndpoint``, and bursts that each reach
a model scaled to zero through ``ServerlessFrontend.begin_cold_start(...)
.finish()``. One process, one thread; every request is timed from its
scheduled arrival, and each host span is recorded for the trace."""

from __future__ import annotations

import gc
import time
from collections import deque
from typing import Dict, List

import torch

from bench.harness.record import ColdRec, Record, ReqRec, StepRec


def _now() -> float:
    return time.perf_counter()


class Loop:
    """Submits and steps one endpoint, recording requests and steps."""

    def __init__(self, rec: Record, params_cls):
        self.rec = rec
        self.params_cls = params_cls
        self.by_rid: Dict[int, ReqRec] = {}
        self.prompts: Dict[int, list] = {}

    def submit(self, ep, q, arrival: float, cold: bool = False) -> ReqRec:
        rr = ReqRec(q.idx, arrival, len(q.prompt), q.max_new, cold=cold)
        a = _now()
        try:
            h = ep.submit(q.prompt, self.params_cls(max_new=q.max_new))
        except ValueError:
            rr.failed = True
        else:
            rr.rid = h.rid
            self.by_rid[h.rid] = rr
            self.prompts[q.idx] = q.prompt
        self.rec.spans.append(("submit", a, _now()))
        self.rec.requests.append(rr)
        return rr

    def step(self, ep):
        a = _now()
        out = ep.step()
        b = _now()
        n_dec = 0
        for ev in out.events:
            rr = self.by_rid[ev.rid]
            if rr.tokens:
                n_dec += 1
            rr.tokens.append(int(ev.token))
            rr.token_times.append(b)
            if ev.finish_reason is not None:
                rr.done_at = b
        st = ep.stats()
        self.rec.steps.append(StepRec(a, b, out.num_queued, n_dec,
                                      out.prefill_tokens,
                                      st["total_blocks"] - st["free_blocks"]))
        self.rec.spans.append(("step", a, b))
        return out

    def wait(self, until: float):
        a = _now()
        if until > a:
            time.sleep(until - a)
            self.rec.spans.append(("wait", a, _now()))


def open_loop(ep, loop: Loop, schedule: List, t_open: float,
              window_s: float, on_open=None):
    """Offer ``schedule`` (arrivals relative to ``t_open``) until the
    window closes; ``on_open`` runs once, when it opens."""
    pending = deque(schedule)
    t_close = t_open + window_s
    opened = False
    while True:
        now = _now()
        if not opened and now >= t_open:
            opened = True
            if on_open is not None:
                on_open()
            now = _now()
        if now >= t_close:
            return
        while pending and t_open + pending[0].arrival <= now:
            q = pending.popleft()
            loop.submit(ep, q, t_open + q.arrival)
        if ep.has_work():
            loop.step(ep)
        else:
            nxt = t_open + pending[0].arrival if pending else t_close
            if not opened:
                nxt = min(nxt, t_open)
            loop.wait(min(nxt, t_close))


def cold_bursts(front, name: str, engine_kw: dict, loop: Loop, bursts,
                t_open: float, window_s: float, on_open=None, timed=None,
                on_endpoint=None):
    """Bursts that each reach a model scaled to zero: the arrival, the
    cold start (Alg. 1's plan, the stages streamed out of the store, the
    engine built), the burst served to completion, the endpoint dropped
    and its card memory returned; the next burst arrives at once. The
    window's last burst runs until its first tokens are out, and its
    endpoint is kept. Returns that endpoint (None if no burst ran)."""
    rec = loop.rec
    t_close = t_open + window_s
    if on_open is not None:
        loop.wait(t_open)
        on_open()
    ep = None
    for burst in bursts:
        t_arr = _now()
        if t_arr >= t_close:
            break
        cr = ColdRec(t_arr, 0.0, 0.0)
        a = _now()
        pend = front.begin_cold_start(name, **engine_kw)
        cr.t_begin_end = _now()
        rec.spans.append(("begin", a, cr.t_begin_end))
        if timed is not None:
            timed(pend, cr)
        ep = pend.finish()
        cr.t_finish_end = _now()
        rec.spans.append(("finish", cr.t_begin_end, cr.t_finish_end))
        if on_endpoint is not None:
            on_endpoint(ep)
        rec.cold.append(cr)
        reqs = [loop.submit(ep, q, t_arr, cold=True) for q in burst]
        while ep.has_work():
            loop.step(ep)
            if cr.t_first_token is None and all(
                    r.token_times or r.failed for r in reqs):
                cr.t_first_token = _now()
            if cr.t_first_token is not None and _now() >= t_close:
                return ep
        if _now() >= t_close:
            return ep
        a = _now()
        del pend
        ep = None
        release()
        rec.spans.append(("drop", a, _now()))
    return ep


def release():
    """Scale to zero, once the caller has let go of the endpoint: its card
    memory goes back to the device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return None

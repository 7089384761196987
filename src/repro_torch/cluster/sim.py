"""Deterministic discrete-event simulator core."""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional


class Event:
    __slots__ = ("time", "seq", "fn", "cancelled")

    def __init__(self, time: float, seq: int, fn: Callable[[], None]):
        self.time = time
        self.seq = seq
        self.fn = fn
        self.cancelled = False

    def __lt__(self, other):
        return (self.time, self.seq) < (other.time, other.seq)


class EventSim:
    def __init__(self):
        self._heap = []
        self._counter = itertools.count()
        self.now = 0.0

    def at(self, time: float, fn: Callable[[], None]) -> Event:
        assert time >= self.now - 1e-9, (time, self.now)
        ev = Event(max(time, self.now), next(self._counter), fn)
        heapq.heappush(self._heap, ev)
        return ev

    def after(self, delay: float, fn: Callable[[], None]) -> Event:
        return self.at(self.now + max(delay, 0.0), fn)

    def cancel(self, ev: Optional[Event]):
        if ev is not None:
            ev.cancelled = True

    def run(self, until: Optional[float] = None, max_events: int = 50_000_000):
        n = 0
        while self._heap and n < max_events:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            if until is not None and ev.time > until:
                self.now = until
                return
            self.now = ev.time
            ev.fn()
            n += 1
        if until is not None:
            self.now = until

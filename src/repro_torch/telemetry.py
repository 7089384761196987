"""The port's wall-clock spans and counters, in one place.

Clock. ``now()`` is ``time.perf_counter()``, in seconds: the clock the
benchmark's ``Record`` stamps requests and steps with, and the clock its
``Tracer`` maps the profiler's device events onto (through a
``torch.cuda._sleep`` marker). Spans recorded here and device events
therefore share one timeline, and need no second mapping.

Spans. ``with span(name):`` records ``(name, t0, t1)`` in the module's
buffer while telemetry is on. It is off by default (``enable()`` /
``disable()``); off, a span costs one read of a module global and returns
one shared no-op context: it allocates and appends nothing. ``drain()``
returns the recorded spans and the counters, and empties the buffer.

The serving step is tiled by five flat phases (no span inside another),
so that every moment of a step falls in one named phase:

  ``engine.schedule``  the plan loop: ``Scheduler.schedule()``, preempted
                       and admitted rows, restores, copy-on-write copies
                       (``Engine.step``, ``Engine._step_fused``)
  ``runner.inputs``    host arrays and their uploads, the block table's
                       included (``ModelRunner.decode`` / ``forward_batch``
                       / ``prefill``)
  ``runner.forward``   the loop over the stage workers: the host issuing
                       every layer's launches
  ``engine.sample``    reading the step's logits to the host: the host's
                       wait for the card's work
  ``engine.emit``      emission, block commits and extensions, finishes

A cold start adds ``coldstart.plan`` (``ServerlessFrontend.
begin_cold_start``), ``load.read`` and ``load.copy`` (each chunk range's
store read and host-to-device copy, ``store/loader.py``; on the card one
more ``load.copy`` a stage, its wait for the copy stream) and
``engine.build`` (``Engine.__init__``).

Counters. Plain module-level ``dict[str, int]``, always on (an int add
each), of the same form as the kernels' launch counts: ``host_sync``, the
points where the host reads or uploads through the card's stream and so
waits for it (each ``ModelRunner._to_dev`` upload, each read of logits in
sampling, each ``read_pages``; counted on every device, so the CPU counts
the same points); ``upload_bytes``, the bytes of those uploads;
``load.bytes``, the bytes the ``load.copy`` spans moved;
``load.staged_bytes``, those of them sent through the card's ring of
page-locked slots (all of them on the card, none on the CPU), and
``load.slot_waits``, the ring's fills that found their slot's DMA still
unfinished (the DMA, not the host's fill, set the pace). They are running
totals, never reset: a window's count is the difference of two readings.
``counters()`` returns them with ``kernels.ops.launch_counts()``, one
read-out for both.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Tuple

now = time.perf_counter

_ON = False
_SPANS: List[Tuple[str, float, float]] = []
COUNTS: Dict[str, int] = {"host_sync": 0, "upload_bytes": 0,
                          "load.bytes": 0, "load.staged_bytes": 0,
                          "load.slot_waits": 0}


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        _SPANS.append((self.name, self.t0, now()))
        return False


def span(name: str):
    """A context recording ``(name, t0, t1)`` while telemetry is on."""
    if not _ON:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """A decorator: each call of the function is one span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def enable():
    global _ON
    _ON = True


def disable():
    global _ON
    _ON = False


def count(name: str, n: int = 1):
    COUNTS[name] += n


def counters() -> Dict[str, int]:
    """The counters' running totals and the kernels' launch counts."""
    from repro_torch.kernels import ops
    return {**COUNTS, **ops.launch_counts()}


def drain() -> Tuple[List[Tuple[str, float, float]], Dict[str, int]]:
    """The spans recorded since the last drain, in order of their ends,
    and ``counters()``; the span buffer is emptied."""
    spans = list(_SPANS)
    _SPANS.clear()
    return spans, counters()

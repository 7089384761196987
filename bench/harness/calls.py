"""Traced runs only: the model FLOPs of each forward and the cost of each
kernel call, counted on the host from the arguments the runner and the
kernels get (no device read), by the configuration's architecture module.

The runner's ``forward_batch`` (a ragged forward), ``decode`` and
``prefill`` are wrapped on the instance. A prefill is counted where it
does not go through ``forward_batch``, which counts its own: a model with
a recurrent mixer, or a prompt with a prefix, prefills through the stage
workers. The ops module's entry points that the module's ``CALLS`` name
are wrapped while the window runs; each call's cost function reads its
arguments and the positions the runner was given (``spans``,
``kv_lens``)."""

from __future__ import annotations

import time
from contextlib import contextmanager

from bench.harness.spec import architecture


class CallCounter:
    def __init__(self, arch: dict, rec):
        self.arch = arch
        self.rec = rec
        self.module = architecture(arch)
        self.spans = []          # (pos0, n) of the current prefill forward
        self.kv_lens = []        # kv_len of each row of the current decode
        self.batched = False     # the current prefill ran forward_batch
        self.on = False

    def _flops(self, t: float, fl: float):
        self.rec.model_flops.append((t, fl))

    def wrap_runner(self, runner):
        fb, dec, pre = runner.forward_batch, runner.decode, runner.prefill
        arch, m = self.arch, self.module

        def forward_batch(segments):
            self.batched = True
            self.spans = [(int(p0), len(tk)) for _, tk, p0 in segments]
            if self.on:
                self._flops(time.perf_counter(),
                            sum(m.span_flops(arch, p0, n, True)
                                for p0, n in self.spans))
            return fb(segments)

        def decode(reqs, skip_slots=()):
            lens = [int(r.pos_next) + 1 for r in reqs]
            self.kv_lens = lens + [1] * (runner.max_batch - len(lens))
            if self.on:
                self._flops(time.perf_counter(),
                            sum(m.token_flops(arch, n, True) for n in lens))
            return dec(reqs, skip_slots=skip_slots)

        def prefill(slot, tokens, start, n, prefix_embeds=None):
            t = time.perf_counter()
            self.batched = False
            self.spans = [(int(start), int(n))]
            out = pre(slot, tokens, start, n, prefix_embeds=prefix_embeds)
            if self.on and not self.batched:
                self._flops(t, m.span_flops(arch, int(start), int(n), True))
            return out

        runner.forward_batch = forward_batch
        runner.decode = decode
        runner.prefill = prefill

    @contextmanager
    def ops_wrapped(self):
        from repro_torch.kernels import ops
        saved = {name: getattr(ops, name) for name in self.module.CALLS}

        def wrap(orig, cost):
            def call(*args, **kw):
                if self.on:
                    fam, nb, fl = cost(self.arch, self, *args, **kw)
                    self.rec.calls.append((time.perf_counter(), fam, nb, fl))
                return orig(*args, **kw)
            return call

        for name, cost in self.module.CALLS.items():
            setattr(ops, name, wrap(saved[name], cost))
        try:
            yield
        finally:
            for name, orig in saved.items():
                setattr(ops, name, orig)

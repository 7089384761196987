"""Traced runs only: the cost of each attention call and the model FLOPs
of each forward, counted on the host from the arguments the runner gets
(no device read). The runner's ``forward_batch`` (a prefill's ragged
forward) and ``decode`` are wrapped on the instance; the ops module's
two entry points are wrapped while the window runs, and read the shapes
of their tensors and the positions the runner was given."""

from __future__ import annotations

import time
from contextlib import contextmanager

from bench.frozen import flops as F


class CallCounter:
    def __init__(self, arch: dict, rec):
        self.arch = arch
        self.rec = rec
        self.spans = []          # (pos0, n) of the current ragged forward
        self.kv_lens = []        # kv_len of each row of the current decode
        self.on = False

    def wrap_runner(self, runner):
        fb, dec = runner.forward_batch, runner.decode

        def forward_batch(segments):
            self.spans = [(int(p0), len(tk)) for _, tk, p0 in segments]
            if self.on:
                fl = sum(F.span_flops(self.arch, p0, n, True)
                         for p0, n in self.spans)
                self.rec.model_flops.append((time.perf_counter(), fl))
            return fb(segments)

        def decode(reqs, skip_slots=()):
            lens = [int(r.pos_next) + 1 for r in reqs]
            self.kv_lens = lens + [1] * (runner.max_batch - len(lens))
            if self.on:
                fl = sum(F.token_flops(self.arch, n, True) for n in lens)
                self.rec.model_flops.append((time.perf_counter(), fl))
            return dec(reqs, skip_slots=skip_slots)

        runner.forward_batch = forward_batch
        runner.decode = decode

    @contextmanager
    def ops_wrapped(self):
        from repro_torch.kernels import ops
        ragged, paged = ops.ragged_paged_attention, ops.paged_decode_attention

        def ragged_w(q, k_pages, v_pages, tables, row, pos, **kw):
            if self.on:
                nb, fl = F.ragged_call_cost(
                    self.arch, q.shape[0], tables.shape[0], tables.shape[1],
                    self.spans, k_pages.element_size(), q.element_size())
                self.rec.calls.append((time.perf_counter(), "ragged", nb, fl))
            return ragged(q, k_pages, v_pages, tables, row, pos, **kw)

        def paged_w(q, k_pages, v_pages, block_tables, kv_len):
            if self.on:
                lens = self.kv_lens[:q.shape[0]]
                nb, fl = F.decode_call_cost(self.arch, lens,
                                            block_tables.shape[1],
                                            k_pages.element_size(),
                                            q.element_size())
                self.rec.calls.append((time.perf_counter(), "paged_decode",
                                       nb, fl))
            return paged(q, k_pages, v_pages, block_tables, kv_len)

        ops.ragged_paged_attention = ragged_w
        ops.paged_decode_attention = paged_w
        try:
            yield
        finally:
            ops.ragged_paged_attention = ragged
            ops.paged_decode_attention = paged

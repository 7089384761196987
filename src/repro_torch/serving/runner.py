"""Plan execution for the serving engine: the ModelRunner.

The runner is the compute half of the scheduler/runner split
(serving/scheduler.py): it owns the ``StageWorker`` pipeline and turns a
``ScheduleBatch``'s assignments into forwards — prefill chunks, one
batched decode over the decode set — returning logits. It holds **no
queue or policy state**.

It also owns the paged layout's batched block table: a ``(B,
table_width)`` int32 array kept **incrementally** current (rows are
updated on allocate / extend / free / preempt), with its device copy
cached and re-uploaded only after a row changes. Idle slots point at the
null page so their (unused) writes never land in a live page; for decode,
half-prefilled slots are masked out the same way.

On the paged layout an attention-only model prefills through the ragged
path (``forward_batch``), as in the reference: the flattening is the
reference's, tile-aligned spans and power-of-two total lengths, so both
packages feed the kernels the same layout. Otherwise (the slot-contiguous
layout, or a model with a recurrent mixer) a prefill runs one request at
batch 1 over its whole prompt into its slot (``prefill_slot``); on the
paged layout its attention K/V go into the pools through the slot's
block-table row. A decode
runs all ``max_batch`` slots, idle ones at position 0, as the reference
does; the slot-contiguous layout has no block table.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ragged_attention import TILE_Q
from repro_torch.models import transformer
from repro_torch.serving.kvcache import KVInvariantError
from repro_torch.serving.worker import StageWorker


class ModelRunner:
    def __init__(self, cfg: ModelConfig, stage_params: Sequence[dict],
                 max_batch: int, max_seq: int, *, paged: bool,
                 n_blocks: int, block_size: int, kv_dtype=None,
                 device=None):
        self.cfg = cfg
        self.paged = paged
        self.max_batch = max_batch
        self.kv_dtype = kv_dtype
        self._attn_only = transformer.attn_only(cfg)
        # one extra trash page: idle slots' block-table rows point here so
        # their (unused) decode writes never land in a live page; the
        # ragged path also routes pad-token writes to it
        self._null_page = n_blocks
        self._table_width = max_seq // block_size + 1
        n = len(stage_params)
        self.workers = [StageWorker(cfg, p, n, i, max_batch, max_seq,
                                    paged=paged, n_pages=n_blocks + 1,
                                    page_size=block_size, kv_dtype=kv_dtype,
                                    device=device)
                        for i, p in enumerate(stage_params)]
        self.device = self.workers[0].device
        self._bt = np.full((max_batch, self._table_width), self._null_page,
                           np.int32)
        # correctness tracer (the reference's analysis/sanitizer.py hooks);
        # None in production
        self.tracer = None
        self._bt_dev = None             # cached device copy, None = dirty
        # masked decode-view cache: (frozen skip set, device tensor)
        self._masked_dev = (None, None)

    def _to_dev(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), device=self.device)

    # --------------------------------------------------- block-table rows
    def set_row(self, slot: int, blocks: Sequence[int]):
        """(Re)write one slot's block-table row: called on allocate and
        whenever extend crosses a block boundary."""
        if not self.paged:
            return
        if self.tracer is not None:
            self.tracer.on_set_row(slot, list(blocks))
        row = self._bt[slot]
        row[:] = self._null_page
        row[:len(blocks)] = blocks
        self._bt_dev = None
        self._masked_dev = (None, None)

    def clear_row(self, slot: int):
        """Point a vacated slot (finish / preempt) back at the null page."""
        if not self.paged:
            return
        if self.tracer is not None:
            self.tracer.on_clear_row(slot)
        self._bt[slot] = self._null_page
        self._bt_dev = None
        self._masked_dev = (None, None)

    def rebuild_rows(self, requests: Iterable, tables: dict):
        """Full rebuild from BlockManager state — only needed when a
        consolidated engine adopts another engine's residents."""
        if not self.paged:
            return
        self._bt[:] = self._null_page
        for r in requests:
            blocks = tables[r.rid].blocks
            if self.tracer is not None:
                self.tracer.on_set_row(r.slot, list(blocks))
            self._bt[r.slot, :len(blocks)] = blocks
        self._bt_dev = None
        self._masked_dev = (None, None)

    def _tables(self) -> torch.Tensor:
        if self._bt_dev is None:
            self._bt_dev = self._to_dev(self._bt)
        return self._bt_dev

    # ------------------------------------------------------------ compute
    def prefill(self, slot: int, tokens: Sequence[int], start: int, n: int,
                prefix_embeds=None):
        """One prefill forward over rows [start, start+n) of a request's
        chain: a one-segment ragged batch on the paged layout of an
        attention-only model without a prefix; otherwise the slot's whole
        prompt at batch 1 (``start`` is 0 there: no chunking), through the
        slot's table row on the paged layout. ``prefix_embeds`` (P, d), a
        VLM's image patch embeddings, are the prompt's first P rows (``n``
        counts them; ``tokens`` are the rest): the ragged step's token axis
        carries token ids only, so a prefix always takes the workers'
        prefill. Returns the last stage's logits at the final row,
        (1, 1, V)."""
        if self.paged and self._attn_only and prefix_embeds is None:
            h = self.forward_batch([(slot, list(tokens), start)])
            return h[0][None, None]
        if start != 0:
            raise KVInvariantError("chunked prefill requires the paged "
                                   "layout of an attention-only model")
        if self.tracer is not None:
            self.tracer.on_prefill(slot, start, n)
        prefix = None
        if prefix_embeds is not None:
            prefix = torch.as_tensor(prefix_embeds).to(self.device)[None]
        h = self._to_dev(np.asarray([list(tokens)], np.int32))
        positions = self._to_dev(np.arange(start, start + n,
                                           dtype=np.int32)[None])
        bt = self._tables()[slot:slot + 1] if self.paged else None
        for w in self.workers:
            h = w.prefill_slot(h, slot, positions, block_tables=bt,
                               prefix_embeds=prefix)
        return h

    def decode(self, reqs: Sequence, skip_slots: Sequence[int] = ()):
        """One batched decode over ``reqs`` (each contributes its last
        generated token at its next cache position). ``skip_slots`` are
        live-but-not-decoding slots (half-prefilled residents) whose
        table rows are masked to the null page for this forward."""
        if self.tracer is not None:
            self.tracer.on_decode([(r.slot, r.pos_next) for r in reqs],
                                  list(skip_slots))
        tokens = np.zeros((self.max_batch, 1), np.int32)
        positions = np.zeros((self.max_batch, 1), np.int32)
        for r in reqs:
            tokens[r.slot, 0] = r.generated[-1]
            positions[r.slot, 0] = r.pos_next
        if not self.paged:
            bt = None
        elif skip_slots:
            key = frozenset(skip_slots)
            if self._masked_dev[0] != key:
                masked = self._bt.copy()
                masked[list(skip_slots)] = self._null_page
                self._masked_dev = (key, self._to_dev(masked))
            bt = self._masked_dev[1]
        else:
            bt = self._tables()
        h = self._to_dev(tokens)
        pos = self._to_dev(positions)
        for w in self.workers:
            h = w.decode(h, pos, block_tables=bt)
        return h

    def forward_batch(self, segments: Sequence):
        """ONE fused launch over a mixed ragged batch. ``segments`` is a
        list of (slot, tokens, pos0) — prefill chunks (len > 1, pos0 =
        rows already in the pool) and decode rows (len 1) freely mixed,
        at most one segment per slot (paged layout only). Tokens are
        flattened into a single ragged axis; each segment's span is
        tile-aligned (pad tokens get pos = -1 → masked, writes routed to
        the trash page) and the total is bucketed to a power of two. Returns (max_batch, V) logits —
        row i is segment i's last real token's logits."""
        if not (self.paged and self._attn_only):
            raise KVInvariantError(
                "forward_batch requires the paged attention-only layout")
        if not 0 < len(segments) <= self.max_batch:
            raise KVInvariantError(
                f"{len(segments)} segments for max_batch={self.max_batch}")
        if self.tracer is not None:
            self.tracer.on_forward_batch(
                [(s, len(tk), p0) for s, tk, p0 in segments])
        tq = TILE_Q
        toks: List[int] = []
        poss: List[int] = []
        rows: List[int] = []
        out_idx = [0] * self.max_batch
        for i, (slot, tokens, pos0) in enumerate(segments):
            n = len(tokens)
            na = -(-n // tq) * tq
            out_idx[i] = len(toks) + n - 1
            toks.extend(int(t) for t in tokens)
            toks.extend([0] * (na - n))
            poss.extend(range(pos0, pos0 + n))
            poss.extend([-1] * (na - n))
            # pad rows inside a segment's aligned span keep its slot so
            # `row` stays constant per tile (the kernel's layout contract)
            rows.extend([slot] * na)
        t = len(toks)
        tb = tq
        while tb < t:
            tb *= 2
        toks.extend([0] * (tb - t))
        poss.extend([-1] * (tb - t))
        rows.extend([0] * (tb - t))
        x = self._to_dev(np.asarray([toks], np.int32))
        pos = self._to_dev(np.asarray([poss], np.int32))
        row = self._to_dev(np.asarray(rows, np.int32))
        valid = pos[0] >= 0
        oi = self._to_dev(np.asarray(out_idx, np.int32))
        bt = self._tables()
        h = x
        for w in self.workers:
            h = w.forward_ragged(h, pos, row, valid, bt, oi)
        return h[0]

    # -------------------------------------------------------- maintenance
    def copy_pages(self, src: int, dst: int):
        """Apply a prefix-cache copy-on-write to every stage's pools."""
        for w in self.workers:
            w.copy_pages(src, dst)

    def read_pages(self, blk: int):
        """One block's KV across the whole model, as a pipeline-shape
        independent payload: ordered (cache_slot_name, k, v) triples whose
        page tensors are concatenated over the stages along the period
        axis. Quantized pools append a 4th element per entry: a dict of
        the scale/zero leaves, concatenated the same way."""
        out = []
        for name, sub in self.workers[0].cache.items():
            if "k_pages" not in sub:
                continue
            parts = [w.read_page(name, blk) for w in self.workers]
            k = torch.cat([p["k_pages"] for p in parts], dim=0)
            v = torch.cat([p["v_pages"] for p in parts], dim=0)
            extra = [l for l in parts[0] if l not in ("k_pages", "v_pages")]
            if extra:
                aux = {l: torch.cat([p[l] for p in parts], dim=0)
                       for l in extra}
                out.append((name, k, v, aux))
            else:
                out.append((name, k, v))
        return out

    def write_pages(self, blk: int, payload):
        """Scatter a block's payload (see ``read_pages``) back into the
        stage pools, splitting the period axis by each stage's share."""
        for entry in payload:
            name, k, v = entry[0], entry[1], entry[2]
            aux = entry[3] if len(entry) > 3 else {}
            off = 0
            for w in self.workers:
                p = w.cache[name]["k_pages"].shape[0]
                extras = {l: a[off:off + p] for l, a in aux.items()} or None
                w.write_page(name, blk, k[off:off + p], v[off:off + p],
                             extras=extras)
                off += p
            if off != k.shape[0]:
                raise KVInvariantError(
                    f"payload periods {k.shape[0]} != pipeline periods {off}")

    def clear_slot(self, slot: int):
        """Zero a vacated slot's contiguous strips and recurrent states on
        every stage."""
        for w in self.workers:
            w.clear_slot(slot)

    def retire(self):
        """Drop caches and params so a retired engine's stale runner
        fails fast instead of writing into pools it no longer owns."""
        for w in self.workers:
            w.retire()
        self.workers = []

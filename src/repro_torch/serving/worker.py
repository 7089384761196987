"""Stage worker: holds one pipeline stage's parameter slice and the KV
caches of its periods, and runs the stage's part of each forward.

Two attention KV layouts, as in the reference:
  * slot-contiguous: (P, B, Smax, Hkv, hd) per attention period; a prefill
    runs one request at batch 1 into its slot's strip.
  * paged: a shared page pool (P, N, bs, Hkv, hd) per attention period,
    addressed through the block tables the engine's BlockManager hands out.

Recurrent mixer states (rwkv's ``shift``/``wkv``, mamba's ``conv``/``h``)
stay slot-indexed in both layouts. The forwards write new K/V and states
into the caches in place, and so do ``copy_pages``, ``write_page`` and
``clear_slot`` (the reference rebuilt each cache array functionally).

Decoder-only families. The encoder-decoder (whisper) is refused here, at
any number of stages: the reference refuses it past one stage, and at
one stage its worker runs the decoder-only blocks over whisper's
``self``/``cross`` blocks and fails at the first prefill (``KeyError:
'slot00'``). ``Model.prefill`` / ``decode_step`` serve it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import tree_map
from repro_torch.models.model import Model


class StageWorker:
    def __init__(self, cfg: ModelConfig, stage_params: dict, n_stages: int,
                 stage: int, max_batch: int, max_seq: int,
                 paged: bool = True, n_pages: Optional[int] = None,
                 page_size: Optional[int] = None, kv_dtype=None,
                 device=None):
        if cfg.is_encdec and n_stages != 1:
            raise ValueError("enc-dec serves single-worker")
        if cfg.is_encdec:
            raise ValueError(f"{cfg.name}: the stage worker runs "
                             f"decoder-only blocks and has no "
                             f"encoder-decoder forward; serve it through "
                             f"Model.prefill and Model.decode_step")
        if kv_dtype is not None and not paged:
            raise ValueError("kv_dtype override requires the paged layout")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = Model(cfg)
        self.n_stages = n_stages
        self.stage = stage
        self.first = stage == 0
        self.last = stage == n_stages - 1
        p0, p1 = self.model.stage_ranges(n_stages)[stage]
        self.periods = (p0, p1)
        self.params = stage_params
        self._check_params_device()
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.paged = paged
        self.n_pages = n_pages
        self.page_size = page_size
        self.kv_dtype = kv_dtype
        self.cache = transformer.init_cache(
            cfg, max_batch, max_seq, cfg.dtype, n_periods=p1 - p0,
            paged=paged, n_pages=n_pages, page_size=page_size,
            kv_dtype=kv_dtype, device=self.device)
        # correctness tracer (the reference's analysis/sanitizer.py hooks);
        # None in production
        self.tracer = None

    def _check_params_device(self):
        def chk(a):
            if a.device.type != self.device.type:
                raise ValueError(f"stage params on {a.device}, worker on "
                                 f"{self.device}: move the params first")
        tree_map(chk, self.params)

    # ------------------------------------------------------------ public
    @torch.no_grad()
    def forward_ragged(self, x_in, positions, row, valid, tables, out_idx):
        """One fused launch over a ragged mixed batch. First stage takes
        tokens (1, T); later stages take hidden states (1, T, d).
        ``positions`` (1, T), ``row/valid`` (T,) are the per-token
        descriptors (attention.self_attention ragged contract), ``tables``
        the full block-table matrix, ``out_idx`` (n_out,) the flat index of
        each segment's last real token. Last stage returns logits
        (1, n_out, V); others the full hidden (1, T, d)."""
        cfg = self.cfg
        if self.first:
            # clamp pad positions (-1) for the embed only; attention masks
            # on the raw values
            x = transformer.embed(cfg, self.params, x_in,
                                  torch.clamp_min(positions, 0),
                                  dtype=self.model.dtype)
        else:
            x = x_in
        x, _, _ = transformer.run_blocks(cfg, self.params["blocks"], x,
                                      positions, cache=self.cache,
                                      ragged=(tables, row, valid))
        if not self.last:
            return x
        # only each segment's last real token needs logits
        sel = x[0][out_idx.long()][None]
        return transformer.head(cfg, self.params, sel)

    @torch.no_grad()
    def prefill_slot(self, x_in, slot: int, positions, block_tables=None,
                     prefix_embeds=None):
        """Prefill of one request (batch 1 inputs: tokens (1, S) on the
        first stage, hidden (1, S, d) after) over its whole prompt, into
        cache slot ``slot``, written in place: contiguous K/V land at rows
        [0, S) of the slot's strips, and every recurrent state of the slot
        starts from zero (the reference scattered a fresh batch-1 cache into
        the slot; idle decode steps leave drift in a free slot's states).
        On the paged layout the attention slots write into the live shared
        pools through ``block_tables`` (1, nb), the slot's table row (a
        hybrid model's prefill, or a prefix's; an attention-only model
        rides ``forward_ragged`` otherwise). ``prefix_embeds`` (1, P, d), a
        VLM's image patch embeddings, are embedded before the tokens by the
        first stage (``positions`` (1, P+S)); later stages take the hidden
        states, prefix rows included. Last stage returns the final row's
        logits (1, 1, V)."""
        if self.paged and block_tables is None and any(
                transformer.is_attn_cache(sub)
                for sub in self.cache.values()):
            raise ValueError("a paged prefill writes the attention pools "
                             "through the slot's block-table row: pass "
                             "block_tables")
        cfg = self.cfg
        if self.first:
            x = transformer.embed(cfg, self.params, x_in, positions,
                                  prefix_embeds=prefix_embeds,
                                  dtype=self.model.dtype)
        else:
            x = x_in
        strip = {}
        for name, sub in self.cache.items():
            if self.paged and transformer.is_attn_cache(sub):
                strip[name] = sub                 # the shared pools
                continue
            strip[name] = {leaf: a[:, slot:slot + 1]
                           for leaf, a in sub.items()}
            if not transformer.is_attn_cache(sub):
                for arr in strip[name].values():
                    arr.zero_()
        x, _, _ = transformer.run_blocks(cfg, self.params["blocks"], x,
                                      positions, cache=strip,
                                      block_tables=block_tables)
        return transformer.head(cfg, self.params, x[:, -1:]) \
            if self.last else x

    @torch.no_grad()
    def decode(self, x_in, positions, block_tables=None):
        """One batched decode step through the stage: tokens (B, 1) on the
        first stage, hidden (B, 1, d) after; last stage returns logits
        (B, 1, V). ``block_tables`` addresses the paged pools; the
        slot-contiguous layout takes none."""
        cfg = self.cfg
        if self.first:
            x = transformer.embed(cfg, self.params, x_in, positions,
                                  dtype=self.model.dtype)
        else:
            x = x_in
        x, _, _ = transformer.run_blocks(cfg, self.params["blocks"], x,
                                      positions, cache=self.cache,
                                      decode=True,
                                      block_tables=block_tables)
        return transformer.head(cfg, self.params, x) if self.last else x

    def _pool(self, name: str) -> dict:
        sub = self.cache[name]
        if "k_pages" not in sub:
            raise ValueError(f"{name} holds no attention page pool")
        return sub

    def copy_pages(self, src: int, dst: int):
        """Copy page ``src`` onto page ``dst`` in every attention pool leaf
        (all periods), in place — the engine's copy-on-write when a
        prefix-cache hit covers a whole prompt and the final token must be
        recomputed into a private block. Recurrent states are slot-indexed
        and not touched."""
        if self.tracer is not None:
            self.tracer.on_copy_pages(src, dst, self.stage)
        for sub in self.cache.values():
            if "k_pages" in sub:
                for arr in sub.values():
                    arr[:, dst] = arr[:, src]

    def read_page(self, name: str, blk: int):
        """Host copies (CPU tensors) of one attention pool's page ``blk``,
        every leaf: {"k_pages": (P_stage, page_size, Hkv, hd), "v_pages":
        ..., plus scale/zero leaves (P_stage, page_size, Hkv) for int8
        pools}."""
        sub = self._pool(name)
        if self.tracer is not None:
            self.tracer.on_page_read(name, blk, self.stage)
        return {leaf: arr[:, blk].to("cpu", copy=True)
                for leaf, arr in sub.items()}

    def write_page(self, name: str, blk: int, k, v, extras=None):
        """Write one page's K/V (and, for int8 pools, the scale/zero
        ``extras`` dict) back into an attention pool, in place."""
        sub = self._pool(name)
        if self.tracer is not None:
            self.tracer.on_page_write(name, blk, self.stage)
        for leaf, val in (("k_pages", k), ("v_pages", v),
                          *(extras or {}).items()):
            sub[leaf][:, blk] = torch.as_tensor(val).to(sub[leaf].device,
                                                        sub[leaf].dtype)

    def clear_slot(self, slot: int):
        """Zero a vacated slot's strips of every non-paged cache leaf, in
        place (the reference zeroes every leaf but the page pools: the
        recurrent states and, here, the slot-contiguous K/V). Paged pools
        need no clear: they are unreachable once the table row is freed."""
        for sub in self.cache.values():
            if "k_pages" not in sub:
                for arr in sub.values():
                    arr[:, slot] = 0

    def retire(self):
        """Drop the cache and params so a retired engine's stale worker
        fails fast instead of writing into pools it no longer owns."""
        self.cache = None
        self.params = None

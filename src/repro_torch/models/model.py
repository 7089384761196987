"""Model facade: ParamDef trees, init, one-shot prefill / decode entry
points over the paged or the slot-contiguous KV layout, and the
stage-slicing API used by pipeline-parallel cold starts. The
encoder-decoder family (``models/encdec.py``) prefills and decodes on the
slot-contiguous layout only, as in the reference."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ragged_attention import TILE_Q
from repro_torch.models import encdec, transformer
from repro_torch.models.common import (ParamDef, as_dtype, init_params,
                                       param_bytes, tree_map)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------- params
    @property
    def defs(self) -> dict:
        if self.cfg.is_encdec:
            return encdec.encdec_defs(self.cfg)
        return transformer.lm_defs(self.cfg)

    @property
    def dtype(self) -> torch.dtype:
        return as_dtype(self.cfg.dtype)

    def init(self, generator: Optional[torch.Generator] = None, *,
             device=None):
        """Random params on ``device`` (default: the card) drawn from
        ``generator`` (default: one seeded with 0 on that device)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return init_params(self.defs, generator, self.dtype, dev)

    def bytes(self) -> int:
        return param_bytes(self.defs, self.dtype.itemsize)

    # ------------------------------------------------------------- serving
    def prefill(self, params, tokens, max_seq: int, *, page_size: int = 16,
                kv_dtype=None, paged: bool = True, prefix_embeds=None,
                frames=None):
        """Full-prompt pass of ``tokens`` (B,S). ``paged=True``: into fresh
        paged pools (each sequence owns ``ceil(max_seq / page_size)``
        pages; the last page is the trash page), stored as ``kv_dtype``
        (default: the model's dtype; ``"int8"`` quantizes the pages and
        attention dequantizes them in its loads); the cache is {"pools":
        the per-period pools, "block_tables": (B,nb) int32}. An
        attention-only model runs through the fused ragged path; a model
        with a recurrent mixer writes its K/V into the pools and attends
        through ``flash_attention`` (the ragged step is attention-only, and
        so are int8 pages). ``paged=False``: through ``flash_attention``
        into fresh slot-contiguous slabs (the reference's
        ``Model.prefill``); the cache is the per-period {"k", "v"} slabs.
        Recurrent slots (rwkv's {"shift", "wkv"}, mamba's {"conv", "h"})
        carry their states from zero on either layout.

        ``prefix_embeds`` (B,P,d), a VLM's image patch embeddings, go before
        the tokens (positions [0, P+S)): such a prefill never takes the
        ragged step (its token axis carries token ids only), so on the
        paged layout it writes its K/V into the pools and attends through
        ``flash_attention``. An encoder-decoder model takes ``frames``
        (B,F,d), stub frame embeddings, and ``paged=False`` (the reference
        has no paged encoder-decoder): its cache is {"self": the decoder's
        slabs, "cross": the encoder memory's per-layer K/V}. Returns
        (last-token logits (B,V), cache)."""
        cfg = self.cfg
        dev = params["final_norm"].device
        b, s = tokens.shape
        if cfg.is_encdec:
            return self._encdec_prefill(params, tokens.to(dev), max_seq,
                                        frames, paged)
        if frames is not None:
            raise ValueError(f"{cfg.name} is no encoder-decoder: it takes "
                             f"no frames")
        prefix = None if prefix_embeds is None else prefix_embeds.to(dev)
        total = s + (0 if prefix is None else prefix.shape[1])
        ragged = paged and transformer.attn_only(cfg) and prefix is None
        if paged and not ragged and kv_dtype is not None \
                and as_dtype(kv_dtype) == torch.int8:
            raise ValueError(f"{cfg.name}: int8 pages are served by the "
                             f"ragged step, which is attention-only and "
                             f"takes no prefix")
        nb = -(-max_seq // page_size)
        tables = (torch.arange(b * nb, dtype=torch.int32,
                               device=dev).reshape(b, nb)
                  if paged else None)
        cache = transformer.init_cache(
            cfg, b, max_seq, self.dtype, paged=paged,
            n_pages=b * nb + 1 if paged else None,
            page_size=page_size if paged else None, kv_dtype=kv_dtype,
            device=dev)
        if ragged:
            sa = -(-s // TILE_Q) * TILE_Q
            toks = torch.zeros((b, sa), dtype=torch.int32, device=dev)
            toks[:, :s] = tokens.to(dev)
            pos = torch.full((b, sa), -1, dtype=torch.int32, device=dev)
            pos[:, :s] = torch.arange(s, dtype=torch.int32, device=dev)
            row = torch.arange(b, dtype=torch.int32,
                               device=dev).repeat_interleave(sa)
            pos = pos.reshape(1, -1)
            x = transformer.embed(cfg, params, toks.reshape(1, -1),
                                  torch.clamp_min(pos, 0), dtype=self.dtype)
            x, _ = transformer.run_blocks(cfg, params["blocks"], x, pos,
                                          cache=cache,
                                          ragged=(tables, row, pos[0] >= 0))
            last = x[0].reshape(b, sa, -1)[:, s - 1]
        else:
            pos = torch.arange(total, dtype=torch.int32,
                               device=dev)[None].expand(b, total)
            x = transformer.embed(cfg, params, tokens.to(dev), pos,
                                  prefix_embeds=prefix, dtype=self.dtype)
            x, _ = transformer.run_blocks(cfg, params["blocks"], x, pos,
                                          cache=cache, block_tables=tables)
            last = x[:, -1]
        logits = transformer.head(cfg, params, last)
        if paged:
            return logits, {"pools": cache, "block_tables": tables}
        return logits, cache

    def _encdec_prefill(self, params, tokens, max_seq: int, frames,
                        paged: bool):
        cfg = self.cfg
        if paged:
            raise ValueError(f"{cfg.name}: an encoder-decoder prefills on "
                             f"the slot-contiguous layout only (paged=False)"
                             f"; the reference has no paged encoder-decoder")
        if frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder prefill takes "
                             f"the stub frame embeddings (frames=)")
        dev = tokens.device
        b, s = tokens.shape
        memory = encdec.encode(cfg, params, frames.to(dev, self.dtype))
        cross_kv = encdec.precompute_cross_kv(cfg, params, memory)
        cache = encdec.init_self_cache(cfg, b, max_seq, self.dtype,
                                       device=dev)
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        h, cache = encdec.decoder(cfg, params, tokens, pos, cross_kv=cross_kv,
                                  self_cache=cache, dtype=self.dtype)
        return (encdec.head(cfg, params, h[:, -1]),
                {"self": cache, "cross": cross_kv})

    def decode_step(self, params, cache, tokens, positions):
        """One decode step on a cache from :meth:`prefill` (either
        layout). tokens (B,1) int32; positions (B,1) — the position each
        new token is written to (attends to [0, pos])."""
        cfg = self.cfg
        if cfg.is_encdec:
            h, _ = encdec.decoder(cfg, params, tokens, positions.to(
                torch.int32), cross_kv=cache["cross"],
                self_cache=cache["self"], decode=True, dtype=self.dtype)
            return encdec.head(cfg, params, h)[:, 0], cache
        x = transformer.embed(cfg, params, tokens, positions,
                              dtype=self.dtype)
        paged = "pools" in cache
        x, _ = transformer.run_blocks(
            cfg, params["blocks"], x, positions.to(torch.int32),
            cache=cache["pools"] if paged else cache, decode=True,
            block_tables=cache["block_tables"] if paged else None)
        return transformer.head(cfg, params, x)[:, 0], cache

    # ------------------------------------------ pipeline stages (the paper)
    def stage_ranges(self, n_stages: int):
        return transformer.stage_period_ranges(self.cfg.n_periods, n_stages)

    def stage_defs(self, n_stages: int, stage: int) -> dict:
        """ParamDef subtree a stage must fetch (drives byte accounting)."""
        full = self.defs
        p0, p1 = self.stage_ranges(n_stages)[stage]
        out = {"blocks": tree_map(
            lambda d: ParamDef((p1 - p0,) + d.shape[1:], d.axes, d.init,
                               d.scale),
            full["blocks"])}
        if stage == 0:
            out["embed"] = full["embed"]
            if self.cfg.is_encdec:
                out["encoder"] = full["encoder"]
                out["enc_final_norm"] = full["enc_final_norm"]
        if stage == n_stages - 1:
            out["final_norm"] = full["final_norm"]
            if "lm_head" in full:
                out["lm_head"] = full["lm_head"]
        return out

    def stage_bytes(self, n_stages: int, stage: int) -> int:
        return param_bytes(self.stage_defs(n_stages, stage),
                           self.dtype.itemsize)

    def slice_stage_params(self, params, n_stages: int, stage: int) -> dict:
        """A stage's param slice of the full params, as views: the stages
        of a pipeline on one card share the full weights' memory."""
        p0, p1 = self.stage_ranges(n_stages)[stage]
        out = {"blocks": transformer.slice_blocks(params["blocks"], p0, p1)}
        if stage == 0:
            out["embed"] = params["embed"]
            if self.cfg.is_encdec:
                out["encoder"] = params["encoder"]
                out["enc_final_norm"] = params["enc_final_norm"]
        if stage == n_stages - 1:
            out["final_norm"] = params["final_norm"]
            if "lm_head" in params:
                out["lm_head"] = params["lm_head"]
        return out

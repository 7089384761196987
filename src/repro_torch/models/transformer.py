"""Decoder LM over a repeated *period* of heterogeneous layers: a period
is ``cfg.mixer_pattern`` (attention, mamba and rwkv slots) zipped with the
MoE cadence ``cfg.mlp_pattern`` (dense or moe MLPs), as in the reference.

Params are stacked over periods on axis 0, as in the reference; where the
reference scans the periods with ``lax.scan``, ``run_blocks`` loops over
them in Python and hands each period a view of its slice (``unbind``, so
a stacked leaf's gradient is the periods' gradients stacked once).
``remat`` wraps each period in ``torch.utils.checkpoint``, as the
reference wraps its scan step in ``jax.checkpoint``. Pipeline stages
slice the stacked axis — stage i owns periods [p0, p1) — via
``slice_blocks``, which returns views, so stage params share the full
weights' memory. The encoder-decoder family (whisper) has its own stacks
in ``models/encdec.py``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import (ParamDef, as_dtype, rmsnorm,
                                       stack_defs, tree_leaves, tree_map)


def _period_plan(cfg: ModelConfig):
    return [(mix, cfg.mlp_pattern[i % len(cfg.mlp_pattern)])
            for i, mix in enumerate(cfg.mixer_pattern)]


MIXERS = {"attn": attn.attn_defs, "mamba": mamba_mod.mamba_defs,
          "rwkv": rwkv_mod.rwkv_defs}
MLPS = {"dense": mlp_mod.dense_mlp_defs, "moe": mlp_mod.moe_defs}


def _check_supported(cfg: ModelConfig):
    for mix, mlp in _period_plan(cfg):
        if mix not in MIXERS or mlp not in MLPS:
            raise ValueError(f"{cfg.name}: unknown layer {mix}/{mlp}")


def attn_only(cfg: ModelConfig) -> bool:
    """Every mixer is attention: the ragged step, the prefix cache, chunked
    prefill and int8 pages serve only such models, as in the reference."""
    return all(m == "attn" for m in cfg.mixer_pattern) and not cfg.is_encdec


def is_attn_cache(sub: dict) -> bool:
    """Whether a slot's cache holds attention K/V (contiguous slabs or page
    pools), not a recurrent mixer's per-slot state."""
    return "k" in sub or "k_pages" in sub


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------


def block_defs(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    return {f"slot{i:02d}": {"mixer": MIXERS[mix](cfg), "mlp": MLPS[mlp](cfg)}
            for i, (mix, mlp) in enumerate(_period_plan(cfg))}


def lm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    defs = {
        "embed": {"tok": ParamDef((cfg.padded_vocab, d), ("vocab", "embed"))},
        "blocks": stack_defs(block_defs(cfg), cfg.n_periods, "layers"),
        "final_norm": ParamDef((d,), ("embed",), init="ones"),
    }
    if cfg.pos_embed == "learned":
        defs["embed"]["pos"] = ParamDef((cfg.max_position, d), (None, "embed"))
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.padded_vocab), ("embed", "vocab"))
    return defs


# ---------------------------------------------------------------------------
# Caches (stacked over periods on axis 0)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, *,
               n_periods: Optional[int] = None, paged: bool = False,
               n_pages: Optional[int] = None,
               page_size: Optional[int] = None, kv_dtype=None, device=None,
               as_structs: bool = False):
    """Stacked per-period caches, zero-filled, as the reference's
    ``transformer.py::init_cache``. Attention slots: ``paged=False``, the
    slot-contiguous slabs {"k", "v"} (np, B, S, Hkv, hd); ``paged=True``,
    shared page pools {"k_pages", "v_pages"} (np, N, bs, Hkv, hd) where pad
    and idle-slot writes land on the null/trash page, and no pool row that
    attention may reach ever holds NaN. ``kv_dtype`` (paged only) overrides
    the pool storage dtype; int8 adds per-row scale/zero leaves
    (attention.KV_QUANT_LEAVES, f32). rwkv slots hold their slot-indexed
    {"shift", "wkv"} states and mamba slots their {"conv", "h"} states, on
    either layout. ``as_structs`` gives them on the ``meta`` device
    (shapes and dtypes only), whatever ``device`` says."""
    _check_supported(cfg)
    if as_structs:
        device = "meta"
    np_ = n_periods if n_periods is not None else cfg.n_periods
    if kv_dtype is not None and not paged:
        raise ValueError("kv_dtype overrides the *paged* pool storage dtype")
    kd = as_dtype(kv_dtype if kv_dtype is not None else dtype)
    if paged:
        assert n_pages is not None and page_size is not None
    shp = (np_, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    cache = {}
    for i, (mix, _) in enumerate(_period_plan(cfg)):
        if mix == "rwkv":
            cache[f"slot{i:02d}"] = rwkv_mod.init_rwkv_cache(
                cfg, np_, batch, as_dtype(dtype), device=device)
            continue
        if mix == "mamba":
            cache[f"slot{i:02d}"] = mamba_mod.init_mamba_cache(
                cfg, np_, batch, as_dtype(dtype), device=device)
            continue
        if not paged:
            cache[f"slot{i:02d}"] = attn.make_kv_cache(
                cfg, np_, batch, max_seq, dtype, device=device)
            continue
        slot = {"k_pages": torch.zeros(shp, dtype=kd, device=device),
                "v_pages": torch.zeros(shp, dtype=kd, device=device)}
        if kd == torch.int8:
            for leaf in attn.KV_QUANT_LEAVES:
                slot[leaf] = torch.zeros(shp[:-1], dtype=torch.float32,
                                         device=device)
        cache[f"slot{i:02d}"] = slot
    return cache


def cache_axes(cfg: ModelConfig) -> dict:
    """The slot-contiguous caches' logical axes, leaf for leaf."""
    axes = {}
    for i, (mix, _) in enumerate(_period_plan(cfg)):
        slot = f"slot{i:02d}"
        if mix == "attn":
            axes[slot] = {"k": attn.KV_CACHE_AXES, "v": attn.KV_CACHE_AXES}
        elif mix == "mamba":
            axes[slot] = {k: ("layers",) + v
                          for k, v in mamba_mod.MAMBA_CACHE_AXES.items()}
        elif mix == "rwkv":
            axes[slot] = {k: ("layers",) + v
                          for k, v in rwkv_mod.RWKV_CACHE_AXES.items()}
    return axes


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def embed(cfg: ModelConfig, params: dict, tokens, positions,
          prefix_embeds=None, dtype=None):
    """tokens (B,S) -> x (B, [P+]S, d). ``prefix_embeds`` (B,P,d), a VLM's
    image patch embeddings, go before the token embeddings; learned
    positions (``positions`` (B, P+S)) are added after the concatenation."""
    x = params["embed"]["tok"][tokens.long()]
    if dtype is not None:
        x = x.to(dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    if cfg.pos_embed == "learned":
        x = x + params["embed"]["pos"][positions.long()].to(x.dtype)
    return x


def head(cfg: ModelConfig, params: dict, x):
    xn = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    w = (params["embed"]["tok"].T if cfg.tie_embeddings
         else params["lm_head"])
    logits = xn @ w.to(xn.dtype)
    if cfg.padded_vocab != cfg.vocab:      # mask padded vocab entries
        logits[..., cfg.vocab:] = -1e30
    return logits


def _period_step(cfg: ModelConfig, pslice: dict, cslice, x, positions,
                 decode: bool, block_tables=None, hist_len: int = 0,
                 ragged=None, appends=None):
    """One period's slots. Returns (x, the period's MoE load-balancing
    loss: 0.0 without a MoE slot). Under the ``append`` decode mode each
    attention slot's new (k, v) is added to ``appends[slot]``, unwritten."""
    aux = 0.0
    for i, (mix, mlp) in enumerate(_period_plan(cfg)):
        slot = f"slot{i:02d}"
        sp = pslice[slot]
        c = cslice.get(slot) if cslice is not None else None
        xin = rmsnorm(x, sp["mixer"]["norm"], cfg.norm_eps)
        if mix == "rwkv":
            # the shift row and WKV state are written into c in place
            x = x + rwkv_mod.rwkv_mixer(cfg, sp["mixer"], xin, cache=c)
        elif mix == "mamba":
            # the conv history and SSM state are written into c in place
            x = x + mamba_mod.mamba_mixer(cfg, sp["mixer"], xin, cache=c)
        else:
            paged = c is not None and "k_pages" in c
            if paged:
                kvc = (c["k_pages"], c["v_pages"])
            else:
                kvc = (c["k"], c["v"]) if c is not None else None
            kvq = ({leaf: c[leaf] for leaf in attn.KV_QUANT_LEAVES}
                   if paged and "k_scale" in c else None)
            y, nc = attn.self_attention(cfg, sp["mixer"], xin,
                                        positions=positions, kv_cache=kvc,
                                        decode=decode,
                                        block_tables=(block_tables if paged
                                                      else None),
                                        hist_len=hist_len if paged else 0,
                                        ragged=ragged, kv_quant=kvq)
            if isinstance(nc, tuple) and nc[0] == "append":
                appends.setdefault(slot, []).append(nc[1:])
            x = x + y
        xin = rmsnorm(x, sp["mlp"]["norm"], cfg.norm_eps)
        if mlp == "dense":
            x = x + mlp_mod.dense_mlp(sp["mlp"], xin)
        else:
            y, a = mlp_mod.moe_mlp(cfg, sp["mlp"], xin)
            x = x + y
            aux = aux + a
    return x, aux


def _dots_saveable(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep the products without batch dims
    (``aten.mm``/``aten.addmm``: the projections), recompute the rest
    (``bmm`` included), as ``dots_with_no_batch_dims_saveable``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


REMAT = ("none", "full", "dots")


def remat_wrap(fn, remat: str):
    """``fn`` under ``torch.utils.checkpoint`` for ``remat`` ``"full"`` (all
    recomputed in the backward) or ``"dots"`` (``_dots_saveable``);
    ``"none"`` returns ``fn``."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: want one of {REMAT}")
    if remat == "none":
        return fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_saveable)
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def run_blocks(cfg: ModelConfig, blocks: dict, x, positions, *,
               cache: Optional[dict] = None, decode: bool = False,
               block_tables=None, hist_len: int = 0, ragged=None,
               remat: str = "none"):
    """Run the stacked periods in order. ``blocks``/``cache`` leading dim =
    periods (possibly a stage's slice); each period gets views of its
    slice, so the caches are written in place. A slot-contiguous cache
    (``k``/``v`` slabs) is prefilled from row 0 or, with ``decode``,
    appended at ``positions``; ``block_tables`` (B,nb) addresses the paged
    pools on a decode step and on a paged prefill (``hist_len`` rows of
    each sequence already in the pools; see attention.self_attention);
    ``ragged`` = (tables, row, valid) routes attention through the fused
    ragged-batch kernel — x is (1, T, d), positions (1, T) with -1 pads.
    An rwkv or mamba slot's recurrence starts from its cached state and
    leaves the new one there. Under the ``append`` decode mode the
    slot-contiguous decode step attends the strips as they were and writes
    every period's new K/V into them once, after the last period (the
    reference's post-pass after its scan). ``remat`` (training, no
    cache): ``"full"`` recomputes each period in the backward, ``"dots"``
    keeps its projections' outputs and recomputes the rest. Returns (x,
    cache, the MoE load-balancing loss summed over periods: 0.0 without
    MoE)."""
    if remat != "none" and cache is not None:
        raise ValueError("remat recomputes a training forward: it takes no "
                         "cache")
    appends = {}
    step = remat_wrap(functools.partial(
        _period_step, cfg, decode=decode, block_tables=block_tables,
        hist_len=hist_len, ragged=ragged, appends=appends), remat)
    periods = tree_map(lambda a: a.unbind(0), blocks)
    aux = 0.0
    for i in range(tree_leaves(blocks)[0].shape[0]):
        pslice = tree_map(lambda a: a[i], periods)
        cslice = tree_map(lambda a: a[i], cache) if cache is not None \
            else None
        x, a = step(pslice, cslice, x, positions)
        aux = aux + a
    if appends:
        rows = torch.arange(x.shape[0], device=x.device)
        pos = positions[:, 0].long()
        for slot, kvs in appends.items():
            for leaf, new in zip(("k", "v"), zip(*kvs)):
                c = cache[slot][leaf]                      # (P,B,S,Hkv,hd)
                c[:, rows, pos] = torch.stack(new)[:, :, 0].to(c.dtype)
    return x, cache, aux


# ---------------------------------------------------------------------------
# Stage slicing (pipeline-parallel cold starts)
# ---------------------------------------------------------------------------


def slice_blocks(params_or_cache, p0: int, p1: int):
    """Views of the stacked period axis [p0, p1) of a blocks/cache tree."""
    return tree_map(lambda a: a[p0:p1], params_or_cache)


def stage_period_ranges(n_periods: int, n_stages: int):
    """Balanced contiguous period ranges, one per pipeline stage."""
    base, rem = divmod(n_periods, n_stages)
    ranges, start = [], 0
    for i in range(n_stages):
        size = base + (1 if i < rem else 0)
        ranges.append((start, start + size))
        start += size
    return ranges

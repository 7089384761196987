"""GQA self-attention with RoPE and QKV bias, over two KV layouts.

* paged: K/V live in a shared page pool (N, bs, Hkv, hd) addressed through
  per-request block tables. The fused ragged step serves a whole mixed
  batch through ``ops.ragged_paged_attention``; a decode step reads the
  pool through ``ops.paged_decode_attention``. A prefill outside the
  ragged step (a hybrid model's, whose recurrent mixers cannot share one
  token axis) writes its K/V into the pool and attends through
  ``ops.flash_attention``: over its own K/V, or over the rows it gathers
  back from the pool when it continues a sequence.
* slot-contiguous: each sequence owns a (S, Hkv, hd) strip of a (B, S, Hkv,
  hd) cache (``make_kv_cache``). A prefill (the whole prompt, no history)
  attends within the prompt through ``ops.flash_attention`` and writes its
  K/V at [0, S); a decode step writes each row's new K/V at its position
  and attends the strip through ``ops.decode_attention``.

Cross-attention (the encoder-decoder's, ``cross_attention``) attends a
decoder chunk over the encoder memory's K/V, precomputed once per request
(``precompute_cross_kv``), through ``ops.flash_attention`` with
``causal=False``: Sq is the chunk (1 on a decode step), Sk the frames.

Where JAX rebuilt the caches functionally, the port writes into them in
place (``paged_kv_write``, ``ragged_kv_write``, the contiguous writes).
Not ported: the reference's ``append`` decode mode (an environment knob
with no kernel of its own).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import quantize_kv
from repro_torch.models.common import ParamDef, apply_rope, as_dtype

# Per-row quantization parameters stored alongside int8 page pools, in the
# same cache subtree as k_pages/v_pages so every page-granular operation
# (copy_pages, migration gather) carries them automatically.
KV_QUANT_LEAVES = ("k_scale", "k_zero", "v_scale", "v_zero")


def attn_defs(cfg: ModelConfig, cross: bool = False) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    defs = {
        "w_q": ParamDef((d, hq * hd), ("embed", "heads")),
        "w_k": ParamDef((d, hkv * hd), ("embed", "kv_heads")),
        "w_v": ParamDef((d, hkv * hd), ("embed", "kv_heads")),
        "w_o": ParamDef((hq * hd, d), ("heads", "embed")),
        "norm": ParamDef((d,), ("embed",), init="ones"),
    }
    if cfg.qkv_bias and not cross:
        defs["b_q"] = ParamDef((hq * hd,), ("heads",), init="zeros")
        defs["b_k"] = ParamDef((hkv * hd,), ("kv_heads",), init="zeros")
        defs["b_v"] = ParamDef((hkv * hd,), ("kv_heads",), init="zeros")
    return defs


def _project(cfg, p, x, which: str, n_heads: int):
    y = x @ p[f"w_{which}"].to(x.dtype)
    if cfg.qkv_bias and f"b_{which}" in p:
        y = y + p[f"b_{which}"].to(x.dtype)
    b, s, _ = y.shape
    return y.reshape(b, s, n_heads, cfg.head_dim)


def make_kv_cache(cfg: ModelConfig, n_attn_layers: int, batch: int,
                  max_seq: int, dtype, device=None) -> dict:
    """Slot-contiguous KV cache, zero-filled: layout (L, B, S, Hkv, hd)."""
    shape = (n_attn_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dt = as_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def paged_kv_token_bytes(cfg: ModelConfig, kv_dtype=None) -> int:
    """Exact bytes one token row occupies in ONE attention period's page
    pools: the K + V rows plus, for quantized pools, the per-row
    scale/zero leaves. Single source of truth for every KV byte account
    (``BlockManager.bytes_per_token`` → migration_bytes). ``kv_dtype=None``
    means the pools hold the compute dtype (``cfg.dtype``)."""
    kd = as_dtype(kv_dtype if kv_dtype is not None else cfg.dtype)
    per = 2 * cfg.n_kv_heads * cfg.head_dim * kd.itemsize
    if kd == torch.int8:
        per += len(KV_QUANT_LEAVES) * cfg.n_kv_heads * 4   # f32 scale/zero
    return per


def paged_kv_write(pages, new, block_tables, positions):
    """Scatter new K/V rows into the shared page pool, in place.

    pages (N,bs,Hkv,hd); new (B,S,Hkv,hd); block_tables (B,nb) int32 page
    ids; positions (B,S) absolute token positions (token t of sequence b
    lives at page block_tables[b, t // bs], row t % bs). Returns ``pages``.
    """
    n_pages, bs = pages.shape[0], pages.shape[1]
    pos = positions.long()
    page = torch.gather(block_tables.long(), 1, pos // bs)
    idx = (page * bs + pos % bs).reshape(-1)
    flat = pages.view((n_pages * bs,) + tuple(pages.shape[2:]))
    flat[idx] = new.to(pages.dtype).reshape((-1,) + tuple(new.shape[2:]))
    return pages


def ragged_kv_write(pages, new, tables, row, pos, valid):
    """Scatter a ragged batch's new K/V rows into the shared page pool, in
    place.

    pages (N,bs,...); new (T,...trailing dims of pages...); tables (B,nb)
    int32 page ids; row (T,) block-table row per token; pos (T,) absolute
    position per token; valid (T,) bool. Token t lands at page
    ``tables[row[t], pos[t] // bs]``, slot ``pos[t] % bs``; invalid
    (padding) rows go to the trash page — the pool's last page, which the
    runner's null-page convention reserves (n_pages = n_blocks + 1).
    Returns ``pages``."""
    n_pages, bs = pages.shape[0], pages.shape[1]
    posc = torch.clamp_min(pos.long(), 0)             # pad rows: safe index
    page = tables.long()[row.long(), posc // bs]      # (T,)
    idx = page * bs + posc % bs
    idx = torch.where(valid, idx, torch.full_like(idx, (n_pages - 1) * bs))
    flat = pages.view((n_pages * bs,) + tuple(pages.shape[2:]))
    flat[idx] = new.to(pages.dtype)
    return pages


def paged_kv_gather(pages, block_tables, n_tokens: int):
    """Rows [0, n_tokens) of each sequence, gathered from the page pool
    into a contiguous (B, n_tokens, Hkv, hd) slab: a prefill chunk attends
    over this history (pages written by earlier chunks) with
    ``q_offset``."""
    bs = pages.shape[1]
    pos = torch.arange(n_tokens, device=pages.device)
    flat = pages.reshape((-1,) + tuple(pages.shape[2:]))
    idx = block_tables.long()[:, pos // bs] * bs + pos % bs   # (B, n)
    return flat[idx]


def self_attention(cfg: ModelConfig, p: dict, x, *, positions,
                   causal: bool = True,
                   kv_cache: Optional[Tuple] = None,
                   decode: bool = False,
                   block_tables=None,
                   hist_len: int = 0,
                   ragged=None,
                   kv_quant: Optional[dict] = None):
    """x (B,S,d). positions (B,S) absolute positions of the tokens in x.

    Slot-contiguous layout (``kv_cache`` = (k, v) slabs (B,Smax,Hkv,hd), no
    ``block_tables``, no ``ragged``):

    * prefill (``decode=False``): attends within x (``ops.flash_attention``,
      ``q_offset`` 0) and writes x's K/V at rows [0, S) of the slabs; with
      no ``kv_cache`` it only attends.
    * decode (``decode=True``): S == 1; row b's new K/V are written at
      ``positions[b, 0]`` and it attends rows [0, pos + 1) of its strip
      (``ops.decode_attention``).

    ``ragged`` = (tables (R,nb), row (T,), valid (T,)) is the fused
    ragged-batch path: x is (1, T, d) — a whole mixed step (prefill chunks
    of varying history + decode rows) flattened into one token axis,
    ``positions`` (1, T) giving each token's absolute position (-1 = pad).
    K/V are written via :func:`ragged_kv_write` (pads to the trash page)
    and ONE ``ops.ragged_paged_attention`` launch serves the whole batch.
    ``kv_quant`` (the int8 pools' scale/zero leaves) turns on quantized
    writes + fused-dequant loads; ``new_cache`` is then a dict of all five
    pool leaves instead of a (k, v) tuple.

    ``decode=True`` with ``block_tables`` (B,nb) is the paged decode step:
    S == 1, the new K/V are written at ``positions`` and attention reads
    the pool through the tables (``ops.paged_decode_attention``).

    ``decode=False`` with ``block_tables`` is the paged prefill outside the
    ragged step: x's K/V are written into the pools at ``positions``
    (:func:`paged_kv_write`); with ``hist_len`` 0 attention runs within x
    (``ops.flash_attention``), and with ``hist_len`` > 0 x continues a
    sequence whose first ``hist_len`` rows already live in the pools, so
    attention runs over rows [0, hist_len + S) gathered back from them
    (:func:`paged_kv_gather`) with ``q_offset=hist_len``.

    Returns (out (B,S,d), new_cache): the same cache tensors, written in
    place (None without a cache).
    """
    paged = ragged is not None or block_tables is not None
    if paged and kv_cache is None:
        raise ValueError("the paged layout needs its pools (kv_cache)")
    if hist_len and (block_tables is None or decode or ragged is not None):
        raise ValueError("hist_len marks a paged prefill chunk (block_tables,"
                         " decode=False)")
    if kv_quant is not None and ragged is None:
        raise ValueError("quantized KV pools are only served by the ragged "
                         "fused path")
    bsz, seq, _ = x.shape
    q = _project(cfg, p, x, "q", cfg.n_heads)
    k = _project(cfg, p, x, "k", cfg.n_kv_heads)
    v = _project(cfg, p, x, "v", cfg.n_kv_heads)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if not paged and not decode:
        if kv_cache is not None:
            # the strips take the prompt's K/V at [0, S): the reference
            # prefilled a fresh zero batch-1 cache and scattered it into the
            # slot, the port writes the slot's strips (what the caller
            # passes) in place. Rows at and past S stay as they are: the
            # slot was zeroed when it was freed (worker.clear_slot), and no
            # kernel reads a row at or past kv_len.
            ck, cv = kv_cache
            ck[:, :seq] = k.to(ck.dtype)
            cv[:, :seq] = v.to(cv.dtype)
            new_cache = (ck, cv)
        out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal, q_offset=0)
    elif not paged:
        assert kv_cache is not None and seq == 1
        ck, cv = kv_cache
        rows = torch.arange(bsz, device=x.device)
        pos = positions[:, 0].long()
        ck[rows, pos] = k[:, 0].to(ck.dtype)
        cv[rows, pos] = v[:, 0].to(cv.dtype)
        new_cache = (ck, cv)
        kv_len = (positions[:, 0] + 1).to(torch.int32)
        out = ops.decode_attention(q.contiguous(), ck, cv, kv_len)
    elif not decode and ragged is None:
        ck, cv = kv_cache
        paged_kv_write(ck, k, block_tables, positions)
        paged_kv_write(cv, v, block_tables, positions)
        new_cache = (ck, cv)
        if hist_len:
            # the chunk's own K/V round-trip through the pages: identity,
            # the pool dtype is the compute dtype
            total = hist_len + seq
            k = paged_kv_gather(ck, block_tables, total)
            v = paged_kv_gather(cv, block_tables, total)
        out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  q_offset=hist_len)
    elif ragged is not None:
        ck, cv = kv_cache
        assert bsz == 1
        tables, row, valid = ragged
        pos1 = positions[0]
        q1, k1, v1 = q[0], k[0], v[0]
        if kv_quant is not None:
            kq, ks, kz = quantize_kv(k1)
            vq, vs, vz = quantize_kv(v1)
            ragged_kv_write(ck, kq, tables, row, pos1, valid)
            ragged_kv_write(cv, vq, tables, row, pos1, valid)
            for leaf, val in zip(KV_QUANT_LEAVES, (ks, kz, vs, vz)):
                ragged_kv_write(kv_quant[leaf], val, tables, row, pos1,
                                valid)
            new_cache = {"k_pages": ck, "v_pages": cv, **kv_quant}
        else:
            ragged_kv_write(ck, k1, tables, row, pos1, valid)
            ragged_kv_write(cv, v1, tables, row, pos1, valid)
            new_cache = (ck, cv)
        out1 = ops.ragged_paged_attention(q1.contiguous(), ck, cv, tables,
                                          row, pos1, kv_quant=kv_quant)
        out = out1[None].to(x.dtype)
    else:
        assert seq == 1
        ck, cv = kv_cache
        paged_kv_write(ck, k, block_tables, positions)
        paged_kv_write(cv, v, block_tables, positions)
        new_cache = (ck, cv)
        kv_len = (positions[:, 0] + 1).to(torch.int32)
        out = ops.paged_decode_attention(q.contiguous(), ck, cv,
                                         block_tables, kv_len)

    b, s, hq, hd = out.shape
    y = out.reshape(b, s, hq * hd) @ p["w_o"].to(x.dtype)
    return y, new_cache


def cross_attention(cfg: ModelConfig, p: dict, x, mem_kv: Tuple):
    """Encoder-decoder cross attention of x (B,S,d) over the precomputed
    memory K/V ``mem_kv`` = (k, v), each (B,Sm,Hkv,hd): the serve path
    (the reference's ``memory=`` branch, which projects them inline, is
    training's). Returns (B,S,d)."""
    k, v = mem_kv
    q = _project(cfg, p, x, "q", cfg.n_heads)
    out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=False)
    b, s, hq, hd = out.shape
    return out.reshape(b, s, hq * hd) @ p["w_o"].to(x.dtype)


def precompute_cross_kv(cfg: ModelConfig, p: dict, memory):
    """One decoder layer's cross K/V of the encoder memory (B,Sm,d): (k, v),
    each (B,Sm,Hkv,hd)."""
    k = _project(cfg, p, memory, "k", cfg.n_kv_heads)
    v = _project(cfg, p, memory, "v", cfg.n_kv_heads)
    return k, v

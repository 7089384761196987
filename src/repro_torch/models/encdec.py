"""Whisper-style encoder-decoder backbone. The conv/audio frontend is a STUB:
inputs are precomputed frame embeddings (B, n_frames, d_model).

The encoder is a stack of non-causal attention blocks over the frames
(``ops.flash_attention`` with ``causal=False``). Each decoder block runs
causal self-attention over the slot-contiguous layout (a prefill writes
the prompt's K/V into the slabs through ``flash_attention``, a decode step
appends one row and reads the strip through ``decode_attention``), then
cross-attention over the encoder memory's K/V, precomputed once per
request (``precompute_cross_kv``), then a dense MLP.

Params are stacked over layers on axis 0, as in the reference; where the
reference scans the layers with ``lax.scan``, the port loops over them in
Python and hands each layer a view of its slice, so the self-attention
slabs are written in place.

Serve path only: the decoder takes the precomputed ``cross_kv``. The
reference's training branches — ``decoder(memory=...)``, which computes
the cross K/V inline, and ``remat`` — come with training (ROADMAP queue 1
item 7), as does the reference's ``cross_kv_structs`` (shape structs for
the sharded dry run).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (ParamDef, as_dtype, rmsnorm,
                                       stack_defs, tree_leaves, tree_map)


def encdec_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    enc_block = {
        "attn": attn.attn_defs(cfg),
        "mlp": mlp_mod.dense_mlp_defs(cfg),
    }
    dec_block = {
        "self": attn.attn_defs(cfg),
        "cross": attn.attn_defs(cfg, cross=True),
        "cross_norm": ParamDef((d,), ("embed",), init="ones"),
        "mlp": mlp_mod.dense_mlp_defs(cfg),
    }
    return {
        "embed": {
            "tok": ParamDef((cfg.padded_vocab, d), ("vocab", "embed")),
            "pos": ParamDef((cfg.max_position, d), (None, "embed")),
            "enc_pos": ParamDef((cfg.n_audio_frames, d), (None, "embed")),
        },
        "encoder": stack_defs(enc_block, cfg.encoder_layers, "layers"),
        "enc_final_norm": ParamDef((d,), ("embed",), init="ones"),
        "blocks": stack_defs(dec_block, cfg.n_layers, "layers"),
        "final_norm": ParamDef((d,), ("embed",), init="ones"),
        "lm_head": ParamDef((d, cfg.padded_vocab), ("embed", "vocab")),
    }


def _layers(stacked: dict):
    """Views of each layer's slice of a tree stacked on axis 0."""
    for i in range(tree_leaves(stacked)[0].shape[0]):
        yield tree_map(lambda a: a[i], stacked)


def encode(cfg: ModelConfig, params: dict, frames):
    """frames (B,F,d) stub embeddings -> encoder memory (B,F,d)."""
    b, f, _ = frames.shape
    x = frames + params["embed"]["enc_pos"][:f].to(frames.dtype)
    positions = torch.arange(f, dtype=torch.int32,
                             device=frames.device)[None].expand(b, f)
    for p in _layers(params["encoder"]):
        xin = rmsnorm(x, p["attn"]["norm"], cfg.norm_eps)
        y, _ = attn.self_attention(cfg, p["attn"], xin, positions=positions,
                                   causal=False)
        x = x + y
        xin = rmsnorm(x, p["mlp"]["norm"], cfg.norm_eps)
        x = x + mlp_mod.dense_mlp(p["mlp"], xin)
    return rmsnorm(x, params["enc_final_norm"], cfg.norm_eps)


def precompute_cross_kv(cfg: ModelConfig, params: dict, memory):
    """Per-decoder-layer cross K/V: {"k", "v"} of (L,B,F,Hkv,hd) each."""
    ks, vs = [], []
    for p in _layers(params["blocks"]):
        k, v = attn.precompute_cross_kv(cfg, p["cross"], memory)
        ks.append(k)
        vs.append(v)
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decoder(cfg: ModelConfig, params: dict, tokens, positions, *,
            cross_kv: dict, self_cache: Optional[dict] = None,
            decode: bool = False, dtype=None):
    """Decoder stack over precomputed ``cross_kv`` (the serve path).
    tokens, positions (B,S). ``self_cache`` {"k", "v"} (L,B,Smax,Hkv,hd):
    a prefill (``decode=False``) writes the tokens' K/V at rows [0, S),
    a decode step (S == 1) at ``positions``; both in place. Returns
    (hidden (B,S,d), self_cache)."""
    x = params["embed"]["tok"][tokens.long()]
    if dtype is not None:
        x = x.to(dtype)
    x = x + params["embed"]["pos"][positions.long()].to(x.dtype)
    for i, p in enumerate(_layers(params["blocks"])):
        xin = rmsnorm(x, p["self"]["norm"], cfg.norm_eps)
        kvc = ((self_cache["k"][i], self_cache["v"][i])
               if self_cache is not None else None)
        y, _ = attn.self_attention(cfg, p["self"], xin, positions=positions,
                                   causal=True, kv_cache=kvc, decode=decode)
        x = x + y
        xin = rmsnorm(x, p["cross_norm"], cfg.norm_eps)
        x = x + attn.cross_attention(
            cfg, p["cross"], xin, mem_kv=(cross_kv["k"][i],
                                          cross_kv["v"][i]))
        xin = rmsnorm(x, p["mlp"]["norm"], cfg.norm_eps)
        x = x + mlp_mod.dense_mlp(p["mlp"], xin)
    return x, self_cache


def head(cfg: ModelConfig, params: dict, x):
    xn = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = xn @ params["lm_head"].to(xn.dtype)
    if cfg.padded_vocab != cfg.vocab:      # mask padded vocab entries
        logits[..., cfg.vocab:] = -1e30
    return logits


def init_self_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                    device=None) -> dict:
    """The decoder's self-attention slabs, zero-filled: {"k", "v"} of
    (L, B, max_seq, Hkv, hd)."""
    shp = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dt = as_dtype(dtype)
    return {"k": torch.zeros(shp, dtype=dt, device=device),
            "v": torch.zeros(shp, dtype=dt, device=device)}

"""Manual-collective tensor parallelism on ``torch.distributed``: the
Megatron-SP prefill of a dense GQA decoder, the port of the reference's
``distributed/manual_tp.py`` (there a ``shard_map`` over the mesh's
``"model"`` axis).

Each rank of the mesh's ``"model"`` group runs ``fn`` on its own shards
(``param_specs``, ``shard_params``) and the full tokens:

  embedding      the rank's vocab rows, masked, all-reduced; then the
                 rank keeps its sequence slice of the residual stream
  per sublayer   x_seqshard --all_gather--> x_full
                 local q heads (or ffn columns) compute
                 partial out --reduce_scatter--> y_seqshard
  head           the final norm all-gathered; logits of the last token over
                 the rank's vocab columns

KV heads (fewer than the ranks) are computed on every rank from all-gathered
``w_k``/``w_v``; each local q head then takes its own kv head, so attention
runs at group 1 (``ops.flash_attention``, causal). Each rank keeps its
sequence slice of every layer's K and V.

Numerics are the reference code's, not its docstring's: the reference says
"one bf16 reduce-scatter", but it casts each partial sum to float32 before
``psum``/``psum_scatter`` and back after (for XLA:CPU's sake), so the port
reduces in float32 too; the all-gathers stay in the compute dtype. A bf16
reduction is a later change, with its tolerance restated.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import NamedSharding, P, placements
from repro_torch.kernels import ops
from repro_torch.models.attention import attn_defs
from repro_torch.models.common import (apply_rope, as_dtype, rmsnorm, silu,
                                       tree_map)
from repro_torch.models.model import Model


def supports(cfg: ModelConfig, tp: int = 16) -> bool:
    return (not cfg.is_moe and not cfg.is_encdec and not cfg.sub_quadratic
            and cfg.n_heads % tp == 0 and cfg.pos_embed == "rope"
            and cfg.d_model % tp == 0 and cfg.d_ff % tp == 0)


def check(cfg: ModelConfig, seq: int, tp: int):
    """Refuse what ``fn`` cannot shard: beyond ``supports``, the sequence,
    the padded vocab and ``w_k``'s columns must split evenly over the
    ranks."""
    if not supports(cfg, tp):
        raise ValueError(f"{cfg.name}: manual TP at tp={tp} is not supported")
    for what, n in (("seq", seq), ("padded_vocab", cfg.padded_vocab),
                    ("w_k's columns", attn_defs(cfg)["w_k"].shape[-1])):
        if n % tp:
            raise ValueError(f"{cfg.name}: {what} = {n} does not split over "
                             f"tp = {tp} ranks")
    if cfg.tie_embeddings or len(cfg.mixer_pattern) != 1:
        raise ValueError(f"{cfg.name}: manual TP takes one attention slot a "
                         f"period and an untied lm_head")


def param_specs(cfg: ModelConfig) -> dict:
    """The physical specs of the params on the ``("data", "model")`` mesh,
    the reference's ``_param_specs``."""
    d = {
        "embed": {"tok": P("model", None)},
        "blocks": {"slot00": {
            "mixer": {
                "w_q": P(None, None, "model"),
                "w_k": P(None, None, "model"),
                "w_v": P(None, None, "model"),
                "w_o": P(None, "model", None),
                "norm": P(None, None),
            },
            "mlp": {
                "w_gate": P(None, None, "model"),
                "w_up": P(None, None, "model"),
                "w_down": P(None, "model", None),
                "norm": P(None, None),
            },
        }},
        "final_norm": P(None),
        "lm_head": P(None, "model"),
    }
    if cfg.qkv_bias:
        d["blocks"]["slot00"]["mixer"].update({
            "b_q": P(None, "model"), "b_k": P(None, "model"),
            "b_v": P(None, "model")})
    return d


def _leaf_shard(a, spec, rank: int, tp: int):
    for dim, part in enumerate(spec):
        if part == "model":
            n = a.shape[dim] // tp
            return a.narrow(dim, rank * n, n)
    return a


def shard_params(cfg: ModelConfig, params: dict, rank: int, tp: int) -> dict:
    """Rank ``rank``'s shards of the full ``params`` under ``param_specs``
    (views: the leaves the specs name, nothing else)."""
    specs = param_specs(cfg)

    def walk(s, p):
        if isinstance(s, dict):
            return {k: walk(s[k], p[k]) for k in s}
        return _leaf_shard(p, s, rank, tp)

    return walk(specs, params)


def _gather_dim(x, dim: int, group, tp: int):
    """All-gather ``x`` along ``dim`` (ranks in order), as ``all_gather(...,
    axis=dim, tiled=True)``."""
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((tp * xt.shape[0],) + xt.shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_seq(y, group, tp: int):
    """Sum ``y`` (B,S,d) over the ranks and keep this rank's slice of S, as
    ``psum_scatter(..., scatter_dimension=1, tiled=True)``."""
    b, s, d = y.shape
    parts = y.reshape(b, tp, s // tp, d).transpose(0, 1).contiguous()
    out = torch.empty((b, s // tp, d), dtype=y.dtype, device=y.device)
    dist.reduce_scatter_tensor(out, parts.reshape(tp * b, s // tp, d),
                               group=group)
    return out


def make_manual_prefill(cfg: ModelConfig, mesh, batch: int, seq: int,
                        tp: int = 16):
    """Returns (fn, arg_structs, in_shardings, out_shardings, donate), as
    the reference's. ``fn(params, tokens)`` is one rank's function under
    the mesh's ``"model"`` group: ``params`` its shards (``shard_params``),
    ``tokens`` (B, ``seq``) all of the data rank's rows. It returns (the
    last token's logits over the rank's vocab columns (B, padded_vocab /
    tp), {"k", "v"}: the rank's sequence slice of every layer's K and V
    (L, B, seq / tp, Hkv, hd)). ``arg_structs`` are the global shapes on
    the ``meta`` device, the shardings ``NamedSharding``s on ``mesh``."""
    check(cfg, seq, tp)
    have = mesh.size(mesh.mesh_dim_names.index("model"))
    if have != tp:
        raise ValueError(f"the mesh's model axis has {have} ranks, not "
                         f"tp = {tp}")
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hq_loc = hq // tp
    s_loc = seq // tp
    vshard = cfg.padded_vocab // tp
    group = hq // hkv

    def fn(params, tokens):
        pg = mesh.get_group("model")
        rank = mesh.get_local_rank("model")
        dev = params["final_norm"].device
        tokens = tokens.to(dev)
        b = tokens.shape[0]
        cdt = as_dtype(cfg.dtype)

        # embedding: the rank's vocab rows, one float32 all-reduce
        local_ids = tokens.long() - rank * vshard
        in_range = (local_ids >= 0) & (local_ids < vshard)
        x = params["embed"]["tok"][local_ids.clamp(0, vshard - 1)]
        x = torch.where(in_range[..., None], x, 0).float()
        dist.all_reduce(x, group=pg)
        x = x.to(cdt)[:, rank * s_loc:(rank + 1) * s_loc]

        positions = torch.arange(seq, dtype=torch.int32,
                                 device=dev)[None].expand(b, seq)
        kv_sel = (rank * hq_loc + torch.arange(hq_loc, device=dev)) // group
        blocks = tree_map(lambda a: a.unbind(0), params["blocks"]["slot00"])
        cache = {n: torch.empty((cfg.n_periods, b, s_loc, hkv, hd), dtype=cdt,
                                device=dev) for n in ("k", "v")}
        for i in range(cfg.n_periods):
            mixer = tree_map(lambda a: a[i], blocks["mixer"])
            mlp = tree_map(lambda a: a[i], blocks["mlp"])
            # ---- attention sublayer
            x_full = _gather_dim(rmsnorm(x, mixer["norm"], cfg.norm_eps), 1,
                                 pg, tp)
            q = x_full @ mixer["w_q"].to(x.dtype)
            if cfg.qkv_bias:
                q = q + mixer["b_q"].to(x.dtype)
            q = q.reshape(b, seq, hq_loc, hd)
            # kv heads on every rank, from the all-gathered w_k / w_v
            w_k = _gather_dim(mixer["w_k"], 1, pg, tp)
            w_v = _gather_dim(mixer["w_v"], 1, pg, tp)
            k = x_full @ w_k.to(x.dtype)
            v = x_full @ w_v.to(x.dtype)
            if cfg.qkv_bias:
                k = k + _gather_dim(mixer["b_k"], 0, pg, tp).to(x.dtype)
                v = v + _gather_dim(mixer["b_v"], 0, pg, tp).to(x.dtype)
            k = apply_rope(k.reshape(b, seq, hkv, hd), positions,
                           cfg.rope_theta)
            v = v.reshape(b, seq, hkv, hd)
            q = apply_rope(q, positions, cfg.rope_theta)
            # GQA: each local q head's kv head, so flash runs at group 1
            out = ops.flash_attention(q, k.index_select(2, kv_sel),
                                      v.index_select(2, kv_sel), causal=True)
            y = out.reshape(b, seq, hq_loc * hd) @ mixer["w_o"].to(x.dtype)
            x = x + _reduce_scatter_seq(y.float(), pg, tp).to(x.dtype)
            # ---- mlp sublayer
            x_full = _gather_dim(rmsnorm(x, mlp["norm"], cfg.norm_eps), 1,
                                 pg, tp)
            h = silu(x_full @ mlp["w_gate"].to(x.dtype)) \
                * (x_full @ mlp["w_up"].to(x.dtype))
            y = h @ mlp["w_down"].to(x.dtype)
            x = x + _reduce_scatter_seq(y.float(), pg, tp).to(x.dtype)
            # this rank keeps its sequence slice of the layer's K and V
            cache["k"][i] = k[:, rank * s_loc:(rank + 1) * s_loc]
            cache["v"][i] = v[:, rank * s_loc:(rank + 1) * s_loc]

        # the head on the last token, which lives on the last rank's slice
        x_full = _gather_dim(rmsnorm(x, params["final_norm"], cfg.norm_eps),
                             1, pg, tp)
        last = x_full[:, -1]
        logits = last @ params["lm_head"].to(last.dtype)
        return logits, cache

    names = mesh.mesh_dim_names
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    bax = batch_axes[0] if len(batch_axes) == 1 else (batch_axes or None)
    ns = lambda s: NamedSharding(mesh, s, placements(mesh, s))  # noqa: E731
    cache_spec = P(None, bax, "model", None, None)
    structs = Model(cfg).structs()
    arg_structs = (structs, torch.empty((batch, seq), dtype=torch.int32,
                                        device="meta"))
    in_sh = (tree_map(ns, param_specs(cfg)), ns(P(bax, None)))
    out_sh = (ns(P(bax, "model")), {"k": ns(cache_spec), "v": ns(cache_spec)})
    return fn, arg_structs, in_sh, out_sh, ()

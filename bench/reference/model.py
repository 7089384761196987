"""The architecture module of the plain decoder: dense SwiGLU or sparse
experts with shared experts, GQA attention with RoPE and optional QKV
bias, one attention layer and one MLP a layer (the port's one-slot
period). The module of every configuration file without a
``"reference"`` key; the interface is ``bench/reference/__init__.py``'s.

The reference is a plain float32 forward over one whole sequence, layer
by layer. It follows the configuration file's keys as run, and so the
port's architecture where the port departs from the published model
(each file lists its departures): no Granite multipliers; for the MoE,
top-k weights renormalised and no sigmoid gate on the shared expert.

``quant="fp8"`` is the control: the same forward with every matrix
product's operands rounded to float8 e4m3 (weights per output column,
activations per token, each scaled by its largest magnitude), the step
below the bfloat16 that the configurations state. Attention, norms and
the router stay in float32.

The weights are the benchmark's own tensors (the port's layout, in the
type served); each layer is upcast when it runs. TF32 is switched off.

The pieces (the leaves of one attention layer, one dense or MoE MLP, the
forward of each) are public, so that another architecture's module can
build its layers from them."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from bench.frozen import flops as F
from bench.frozen.flops import span_flops, token_flops  # noqa: F401

FP8_MAX = 448.0


# ------------------------------------------------------------ port config

def port_config(arch: dict):
    """The port's ``ModelConfig`` for a configuration file: its Hugging
    Face keys, as run, mapped onto the port's fields, and the ``port``
    block for what those keys do not state."""
    from repro_torch.configs.base import ModelConfig
    port = arch["port"]
    kw = dict(name=port["name"], family=port["family"],
              n_layers=arch["num_hidden_layers"],
              d_model=arch["hidden_size"],
              n_heads=arch["num_attention_heads"],
              n_kv_heads=arch["num_key_value_heads"],
              vocab=arch["vocab_size"],
              rope_theta=float(arch["rope_theta"]),
              norm_eps=float(arch["rms_norm_eps"]),
              tie_embeddings=bool(arch["tie_word_embeddings"]),
              qkv_bias=bool(port.get("qkv_bias", False)),
              dtype=arch["torch_dtype"])
    if arch.get("head_dim"):
        kw["head_dim"] = arch["head_dim"]
    if arch.get("num_experts"):
        eff = arch["moe_intermediate_size"]
        kw.update(d_ff=eff, n_experts=arch["num_experts"],
                  top_k=arch["num_experts_per_tok"], expert_d_ff=eff,
                  n_shared_experts=arch["shared_expert_intermediate_size"]
                  // eff,
                  capacity_factor=float(port["capacity_factor"]),
                  expert_sharding=port.get("expert_sharding", "expert"),
                  mlp_pattern=("moe",))
    else:
        kw["d_ff"] = arch["intermediate_size"]
    return ModelConfig(**kw)


# ----------------------------------------------------------------- layout

def padded_vocab(arch: dict) -> int:
    return -(-arch["vocab_size"] // 256) * 256


def heads(arch: dict):
    """(d, Hq, Hkv, head_dim)."""
    d = arch["hidden_size"]
    hq = arch["num_attention_heads"]
    return d, hq, arch["num_key_value_heads"], arch.get("head_dim") or d // hq


def embedding_leaves(arch: dict) -> dict:
    """The embedding, the final norm and an untied output head."""
    d, vp = arch["hidden_size"], padded_vocab(arch)
    tied = bool(arch["tie_word_embeddings"])
    out = {("embed", "tok"): ((vp, d), "embed",
                              1 / math.sqrt(d) if tied else 1.0),
           ("final_norm",): ((d,), "norm", 0.1)}
    if not tied:
        out[("lm_head",)] = ((d, vp), "matrix", 1 / math.sqrt(d))
    return out


def attention_leaves(arch: dict, slot: str, p: int) -> dict:
    """One GQA attention layer's leaves in ``slot``, stacked over ``p``
    periods."""
    d, hq, hkv, hd = heads(arch)
    mix = ("blocks", slot, "mixer")
    out = {}
    for name, shape in (("w_q", (d, hq * hd)), ("w_k", (d, hkv * hd)),
                        ("w_v", (d, hkv * hd)), ("w_o", (hq * hd, d))):
        out[mix + (name,)] = ((p,) + shape, "matrix", 1 / math.sqrt(shape[0]))
    out[mix + ("norm",)] = ((p, d), "norm", 0.1)
    if arch["port"].get("qkv_bias"):
        for name, n in (("b_q", hq * hd), ("b_k", hkv * hd),
                        ("b_v", hkv * hd)):
            out[mix + (name,)] = ((p, n), "bias", 0.2)
    return out


def dense_leaves(arch: dict, slot: str, p: int) -> dict:
    """One SwiGLU MLP's leaves (``intermediate_size``) in ``slot``."""
    d, ff = arch["hidden_size"], arch["intermediate_size"]
    mlp = ("blocks", slot, "mlp")
    return {mlp + ("norm",): ((p, d), "norm", 0.1),
            mlp + ("w_gate",): ((p, d, ff), "matrix", 1 / math.sqrt(d)),
            mlp + ("w_up",): ((p, d, ff), "matrix", 1 / math.sqrt(d)),
            mlp + ("w_down",): ((p, ff, d), "matrix", 1 / math.sqrt(ff))}


def moe_leaves(arch: dict, slot: str, p: int) -> dict:
    """One sparse MLP's leaves (routed and shared experts) in ``slot``."""
    d = arch["hidden_size"]
    e, eff = arch["num_experts"], arch["moe_intermediate_size"]
    sff = arch["shared_expert_intermediate_size"]
    mlp = ("blocks", slot, "mlp")
    return {mlp + ("norm",): ((p, d), "norm", 0.1),
            mlp + ("router",): ((p, d, e), "matrix", 1 / math.sqrt(d)),
            mlp + ("w_gate",): ((p, e, d, eff), "matrix", 1 / math.sqrt(d)),
            mlp + ("w_up",): ((p, e, d, eff), "matrix", 1 / math.sqrt(d)),
            mlp + ("w_down",): ((p, e, eff, d), "matrix", 1 / math.sqrt(eff)),
            mlp + ("shared_gate",): ((p, d, sff), "matrix", 1 / math.sqrt(d)),
            mlp + ("shared_up",): ((p, d, sff), "matrix", 1 / math.sqrt(d)),
            mlp + ("shared_down",): ((p, sff, d), "matrix",
                                     1 / math.sqrt(sff))}


def layout(arch: dict):
    """path -> (shape, kind, std) of every leaf, in the drawing order;
    kind is "matrix", "embed", "norm" or "bias"."""
    p = arch["num_hidden_layers"]
    out = embedding_leaves(arch)
    out.update(attention_leaves(arch, "slot00", p))
    out.update((moe_leaves if arch.get("num_experts") else dense_leaves)(
        arch, "slot00", p))
    return dict(sorted(out.items()))


# ---------------------------------------------------------------- forward

def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _mm(x, w, quant):
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, -2)
    return x @ w


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    hd = x.shape[-1]
    half = hd // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = pos[:, None].float() * inv                       # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, block: int = 512):
    """Causal GQA attention. q (S,Hq,hd), k/v (S,Hkv,hd) -> (S,Hq*hd)."""
    s, hq, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    kk = k.permute(1, 2, 0)                                # (Hkv,hd,S)
    vv = v.permute(1, 0, 2)                                # (Hkv,S,hd)
    out = torch.empty((s, hq, hd), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(hd)
    kpos = torch.arange(s, device=q.device)
    for a in range(0, s, block):
        b = min(s, a + block)
        qb = q[a:b].reshape(b - a, hkv, g, hd).permute(1, 2, 0, 3)
        sc = (qb @ kk[:, None]) * scale                    # (Hkv,g,n,S)
        mask = kpos[None, :] <= torch.arange(a, b, device=q.device)[:, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        o = p @ vv[:, None]                                # (Hkv,g,n,hd)
        out[a:b] = o.permute(2, 0, 1, 3).reshape(b - a, hq, hd)
    return out.reshape(s, hq * hd)


def _dense(h, wg, wu, wd, quant):
    g = _mm(h, wg, quant)
    u = _mm(h, wu, quant)
    return _mm(torch.nn.functional.silu(g) * u, wd, quant)


def _moe(arch, p, h, quant):
    e, k = arch["num_experts"], arch["num_experts_per_tok"]
    probs = torch.softmax(h @ p["router"].float(), dim=-1)    # (S,E)
    top_w, top_i = torch.topk(probs, k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros_like(h)
    for ex in range(e):
        tok, slot = torch.nonzero(top_i == ex, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _dense(h[tok], p["w_gate"][ex].float(), p["w_up"][ex].float(),
                   p["w_down"][ex].float(), quant)
        out.index_add_(0, tok, y * top_w[tok, slot][:, None])
    out += _dense(h, p["shared_gate"].float(), p["shared_up"].float(),
                  p["shared_down"].float(), quant)
    return out


def attention_layer(arch: dict, leaves: dict, i: int, x, pos, quant):
    """``x`` plus one GQA attention layer: period ``i`` of a slot's
    ``mixer`` leaves."""
    _, hq, hkv, hd = heads(arch)
    s = x.shape[0]
    pm = {n: t[i].float() for n, t in leaves.items()}
    h = _rmsnorm(x, pm["norm"], float(arch["rms_norm_eps"]))
    q = _mm(h, pm["w_q"], quant)
    k = _mm(h, pm["w_k"], quant)
    v = _mm(h, pm["w_v"], quant)
    if arch["port"].get("qkv_bias", False):
        q, k, v = q + pm["b_q"], k + pm["b_k"], v + pm["b_v"]
    theta = float(arch["rope_theta"])
    q = _rope(q.reshape(s, hq, hd), pos, theta)
    k = _rope(k.reshape(s, hkv, hd), pos, theta)
    o = _attention(q, k, v.reshape(s, hkv, hd))
    return x + _mm(o, pm["w_o"], quant)


def mlp_layer(arch: dict, leaves: dict, i: int, x, quant, moe: bool):
    """``x`` plus one MLP (sparse when ``moe``): period ``i`` of a slot's
    ``mlp`` leaves, each expert upcast as it runs."""
    pl = {n: t[i] for n, t in leaves.items()}
    h = _rmsnorm(x, pl["norm"].float(), float(arch["rms_norm_eps"]))
    if moe:
        return x + _moe(arch, pl, h, quant)
    return x + _dense(h, pl["w_gate"].float(), pl["w_up"].float(),
                      pl["w_down"].float(), quant)


def logits_at(arch: dict, weights: dict, tokens: Sequence[int],
              rows: Sequence[int], quant: Optional[str] = None,
              body=None) -> torch.Tensor:
    """float32 logits (len(rows), vocab) at positions ``rows`` of the
    sequence ``tokens`` (position t predicts token t + 1). ``body(x,
    pos)`` runs the layers (another architecture's); by default this
    module's, one attention layer and one MLP a layer."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(arch, weights, tokens, rows, quant, body)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]


def _layers(arch, weights, x, pos, quant):
    mix = weights["blocks"]["slot00"]["mixer"]
    mlp = weights["blocks"]["slot00"]["mlp"]
    moe = bool(arch.get("num_experts"))
    for layer in range(arch["num_hidden_layers"]):
        x = attention_layer(arch, mix, layer, x, pos, quant)
        x = mlp_layer(arch, mlp, layer, x, quant, moe)
    return x


@torch.no_grad()
def _logits_at(arch, weights, tokens, rows, quant, body):
    emb = weights["embed"]["tok"]
    dev = emb.device
    tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    pos = torch.arange(tok.numel(), device=dev)
    x = emb[tok].float()
    if body is None:
        x = _layers(arch, weights, x, pos, quant)
    else:
        x = body(x, pos)
    sel = x[torch.as_tensor(list(rows), dtype=torch.long, device=dev)]
    xn = _rmsnorm(sel, weights["final_norm"].float(),
                  float(arch["rms_norm_eps"]))
    head = (emb.float().T if arch["tie_word_embeddings"]
            else weights["lm_head"].float())
    return _mm(xn, head, quant)[:, :arch["vocab_size"]]


# ----------------------------------------------------------------- memory

def itemsize(arch: dict) -> int:
    return torch.finfo(getattr(torch, arch["torch_dtype"])).bits // 8


def weights_bytes(arch: dict, leaves: dict) -> int:
    return sum(itemsize(arch) * math.prod(shape)
               for shape, _, _ in leaves.values())


def kv_block_bytes(arch: dict, attention_layers: int) -> int:
    """The K/V bytes of one page over ``attention_layers`` layers."""
    _, _, hkv, hd = heads(arch)
    return (arch["engine"]["block_size"] * 2 * hkv * hd * itemsize(arch)
            * attention_layers)


def memory(arch: dict, engine_stats: dict, held_blocks: int) -> dict:
    """The weights' bytes, the KV pool's as reserved (``engine_stats``:
    the endpoint's ``stats()``), and the K/V bytes of ``held_blocks``
    pages, every layer's."""
    block = kv_block_bytes(arch, arch["num_hidden_layers"])
    return {"weights_bytes": weights_bytes(arch, layout(arch)),
            "kv_pool_bytes": engine_stats["total_blocks"] * block,
            "kv_live_peak_bytes": held_blocks * block}


# ------------------------------------------------------------------ calls

def ragged_cost(arch, ctx, q, k_pages, v_pages, tables, row, pos, **kw):
    """``ops.ragged_paged_attention``: the spans of the runner's current
    ragged forward (``ctx.spans``), one table row each."""
    return ("ragged",) + F.ragged_call_cost(
        arch, q.shape[0], tables.shape[0], tables.shape[1], ctx.spans,
        k_pages.element_size(), q.element_size())


def paged_decode_cost(arch, ctx, q, k_pages, v_pages, block_tables, kv_len):
    """``ops.paged_decode_attention``: each row's ``kv_len`` as the
    runner's current decode set it (``ctx.kv_lens``)."""
    return ("paged_decode",) + F.decode_call_cost(
        arch, ctx.kv_lens[:q.shape[0]], block_tables.shape[1],
        k_pages.element_size(), q.element_size())


CALLS = {"ragged_paged_attention": ragged_cost,
         "paged_decode_attention": paged_decode_cost}

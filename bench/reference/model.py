"""Plain float32 forward of a decoder configuration (dense SwiGLU or
sparse experts with shared experts; GQA attention with RoPE and optional
QKV bias), over one whole sequence, layer by layer.

It follows the configuration file's keys as run, and so the port's
architecture where the port departs from the published model (each file
lists its departures): no Granite multipliers; for the MoE, top-k
weights renormalised and no sigmoid gate on the shared expert.

``quant="fp8"`` is the control: the same forward with every matrix
product's operands rounded to float8 e4m3 (weights per output column,
activations per token, each scaled by its largest magnitude), the step
below the bfloat16 that the configurations state. Attention, norms and
the router stay in float32.

The weights are the benchmark's own tensors (the port's layout, in the
type served); each layer is upcast when it runs. TF32 is switched off."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

FP8_MAX = 448.0


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


def logits_at(arch: dict, weights: dict, tokens: Sequence[int],
              rows: Sequence[int], quant: Optional[str] = None
              ) -> torch.Tensor:
    """float32 logits (len(rows), vocab) at positions ``rows`` of the
    sequence ``tokens`` (position t predicts token t + 1)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(arch, weights, tokens, rows, quant)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]


@torch.no_grad()
def _logits_at(arch, weights, tokens, rows, quant):
    emb = weights["embed"]["tok"]
    dev = emb.device
    d = arch["hidden_size"]
    hq = arch["num_attention_heads"]
    hkv = arch["num_key_value_heads"]
    hd = arch.get("head_dim") or d // hq
    eps = float(arch["rms_norm_eps"])
    theta = float(arch["rope_theta"])
    bias = arch["port"].get("qkv_bias", False)
    tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    s = tok.numel()
    pos = torch.arange(s, device=dev)
    x = emb[tok].float()
    mix = weights["blocks"]["slot00"]["mixer"]
    mlp = weights["blocks"]["slot00"]["mlp"]
    for layer in range(arch["num_hidden_layers"]):
        pm = {n: t[layer].float() for n, t in mix.items()}
        h = _rmsnorm(x, pm["norm"], eps)
        q = _mm(h, pm["w_q"], quant)
        k = _mm(h, pm["w_k"], quant)
        v = _mm(h, pm["w_v"], quant)
        if bias:
            q, k, v = q + pm["b_q"], k + pm["b_k"], v + pm["b_v"]
        q = _rope(q.reshape(s, hq, hd), pos, theta)
        k = _rope(k.reshape(s, hkv, hd), pos, theta)
        o = _attention(q, k, v.reshape(s, hkv, hd))
        x = x + _mm(o, pm["w_o"], quant)
        pl = {n: t[layer] for n, t in mlp.items()}
        h = _rmsnorm(x, pl["norm"].float(), eps)
        if arch.get("num_experts"):
            x = x + _moe(arch, pl, h, quant)
        else:
            x = x + _dense(h, pl["w_gate"].float(), pl["w_up"].float(),
                           pl["w_down"].float(), quant)
    sel = x[torch.as_tensor(list(rows), dtype=torch.long, device=dev)]
    xn = _rmsnorm(sel, weights["final_norm"].float(), eps)
    head = (emb.float().T if arch["tie_word_embeddings"]
            else weights["lm_head"].float())
    return _mm(xn, head, quant)[:, :arch["vocab_size"]]

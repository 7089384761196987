"""Frozen copies of the benchmark's functions as they were before the
architecture modules (``bench/reference/__init__.py``) took over what
depends on a model's shape: the port's config mapping, the weights'
layout and draw, the plain decoder's reference forward, the call
counter and the memory count. ``test_bench_arch_move.py`` holds the
modules to them, so that the move is seen to change no number. Not
used by the benchmark's runs."""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from bench.frozen import flops as F

_PIECE = 1 << 30
FP8_MAX = 448.0


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


def seed_of(seed: int, salt: int = 0) -> int:
    return (int(seed) * 0x9E3779B1 + salt) % (1 << 63)


def padded_vocab(arch: dict) -> int:
    return -(-arch["vocab_size"] // 256) * 256


def layout(arch: dict) -> Dict[Tuple[str, ...], Tuple[Tuple[int, ...], str,
                                                      float]]:
    """path -> (shape, kind, std) of every leaf; kind is "matrix",
    "embed", "norm" or "bias"."""
    d = arch["hidden_size"]
    hq = arch["num_attention_heads"]
    hkv = arch["num_key_value_heads"]
    hd = arch.get("head_dim") or d // hq
    p = arch["num_hidden_layers"]
    vp = padded_vocab(arch)
    tied = bool(arch["tie_word_embeddings"])
    out = {("embed", "tok"): ((vp, d), "embed",
                              1 / math.sqrt(d) if tied else 1.0),
           ("final_norm",): ((d,), "norm", 0.1)}
    if not tied:
        out[("lm_head",)] = ((d, vp), "matrix", 1 / math.sqrt(d))
    mix = ("blocks", "slot00", "mixer")
    for name, shape in (("w_q", (d, hq * hd)), ("w_k", (d, hkv * hd)),
                        ("w_v", (d, hkv * hd)), ("w_o", (hq * hd, d))):
        out[mix + (name,)] = ((p,) + shape, "matrix",
                              1 / math.sqrt(shape[0]))
    out[mix + ("norm",)] = ((p, d), "norm", 0.1)
    if arch["port"].get("qkv_bias"):
        for name, n in (("b_q", hq * hd), ("b_k", hkv * hd),
                        ("b_v", hkv * hd)):
            out[mix + (name,)] = ((p, n), "bias", 0.2)
    mlp = ("blocks", "slot00", "mlp")
    out[mlp + ("norm",)] = ((p, d), "norm", 0.1)
    if arch.get("num_experts"):
        e, eff = arch["num_experts"], arch["moe_intermediate_size"]
        sff = arch["shared_expert_intermediate_size"]
        out[mlp + ("router",)] = ((p, d, e), "matrix", 1 / math.sqrt(d))
        out[mlp + ("w_gate",)] = ((p, e, d, eff), "matrix", 1 / math.sqrt(d))
        out[mlp + ("w_up",)] = ((p, e, d, eff), "matrix", 1 / math.sqrt(d))
        out[mlp + ("w_down",)] = ((p, e, eff, d), "matrix",
                                  1 / math.sqrt(eff))
        out[mlp + ("shared_gate",)] = ((p, d, sff), "matrix",
                                       1 / math.sqrt(d))
        out[mlp + ("shared_up",)] = ((p, d, sff), "matrix", 1 / math.sqrt(d))
        out[mlp + ("shared_down",)] = ((p, sff, d), "matrix",
                                       1 / math.sqrt(sff))
    else:
        ff = arch["intermediate_size"]
        out[mlp + ("w_gate",)] = ((p, d, ff), "matrix", 1 / math.sqrt(d))
        out[mlp + ("w_up",)] = ((p, d, ff), "matrix", 1 / math.sqrt(d))
        out[mlp + ("w_down",)] = ((p, ff, d), "matrix", 1 / math.sqrt(ff))
    return dict(sorted(out.items()))


def dtype_of(arch: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[arch["torch_dtype"]]


def leaves(arch: dict, seed: int, device) -> Iterator[Tuple[Tuple[str, ...],
                                                           torch.Tensor]]:
    """(path, tensor) for every leaf, in order, drawn from the seed."""
    dev = torch.device(device)
    dt = dtype_of(arch)
    g = torch.Generator(device=dev).manual_seed(seed_of(seed))
    for path, (shape, kind, std) in layout(arch).items():
        t = torch.empty(shape, dtype=dt, device=dev)
        rows = max(1, _PIECE // max(1, math.prod(shape[1:])))
        for i in range(0, shape[0], rows):
            part = t[i:i + rows]
            part.normal_(0.0, 1.0, generator=g)
            part.mul_(std)
            if kind == "norm":
                part.add_(1.0)
        yield path, t


def nest(flat: Dict[Tuple[str, ...], torch.Tensor]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree


def make(arch: dict, seed: int, device) -> dict:
    """The whole tree, nested as the port's parameters."""
    return nest(dict(leaves(arch, seed, device)))


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


def memory_held(arch: dict, rec, pool_blocks: int) -> dict:
    """The weights' bytes, the KV pool's as reserved, and the K/V bytes of
    the most pages held after any step of the window: the memory the
    deployment really holds, beside the allocator's peak, which counts the
    whole pool."""
    itemsize = dtype_of(arch).itemsize
    hkv = arch["num_key_value_heads"]
    hd = arch.get("head_dim") or (arch["hidden_size"]
                                  // arch["num_attention_heads"])
    block = (arch["engine"]["block_size"] * 2 * hkv * hd * itemsize
             * arch["num_hidden_layers"])
    held = max((s.kv_blocks for s in rec.steps if rec.in_window(s.t0)),
               default=0)
    return {"weights_bytes": sum(itemsize * math.prod(shape) for shape, _, _
                                 in layout(arch).values()),
            "kv_pool_bytes": pool_blocks * block,
            "kv_live_peak_bytes": held * block}

"""RWKV6 ('Finch') time-mix with data-dependent decay.

The reference's mixer (``src/repro/models/rwkv.py``), as it computes it:
sigmoid-lerp token shifts of the (normed) mixer input against the previous
token, a tanh LoRA decay in float32, the WKV6 recurrence
(``ops.wkv6``: the CUDA kernel on the card), a LayerNorm over all of d in
float32 and a ``silu(g)`` gate. The channel mix is the shared dense SwiGLU
(``mlp.py``). Its cache is the last input row (``shift``) and the float32
WKV state (``wkv``); a forward with a cache reads both and writes the new
ones into them in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import ParamDef, silu

LORA_R = 64


def rwkv_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h, hd = cfg.n_heads, cfg.head_dim
    assert h * hd == d, "rwkv requires n_heads*head_dim == d_model"
    return {
        "mu_r": ParamDef((d,), ("embed",), init="ones", scale=0.5),
        "mu_k": ParamDef((d,), ("embed",), init="ones"),
        "mu_v": ParamDef((d,), ("embed",), init="ones"),
        "mu_g": ParamDef((d,), ("embed",), init="ones"),
        "mu_w": ParamDef((d,), ("embed",), init="ones"),
        "w_r": ParamDef((d, d), ("embed", "heads")),
        "w_k": ParamDef((d, d), ("embed", "heads")),
        "w_v": ParamDef((d, d), ("embed", "heads")),
        "w_g": ParamDef((d, d), ("embed", "heads")),
        "w_o": ParamDef((d, d), ("heads", "embed")),
        "decay_base": ParamDef((d,), ("embed",), init="zeros"),
        "decay_A": ParamDef((d, LORA_R), ("embed", None)),
        "decay_B": ParamDef((LORA_R, d), (None, "embed")),
        "u": ParamDef((h, hd), ("heads", "head_dim"), init="zeros"),
        "ln_w": ParamDef((d,), ("embed",), init="ones"),
        "ln_b": ParamDef((d,), ("embed",), init="zeros"),
        "norm": ParamDef((d,), ("embed",), init="ones"),
    }


def init_rwkv_cache(cfg: ModelConfig, n_periods: int, batch: int, dtype,
                    device=None) -> dict:
    """Zeroed recurrent caches of ``n_periods`` stacked rwkv periods: the
    previous token's input row (np, B, 1, d) in the model dtype and the
    WKV state (np, B, H, hd, hd) float32. Slot-indexed on either KV
    layout."""
    return {
        "shift": torch.zeros((n_periods, batch, 1, cfg.d_model), dtype=dtype,
                             device=device),
        "wkv": torch.zeros((n_periods, batch, cfg.n_heads, cfg.head_dim,
                            cfg.head_dim), dtype=torch.float32,
                           device=device),
    }


# the caches' logical axes, as the reference names them for its sharding
# rules (``transformer.cache_axes``)
RWKV_CACHE_AXES = {
    "shift": ("batch", None, "embed"),
    "wkv": ("batch", "heads", "head_dim", None),
}


def _token_shift(x, shift_state):
    """Previous-token tensor: concat(state, x[:, :-1])."""
    return torch.cat([shift_state.to(x.dtype), x[:, :-1]], dim=1)


def rwkv_mixer(cfg: ModelConfig, p: dict, x, *,
               cache: Optional[dict] = None):
    """x (B,S,d) -> (B,S,d). With ``cache`` ({"shift": (B,1,d), "wkv":
    (B,H,hd,hd)} views of one period), the shift row and the WKV state
    start from it and the new ones are written into it."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    shift_state = (cache["shift"] if cache is not None
                   else x.new_zeros((b, 1, d)))
    prev = _token_shift(x, shift_state)

    def lerp(mu):
        m = torch.sigmoid(p[mu].float()).to(x.dtype)
        return x * m + prev * (1 - m)

    xr, xk, xv, xg, xw = (lerp(m) for m in
                          ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"))
    r = (xr @ p["w_r"].to(x.dtype)).reshape(b, s, h, hd)
    k = (xk @ p["w_k"].to(x.dtype)).reshape(b, s, h, hd)
    v = (xv @ p["w_v"].to(x.dtype)).reshape(b, s, h, hd)
    g = xg @ p["w_g"].to(x.dtype)

    lora = torch.tanh(xw.float() @ p["decay_A"].float())
    w = (p["decay_base"].float()
         + lora @ p["decay_B"].float()).reshape(b, s, h, hd)

    state = cache["wkv"] if cache is not None else None
    y, _ = ops.wkv6(r, k, v, w, p["u"].float(), state, out_state=state)

    yf = y.reshape(b, s, d).float()
    mean = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    yn = (yf - mean) * torch.rsqrt(var + 1e-5)
    yn = yn * p["ln_w"].float() + p["ln_b"].float()
    out = (yn.to(x.dtype) * silu(g)) @ p["w_o"].to(x.dtype)
    if cache is not None:
        cache["shift"].copy_(x[:, -1:])
    return out

"""Mamba-1 selective-SSM mixer (Jamba's recurrent layer).

The reference's mixer (``src/repro/models/mamba.py``), as it computes it:
an input projection split into x and the gate z, a causal depthwise
convolution over a carried history of ``d_conv - 1`` rows, SiLU, the
selective-scan inputs (dt through a low-rank projection and softplus, B
and C, A = -exp(A_log)), all in float32, then the scan
h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t, y_t = h_t C_t, a skip through D
and the SiLU(z) gate.

Where the reference scans chunks of 64 steps with ``lax.scan`` (padding
the last chunk with dt = 0, which leaves the state as it was), the port
computes every step's decay and input term at once and runs the
recurrence as a loop over the steps in eager PyTorch; the padding has no
effect on the real steps, so it is left out. A forward with a cache reads
the conv history and the float32 state from it and writes the new ones
into it in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, silu


def _dims(cfg: ModelConfig):
    d_in = cfg.mamba_expand * cfg.d_model
    dt_rank = max(1, d_in // 16)
    return d_in, cfg.mamba_d_state, cfg.mamba_d_conv, dt_rank


def mamba_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_in, n, d_conv, dt_rank = _dims(cfg)
    return {
        "in_proj": ParamDef((d, 2 * d_in), ("embed", "ffn")),
        "conv_w": ParamDef((d_conv, d_in), ("conv", "ffn")),
        "conv_b": ParamDef((d_in,), ("ffn",), init="zeros"),
        "x_proj": ParamDef((d_in, dt_rank + 2 * n), ("ffn", None)),
        "dt_w": ParamDef((dt_rank, d_in), ("dt_rank", "ffn")),
        "dt_b": ParamDef((d_in,), ("ffn",), init="zeros"),
        "A_log": ParamDef((d_in, n), ("ffn", "state"), init="ones"),
        "D": ParamDef((d_in,), ("ffn",), init="ones"),
        "out_proj": ParamDef((d_in, d), ("ffn", "embed")),
        "norm": ParamDef((d,), ("embed",), init="ones"),
    }


def init_mamba_cache(cfg: ModelConfig, n_periods: int, batch: int, dtype,
                     device=None) -> dict:
    """Zeroed caches of ``n_periods`` stacked mamba periods: the conv
    history (np, B, d_conv - 1, d_in) in the model dtype and the SSM state
    (np, B, d_in, n) float32. Slot-indexed on either KV layout."""
    d_in, n, d_conv, _ = _dims(cfg)
    return {
        "conv": torch.zeros((n_periods, batch, d_conv - 1, d_in),
                            dtype=dtype, device=device),
        "h": torch.zeros((n_periods, batch, d_in, n), dtype=torch.float32,
                         device=device),
    }


# the caches' logical axes, as the reference names them for its sharding
# rules (``transformer.cache_axes``)
MAMBA_CACHE_AXES = {
    "conv": ("batch", None, "ffn"),
    "h": ("batch", "ffn", "state"),
}


def _causal_conv(x, conv_w, conv_b, history=None):
    """x (B,S,d_in); history (B,d_conv-1,d_in) prepended (zeros if None).
    Returns (y (B,S,d_in), the last d_conv-1 rows of history + x: a
    prefill shorter than d_conv-1 keeps part of the old history)."""
    d_conv = conv_w.shape[0]
    b, s, d_in = x.shape
    if history is None:
        history = x.new_zeros((b, d_conv - 1, d_in))
    xp = torch.cat([history.to(x.dtype), x], dim=1)
    y = torch.zeros_like(x)
    for i in range(d_conv):
        y = y + conv_w[i].to(x.dtype) * xp[:, i:i + s]
    return y + conv_b.to(x.dtype), xp[:, -(d_conv - 1):]


def _softplus(v):
    """``jax.nn.softplus``: log(1 + exp(v)) as logaddexp(v, 0), without a
    threshold."""
    return torch.logaddexp(v, torch.zeros_like(v))


def _ssm_inputs(cfg: ModelConfig, p: dict, xc):
    """xc (B,S,d_in) post-conv activations -> (dt, B, C, A), float32."""
    _, n, _, dt_rank = _dims(cfg)
    dbc = xc @ p["x_proj"].to(xc.dtype)
    dt_r = dbc[..., :dt_rank]
    bm = dbc[..., dt_rank:dt_rank + n].float()
    cm = dbc[..., dt_rank + n:].float()
    dt = _softplus((dt_r @ p["dt_w"].to(xc.dtype)).float()
                   + p["dt_b"].float())
    a = -torch.exp(p["A_log"].float())                     # (d_in, n)
    return dt, bm, cm, a


def _scan(a, h, dt, bm, cm, u):
    """The selective scan over S steps from state ``h`` (B,d_in,n), written
    in place. dt, u (B,S,d_in); bm, cm (B,S,n); a (d_in,n). Returns
    y (B,S,d_in) float32."""
    da = torch.exp(dt[..., None] * a)                      # (B,S,d_in,n)
    dbu = (dt * u)[..., None] * bm[:, :, None, :]          # (B,S,d_in,n)
    prev = h
    if torch.is_grad_enabled() and (da.requires_grad or dbu.requires_grad):
        # training: ``out=`` takes no autograd, so the same steps are
        # stacked after the loop; the first step reads a copy of ``h``,
        # which autograd saves and the write below must not reach
        prev, states = h.clone(), []
        for t in range(dt.shape[1]):
            prev = torch.addcmul(dbu[:, t], da[:, t], prev)
            states.append(prev)
        hs = torch.stack(states, 1)
    else:
        hs = torch.empty_like(da)
        for t in range(dt.shape[1]):
            prev = torch.addcmul(dbu[:, t], da[:, t], prev, out=hs[:, t])
    h.copy_(prev)
    return torch.einsum("bsdn,bsn->bsd", hs, cm)


def mamba_mixer(cfg: ModelConfig, p: dict, x, *,
                cache: Optional[dict] = None):
    """x (B,S,d) -> (B,S,d). With ``cache`` ({"conv": (B,d_conv-1,d_in),
    "h": (B,d_in,n)} views of one period) the convolution and the scan
    start from it and the new history and state are written into it; a
    decode step is S == 1."""
    b = x.shape[0]
    d_in, n, _, _ = _dims(cfg)
    xz = x @ p["in_proj"].to(x.dtype)
    x1, z = xz[..., :d_in], xz[..., d_in:]

    history = cache["conv"] if cache is not None else None
    xc, new_hist = _causal_conv(x1, p["conv_w"], p["conv_b"], history)
    xc = silu(xc)

    dt, bm, cm, a = _ssm_inputs(cfg, p, xc)
    h = (cache["h"] if cache is not None
         else torch.zeros((b, d_in, n), dtype=torch.float32,
                          device=x.device))
    ys = _scan(a, h, dt, bm, cm, xc.float())

    y = ys.to(x.dtype) + p["D"].to(x.dtype) * xc
    y = y * silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    if cache is not None:
        cache["conv"].copy_(new_hist)
    return out

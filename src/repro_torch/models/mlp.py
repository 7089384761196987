"""Dense gated MLP (SwiGLU). The MoE MLP is not ported yet."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, silu


def dense_mlp_defs(cfg: ModelConfig, d_ff: int = 0) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    return {
        "w_gate": ParamDef((d, ff), ("embed", "ffn")),
        "w_up": ParamDef((d, ff), ("embed", "ffn")),
        "w_down": ParamDef((ff, d), ("ffn", "embed")),
        "norm": ParamDef((d,), ("embed",), init="ones"),
    }


def dense_mlp(p: dict, x):
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return (silu(g) * u) @ p["w_down"].to(x.dtype)

"""Dense gated MLP (SwiGLU) and the reference's sort-based dropping MoE.

``moe_mlp`` computes the reference's function (``src/repro/models/mlp.py``),
drop rule included: tokens are split into groups, each group routes its
rows (token x top-k choice) to experts through a stable sort, keeps at most
``capacity`` rows an expert and runs the expert products over a
``(g, e, capacity, d)`` buffer. Where the reference combined with a
scatter-add, the port un-sorts the weighted rows back to token-major order
and sums each token's k rows: no atomics, so the bits of a step do not
depend on the order the card adds in.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, silu


# ---------------------------------------------------------------------------
# Dense gated MLP (SwiGLU)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_defs(cfg: ModelConfig) -> dict:
    d, e, eff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    # the reference's logical axes: expert-parallel ('expert') or
    # tensor-parallel inside each expert ('ffn')
    if cfg.expert_sharding == "expert":
        ax = ("experts", "embed", None)
        ax_out = ("experts", None, "embed")
    else:
        ax = (None, "embed", "expert_ffn")
        ax_out = (None, "expert_ffn", "embed")
    defs = {
        "router": ParamDef((d, e), ("embed", None)),
        "w_gate": ParamDef((e, d, eff), ax),
        "w_up": ParamDef((e, d, eff), ax),
        "w_down": ParamDef((e, eff, d), ax_out),
        "norm": ParamDef((d,), ("embed",), init="ones"),
    }
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * eff
        defs.update({
            "shared_gate": ParamDef((d, sff), ("embed", "ffn")),
            "shared_up": ParamDef((d, sff), ("embed", "ffn")),
            "shared_down": ParamDef((sff, d), ("ffn", "embed")),
        })
    return defs


def moe_groups(t: int) -> int:
    """Groups the reference splits ``t`` rows of x into (its data-parallel
    alignment): 16 when they divide evenly, else 1."""
    return 16 if t % 16 == 0 and t >= 16 else 1


def moe_capacity(cfg: ModelConfig, rows: int) -> int:
    """Rows an expert keeps in a group of ``rows`` routed rows: the
    capacity factor over an even share, every row (no drop) when the share
    is under 8, and never fewer than 4."""
    e = cfg.n_experts
    capacity = int(-(-rows // e) * cfg.capacity_factor)
    if rows // e < 8:
        capacity = rows          # small-batch no-drop mode (decode path)
    return max(capacity, 4)


def moe_mlp(cfg: ModelConfig, p: dict, x) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """x (B,S,d) -> (y (B,S,d), the float32 load-balancing loss).

    Every row of x counts, pads of a ragged step too, so the group count
    and each expert's capacity follow the step's composition."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    g_ = moe_groups(t)
    tg = t // g_
    xg = x.reshape(g_, tg, d)

    logits = xg.float() @ p["router"].float()              # (g,tg,e)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)            # (g,tg,k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    # aux load-balancing loss (Switch-style), over every group
    frac_tokens = torch.nn.functional.one_hot(top_i[..., 0], e).float() \
        .mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs)

    rows = tg * k
    capacity = moe_capacity(cfg, rows)
    row_expert = top_i.reshape(g_, rows)
    row_weight = top_w.reshape(g_, rows)
    row_token = torch.arange(tg, device=x.device).repeat_interleave(k)

    # a row's rank among its expert's rows (in token order) decides keep
    order = torch.argsort(row_expert, dim=1, stable=True)
    se = torch.gather(row_expert, 1, order)
    st = row_token[order]
    sw = torch.gather(row_weight, 1, order)
    counts = torch.zeros((g_, e), dtype=torch.long, device=x.device)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(rows, device=x.device)[None] \
        - torch.gather(starts, 1, se)
    keep = rank < capacity
    slot = torch.where(keep, se * capacity + rank,
                       torch.full_like(se, e * capacity))

    # dispatch: every dropped row lands on the sentinel slot e*capacity,
    # which the buffer's view below leaves out
    garange = torch.arange(g_, device=x.device)[:, None]
    buf = x.new_zeros((g_, e * capacity + 1, d))
    buf[garange, slot] = xg[garange, st]
    h = buf[:, :e * capacity].reshape(g_, e, capacity, d)

    wg = p["w_gate"].to(x.dtype)
    wu = p["w_up"].to(x.dtype)
    wd = p["w_down"].to(x.dtype)
    gact = torch.einsum("gecd,edf->gecf", h, wg)
    uact = torch.einsum("gecd,edf->gecf", h, wu)
    y_e = torch.einsum("gecf,efd->gecd", silu(gact) * uact, wd)

    # combine: each sorted row takes its expert output (0 if dropped),
    # weighted, then the rows go back to token-major order and a token's
    # k rows are summed in choice order
    yf = y_e.reshape(g_, e * capacity, d)
    y_rows = yf[garange, torch.clamp_max(slot, e * capacity - 1)]
    y_rows = torch.where(keep[..., None], y_rows, y_rows.new_zeros(()))
    y_rows = y_rows * sw[..., None].to(x.dtype)
    unsort = torch.empty_like(order)
    unsort.scatter_(1, order, torch.arange(rows, device=x.device)
                    .expand(g_, rows).contiguous())
    y_tok = y_rows[garange, unsort].reshape(g_, tg, k, d)
    out = y_tok.sum(dim=2).reshape(b, s, d)

    if cfg.n_shared_experts:
        sh = {"w_gate": p["shared_gate"], "w_up": p["shared_up"],
              "w_down": p["shared_down"]}
        out = out + dense_mlp(sh, x)
    return out, aux.float()

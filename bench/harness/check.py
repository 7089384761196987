"""How ``correct`` is decided for a served model.

Once the window has closed and the program's state is freed, a sample of
the requests the program finished in the window, drawn from the seed and
holding the longest of them, goes through the plain float32 reference
(``logits_at`` of the configuration's architecture module,
``bench/reference/``) once each, over its prompt and its served
tokens. At each served token the gap by which the reference's logit of
that token lies below the reference's best is read; the widest gap over
the sample is compared with the cell's limit (``correct.max_logit_gap``
in ``bench/cells/<workload>.json``). Served tokens are greedy, so a sound
program's gaps come from rounding near ties alone."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from bench.harness.spec import architecture


def sample(finished: Sequence, k: int, seed: int) -> List:
    """``k`` of the finished requests, drawn from the seed, the longest
    (prompt and served tokens) always among them."""
    if not finished:
        return []
    order = sorted(finished, key=lambda r: r.idx)
    longest = max(order, key=lambda r: (r.prompt_len + len(r.tokens), -r.idx))
    rest = [r for r in order if r is not longest]
    rng = np.random.default_rng((int(seed) * 7919 + 17) % (1 << 63))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) \
        if rest and k > 1 else []
    return [longest] + [rest[i] for i in sorted(pick)]


def gaps(arch: dict, weights: dict, prompt: Sequence[int],
         served: Sequence[int], quant=None):
    """(reference gaps of the served tokens, and, with ``quant``, the
    reference gaps of the tokens that the quantized forward puts first at
    the same positions)."""
    ref = architecture(arch)
    seq = list(prompt) + list(served[:-1])
    rows = list(range(len(prompt) - 1, len(seq)))
    lg = ref.logits_at(arch, weights, seq, rows)
    best = lg.max(dim=-1).values
    tok = torch.as_tensor(list(served), device=lg.device)
    g = best - lg.gather(1, tok[:, None])[:, 0]
    if quant is None:
        return g, None
    lq = ref.logits_at(arch, weights, seq, rows, quant=quant)
    pick = lq.argmax(dim=-1)
    gq = best - lg.gather(1, pick[:, None])[:, 0]
    return g, gq


def summary(gap_list) -> Dict[str, float]:
    """The numbers a cell may compare, over every checked token: the
    widest gap, the mean gap, and the share of tokens with a gap (a
    served token that is not the reference's best)."""
    g = torch.cat([x.flatten() for x in gap_list]) if gap_list else \
        torch.zeros(0)
    if g.numel() == 0:
        return {"max_logit_gap": float("nan"), "mean_logit_gap": float("nan"),
                "parted_share": float("nan")}
    return {"max_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "parted_share": float((g > 0).float().mean())}


def judge(arch: dict, weights: dict, picked: Sequence,
          prompts: Dict[int, list], limits: dict) -> dict:
    """The numbers compared, each with its limit: those the cell's file
    names under ``correct`` (``max_logit_gap``, ``mean_logit_gap``), and
    the counts of requests and tokens checked."""
    gl = [gaps(arch, weights, prompts[r.idx], r.tokens)[0] for r in picked]
    got = summary(gl)
    checks = {name: {"value": got[name], "limit": float(limits[name])}
              for name in ("max_logit_gap", "mean_logit_gap")
              if name in limits}
    checks["checked_tokens"] = {"value": sum(len(r.tokens) for r in picked),
                                "limit": 1}
    checks["checked_requests"] = {"value": len(picked), "limit": 1}
    return checks


def passed(checks: dict) -> bool:
    """Each number within its limit: a gap at most its limit, a count of
    faults at most its limit, a count of things checked at least its."""
    for name, c in checks.items():
        v, lim = c["value"], c["limit"]
        if name.startswith("checked_"):
            if not v >= lim:
                return False
        elif not v <= lim:
            return False
    return True

"""Algorithm 1 — pipeline-parallelism size selection, with the paper's TTFT /
TPOT predictors (Eq. 1, Eq. 2, Eq. 5)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.types import (ColdStartScheme, ModelProfile,
                                    ServerSpec, SLO, TimingProfile)


class NoPlacement(RuntimeError):
    """No server set can currently host the model (HBM pressure)."""


def _ratio(b: float, p: float) -> float:
    return 1.0 / b + 1.0 / p


def predict_ttft(M: float, s: int, w: int, ratios: Sequence[float],
                 t: TimingProfile, t_w: float = 0.0) -> float:
    """Eq. 1 — non-overlapped cold-start TTFT."""
    max_ratio = max(ratios)
    return (t_w + t.t_c + (M / s) * max_ratio
            + t.t_p * (s - w + w / s) + t.t_n * s)


def predict_ttft_overlapped(M: float, s: int, w: int,
                            bandwidths: Sequence[float],
                            pcies: Sequence[float],
                            t: TimingProfile, t_w: float = 0.0) -> float:
    """Eq. 5 — TTFT with worker-level overlapping (§5).

    Per worker: ready = max(container-path, fetch-path) where the container
    path is t_cc + t_cu + max(load, t_l) (library loading overlapped with
    host->device loading) and the fetch path is (M/s)/b_i (prefetch starts
    at t=0, pipelined with loading at tensor granularity).
    """
    per_worker = [
        max(t.t_cc + t.t_cu + max((M / s) / p, t.t_l), (M / s) / b)
        for b, p in zip(bandwidths, pcies)
    ]
    return (t_w + max(per_worker)
            + t.t_p * (s - w + w / s) + t.t_n * s)


def predict_tpot(s: int, w: int, t: TimingProfile) -> float:
    """Eq. 2 — decode latency of the pipeline group. A full-memory worker
    contributes t_d/s per hop, a low-memory worker a full t_d."""
    if s == 1:
        return t.t_d
    return t.t_d * (s - w + w / s) + t.t_n * s


def select_scheme(
    model: ModelProfile,
    servers: Dict[str, ServerSpec],
    free_hbm: Dict[str, int],
    effective_bw: Dict[str, float],
    t_w: float = 0.0,
    overlapped: bool = True,
    slo: Optional[SLO] = None,
    fixed_s: Optional[int] = None,
) -> ColdStartScheme:
    """Algorithm 1.

    ``effective_bw`` is the per-server bandwidth the Alg.2 tracker grants a
    *new* cold-start worker right now (0 => the server must not be used).
    Enumerates (s, w) in minimal-resource order and returns the first scheme
    meeting both SLOs; falls back to the feasible scheme with minimal
    predicted TTFT (paper falls back to a single worker).
    """
    slo = slo or model.slo
    t = model.timings
    M = model.size_bytes

    usable = [sid for sid, spec in servers.items()
              if effective_bw.get(sid, spec.nic_bytes_per_s) > 0]

    def ratio_of(sid: str) -> float:
        spec = servers[sid]
        return _ratio(effective_bw.get(sid, spec.nic_bytes_per_s),
                      spec.pcie_bytes_per_s)

    best_fallback: Optional[ColdStartScheme] = None

    s_range = [fixed_s] if fixed_s else range(1, model.max_pp + 1)
    for s in s_range:
        for w in range(0, s + 1):
            # servers that fit a full-memory worker (paper: "fit a model of
            # size M"), best fetch+load ratio first
            full_ok = sorted(
                (sid for sid in usable if free_hbm[sid] >= model.hbm_full()),
                key=ratio_of)
            if len(full_ok) < w:
                continue
            chosen_full = full_ok[:w]
            # low-memory candidates: fit M/s; merge leftover full-capable
            # servers in (paper's MergeSort), keep ascending ratio. (The
            # pseudocode prints "descending" for {j}; that contradicts the
            # max-ratio TTFT term, so we sort ascending — see DESIGN.md §9.)
            rest = [sid for sid in usable
                    if sid not in chosen_full
                    and free_hbm[sid] >= model.hbm_low(s)]
            # tie-break: prefer servers that could later host the FULL
            # model, so scale-down consolidation has an upgrade target
            rest.sort(key=lambda sid: (ratio_of(sid),
                                       free_hbm[sid] < model.hbm_full()))
            if len(rest) < s - w:
                continue
            chosen_low = rest[: s - w]
            g = tuple(chosen_full + chosen_low)
            bws = [effective_bw.get(sid, servers[sid].nic_bytes_per_s)
                   for sid in g]
            pcs = [servers[sid].pcie_bytes_per_s for sid in g]
            if overlapped:
                ttft = predict_ttft_overlapped(M, s, w, bws, pcs, t, t_w)
            else:
                ttft = predict_ttft(M, s, w,
                                    [_ratio(b, p) for b, p in zip(bws, pcs)],
                                    t, t_w)
            tpot = predict_tpot(s, w, t)
            scheme = ColdStartScheme(s, w, g, ttft, tpot, slo_ok=True)
            if ttft <= slo.ttft and tpot <= slo.tpot:
                return scheme
            # fallback preference: never trade TPOT away (the paper's
            # fallback is a single full worker, which is TPOT-clean)
            cand = ColdStartScheme(s, w, g, ttft, tpot, slo_ok=False)
            if best_fallback is None:
                best_fallback = cand
            else:
                best_ok = best_fallback.predicted_tpot <= slo.tpot
                cand_ok = tpot <= slo.tpot
                if (cand_ok, -ttft) > (best_ok, -best_fallback.predicted_ttft):
                    best_fallback = cand

    if best_fallback is None:
        raise NoPlacement(
            f"no placement fits model {model.name} "
            f"({model.size_bytes >> 20} MiB) on any server")
    return best_fallback

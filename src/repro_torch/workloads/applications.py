"""Application presets from the paper (Table 1 + Table 2).

SLOs derive from warm-request latencies: global TTFT SLO = 5x warm TTFT,
TPOT SLO = 2x warm TPOT; summarization TTFT doubled; chatbot TPOT aligned to
300 wpm reading speed (= 200 ms/token).
Prompt/output length statistics approximate ShareGPT / HumanEval / LongBench.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.types import GB, SLO, ModelProfile, TimingProfile


@dataclass(frozen=True)
class WarmProfile:
    model: str
    size_bytes: int
    gpu: str
    ttft: float      # Table 1
    tpot: float


WARM = {
    "llama2-7b": WarmProfile("llama2-7b", int(12.5 * GB), "A10", 1.5, 0.042),
    "llama2-13b": WarmProfile("llama2-13b", int(24.2 * GB), "V100", 2.4, 0.058),
    "opt-6.7b": WarmProfile("opt-6.7b", int(13.3 * GB), "A10", 1.4, 0.040),
}


@dataclass(frozen=True)
class Application:
    name: str
    model: str
    slo: SLO
    mean_prompt: int
    mean_output: int
    dataset: str


# Table 2 — note the paper's per-app SLO adjustments.
APPLICATIONS = [
    Application("chatbot-7b", "llama2-7b", SLO(7.5, 0.200), 315, 240,
                "ShareGPT"),
    Application("chatbot-13b", "llama2-13b", SLO(12.0, 0.200), 315, 240,
                "ShareGPT"),
    Application("code-7b", "llama2-7b", SLO(7.5, 0.084), 150, 60,
                "HumanEval"),
    Application("code-13b", "llama2-13b", SLO(12.0, 0.116), 150, 60,
                "HumanEval"),
    Application("summ-7b", "llama2-7b", SLO(15.0, 0.084), 3000, 200,
                "LongBench"),
    Application("summ-13b", "llama2-13b", SLO(24.0, 0.116), 3000, 200,
                "LongBench"),
]


def timings_for(model: str) -> TimingProfile:
    w = WARM[model]
    return TimingProfile(t_p=w.ttft, t_d=w.tpot)


def kv_bytes_for(model: str) -> int:
    """Per-token KV footprint from the registered model geometry (fp16):
    for llama2-7b this reproduces the 512 KiB/token constant the
    simulation used to hardcode; 13B-class models pin ~1.6x that."""
    from repro_torch.configs import get_config       # paper_models registers these
    cfg = get_config(model)
    n_attn = cfg.n_periods * sum(1 for m in cfg.mixer_pattern if m == "attn")
    return ModelProfile.kv_bytes_from_geometry(n_attn, cfg.n_kv_heads,
                                               cfg.head_dim)

"""Model / shape configuration registry.

Every assigned architecture is a ``ModelConfig``; every assigned input shape
is a ``ShapeConfig``.  ``(arch x shape)`` cells drive the smoke tests, the
multi-pod dry-run and the roofline table.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

# ---------------------------------------------------------------------------
# Layer-pattern vocabulary (one period of the repeated block structure).
#   mixer:  'attn' | 'mamba' | 'rwkv'
#   mlp:    'dense' | 'moe'
# A uniform transformer has period length 1.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int                  # == n_heads for MHA; 0 for attn-free slots
    d_ff: int
    vocab: int

    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    pos_embed: str = "rope"          # 'rope' | 'learned'
    max_position: int = 1 << 19      # learned-pos table size / rope max
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0             # 0 -> d_ff
    capacity_factor: float = 1.25
    expert_sharding: str = "expert"  # 'expert' (EP over experts) | 'ffn' (TP inside expert)

    # --- hybrid / ssm ---
    mixer_pattern: Tuple[str, ...] = ("attn",)      # one period
    mlp_pattern: Tuple[str, ...] = ("dense",)       # one period (moe cadence)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    n_audio_frames: int = 1500       # stub frontend output length

    # --- vlm ---
    n_image_tokens: int = 0          # stub frontend output length

    dtype: str = "bfloat16"

    # --- serving-side metadata used by the cold-start controller ---
    # Max pipeline-parallel size Alg.1 may choose (paper default 4).
    max_pp: int = 4

    # FSDP: additionally shard weights' d_model dim over 'data' (needed for
    # archs whose TP=16 param slice exceeds one chip's HBM).
    fsdp: bool = False

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and self.expert_d_ff == 0:
            object.__setattr__(self, "expert_d_ff", self.d_ff)

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Embedding tables padded to a multiple of 256 so the vocab dim
        shards evenly on TP=16/32 (pad logits are masked in the head)."""
        return -(-self.vocab // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attn_free(self) -> bool:
        return all(m != "attn" for m in self.mixer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch supports 500k-token decode (SSM / hybrid)."""
        return any(m in ("mamba", "rwkv") for m in self.mixer_pattern)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.mixer_pattern) == 0, self.name
        return self.n_layers // len(self.mixer_pattern)

    @property
    def layer_plan(self) -> Tuple[Tuple[str, str], ...]:
        """Full per-layer (mixer, mlp) plan, length n_layers."""
        plan = []
        for _ in range(self.n_periods):
            for i, mix in enumerate(self.mixer_pattern):
                plan.append((mix, self.mlp_pattern[i % len(self.mlp_pattern)]))
        return tuple(plan)

    # ------------------------------------------------------------------
    # Parameter counting (used for fetch-time modelling and rooflines).
    # ------------------------------------------------------------------
    def param_count(self) -> int:
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = self.vocab * d                       # tok embed
        if not self.tie_embeddings:
            total += self.vocab * d                  # lm head
        total += d                                   # final norm

        def attn_params() -> int:
            p = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
            if self.qkv_bias:
                p += n_q * hd + 2 * n_kv * hd
            return p + d                             # + pre-norm

        def dense_mlp() -> int:
            return 3 * d * ff + d                    # gate/up/down + pre-norm

        def moe_mlp() -> int:
            eff = self.expert_d_ff
            p = self.n_experts * 3 * d * eff + d * self.n_experts  # experts + router
            if self.n_shared_experts:
                p += 3 * d * (eff * self.n_shared_experts)
            return p + d

        def mamba_params() -> int:
            d_in = self.mamba_expand * d
            n = self.mamba_d_state
            p = d * 2 * d_in                          # in_proj
            p += d_in * self.mamba_d_conv + d_in      # conv
            p += d_in * (n * 2 + d_in // 16) + (d_in // 16) * d_in  # x_proj + dt_proj
            p += d_in * n + d_in                      # A_log, D
            p += d_in * d                             # out_proj
            return p + d

        def rwkv_params() -> int:
            # time-mix r/k/v/g/o + data-dependent decay lora + channel-mix
            p = 5 * d * d + 2 * (d * 64 + 64 * d) + 6 * d
            return p + d

        mixer_cost = {"attn": attn_params, "mamba": mamba_params, "rwkv": rwkv_params}
        mlp_cost = {"dense": dense_mlp, "moe": moe_mlp, "none": lambda: 0}
        for mix, mlp in self.layer_plan:
            total += mixer_cost[mix]()
            total += mlp_cost[mlp]()
        if self.is_encdec:
            # encoder self-attn + dense mlp + cross-attn params in decoder
            total += self.encoder_layers * (attn_params() + dense_mlp())
            total += self.n_layers * attn_params()   # cross attention
            total += self.n_audio_frames * d         # encoder pos embed (stub side)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        d, eff = self.d_model, self.expert_d_ff
        inactive = 0
        for _, mlp in self.layer_plan:
            if mlp == "moe":
                inactive += (self.n_experts - self.top_k) * 3 * d * eff
        return self.param_count() - inactive

    def size_bytes(self, bytes_per_param: int = 2) -> int:
        return self.param_count() * bytes_per_param


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def applicable_shapes(cfg: ModelConfig):
    """Assigned-shape cells for one arch (skips recorded in DESIGN.md §5)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return [SHAPES[n] for n in names]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import side-effect registration
        from repro_torch import configs  # noqa: F401
        configs.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    from repro_torch import configs
    configs.load_all()
    return dict(_REGISTRY)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    period = len(cfg.mixer_pattern)
    n_layers = max(period, 2 if period == 1 else period)
    updates = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab=512,
        dtype="float32",
    )
    if cfg.is_moe:
        updates.update(n_experts=4, top_k=min(cfg.top_k, 2), expert_d_ff=64,
                       n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.is_encdec:
        updates.update(encoder_layers=2, n_audio_frames=8)
    if cfg.n_image_tokens:
        updates.update(n_image_tokens=4)
    if cfg.attn_free:
        updates.update(n_heads=4, n_kv_heads=0, head_dim=16)
    return dataclasses.replace(cfg, **updates)

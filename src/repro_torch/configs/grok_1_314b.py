"""grok-1-314b [moe] — 8 experts, top-2. [hf:xai-org/grok-1; unverified]

Only 8 (large) experts: shard the expert FFN dim over `model` (TP inside
expert) instead of EP, which would leave half the axis idle.
314B never fits one host -> Alg.1 is allowed a deeper pipeline (max_pp=8)
and consolidation targets the min-PP warm configuration (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    top_k=2,
    expert_d_ff=32768,
    expert_sharding="ffn",
    mlp_pattern=("moe",),
    max_pp=8,
    fsdp=True,
))

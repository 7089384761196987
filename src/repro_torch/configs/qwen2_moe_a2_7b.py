"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

60 experts don't divide TP=16, so the baseline shards the expert FFN dim
(1408/16=88); the §Perf hillclimb evaluates padding 60->64 experts for EP.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    qkv_bias=True,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    expert_d_ff=1408,
    expert_sharding="ffn",
    mlp_pattern=("moe",),
))

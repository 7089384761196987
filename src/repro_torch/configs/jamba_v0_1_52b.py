"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887; hf]

Period of 8 layers: attention at slot 4, Mamba elsewhere; MoE on odd slots.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    top_k=2,
    expert_d_ff=14336,
    expert_sharding="expert",
    mixer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    mlp_pattern=("dense", "moe"),
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    fsdp=True,
))

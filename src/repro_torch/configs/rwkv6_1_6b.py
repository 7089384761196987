"""rwkv6-1.6b [ssm] — Finch, attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]

head_size=64 -> 32 heads over d_model=2048.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=0,
    head_dim=64,
    d_ff=7168,
    vocab=65536,
    mixer_pattern=("rwkv",),
))

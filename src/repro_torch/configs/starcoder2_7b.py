"""starcoder2-7b [dense] — GQA, RoPE. [arXiv:2402.19173; hf]

36 query heads: not divisible by TP=16 — GSPMD pads the head dim
(see DESIGN.md §5 and the roofline notes).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
))

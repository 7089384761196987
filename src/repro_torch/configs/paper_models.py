"""Models the paper itself evaluates (Fig. 8, Table 1): Llama2-7B/13B and
OPT-6.7B. Used by the cold-start benchmarks for byte-size fidelity
(Llama2-7B FP16 = 12.5 GB, Llama2-13B = 24.2 GB)."""

from repro_torch.configs.base import ModelConfig, register

LLAMA2_7B = register(ModelConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=32000,
))

LLAMA2_13B = register(ModelConfig(
    name="llama2-13b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=13824,
    vocab=32000,
))

OPT_6_7B = register(ModelConfig(
    name="opt-6.7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=16384,
    vocab=50272,
))

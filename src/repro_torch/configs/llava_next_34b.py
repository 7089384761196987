"""llava-next-34b [vlm] — transformer backbone only; anyres vision tower is a
STUB: ``input_specs()`` provides precomputed patch embeddings.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    n_image_tokens=576,
    fsdp=True,
))

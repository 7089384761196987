"""whisper-small [audio] — encoder-decoder backbone; conv frontend is a STUB
(``input_specs()`` provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,             # decoder layers
    encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    n_audio_frames=1500,
    pos_embed="learned",
    max_position=32_768,
))

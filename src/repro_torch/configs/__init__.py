"""Architecture configs: a copy of every config the reference registers
(the port serves all but the encoder-decoder whisper-small; llava's image
prefix is refused at ``Engine.submit``), and the paper's own
llama2-7b/13b and opt-6.7b, whose geometry the fleet's workload presets
read. ``load_all()`` imports every arch module so that
``get_config(name)`` can resolve by name."""

import importlib

_ARCH_MODULES = [
    "granite_3_8b",
    "internlm2_20b",
    "starcoder2_7b",
    "qwen1_5_32b",
    "qwen2_moe_a2_7b",
    "grok_1_314b",
    "llava_next_34b",
    "whisper_small",
    "jamba_v0_1_52b",
    "rwkv6_1_6b",
    "paper_models",
]

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True


from repro_torch.configs.base import (  # noqa: E402,F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    applicable_shapes,
    get_config,
    list_configs,
    smoke_variant,
)

"""Architecture configs (the port's slices: granite-3-8b, rwkv6-1.6b; and
the paper's own llama2-7b/13b and opt-6.7b, whose geometry the fleet's
workload presets read).
``load_all()`` imports every arch module so that ``get_config(name)`` can
resolve by name."""

import importlib

_ARCH_MODULES = [
    "granite_3_8b",
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

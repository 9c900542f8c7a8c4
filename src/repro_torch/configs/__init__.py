"""Config registry of the port: ``get_config(arch_id)``."""
from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3_moe

REGISTRY = {c.name: c for c in (_qwen3_moe,)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}' (the port has: "
                       f"{', '.join(sorted(REGISTRY))})")
    return REGISTRY[name]

"""Config registry of the port: ``get_config(arch_id)`` / ``list_archs()``,
the reference's registry: the 10 assigned architectures and the paper's
own evaluation models."""
from repro_torch.configs.base import ModelConfig, ShapeConfig, \
    applicable  # noqa: F401
from repro_torch.configs.shapes import SHAPES, get_shape  # noqa: F401

from repro_torch.configs.qwen2_1_5b import CONFIG as _qwen2_1_5b
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2_15b
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2_72b
from repro_torch.configs.smollm_360m import CONFIG as _smollm_360m
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2_2_7b
from repro_torch.configs.internvl2_1b import CONFIG as _internvl2_1b
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6_3b
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3_moe
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless
from repro_torch.configs import paper_models

# the reference's assigned pool
ASSIGNED = {
    c.name: c
    for c in (_qwen2_1_5b, _starcoder2_15b, _qwen2_72b, _smollm_360m,
              _zamba2_2_7b, _internvl2_1b, _rwkv6_3b, _qwen3_moe, _dbrx,
              _seamless)
}

# the paper's own evaluation models (serving benchmarks)
PAPER = {
    c.name: c
    for c in (paper_models.MIXTRAL_8X7B, paper_models.GPT_OSS_20B,
              paper_models.QWEN3_30B_A3B, paper_models.SCALED_MOE)
}

REGISTRY = {**ASSIGNED, **PAPER}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs(assigned_only: bool = True):
    return sorted(ASSIGNED if assigned_only else REGISTRY)


__all__ = ["ModelConfig", "ShapeConfig", "applicable", "SHAPES", "get_shape",
           "get_config", "list_archs", "ASSIGNED", "PAPER", "REGISTRY"]

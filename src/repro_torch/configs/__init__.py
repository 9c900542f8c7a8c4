"""Config registry of the port: ``get_config(arch_id)`` / ``list_archs()``,
the reference's registry cut to the families the port serves (dense, moe,
vlm). The ssm, hybrid and audio configs come with their families (ROADMAP
A7d)."""
from repro_torch.configs.base import ModelConfig  # noqa: F401

from repro_torch.configs.qwen2_1_5b import CONFIG as _qwen2_1_5b
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2_15b
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2_72b
from repro_torch.configs.smollm_360m import CONFIG as _smollm_360m
from repro_torch.configs.internvl2_1b import CONFIG as _internvl2_1b
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3_moe
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs import paper_models

# the reference's assigned pool, less its ssm / hybrid / audio configs
ASSIGNED = {
    c.name: c
    for c in (_qwen2_1_5b, _starcoder2_15b, _qwen2_72b, _smollm_360m,
              _internvl2_1b, _qwen3_moe, _dbrx)
}

# the paper's own evaluation models (serving benchmarks)
PAPER = {
    c.name: c
    for c in (paper_models.MIXTRAL_8X7B, paper_models.GPT_OSS_20B,
              paper_models.QWEN3_30B_A3B, paper_models.SCALED_MOE)
}

REGISTRY = {**ASSIGNED, **PAPER}

# the reference's configs whose families the port does not serve yet
UNPORTED = {"rwkv6-3b": "ssm", "zamba2-2.7b": "hybrid",
            "seamless-m4t-large-v2": "audio"}


def get_config(name: str) -> ModelConfig:
    if name in UNPORTED:
        raise KeyError(f"arch {name!r}: the {UNPORTED[name]} family is not "
                       f"ported yet (ROADMAP A7d)")
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs(assigned_only: bool = True):
    return sorted(ASSIGNED if assigned_only else REGISTRY)


__all__ = ["ModelConfig", "get_config", "list_archs", "ASSIGNED", "PAPER",
           "REGISTRY", "UNPORTED"]

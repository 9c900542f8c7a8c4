"""Model configuration of the port: the fields of the reference's
``ModelConfig`` that the disaggregated MoE serving path reads, with the
same defaults and the same ``reduced()`` rule (a tiny same-family config
for CPU tests)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # the port serves "moe"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    gated_mlp: bool = True
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    sliding_window: int = 0  # 0 = full attention
    lora_rank: int = 64
    lora_targets: Tuple[str, ...] = ("q", "k", "v", "o", "gate", "up", "down")
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads must be a multiple of "
                             f"n_kv_heads")

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256, as the reference's embedding tables."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's rule)."""
        changes = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=(min(self.n_kv_heads, 2)
                        if self.n_kv_heads < self.n_heads else 4),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
        )
        if self.is_moe:
            changes.update(n_experts=4, top_k=2)
        return dataclasses.replace(self, **changes)

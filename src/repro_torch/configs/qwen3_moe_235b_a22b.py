"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-235B-A22B]: 128 experts top-8 with
fine-grained experts (d_ff=1536 per expert), LoRA rank 32 as in the paper
(Table 3). The same numbers as the reference's config of this name."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    n_experts=128, top_k=8, rope_theta=1_000_000.0,
    lora_rank=32,
    lora_targets=("q", "k", "v", "o", "gate", "up", "down"),
)

"""DBRX-132B [hf:databricks/dbrx-base] — MoE 16 experts top-4, fine-grained.
Also one of the paper's own eval models (Table 3, rank 64)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    n_experts=16, top_k=4, rope_theta=500_000.0,
    lora_rank=64,
)

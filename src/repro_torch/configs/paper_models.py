"""The paper's own evaluation models (Table 3) not already in the assigned
pool. Used by the serving benchmarks to reproduce Figs 11-14 / Tables 3-4.
(DBRX is shared with the assigned pool — see dbrx_132b.py.)"""
from repro_torch.configs.base import ModelConfig

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    n_experts=8, top_k=2, rope_theta=1_000_000.0,
    lora_rank=64,
)

GPT_OSS_20B = ModelConfig(
    name="gpt-oss-20b", family="moe",
    n_layers=24, d_model=2880, n_heads=64, n_kv_heads=8, head_dim=64,
    d_ff=2880, vocab_size=201088,
    n_experts=32, top_k=4, rope_theta=150_000.0,
    lora_rank=64,
)

QWEN3_30B_A3B = ModelConfig(
    name="qwen3-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936,
    n_experts=128, top_k=8, rope_theta=1_000_000.0,
    lora_rank=32,  # paper: reduced rank for fine-grained expert structure
)

SCALED_MOE = ModelConfig(
    name="scaled-moe", family="moe",
    n_layers=18, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=65536,
    n_experts=32, top_k=4, rope_theta=500_000.0,
    lora_rank=64,
)

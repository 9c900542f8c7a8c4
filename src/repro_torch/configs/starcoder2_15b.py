"""StarCoder2-15B [arXiv:2402.19173] — dense, GQA, RoPE, attention bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152,
    qkv_bias=True, rope_theta=100_000.0, gated_mlp=False,
    lora_rank=64,
    lora_targets=("q", "k", "v", "o", "up", "down"),
)

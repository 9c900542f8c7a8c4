"""Zamba2-2.7B [arXiv:2411.15242]: hybrid, a Mamba2 backbone with one
weight-shared attention + MLP block applied every 6 mamba layers; the
shared block attends over a 4096-token sliding window. The same numbers
as the reference's config of this name."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    shared_attn_every=6, sliding_window=4096,
    lora_rank=64,
    lora_targets=("q", "k", "v", "o", "gate", "up", "down", "ssm_in",
                  "ssm_out"),
)

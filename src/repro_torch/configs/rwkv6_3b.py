"""RWKV-6 (Finch) 3B [arXiv:2404.05892]: attention-free linear attention
with a data-dependent decay; O(1) recurrent state. The same numbers as
the reference's config of this name."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", rwkv=True,
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    lora_rank=64,
    lora_targets=("r", "k", "v", "o", "ck", "cv"),
)

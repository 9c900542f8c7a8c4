"""SeamlessM4T-large-v2 [arXiv:2308.11596]: audio encoder-decoder. The
speech frontend is a stub (callers pass frame embeddings); the backbone is
24 encoder + 24 decoder layers, MHA (kv == heads). The same numbers as
the reference's config of this name."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, n_enc_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206,
    frontend="audio", frontend_tokens=4096, cross_kv_len=4096,
    lora_rank=64,
)

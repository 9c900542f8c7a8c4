"""InternVL2-1B [arXiv:2404.16821] — VLM: InternViT frontend (a stub: the
fields are data only, the slot engine serves the text tokens) +
Qwen2-0.5B-class LM backbone."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151655,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
    frontend="vit", frontend_tokens=256,
    lora_rank=64,
)

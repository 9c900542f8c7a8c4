"""Model configuration of the port: the fields of the reference's
``ModelConfig`` that the slot families (dense, moe, vlm) read, with the
same defaults and the same ``reduced()`` rule (a tiny same-family config
for CPU tests), and the parameter and adapter accounting the cost model,
provisioning and the simulator price with. The ssm, hybrid and audio
families, and their fields, come with ROADMAP A7d."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

BYTES = {"bfloat16": 2, "float32": 4, "int8": 1, "float16": 2}
# the families the slot engine serves (the reference's ``SLOT_FAMILIES``)
SLOT_FAMILIES = ("dense", "moe", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # the port serves dense | moe | vlm
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
    # modality frontend stub: data only (the slot engine ignores it)
    frontend: str = ""  # "vit" | ""
    frontend_tokens: int = 0
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

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    # ---------------------------- accounting --------------------------- #
    def _need_slot_family(self, what: str) -> None:
        if self.family not in SLOT_FAMILIES:
            raise ValueError(f"{self.name}: {what} of the {self.family!r} "
                             f"family is not ported yet (ROADMAP A7d)")

    def param_count(self) -> int:
        """Total parameter count: embeddings, lm head, final norm and per
        layer the attention, two norms and the MLP (dense, vlm: 3 matrices
        gated, 2 not) or the router and the experts (moe: 3 matrices
        each)."""
        self._need_slot_family("param_count")
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.qkv_bias:
            attn += (H + 2 * KV) * hd
        emb = V * d
        head = 0 if self.tie_embeddings else V * d
        norms = 2 * d
        if self.family == "moe":
            ffn = d * self.n_experts + self.n_experts * 3 * d * ff
        else:
            ffn = (3 if self.gated_mlp else 2) * d * ff
        return emb + head + d + self.n_layers * (attn + ffn + norms)

    def active_param_count(self) -> int:
        """Parameters a token activates (top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_experts = self.n_experts * 3 * d * ff
        active_experts = self.top_k * 3 * d * ff
        return self.param_count() - self.n_layers * (dense_experts
                                                     - active_experts)

    def lora_adapter_bytes(self, rank: Optional[int] = None,
                           dtype: str = "bfloat16") -> int:
        """Device bytes of ONE adapter (paper Fig. 1a): the attention
        targets plus the FFN targets, expert-specific on a MoE."""
        self._need_slot_family("lora_adapter_bytes")
        r = rank or self.lora_rank
        d, ff = self.d_model, self.d_ff
        hd, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        per_layer = 0
        tgt = self.lora_targets
        if "q" in tgt:
            per_layer += d * r + r * H * hd
        if "k" in tgt:
            per_layer += d * r + r * KV * hd
        if "v" in tgt:
            per_layer += d * r + r * KV * hd
        if "o" in tgt:
            per_layer += H * hd * r + r * d
        e = max(self.n_experts, 1)
        if "gate" in tgt:
            per_layer += e * (d * r + r * ff)
        if "up" in tgt:
            per_layer += e * (d * r + r * ff)
        if "down" in tgt:
            per_layer += e * (ff * r + r * d)
        return per_layer * self.n_layers * BYTES[dtype]

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
        if self.frontend:
            changes.update(frontend_tokens=8)
        return dataclasses.replace(self, **changes)

"""Model configuration of the port: every field of the reference's
``ModelConfig``, with the same defaults and the same ``reduced()`` rule (a
tiny same-family config for CPU tests), and the parameter and adapter
accounting the cost model, provisioning and the simulator price with.
Families: dense | moe | vlm (served by the slot engine) and ssm (rwkv6) |
hybrid (mamba2 + a shared attention block) | audio (encoder-decoder),
which only the static-batch ``Engine.prefill`` / ``decode`` serves."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

BYTES = {"bfloat16": 2, "float32": 4, "int8": 1, "float16": 2}
# the families the slot engine serves (the reference's ``SLOT_FAMILIES``)
SLOT_FAMILIES = ("dense", "moe", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
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
    # SSM (mamba2 / rwkv6)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    rwkv: bool = False  # RWKV-6 token/channel mix instead of mamba2
    # hybrid (zamba2): one shared attention block every k mamba layers
    shared_attn_every: int = 0
    # encoder-decoder (seamless)
    n_enc_layers: int = 0
    cross_kv_len: int = 4096
    # modality frontend stub: frontend positions at the sequence's head
    frontend: str = ""  # "vit" | "audio" | ""
    frontend_tokens: int = 0
    sliding_window: int = 0  # 0 = full attention
    lora_rank: int = 64
    lora_targets: Tuple[str, ...] = ("q", "k", "v", "o", "gate", "up", "down")
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) and not self.rwkv:
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

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def attention_free(self) -> bool:
        """True when no layer does full softmax attention over the context."""
        return self.family == "ssm" and self.rwkv or (
            self.family == "ssm" and self.shared_attn_every == 0)

    @property
    def sub_quadratic(self) -> bool:
        """The ssm and hybrid families (linear in the context)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    # ---------------------------- accounting --------------------------- #
    def param_count(self) -> int:
        """Total parameter count of the ``param_specs`` tree: embeddings, lm
        head, final norm and per layer
          dense, vlm : attention, 2 norms, MLP (3 matrices gated, 2 not)
          moe        : attention, 2 norms, router, experts (3 each)
          ssm (rwkv) : time mix (r, k, v, g, o, decay lora), channel mix,
                       2 norms
          hybrid     : a mamba2 layer each, plus one shared dense block
          audio      : a dense layer per encoder and decoder layer, plus
                       a cross attention and its norm per decoder layer"""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.qkv_bias:
            attn += (H + 2 * KV) * hd
        norms = 2 * d
        dense_layer = attn + (3 if self.gated_mlp else 2) * d * ff + norms
        total = V * d + (0 if self.tie_embeddings else V * d) + d
        fam = self.family
        if fam in ("dense", "vlm"):
            return total + self.n_layers * dense_layer
        if fam == "moe":
            experts = d * self.n_experts + self.n_experts * 3 * d * ff
            return total + self.n_layers * (attn + experts + norms)
        if fam == "ssm" and self.rwkv:
            time_mix = 5 * d * d + 2 * d * 64 + 64 * d
            channel_mix = 2 * d * ff + d * d
            return total + self.n_layers * (time_mix + channel_mix + norms)
        if fam == "hybrid":
            di, N = self.d_inner, self.ssm_state
            nh = di // self.ssm_head_dim
            mamba = (d * (2 * di + 2 * N + nh) + self.ssm_conv * (di + 2 * N)
                     + di * d + nh * 2 + d)
            return total + self.n_layers * mamba + dense_layer
        if fam == "audio":
            return (total + (self.n_layers + self.n_enc_layers) * dense_layer
                    + self.n_layers * (attn + norms))
        raise ValueError(fam)

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
        targets plus the FFN targets, expert-specific on a MoE, over the
        decoder's and the encoder's layers (the reference counts no ssm
        target)."""
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
        return per_layer * (self.n_layers + self.n_enc_layers) * BYTES[dtype]

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
        if self.is_ssm:
            changes.update(ssm_state=16, ssm_head_dim=32)
        if self.shared_attn_every:
            changes.update(shared_attn_every=1, n_layers=2)
        if self.is_encdec:
            changes.update(n_enc_layers=2, cross_kv_len=32)
        if self.frontend:
            changes.update(frontend_tokens=8)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the reference's four (``configs/shapes.py``)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


def applicable(arch: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell; else the reason to
    SKIP (the reference's)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, ("full-attention arch: 500k dense-KV decode is the "
                       "quadratic case long_500k excludes (DESIGN.md §5)")
    return True, ""

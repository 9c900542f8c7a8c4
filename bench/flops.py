"""The yardstick's arithmetic: the chip's published peaks and the model
flops a window's work needs, counted from the configuration and the
traffic alone, so they read the same whatever implements them.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity (the
copy of ``repro_torch.analysis.roofline``'s constants).

Model flops, 2 per multiply-add of a plain forward:
  - each matrix product's weights a token uses: the attention projections,
    the router, its top_k experts' three products, and, for an output
    token, the lm head (the embedding is a lookup and counts nothing);
  - a served token's adapter factors at the adapter's true rank (gate, up
    and down of each of its experts);
  - attention: 4 * n_heads * head_dim * (context length) a token a layer
    (q k and p v).
A prompt token is prefilled without adapters; the last prompt token is
the first decode input. The prefill needs no output of the last layer's
experts for a prompt token, so they are not counted there.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s, H100 SXM
HBM_BW = 3.35e12         # B/s, H100 SXM


def _attn_proj(m) -> int:
    d, H, KV, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], \
        m["head_dim"]
    return d * H * hd + 2 * d * KV * hd + H * hd * d


def _experts(m) -> int:
    return m["top_k"] * 3 * m["d_model"] * m["d_ff"]


def _lora(m, rank: int) -> int:
    d, ff = m["d_model"], m["d_ff"]
    return m["top_k"] * rank * (2 * (d + ff) + (ff + d))


def prefill_flops(m, n_tokens: int, start: int = 0) -> float:
    """Prefilling ``n_tokens`` prompt positions start..start+n-1 (no lm
    head, no adapter, the last layer's experts skipped)."""
    L = m["n_layers"]
    ctx = n_tokens * start + n_tokens * (n_tokens + 1) / 2
    per_tok = L * (_attn_proj(m) + m["d_model"] * m["n_experts"]) \
        + (L - 1) * _experts(m)
    return 2.0 * per_tok * n_tokens \
        + 4.0 * m["n_heads"] * m["head_dim"] * L * ctx


def decode_flops(m, position: int, rank: int) -> float:
    """One served token fed at ``position`` (its context is position + 1
    keys) under an adapter of true rank ``rank``."""
    L = m["n_layers"]
    per_tok = L * (_attn_proj(m) + m["d_model"] * m["n_experts"]
                   + _experts(m) + _lora(m, rank)) \
        + m["d_model"] * m["vocab_size"]
    return 2.0 * per_tok + 4.0 * m["n_heads"] * m["head_dim"] * L \
        * (position + 1)

"""Chunked prefill of the slot engine, the counterpart of
``repro.models.transformer.prefill_chunk`` for the moe family: plain torch
operations, LoRA-free (under prefill/decode disaggregation prefill runs on
LoRA-free instances, paper footnote 1)."""
from __future__ import annotations

import torch

from repro_torch.models import layers as ll
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import layer_params


def prefill_chunk(params, cfg, tokens, k_ctx, v_ctx):
    """One prefill chunk attending over the previously cached KV.

    tokens: (B, C); k_ctx/v_ctx: (L, B, S_ctx, KV, hd) the earlier chunks'
    KV (S_ctx sets the position offset and may be 0). Returns (k_chunk,
    v_chunk), each (L, B, C, KV, hd) post-RoPE, position-for-position what
    a monolithic forward over the whole prompt would cache. The last
    layer's MoE is skipped: no returned KV depends on it."""
    if cfg.family != "moe":
        raise ValueError(f"the port's prefill serves moe, not {cfg.family}")
    x = ll.embed(tokens, params["embed"])
    B, C, _ = x.shape
    pos0 = k_ctx.shape[2]
    positions = (pos0 + torch.arange(C, device=x.device)).expand(B, C)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        lp = layer_params(params["layers"], l)
        h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = ll.qkv_project(h, lp["attn"], cfg)
        q = ll.apply_rope(q, positions, cfg.rope_theta)
        k = ll.apply_rope(k, positions, cfg.rope_theta)
        k_full = torch.cat([k_ctx[l].to(k.dtype), k], dim=1)
        v_full = torch.cat([v_ctx[l].to(v.dtype), v], dim=1)
        attn = ll.causal_attention(q, k_full, v_full, causal=True,
                                   window=cfg.sliding_window, q_offset=pos0)
        x = x + ll.out_project(attn, lp["attn"])
        ks.append(k)
        vs.append(v)
        if l + 1 < cfg.n_layers:
            h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + moe_mod.moe_local(h, lp["moe"], cfg)
    return torch.stack(ks), torch.stack(vs)

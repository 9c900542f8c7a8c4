"""The slot engine's model steps for the slot families (dense, moe, vlm),
the counterpart of ``repro.models.transformer``: LoRA-free chunked prefill
(under prefill/decode disaggregation prefill runs on LoRA-free instances,
paper footnote 1) and the coupled (S-LoRA) decode step, which applies the
adapters inside the model: q/k/v/o deltas through ``ops.bgmv``, expert
deltas through ``moe.moe_block`` (moe) and the MLP's gate/up/down deltas
through ``ops.bgmv`` (``_mlp_with_lora``; dense, vlm). Each decode layer
writes its token's KV into a paged pool or a dense slab.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SLOT_FAMILIES
from repro_torch.kernels import ops
from repro_torch.models import layers as ll
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import layer_params


# ------------------------- LoRA helper (coupled) ------------------------ #
def _delta(xf, lora_layer, name, ids_tok, scale):
    """One target's per-row delta ops.bgmv(xf, A, B, ids) * scale in f32,
    or None if the layer has no adapter for it."""
    if lora_layer is None or name not in lora_layer:
        return None
    ab = lora_layer[name]
    return ops.bgmv(xf, ab["A"], ab["B"], ids_tok) * scale


def _mlp_with_lora(h, mp, cfg, lora_layer, ids_tok, scale):
    """The dense MLP with its gate/up/down adapters (the reference's exact
    multi-LoRA MLP). h: (B, S, d). Each delta is added in f32: gate's and
    up's to their f32 products before the activation, down's to the f32
    output before the final cast."""
    if lora_layer is None or not any(n in lora_layer
                                     for n in ("gate", "up", "down")):
        return ll.mlp(h, mp, cfg)
    B, S, d = h.shape
    xf = h.reshape(-1, d)

    def with_delta(base, name):
        dlt = _delta(xf, lora_layer, name, ids_tok, scale)
        return base if dlt is None else base + dlt.reshape(base.shape)

    g = with_delta(ll.mm_f32(h, mp["gate"]), "gate") if cfg.gated_mlp \
        else None
    act = ll.mlp_act(g, with_delta(ll.mm_f32(h, mp["up"]), "up"), cfg,
                     h.dtype)
    y = ll.mm_f32(act, mp["down"])
    dlt = _delta(act.reshape(B * S, -1), lora_layer, "down", ids_tok, scale)
    if dlt is not None:
        y = y + dlt.reshape(y.shape)
    return y.to(h.dtype)


def _check_family(cfg, what: str) -> None:
    if cfg.family not in SLOT_FAMILIES:
        raise ValueError(f"{what} supports attention LMs "
                         f"({', '.join(SLOT_FAMILIES)}), not {cfg.family} "
                         f"(ROADMAP A7d)")


# ------------------------------ decode ---------------------------------- #
def attn_decode_slots(x, lp, cfg, positions, pos_vec, k_l, v_l, block_table,
                      lora_layer=None, ids_tok=None, lora_scale=1.0):
    """The attention half of one decode layer: rms_norm -> q/k/v (+ their
    deltas) -> RoPE -> this token's KV write + attention -> out projection
    (+ its delta) -> residual. x: (B, 1, d); k_l/v_l: one layer's paged
    pool (P, page_size, KV, hd) when ``block_table`` (B, nb) is given, else
    its dense rows (B, S, KV, hd); both are written in place.

    Deltas round where the reference rounds: each is cast to its target's
    dtype before the add."""
    B = x.shape[0]
    h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = ll.qkv_project(h, lp["attn"], cfg)
    if lora_layer is not None:
        xf = h.reshape(B, -1)
        qkv = []
        for name, t in (("q", q), ("k", k), ("v", v)):
            dlt = _delta(xf, lora_layer, name, ids_tok, lora_scale)
            qkv.append(t if dlt is None else
                       t + dlt.reshape(t.shape).to(t.dtype))
        q, k, v = qkv
    q = ll.apply_rope(q, positions, cfg.rope_theta)
    k = ll.apply_rope(k, positions, cfg.rope_theta)
    if block_table is None:
        att, _, _ = ll.decode_attention_update_slots(
            q[:, 0], k[:, 0], v[:, 0], k_l, v_l, pos_vec,
            window=cfg.sliding_window)
    else:
        att, _, _ = ll.decode_attention_update_slots_paged(
            q[:, 0], k[:, 0], v[:, 0], k_l, v_l, block_table, pos_vec,
            window=cfg.sliding_window)
    att = att[:, None]                                      # (B, 1, H, hd)
    y = ll.out_project(att, lp["attn"])
    dlt = _delta(att.reshape(B, -1), lora_layer, "o", ids_tok, lora_scale)
    if dlt is not None:
        y = y + dlt.reshape(y.shape).to(y.dtype)
    return x + y


def decode_step_slots(params, cfg, k_cache, v_cache, tokens, pos_vec,
                      lora_ctx=None, *, block_table=None):
    """One coupled decode token for a batch of engine slots.

    tokens: (B, 1); pos_vec: (B,) int32 position of this token per slot
    (-1 = inactive row: no cache write, garbage logits); k_cache/v_cache:
    paged pools (L, n_pages, page_size, KV, hd) with ``block_table``
    (B, nb), or dense rows (L, B, S, KV, hd) without; written in place.
    ``lora_ctx`` (``AdapterPool.lora_ctx``): adapter stacks, per-row int32
    ids (-1 = no delta) and the scale. Returns (logits (B, Vp) f32,
    k_cache, v_cache)."""
    _check_family(cfg, "slot decode")
    # the pool's layer-stacked factors {target: {A, B}}; a port pool holds
    # only the targets of a slot family, so none needs filtering out
    stack = lora_ctx["adapters"] if lora_ctx is not None else None
    ids_tok = lora_ctx["ids"] if lora_ctx is not None else None
    scale = lora_ctx["scale"] if lora_ctx is not None else 1.0
    x = ll.embed(tokens, params["embed"])
    positions = pos_vec.clamp_min(0)[:, None]
    for l in range(cfg.n_layers):
        lp = layer_params(params["layers"], l)
        lora_layer = layer_params(stack, l) if stack is not None else None
        x = attn_decode_slots(x, lp, cfg, positions, pos_vec, k_cache[l],
                              v_cache[l], block_table, lora_layer, ids_tok,
                              scale)
        h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
        if cfg.is_moe:
            y = moe_mod.moe_block(h, lp["moe"], cfg, lora=lora_layer,
                                  ids_tok=ids_tok, lora_scale=scale)
        else:
            y = _mlp_with_lora(h, lp["mlp"], cfg, lora_layer, ids_tok, scale)
        x = x + y
    x = ll.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = ll.unembed(x, params.get("lm_head", params["embed"]))
    return logits[:, 0], k_cache, v_cache


# ------------------------------ prefill --------------------------------- #
def prefill_chunk(params, cfg, tokens, k_ctx, v_ctx):
    """One prefill chunk attending over the previously cached KV.

    tokens: (B, C); k_ctx/v_ctx: (L, B, S_ctx, KV, hd) the earlier chunks'
    KV (S_ctx sets the position offset and may be 0). Returns (k_chunk,
    v_chunk), each (L, B, C, KV, hd) post-RoPE, position-for-position what
    a monolithic forward over the whole prompt would cache. The last
    layer's MoE or MLP is skipped: no returned KV depends on it."""
    _check_family(cfg, "chunked prefill")
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
            x = x + (moe_mod.moe_block(h, lp["moe"], cfg) if cfg.is_moe
                     else ll.mlp(h, lp["mlp"], cfg))
    return torch.stack(ks), torch.stack(vs)

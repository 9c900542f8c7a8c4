"""Client-side disaggregated LoRA execution (paper §3 / Fig. 7), the
counterpart of ``repro.core.disagg`` for the slot engine.

The LLM instance stays LoRA-free; at each MoE layer's two hook points the
activated (token, expert) rows go to the LoRA Server and the deltas are
added to the locally computed base GEMM outputs:

    g, u  = x W_g, x W_u
    dg,du = server.compute("up",   l, x-rows)
    h     = silu(g + dg) * (u + du)
    y     = h W_d + server.compute("down", l, h-rows)

``server`` needs only the ``compute(hook, layer, rows, adapter_ids,
expert_ids)`` contract. Under a mesh the params hold the expert weights
in blocks (``distributed.steps.shard_serve_params``) and the three base
expert GEMMs run expert-parallel (``moe.expert_gmm``): a pure map over
blocks of experts with no collective, so the tokens are those of one
device, bit for bit.

Two decode steps share one MoE hook body (``_moe_hooks_layer``), so both
stay token-identical to the coupled path: ``disagg_decode_step_slots``
(the slot engine, per-slot positions) and ``disagg_decode_step`` (the
legacy static batch, one shared position).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as ll
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer
from repro_torch.models.model import layer_params


def _moe_hooks_layer(x, lp, cfg, l: int, server, adapter_ids,
                     lora_scale: float):
    """One MoE layer with the two server hook points. x: (B, 1, d) residual
    after attention; adapter_ids: (B,) global ids (-1 rows get no delta).
    Expert weights held in blocks run their GEMMs expert-parallel."""
    B = x.shape[0]
    E, K, d = cfg.n_experts, cfg.top_k, cfg.d_model
    h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
    xf = h.reshape(-1, d)
    T = xf.shape[0]
    ids, wts = moe_mod.route(xf, lp["moe"]["router"], E, K)
    # the coupled path's dropless threshold: both paths drop alike
    C = moe_mod.capacity(T, K, E, cfg.capacity_factor,
                         dropless=(T * K <= 4096))
    xe, slot_tok, pair_slot, sizes = moe_mod.dispatch(xf, ids, C, E)
    rows = xe.reshape(E * C, d)
    row_expert = torch.arange(E * C, dtype=torch.int32, device=x.device) // C
    row_adapter = torch.where(slot_tok < T,
                              adapter_ids[slot_tok.clamp(max=T - 1)], -1)

    # hook 1: up/gate, base GEMMs on the client + server delta; the base
    # GEMMs skip each expert's pad rows (ops.gmm, as moe.expert_ffn)
    mp = lp["moe"]
    g = moe_mod.expert_gmm(xe, mp["gate"], sizes)
    u = moe_mod.expert_gmm(xe, mp["up"], sizes)
    d_up = server.compute("up", l, rows, row_adapter, row_expert)
    d_up = d_up.reshape(E, C, -1) * lora_scale
    dg, du = d_up.chunk(2, dim=-1)
    act = (F.silu(g + dg) * (u + du)).to(x.dtype)

    # hook 2: down
    y = moe_mod.expert_gmm(act, mp["down"], sizes)
    d_dn = server.compute("down", l, act.reshape(E * C, -1), row_adapter,
                          row_expert)
    y = y + d_dn.reshape(E, C, -1) * lora_scale

    out = moe_mod.combine(y.reshape(E * C, -1), pair_slot, wts)
    return x + out.reshape(B, 1, d).to(x.dtype)


def disagg_decode_step_slots(params, cfg, k_cache, v_cache, tokens, pos_vec,
                             server, adapter_ids, lora_scale: float, *,
                             block_table=None):
    """Continuous-batching disaggregated decode: the client math of
    ``transformer.decode_step_slots`` without adapters, plus the server's
    deltas at the two MoE hook points.

    tokens: (B, 1); pos_vec: (B,) int32 (-1 = inactive row, whose adapter
    id must be -1 too); k_cache/v_cache: paged pools (L, n_pages,
    page_size, KV, hd) with ``block_table`` (B, nb) int32, or dense rows
    (L, B, S, KV, hd) without; written in place. Expert weights held in
    blocks (``shard_serve_params``) run expert-parallel over their devices.
    Returns (logits (B, V) f32, k_cache, v_cache)."""
    if not cfg.is_moe:
        raise ValueError("disaggregated hooks target MoE FFNs (paper Fig. 3b)")
    x = ll.embed(tokens, params["embed"])
    positions = pos_vec.clamp_min(0)[:, None]
    for l in range(cfg.n_layers):
        lp = layer_params(params["layers"], l)
        x = transformer.attn_decode_slots(x, lp, cfg, positions, pos_vec,
                                          k_cache[l], v_cache[l], block_table)
        x = _moe_hooks_layer(x, lp, cfg, l, server, adapter_ids, lora_scale)
    x = ll.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = ll.unembed(x, params.get("lm_head", params["embed"]))
    return logits[:, 0], k_cache, v_cache


def _client_attn(x, lp, cfg, pos: int, k_c, v_c, positions):
    """The static batch's LoRA-free attention half of a layer: this token's
    KV written into one layer's (B, S, KV, hd) cache IN PLACE at ``pos``
    (a host int). x: (B, 1, d) -> the residual after attention."""
    h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = ll.qkv_project(h, lp["attn"], cfg)
    q = ll.apply_rope(q, positions, cfg.rope_theta)
    k = ll.apply_rope(k, positions, cfg.rope_theta)
    att = ll.decode_attention_update(q[:, 0], k[:, 0], v[:, 0], k_c, v_c,
                                     pos, window=cfg.sliding_window)[0]
    return x + ll.out_project(att[:, None], lp["attn"])


def disagg_decode_step(params, cfg, cache, tokens, server, adapter_ids,
                       lora_scale: float):
    """One decode step of a MoE model with disaggregated LoRA, for a static
    batch (the legacy ``Engine.decode``). tokens: (B, 1); cache: a bf16
    ``cache.init_cache`` dict (its KV written in place; no int8: the
    engine refuses it); adapter_ids: (B,) int32 global ids on the device
    (-1 = no delta). Returns (logits (B, V) f32, the new cache with
    ``pos`` + 1)."""
    if not cfg.is_moe:
        raise ValueError("disaggregated hooks target MoE FFNs (paper Fig. 3b)")
    pos = int(cache["pos"])
    x = ll.embed(tokens, params["embed"])
    positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.long,
                           device=x.device)
    for l in range(cfg.n_layers):
        lp = layer_params(params["layers"], l)
        x = _client_attn(x, lp, cfg, pos, cache["k"][l], cache["v"][l],
                         positions)
        x = _moe_hooks_layer(x, lp, cfg, l, server, adapter_ids, lora_scale)
    x = ll.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = ll.unembed(x, params.get("lm_head", params["embed"]))
    return logits[:, 0], dict(cache, pos=pos + 1)

"""Model forward passes, the counterpart of ``repro.models.transformer``.

The slot engine's steps (dense, moe, vlm): LoRA-free chunked prefill
(under prefill/decode disaggregation prefill runs on LoRA-free instances,
paper footnote 1) and the coupled (S-LoRA) decode step over per-slot
positions, each decode layer writing its token's KV into a paged pool or a
dense slab.

The static batch's (every family; ``Engine.prefill`` / ``decode``): the
parallel ``forward`` (dense / moe / vlm decoder LMs, rwkv6, the zamba2
hybrid, the audio encoder-decoder) and ``decode_step``, one token at one
shared host-int position over ``cache.init_cache``'s caches.

The coupled plane applies the adapters inside the model: q/k/v/o deltas
through ``ops.bgmv``, expert deltas through ``moe.moe_block`` (moe) and
the MLP's gate/up/down deltas through ``ops.bgmv`` (``_mlp_with_lora``;
dense, vlm). The ssm, hybrid and audio families take no adapter in the
model, as in the reference.

The training plane's (``forward(kind="train")``, every family): each
layer body under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint(nothing_saveable)``: a layer keeps only its input and is
recomputed in the backward) and the chunked flash attention
(``layers.flash_attention``) in place of the prefill's.

Under active sharding rules (the SPMD steps, ``distributed.steps``) the
same code runs on this process's shards: tokens and activations are its
batch rows and sequence slice (positions offset to the slice's), the
``kind`` picks the MoE's plan, and the attention, the MLP and the MoE run
their sharded bodies (``layers``, ``moe``). The parameters are this
rank's shards of the reference's layout: each layer body gathers its own
weights first (``weights_at_use``; in a checkpointed body, again
in the recompute), and the embedding and lm head run vocab-parallel
(``layers.embed``, ``layers.unembed``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import SLOT_FAMILIES
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import active_rules, axes_of, \
    use_rules
from repro_torch.kernels import ops
from repro_torch.models import cache as cache_mod
from repro_torch.models import layers as ll
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models import model as model_mod
from repro_torch.models.model import layer_params


def weights_at_use(lp, cfg, group: str, x):
    """One layer's weights as its body computes with them
    (``model.use_layout``). ``lp`` is ``params[group]`` at one layer (its
    layer dims dropped), or the whole group where it has none. Under
    active rules each leaf is this rank's shard of the reference's layout,
    and each the layer takes whole is gathered here (``LeafUse.take``;
    called inside a checkpointed body, again in the recompute, so a
    layer's weights live for that layer only). The MoE's expert weights
    and the sequence-parallel MLP's, over activations ``x`` (B, S, d), are
    left to their bodies. Without rules, ``lp`` itself."""
    rules = active_rules()
    if rules is None:
        return lp
    B, S = x.shape[:2]
    sp = ll.mlp_sp_axes(rules, cfg, B, S)
    layout = model_mod.use_layout(cfg, rules, group, None if sp is None
                                  else tuple(a for a in sp[1:] if a))
    token_axes = sum(rules.token_layout(B, S), ())

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        leaf = layout[path]
        if leaf.body != "layer":
            return t
        return leaf.take(t, rules.mesh, token_axes,
                         f"{group}/{'/'.join(path)}")

    return walk(lp, ())


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
                         f"({', '.join(SLOT_FAMILIES)}), not {cfg.family}; "
                         f"use the legacy prefill/decode API")


def _qkv_with_deltas(h, ap, cfg, lora_layer, ids_tok, scale):
    """q (B,S,H,hd), k/v (B,S,KV,hd) of h (B, S, d) with their adapters'
    deltas, each cast to its target's dtype before the add (where the
    reference rounds); RoPE not applied."""
    q, k, v = ll.qkv_project(h, ap, cfg)
    if lora_layer is None:
        return q, k, v
    xf = h.reshape(-1, h.shape[-1])
    out = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        dlt = _delta(xf, lora_layer, name, ids_tok, scale)
        out.append(t if dlt is None else t + dlt.reshape(t.shape).to(t.dtype))
    return tuple(out)


def _out_with_delta(att, ap, lora_layer, ids_tok, scale):
    """The out projection of att (B, S, H, hd) plus its adapter's delta."""
    B, S = att.shape[:2]
    y = ll.out_project(att, ap)
    dlt = _delta(att.reshape(B * S, -1), lora_layer, "o", ids_tok, scale)
    return y if dlt is None else y + dlt.reshape(y.shape).to(y.dtype)


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
    h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv_with_deltas(h, lp["attn"], cfg, lora_layer, ids_tok,
                               lora_scale)
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
    return x + _out_with_delta(att[:, None], lp["attn"], lora_layer, ids_tok,
                               lora_scale)


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
    x = _embed(params, cfg, tokens)
    positions = pos_vec.clamp_min(0)[:, None]
    for l in range(cfg.n_layers):
        lp = weights_at_use(layer_params(params["layers"], l), cfg,
                               "layers", x)
        lora_layer = layer_params(stack, l) if stack is not None else None
        x = attn_decode_slots(x, lp, cfg, positions, pos_vec, k_cache[l],
                              v_cache[l], block_table, lora_layer, ids_tok,
                              scale)
        h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
        if cfg.is_moe:
            y = moe_mod.moe_block(h, lp["moe"], cfg, kind="decode",
                                  lora=lora_layer, ids_tok=ids_tok,
                                  lora_scale=scale)
        else:
            y = _mlp_with_lora(h, lp["mlp"], cfg, lora_layer, ids_tok, scale)
        x = x + y
    return _logits(params, cfg, x)[:, 0], k_cache, v_cache


# ------------------------------ prefill --------------------------------- #
def prefill_chunk(params, cfg, tokens, k_ctx, v_ctx):
    """One prefill chunk attending over the previously cached KV.

    tokens: (B, C); k_ctx/v_ctx: (L, B, S_ctx, KV, hd) the earlier chunks'
    KV (S_ctx sets the position offset and may be 0). Returns (k_chunk,
    v_chunk), each (L, B, C, KV, hd) post-RoPE, position-for-position what
    a monolithic forward over the whole prompt would cache. The last
    layer's MoE or MLP is skipped: no returned KV depends on it."""
    _check_family(cfg, "chunked prefill")
    x = _embed(params, cfg, tokens)
    B, C, _ = x.shape
    pos0 = k_ctx.shape[2]
    positions = (pos0 + torch.arange(C, device=x.device)).expand(B, C)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        lp = weights_at_use(layer_params(params["layers"], l), cfg,
                               "layers", x)
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
            x = x + (moe_mod.moe_block(h, lp["moe"], cfg, kind="decode")
                     if cfg.is_moe else ll.mlp(h, lp["mlp"], cfg))
    return torch.stack(ks), torch.stack(vs)


# ===================== the static batch (every family) ================= #
def _lora_parts(lora_ctx, seq: int = 1):
    """(layer-stacked factors, per-token ids, scale) of a ``lora_ctx``;
    each row's id repeated over its ``seq`` tokens."""
    if lora_ctx is None:
        return None, None, 1.0
    ids = lora_ctx["ids"]
    if seq > 1:
        ids = ids.repeat_interleave(seq)
    return lora_ctx["adapters"], ids, lora_ctx["scale"]


def attn_block(x, ap, cfg, positions, *, causal=True, window=0,
               kv_override=None, rope=True, lora_layer=None, ids_tok=None,
               lora_scale=1.0, train=False):
    """x: (B, S, d) -> (y (B, S, d), (k, v) post-RoPE for caching).
    ``kv_override``: the (k, v) to attend over instead (cross attention,
    no mask); only q is then used from x. ``train``: the flash attention
    with its chunked backward."""
    q, k, v = _qkv_with_deltas(x, ap, cfg, lora_layer, ids_tok, lora_scale)
    if rope:
        q = ll.apply_rope(q, positions, cfg.rope_theta)
        k = ll.apply_rope(k, positions, cfg.rope_theta)
    attention = ll.flash_attention if train else ll.causal_attention
    if kv_override is not None:
        k, v = kv_override
        attn = attention(q, k, v, causal=False)
    else:
        attn = attention(q, k, v, causal=causal, window=window)
    return _out_with_delta(attn, ap, lora_layer, ids_tok, lora_scale), (k, v)


def _seq_shard(B: int, S: int):
    """(mesh, seq axes, this rank's first position) of activations of local
    shape (B, S) under the active rules, or None where the sequence is
    whole here."""
    rules = active_rules()
    if rules is None:
        return None
    ax = rules.token_layout(B, S)[1]
    if rules.size(ax) == 1:
        return None
    return rules.mesh, ax, rules.mesh.coord(ax) * S


def _positions(B: int, S: int, device):
    """The positions of (B, S) activations: 0..S-1, or this rank's slice
    of the sequence under sequence parallelism."""
    shard = _seq_shard(B, S)
    p0 = shard[2] if shard is not None else 0
    return (p0 + torch.arange(S, device=device)).expand(B, S)


def _check_frontend(batch: int, seq: int) -> None:
    """A frontend's positions lie ahead of the text's: with the sequence
    (local (batch, seq), the frontend's rows and the text's) sharded,
    each rank's slice of the joined sequence is not its two slices
    joined, so that layout is refused."""
    if _seq_shard(batch, seq) is not None:
        raise NotImplementedError(
            "a frontend (frontend_emb) under sequence parallelism: shard the "
            "batch only (rules whose 'seq' is None)")


def _remat(train: bool, fn, *args):
    """``fn(*args)``; when training with autograd on, under a
    non-reentrant ``checkpoint``: only the inputs are kept, the body is
    run again in the backward, under the sharding rules active now (the
    backward of CUDA tensors runs on autograd's own thread, which does
    not see this thread's rules)."""
    if train and torch.is_grad_enabled():
        rules = active_rules()

        def body(*a):
            with use_rules(rules):
                return fn(*a)

        return checkpoint(body, *args, use_reentrant=False)
    return fn(*args)


def _decoder_layer(x, lp, lora_layer, cfg, positions, ids_tok, scale,
                   ffn: bool, train: bool, kind: str = "prefill"):
    """One decoder layer -> (x, k, v); ``ffn`` False skips its MoE or
    MLP (the KV-only prefill's last layer); ``kind`` picks the MoE's plan
    under rules; ``lp`` is this rank's shards (``weights_at_use``)."""
    lp = weights_at_use(lp, cfg, "layers", x)
    h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
    att, (k, v) = attn_block(h, lp["attn"], cfg, positions,
                             window=cfg.sliding_window, lora_layer=lora_layer,
                             ids_tok=ids_tok, lora_scale=scale, train=train)
    x = x + att
    if ffn:
        h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
        if cfg.is_moe:
            y = moe_mod.moe_block(h, lp["moe"], cfg, kind=kind,
                                  lora=lora_layer, ids_tok=ids_tok,
                                  lora_scale=scale)
        else:
            y = _mlp_with_lora(h, lp["mlp"], cfg, lora_layer, ids_tok, scale)
        x = x + y
    return x, k, v


def forward(params, cfg, tokens, frontend_emb=None, kind="prefill",
            lora_ctx=None, collect_kv=False, unembed=True):
    """Parallel forward. tokens: (B, S_text); frontend_emb: (B, S_front, d)
    (vlm: put ahead of the text; audio: the encoder's input frames).

    Returns (logits (B, S, Vp) f32, aux): aux holds the K/V stacks
    (L, B, S, KV, hd) when ``collect_kv`` (audio: ((k, v), (ck, cv)) of
    the self and cross attention; hybrid: ((k, v) (G, ...), (h, conv)
    (G, every, ...))), or rwkv's final states (tm, cm, wkv), as the
    reference. ``unembed=False`` (the KV-only prefill of a decoder LM)
    skips the last layer's FFN, the final norm and the lm head, on which
    no K/V depends, and returns (None, aux). ``kind="train"``: the
    training plane's forward (layer bodies checkpointed, flash
    attention); the same values as any other kind. Without rules the
    MoE's plan is the reference's local one whatever the kind: dropless
    only when T * top_k <= 4096, else capacity ``capacity_factor``; under
    rules the ``kind`` picks its sharded plan, and tokens (and
    ``frontend_emb``) are this rank's shards (a frontend with the
    sequence sharded is refused)."""
    train = kind == "train"
    fam = cfg.family
    if fam == "audio":
        return _forward_encdec(params, cfg, tokens, frontend_emb, collect_kv,
                               train)
    if fam == "ssm" and cfg.rwkv:
        return _forward_rwkv(params, cfg, tokens, train)
    if fam == "hybrid":
        return _forward_hybrid(params, cfg, tokens, collect_kv, train)

    front = frontend_emb if cfg.frontend else None
    if front is not None:
        _check_frontend(tokens.shape[0], tokens.shape[1] + front.shape[1])
    x = _embed(params, cfg, tokens)
    if front is not None:
        x = torch.cat([front.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    stack, ids_tok, scale = _lora_parts(lora_ctx, S)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        lp = layer_params(params["layers"], l)
        lora_layer = layer_params(stack, l) if stack is not None else None
        ffn = unembed or l + 1 < cfg.n_layers
        x, k, v = _remat(train, _decoder_layer, x, lp, lora_layer, cfg,
                         positions, ids_tok, scale, ffn, train, kind)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    if not unembed:
        return None, kvs
    return _logits(params, cfg, x), kvs


def _embed(params, cfg, tokens):
    return ll.embed(tokens, params["embed"], cfg.padded_vocab)


def _logits(params, cfg, x):
    x = ll.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return ll.unembed(x, params.get("lm_head", params["embed"]),
                      cfg.padded_vocab)


def _rwkv_layer(x, lp, cfg, state0):
    """One RWKV-6 layer from the zero state -> (x, its final state)."""
    lp = weights_at_use(lp, cfg, "layers", x)
    y, st = ssm.rwkv6_time_mix(ll.rms_norm(x, lp["ln1"], cfg.norm_eps),
                               lp, cfg, state0)
    x = x + y
    y, st = ssm.rwkv6_channel_mix(ll.rms_norm(x, lp["ln2"], cfg.norm_eps),
                                  lp, cfg, st)
    return x + y, st


def _forward_rwkv(params, cfg, tokens, train=False):
    """RWKV-6: time mix then channel mix a layer, each from a zero state."""
    x = _embed(params, cfg, tokens)
    state0 = ssm.rwkv6_init_state(cfg, x.shape[0], x.device)
    states = []
    for l in range(cfg.n_layers):
        x, st = _remat(train, _rwkv_layer, x,
                       layer_params(params["layers"], l), cfg, state0)
        states.append(st)
    return _logits(params, cfg, x), tuple(torch.stack(s)
                                          for s in zip(*states))


def _shared_block(x, sp, cfg, positions, window, train=False):
    """The hybrid's weight-shared attention + MLP block."""
    sp = weights_at_use(sp, cfg, "shared_attn", x)
    att, kv = attn_block(ll.rms_norm(x, sp["ln1"], cfg.norm_eps), sp["attn"],
                         cfg, positions, window=window, train=train)
    x = x + att
    return x + ll.mlp(ll.rms_norm(x, sp["ln2"], cfg.norm_eps), sp["mlp"],
                      cfg), kv


def _mamba_layer(layers, g: int, j: int) -> dict:
    """Views of the hybrid's mamba layer j of group g."""
    return {k: v[g, j] for k, v in layers.items()}


def _mamba_residual(x, lp, cfg):
    lp = weights_at_use(lp, cfg, "layers", x)
    y, st = ssm.mamba2_forward(x, lp, cfg, None)
    return x + y, st


def _forward_hybrid(params, cfg, tokens, collect_kv, train=False):
    """Zamba2: per group, the shared block then ``every`` mamba2 layers
    (the mamba layers checkpointed when training, as the reference's)."""
    x = _embed(params, cfg, tokens)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    every = cfg.shared_attn_every
    kvs, states = [], []
    for g in range(cfg.n_layers // every):
        x, kv = _shared_block(x, params["shared_attn"], cfg, positions,
                              cfg.sliding_window, train)
        kvs.append(kv)
        for j in range(every):
            x, st = _remat(train, _mamba_residual, x,
                           _mamba_layer(params["layers"], g, j), cfg)
            states.append(st)
    aux = (None, None)
    if collect_kv:
        G = len(kvs)
        aux = (tuple(torch.stack(t) for t in zip(*kvs)),
               tuple(torch.stack(t).reshape(G, every, *t[0].shape)
                     for t in zip(*states)))
    return _logits(params, cfg, x), aux


def _enc_layer(enc, lp, cfg, enc_pos, train):
    lp = weights_at_use(lp, cfg, "enc_layers", enc)
    att, _ = attn_block(ll.rms_norm(enc, lp["ln1"], cfg.norm_eps),
                        lp["attn"], cfg, enc_pos, causal=False, train=train)
    enc = enc + att
    return enc + ll.mlp(ll.rms_norm(enc, lp["ln2"], cfg.norm_eps),
                        lp["mlp"], cfg)


def _dec_layer(x, lp, enc, cfg, dec_pos, train):
    """One decoder layer -> (x, (k, v), (ck, cv))."""
    lp = weights_at_use(lp, cfg, "layers", x)
    att, kv = attn_block(ll.rms_norm(x, lp["ln1"], cfg.norm_eps),
                         lp["attn"], cfg, dec_pos, train=train)
    x = x + att
    # cross attention: k/v of the encoder's output by this layer's weights
    _, ck, cv = ll.qkv_project(enc, lp["cross"], cfg)
    catt, _ = attn_block(ll.rms_norm(x, lp["ln2"], cfg.norm_eps),
                         lp["cross"], cfg, dec_pos, rope=False,
                         kv_override=(ck, cv), train=train)
    x = x + catt
    x = x + ll.mlp(ll.rms_norm(x, lp["ln3"], cfg.norm_eps), lp["mlp"], cfg)
    return x, kv, (ck, cv)


def _forward_encdec(params, cfg, tokens, frontend_emb, collect_kv,
                    train=False):
    """The audio encoder-decoder: a bidirectional encoder over the frames
    (run in bf16 whatever the weights, as the reference casts them), then
    the decoder with self and cross attention."""
    enc = frontend_emb.to(torch.bfloat16)
    B, Se, _ = enc.shape
    enc_pos = _positions(B, Se, enc.device)
    for l in range(cfg.n_enc_layers):
        enc = _remat(train, _enc_layer, enc,
                     layer_params(params["enc_layers"], l), cfg, enc_pos,
                     train)
    enc = ll.rms_norm(enc, params["enc_norm"], cfg.norm_eps)

    x = _embed(params, cfg, tokens)
    dec_pos = _positions(B, x.shape[1], x.device)
    kvs = []
    for l in range(cfg.n_layers):
        x, kv, ckv = _remat(train, _dec_layer, x,
                            layer_params(params["layers"], l), enc, cfg,
                            dec_pos, train)
        kvs.append((kv, ckv))
    aux = None
    if collect_kv:
        aux = tuple(tuple(torch.stack([layer[i][j] for layer in kvs])
                          for j in range(2)) for i in range(2))
    return _logits(params, cfg, x), aux


_STATES = ("tm", "cm", "wkv", "h", "conv")     # the recurrent caches


def _states_at_use(cfg, cache, batch: int):
    """(the recurrent states of ``cache`` whole over every axis but the
    batch's, fn(name, new state) -> this rank's slice of it). Under decode
    rules the reference's layout shards the states' heads and inner
    channels (rwkv's wkv, the hybrid's h and conv) over "model"; the
    recurrences run on this rank's rows of the whole states. Without
    rules, the states and the identity."""
    rules = active_rules()
    names = [k for k in _STATES if k in cache]
    if rules is None or not names:
        return cache, lambda name, t: t
    axes = cache_mod.cache_logical_axes(cfg)
    B = batch * rules.size(rules.token_layout(batch)[0])
    glob = cache_mod.init_cache(cfg, B, 1, device="meta")
    cuts = {k: [(dim, axes_of(p)) for dim, (name, p) in enumerate(zip(
        axes[k], rules.spec(axes[k], glob[k].shape)))
        if name != "batch" and axes_of(p)] for k in names}
    mesh = rules.mesh
    whole = {}
    for k in names:
        t = cache[k]
        for dim, ax in cuts[k]:
            t = col.all_gather(t, mesh.get_group(ax), dim)
        whole[k] = t

    def local(name, t):
        for dim, ax in cuts[name]:
            n = t.shape[dim] // mesh.size(ax)
            t = t.narrow(dim, mesh.coord(ax) * n, n)
        return t.contiguous()

    return whole, local


def decode_step(params, cfg, cache, tokens, lora_ctx=None):
    """One token for a static batch, every family. tokens: (B, 1); cache:
    ``cache.init_cache``'s dict, its ``pos`` a host int (this token's
    position). The KV buffers (k/v and their scales, the hybrid's ring
    ak/av/apos) are written IN PLACE; the recurrent states (rwkv's
    tm/cm/wkv, the hybrid's h/conv) are replaced by the new ones, in the
    activations' dtype as the reference's scan returns them. ``lora_ctx``
    applies to the dense, moe and vlm families. Under decode rules the
    batch rows and the caches' "kv_seq" slices are this rank's
    (``layers.decode_attention_update``), the recurrent states its heads
    or channels (gathered at use, ``_states_at_use``), and the MoE runs
    its decode plan. Returns (logits (B, Vp) f32, the new cache: a new
    dict with ``pos`` + 1)."""
    fam = cfg.family
    pos = int(cache["pos"])
    x = _embed(params, cfg, tokens)
    positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.long,
                           device=x.device)
    new = dict(cache, pos=pos + 1)
    if fam in ("dense", "moe", "vlm", "audio"):
        stack, ids_tok, scale = _lora_parts(None if fam == "audio"
                                            else lora_ctx)
        quant = "k_scale" in cache
        for l in range(cfg.n_layers):
            lp = weights_at_use(layer_params(params["layers"], l), cfg,
                                   "layers", x)
            lora_layer = layer_params(stack, l) if stack is not None else None
            h = ll.rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = _qkv_with_deltas(h, lp["attn"], cfg, lora_layer,
                                       ids_tok, scale)
            q = ll.apply_rope(q, positions, cfg.rope_theta)
            k = ll.apply_rope(k, positions, cfg.rope_theta)
            att = ll.decode_attention_update(
                q[:, 0], k[:, 0], v[:, 0], cache["k"][l], cache["v"][l], pos,
                window=cfg.sliding_window,
                k_scale=cache["k_scale"][l] if quant else None,
                v_scale=cache["v_scale"][l] if quant else None)[0]
            x = x + _out_with_delta(att[:, None], lp["attn"], lora_layer,
                                    ids_tok, scale)
            h = ll.rms_norm(x, lp["ln2"], cfg.norm_eps)
            if fam == "audio":
                cp = lp["cross"]
                cq = ll.mm_f32(h, cp["wq"])
                if cfg.qkv_bias:
                    cq = cq + cp["bq"].to(torch.float32)
                cq = cq.to(h.dtype).reshape(h.shape[0], cfg.n_heads,
                                            cfg.head_dim)
                catt = ll.decode_attention(cq, cache["ck"][l], cache["cv"][l],
                                           int(cache["cross_len"]))
                x = x + ll.out_project(catt[:, None], cp)
                y = ll.mlp(ll.rms_norm(x, lp["ln3"], cfg.norm_eps),
                           lp["mlp"], cfg)
            elif cfg.is_moe:
                y = moe_mod.moe_block(h, lp["moe"], cfg, kind="decode",
                                      lora=lora_layer, ids_tok=ids_tok,
                                      lora_scale=scale)
            else:
                y = _mlp_with_lora(h, lp["mlp"], cfg, lora_layer, ids_tok,
                                   scale)
            x = x + y
    elif fam == "ssm" and cfg.rwkv:
        whole, local = _states_at_use(cfg, cache, tokens.shape[0])
        states = []
        for l in range(cfg.n_layers):
            lp = weights_at_use(layer_params(params["layers"], l), cfg,
                                   "layers", x)
            st = ssm.RWKV6State(whole["tm"][l], whole["cm"][l],
                                whole["wkv"][l])
            y, st = ssm.rwkv6_time_mix(ll.rms_norm(x, lp["ln1"], cfg.norm_eps),
                                       lp, cfg, st, chunk=1)
            x = x + y
            y, st = ssm.rwkv6_channel_mix(
                ll.rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg, st)
            x = x + y
            states.append(st)
        for name, s in zip(("tm", "cm", "wkv"), zip(*states)):
            new[name] = local(name, torch.stack(s))
    elif fam == "hybrid":
        every = cfg.shared_attn_every
        slot = pos % cache["ak"].shape[2]
        whole, local = _states_at_use(cfg, cache, tokens.shape[0])
        states = []
        for g in range(cfg.n_layers // every):
            # the shared block against the ring buffer of the window's KV
            sp = weights_at_use(params["shared_attn"], cfg, "shared_attn",
                                   x)
            h = ll.rms_norm(x, sp["ln1"], cfg.norm_eps)
            q, k, v = ll.qkv_project(h, sp["attn"], cfg)
            q = ll.apply_rope(q, positions, cfg.rope_theta)
            k = ll.apply_rope(k, positions, cfg.rope_theta)
            att = ll.decode_attention_update(
                q[:, 0], k[:, 0], v[:, 0], cache["ak"][g], cache["av"][g], pos,
                window=cfg.sliding_window, key_positions=cache["apos"],
                write_slot=slot)[0]
            x = x + ll.out_project(att[:, None], sp["attn"])
            x = x + ll.mlp(ll.rms_norm(x, sp["ln2"], cfg.norm_eps), sp["mlp"],
                           cfg)
            for j in range(every):
                y, st = ssm.mamba2_decode_step(
                    x, weights_at_use(_mamba_layer(params["layers"], g, j),
                                         cfg, "layers", x), cfg,
                    ssm.Mamba2State(whole["h"][g, j], whole["conv"][g, j]))
                x = x + y
                states.append(st)
        G = cfg.n_layers // every
        for name, s in zip(("h", "conv"), zip(*states)):
            new[name] = local(name, torch.stack(s).reshape(G, every,
                                                           *s[0].shape))
    else:
        raise ValueError(fam)
    return _logits(params, cfg, x)[:, 0], new

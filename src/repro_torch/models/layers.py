"""Forward math of the transformer layers on the serving path (functions on
tensors over plain dicts of parameters), the counterpart of
``repro.models.layers``.

Activations are (B, S, d); attention internals (B, S, H, hd). Matrix
products that the reference takes with ``preferred_element_type=f32`` are
taken with an f32 result here too (``mm_f32``), so a bf16 model rounds at
the same places as the reference.

Under active sharding rules over a ``ProcessMesh`` (the SPMD steps) every
tensor is this process's shard, and three functions run the reference's
``shard_map`` bodies with their collectives written out:
``causal_attention`` / ``flash_attention`` head-sharded under sequence
parallelism, the ``kv_seq`` flash-decode (``decode_attention_update``,
``decode_attention``) and the sequence-parallel ``mlp``; the embedding
and lm head run vocab-parallel on this process's rows of their tables
(``embed``, ``unembed``). Without rules each runs its local path,
unchanged.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import active_rules, axes_of, \
    use_rules
from repro_torch.kernels import ops
from repro_torch.kernels.autograd import matmul_f32
from repro_torch.models.cache import quantize_kv

F32 = torch.float32
NEG_INF = -1e30


def mm_f32(a, b):
    """a @ b with an f32 result (a: (..., k), b: (k, m)). f32 operands
    multiply as they are; bf16 operands on the card accumulate in f32 and
    return f32 (cuBLAS ``out_dtype``), as the reference's
    ``preferred_element_type=f32``. Mixed operands (f32 activations on
    bf16 weights, or the reverse) multiply in f32, as the reference
    promotes them. The batched expert GEMMs go to ``ops.gmm``. Under
    autograd the bf16 product goes through ``_MmF32`` (cuBLAS's
    ``out_dtype`` form has no derivative). A trace on the meta device
    takes the card's branch, so it counts the card's work."""
    if a.dtype == F32 and b.dtype == F32:
        return a @ b
    if a.device.type not in ("cuda", "meta") or a.dtype != b.dtype:
        return a.to(F32) @ b.to(F32)
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    y = _MmF32.apply(a2, b) if torch.is_grad_enabled() and (
        a.requires_grad or b.requires_grad) else torch.mm(a2, b,
                                                          out_dtype=F32)
    return y.reshape(*lead, b.shape[-1])


class _MmF32(torch.autograd.Function):
    """a (M, k) @ b (k, m) of bf16 operands with an f32 result, under
    autograd; the f32 gradient meets the bf16 operands through
    ``autograd.matmul_f32``, and each gradient is cast to its operand's
    dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=F32)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        dy = dy.to(F32)
        da = matmul_f32(dy, b.t()).to(a.dtype) if ctx.needs_input_grad[0] \
            else None
        db = matmul_f32(a.t(), dy).to(b.dtype) if ctx.needs_input_grad[1] \
            else None
        return da, db


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm in f32 with the reference's (1 + scale) weight."""
    xf = x.to(F32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(F32))).to(x.dtype)


# ------------------------------- RoPE ---------------------------------- #
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies in float64 (cast to f32 where used), as the
    reference computes them."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    # copied to the device once: a host->device copy from pageable memory
    # inside the decode step would wait for the stream to drain
    # staticcheck: disable=SC006 (cached: made at the warm-up, not captured)
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=F32,
                           device=device)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)
    angles = positions[..., None].to(F32) * freqs          # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------- projections ------------------------------ #
def qkv_project(x, p, cfg):
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,KV,hd); RoPE applied outside."""
    B, S, _ = x.shape
    outs = []
    for name, heads in (("q", cfg.n_heads), ("k", cfg.n_kv_heads),
                        ("v", cfg.n_kv_heads)):
        y = mm_f32(x, p["w" + name])
        if cfg.qkv_bias:
            y = y + p["b" + name].to(F32)
        outs.append(y.to(x.dtype).reshape(B, S, heads, cfg.head_dim))
    return tuple(outs)


def out_project(attn_out, p):
    """attn_out: (B, S, H, hd) -> (B, S, d)."""
    B, S = attn_out.shape[:2]
    return mm_f32(attn_out.reshape(B, S, -1), p["wo"]).to(attn_out.dtype)


def _vocab_group(table, vocab: Optional[int], batch: int, seq: int):
    """(process group, this rank's first row, whether the activations of
    local (batch, seq) are sharded over it) of an embedding table of
    ``vocab`` global rows whose rows the active rules shard ("vocab"),
    or None where it is whole here. A table of another row count than
    its placement's is refused, and so is a vocab whose axes shard the
    tokens in part."""
    rules = active_rules()
    if rules is None or vocab is None:
        return None
    place = rules.sharding(("vocab", None), (vocab, table.shape[1]))
    rows = place.local_shape[0]
    if table.shape[0] != rows:
        raise ValueError(f"an embedding table of {vocab} rows holds {rows} "
                         f"a rank under these rules, got {table.shape[0]}")
    ax = axes_of(place.spec[0])
    if rules.size(ax) == 1:
        return None
    tok = set(sum(rules.token_layout(batch, seq), ()))
    if 0 < len(tok & set(ax)) < len(ax):
        raise NotImplementedError(
            f"the vocab over {ax}, of which only {sorted(tok & set(ax))} "
            f"shard the tokens")
    return rules.mesh.get_group(ax), rules.mesh.coord(ax) * rows, \
        bool(tok & set(ax))


def embed(tokens, table, vocab: Optional[int] = None):
    """tokens: (B, S) int; table: (V, d). Under rules that shard the rows
    of a ``vocab``-row table, ``table`` is this rank's rows and the lookup
    is vocab-parallel: each rank looks up the ids its rows hold (zero rows
    elsewhere) and the partial rows are summed over the vocab's ranks,
    exactly (one rank holds each row). Where those ranks hold other
    tokens, the ids are gathered first and the sum reduce-scattered back
    to this rank's tokens; where they hold the same ones, the sum is an
    all-reduce whose gradient passes unchanged (``col.psum``)."""
    shard = _vocab_group(table, vocab, *tokens.shape)
    if shard is None:
        return table[tokens]
    g, v0, sharded = shard
    ids = tokens.reshape(-1)
    if sharded:
        ids = col.all_gather(ids, g, 0)
    ids = ids - v0
    mine = (ids >= 0) & (ids < table.shape[0])
    rows = torch.where(mine[:, None], table[ids.clamp(0, table.shape[0] - 1)],
                       0.0)
    rows = col.reduce_scatter(rows, g, 0) if sharded else col.psum(rows, g)
    return rows.reshape(*tokens.shape, -1)


def unembed(x, table, vocab: Optional[int] = None):
    """x: (B, S, d) -> logits (B, S, V) f32. Under rules that shard the
    rows of a ``vocab``-row table, each rank computes its vocab columns in
    f32 (x cast first, so the input's gradient is summed in f32). Where
    the vocab's ranks hold other tokens, x is gathered over them and a
    tiled all-to-all returns this rank's rows over the whole vocab; where
    they hold the same ones, the columns are gathered (their gradient
    kept unsummed) and x's gradient is summed over them
    (``col.sum_grad``). The columns come in the placement's order."""
    shard = _vocab_group(table, vocab, *x.shape[:2])
    if shard is None:
        return mm_f32(x, table.t())
    g, _, sharded = shard
    xf = x.reshape(-1, x.shape[-1]).float()
    if not sharded:
        y = mm_f32(col.sum_grad(xf, g), table.t())
        return col.all_gather_replicated(y, g, 1).reshape(*x.shape[:-1], -1)
    y = col.all_to_all(mm_f32(col.all_gather(xf, g, 0), table.t()), g, 0, 1)
    return y.reshape(*x.shape[:-1], y.shape[-1])


# -------------------------------- MLP ---------------------------------- #
def gelu(x):
    """GELU in its tanh form, the default of the reference's
    ``jax.nn.gelu`` (``approximate=True``)."""
    return F.gelu(x, approximate="tanh")


def mlp_act(g, u, cfg, dtype):
    """The MLP's activation of its f32 gate/up products, cast to the
    activations' dtype: silu(g) * u gated (SwiGLU), gelu(u) not."""
    return (F.silu(g) * u if cfg.gated_mlp else gelu(u)).to(dtype)


def _mlp_math(x, p, cfg):
    g = mm_f32(x, p["gate"]) if cfg.gated_mlp else None
    act = mlp_act(g, mm_f32(x, p["up"]), cfg, x.dtype)
    return mm_f32(act, p["down"])


def mlp_sp_axes(rules, cfg, batch: int, seq: int):
    """(seq axes, fsdp axis) of the sequence-parallel MLP for activations
    of local (batch, seq) under ``rules``, or None where it does not apply
    (the sequence is not sharded, or not over the axis that shards d_ff)."""
    if rules is None:
        return None
    sax = rules.token_layout(batch, seq)[1]
    if not sax or seq * rules.size(sax) <= 1 or \
            axes_of(rules._resolve("mlp", cfg.d_ff))[:1] != sax[:1]:
        return None
    fsdp = axes_of(rules._resolve("fsdp", cfg.d_model))
    return sax, (fsdp[0] if fsdp else None)


def mlp(x, p, cfg):
    """SwiGLU (gated) or GELU MLP of the dense families. x: (B, S, d); p:
    {gate (gated only), up (d, ff), down (ff, d)}. The products have an f32
    result, the activation is cast to x's dtype, and the output too, as the
    reference rounds.

    Under sequence parallelism (rules whose "seq" and "mlp" take one axis)
    x is this rank's sequence shard and the weights its (fsdp, mlp) shards:
    the reference's Megatron-SP pair, x all-gathered over the sequence
    axis, the partial output over this rank's d_ff shard reduce-scattered
    back, with the weights' fsdp shards gathered first."""
    sp = mlp_sp_axes(active_rules(), cfg, x.shape[0], x.shape[1])
    if sp is None:
        return _mlp_math(x, p, cfg).to(x.dtype)
    (seq_axes, fsdp), mesh = sp, active_rules().mesh
    p = dict(p)
    if fsdp is not None:        # ZeRO-3: this layer's d shards gathered
        g = mesh.get_group(fsdp)
        for name, dim in (("up", 0), ("gate", 0), ("down", 1)):
            if name in p:
                p[name] = col.all_gather(p[name], g, dim)
    gs = mesh.get_group(seq_axes)
    y = _mlp_math(col.all_gather(x, gs, 1), p, cfg)
    return col.reduce_scatter(y, gs, 1).to(x.dtype)


# --------------------------- prefill attention ------------------------- #
def _sharded_attention(attn, q, k, v, **kw):
    """``attn`` (a local attention) under active rules, on this rank's
    sequence shards of q, k, v (or, unsharded, None: the caller runs it
    alone). Where the heads divide the sequence's axis, q is made
    head-sharded by a tiled all-to-all (the sequence gathered, this rank's
    H/n heads kept), k and v are gathered whole once (their gradients
    summed once over the axis, by the gather's reduce-scatter), and the
    output goes back to sequence shards the same way; q's heads pick
    their kv heads by their global index (GQA). Otherwise q, k and v are
    gathered and each rank keeps its own rows of the output."""
    rules = active_rules()
    if rules is None:
        return None
    sax = rules.token_layout(q.shape[0], q.shape[1])[1]
    if rules.size(sax) == 1:    # the sequence is whole here
        return None
    mesh = rules.mesh
    g, n = mesh.get_group(sax), mesh.size(sax)
    B, Sl, H, hd = q.shape
    KV = k.shape[2]
    kg, vg = col.all_gather(k, g, 1), col.all_gather(v, g, 1)
    with use_rules(None):       # the local attention on gathered tensors
        if axes_of(rules._resolve("heads", H)) != sax:
            out = attn(col.all_gather(q, g, 1), kg, vg, **kw)
            return out.narrow(1, mesh.coord(sax) * Sl, Sl)
        H_loc = H // n
        qh = col.all_to_all(q, g, 2, 1)                # (B, S, H/n, hd)
        kv_idx = (mesh.coord(sax) * H_loc
                  + torch.arange(H_loc, device=q.device)) // (H // KV)
        out = attn(qh, kg.index_select(2, kv_idx),
                   vg.index_select(2, kv_idx), **kw)
    return col.all_to_all(out, g, 1, 2)


def causal_attention(q, k, v, *, causal: bool = True, window: int = 0,
                     q_offset: int = 0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), GQA by head grouping.
    ``window`` > 0 masks keys at least ``window`` positions older than the
    query; ``q_offset`` is the position of q[0] relative to k[0]. Scores and
    softmax in f32. Returns (B, Sq, H, hd) in q's dtype. Under sequence
    parallelism: this rank's sequence shards, head-sharded inside
    (``_sharded_attention``)."""
    out = _sharded_attention(causal_attention, q, k, v, causal=causal,
                             window=window, q_offset=q_offset)
    if out is not None:
        return out
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(F32), k.to(F32))
    s = s * (1.0 / np.sqrt(hd))
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)                                        # (B,KV,G,Sq)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(F32))
    o = o / l.clamp_min(1e-20).permute(0, 3, 1, 2)[..., None]
    return o.to(q.dtype).reshape(B, Sq, H, hd)


# ------------------------ training attention --------------------------- #
def _attn_mask(q_pos, k_pos, causal: bool, window: int):
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def _key_span(q0: int, q1: int, Sk: int, causal: bool, window: int):
    """Keys [lo, hi) that queries at positions q0..q1-1 may see."""
    hi = min(Sk, q1) if causal else Sk
    lo = max(0, q0 - window + 1) if window else 0
    return lo, max(lo, hi)


def _query_span(k0: int, k1: int, Sq: int, q_offset: int, causal: bool,
                window: int):
    """Query rows [lo, hi) that keys k0..k1-1 may be seen by."""
    lo = max(0, k0 - q_offset) if causal else 0
    hi = min(Sq, k1 + window - 1 - q_offset) if window else Sq
    return lo, max(lo, hi)


def _mask_(s, q0: int, k0: int, causal: bool, window: int) -> None:
    """Set the masked scores of s (..., nq, nk) (queries at positions q0..,
    keys k0..) to NEG_INF, in place, touching only the key columns that
    some query of the block masks."""
    nq, nk = s.shape[-2:]
    q1, k1 = q0 + nq, k0 + nk
    cols = []
    if causal and k1 > q0 + 1:                 # keys after the first query
        cols.append((max(k0, q0 + 1), k1))
    if window and q1 - window > k0:            # keys before the last window
        cols.append((k0, min(k1, q1 - window)))
    dev = s.device
    for a, b in cols:
        mask = _attn_mask(torch.arange(q0, q1, device=dev),
                          torch.arange(a, b, device=dev), causal, window)
        s[..., a - k0:b - k0].masked_fill_(~mask, NEG_INF)


def _flash_fwd(qg, k, v, causal, window, q_chunk, q_offset, trim):
    """Per q-chunk softmax over the keys: out (B, Sq, KV, G, hd) in qg's
    dtype and the log-sum-exp (B, KV, G, Sq) f32. The scale goes onto q
    (and, in the backward, onto dq and dk), the mask onto the key columns
    that need it, and the exponential in place: the chunk's scores are
    the largest tensor, passed over as few times as the math allows."""
    B, Sq, KV, G, hd = qg.shape
    Sk = k.shape[1]
    scale = 1.0 / np.sqrt(hd)
    kf, vf = k.to(F32), v.to(F32)
    out = torch.empty_like(qg)
    lse = torch.empty((B, KV, G, Sq), dtype=F32, device=qg.device)
    for c0 in range(0, Sq, q_chunk):
        c1 = c0 + q_chunk
        lo, hi = _key_span(q_offset + c0, q_offset + c1, Sk, causal,
                           window) if trim else (0, Sk)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg[:, c0:c1].to(F32) * scale,
                         kf[:, lo:hi])
        _mask_(s, q_offset + c0, lo, causal, window)
        m = s.amax(dim=-1)
        p = s.sub_(m[..., None]).exp_()
        l = p.sum(dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, vf[:, lo:hi])
        o = o / l.clamp_min(1e-20).permute(0, 3, 1, 2)[..., None]
        out[:, c0:c1] = o.to(qg.dtype)
        lse[..., c0:c1] = m + torch.log(l.clamp_min(1e-20))
    return out, lse


def _flash_bwd(causal, window, q_chunk, q_offset, trim, qg, k, v, out, lse,
               dout):
    """The reference's two passes: dq per q-chunk (against its keys), then
    dk and dv per k-chunk (against its queries)."""
    B, Sq, KV, G, hd = qg.shape
    Sk = k.shape[1]
    scale = 1.0 / np.sqrt(hd)
    k_chunk = min(q_chunk, Sk)
    while Sk % k_chunk:
        k_chunk //= 2
    dev = qg.device
    qf, kf, vf = qg.to(F32), k.to(F32), v.to(F32)
    qs = qf * scale
    dout = dout.to(F32)
    D = torch.einsum("bqkgd,bqkgd->bkgq", dout, out.to(F32))

    def probs(q_lo, q_hi, k_lo, k_hi):
        """exp(s - lse) of queries q_lo..q_hi-1 against keys k_lo..k_hi-1,
        0 where masked (B, KV, G, nq, nk)."""
        s = torch.einsum("bqkgd,bskd->bkgqs", qs[:, q_lo:q_hi],
                         kf[:, k_lo:k_hi])
        _mask_(s, q_offset + q_lo, k_lo, causal, window)
        return s.sub_(lse[..., q_lo:q_hi, None]).exp_()

    def dscores(p, q_lo, q_hi, k_lo, k_hi):
        """p * (dp - D), the scores' gradient over the scale."""
        dp = torch.einsum("bqkgd,bskd->bkgqs", dout[:, q_lo:q_hi],
                          vf[:, k_lo:k_hi])
        return dp.sub_(D[..., q_lo:q_hi, None]).mul_(p)

    dq = torch.zeros(qg.shape, dtype=F32, device=dev)
    for c0 in range(0, Sq, q_chunk):
        c1 = c0 + q_chunk
        lo, hi = _key_span(q_offset + c0, q_offset + c1, Sk, causal,
                           window) if trim else (0, Sk)
        ds = dscores(probs(c0, c1, lo, hi), c0, c1, lo, hi)
        dq[:, c0:c1] = torch.einsum("bkgqs,bskd->bqkgd", ds,
                                    kf[:, lo:hi]) * scale
    dk = torch.zeros((B, Sk, KV, hd), dtype=F32, device=dev)
    dv = torch.zeros((B, Sk, KV, hd), dtype=F32, device=dev)
    for j0 in range(0, Sk, k_chunk):
        j1 = j0 + k_chunk
        lo, hi = _query_span(j0, j1, Sq, q_offset, causal, window) \
            if trim else (0, Sq)
        if hi <= lo:
            continue
        p = probs(lo, hi, j0, j1)
        dv[:, j0:j1] = torch.einsum("bkgqs,bqkgd->bskd", p, dout[:, lo:hi])
        ds = dscores(p, lo, hi, j0, j1)
        dk[:, j0:j1] = torch.einsum("bkgqs,bqkgd->bskd", ds,
                                    qf[:, lo:hi]) * scale
    return dq.to(qg.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_attention`` with its custom VJP: the
    forward saves out and the log-sum-exp, the backward recomputes each
    chunk's scores."""

    @staticmethod
    def forward(ctx, qg, k, v, causal, window, q_chunk, q_offset):
        Sq, Sk = qg.shape[1], k.shape[1]
        # every query sees its own position: the keys (queries) outside a
        # chunk's span weigh exactly 0, so the span is all a chunk needs
        trim = q_offset >= 0 and q_offset + Sq <= Sk
        out, lse = _flash_fwd(qg, k, v, causal, window, q_chunk, q_offset,
                              trim)
        ctx.save_for_backward(qg, k, v, out, lse)
        ctx.args = (causal, window, q_chunk, q_offset, trim)
        return out

    @staticmethod
    def backward(ctx, dout):
        qg, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(*ctx.args, qg, k, v, out, lse, dout)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_chunk: int = 512, q_offset: int = 0):
    """Chunked attention with the flash backward, the training plane's
    (the reference's ``causal_attention``: plain torch, as the reference's
    is jnp). It never holds more than one chunk's scores: q_chunk queries
    (halved until it divides Sq) against the keys they may see, in the
    forward and in both backward passes. Arguments and result as
    ``causal_attention``'s, sharded the same way under rules."""
    out = _sharded_attention(flash_attention, q, k, v, causal=causal,
                             window=window, q_chunk=q_chunk,
                             q_offset=q_offset)
    if out is not None:
        return out
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    q_chunk = min(q_chunk, Sq)
    while Sq % q_chunk:
        q_chunk //= 2
    out = _FlashAttention.apply(q.reshape(B, Sq, KV, H // KV, hd), k, v,
                                causal, int(window), q_chunk, int(q_offset))
    return out.reshape(B, Sq, H, hd)


# --------------------------- slot decode ------------------------------- #
def decode_attention_update_slots(q, k_new, v_new, k_cache, v_cache, pos_vec,
                                  *, window: int = 0):
    """Per-slot KV write + decode attention over a dense slab (plain torch,
    as the reference's is plain jnp).

    q: (B, H, hd); k_new/v_new: (B, KV, hd) post-RoPE; k_cache/v_cache:
    (B, S, KV, hd), updated IN PLACE; pos_vec: (B,) int32 tokens already
    cached per row (this token is written at position pos_vec[b]). Rows
    with pos_vec < 0 are inactive: they rewrite the cell they point at with
    its own value, and their output is finite garbage. Returns (out
    (B, H, hd), k_cache, v_cache)."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1:3]
    active = (pos_vec >= 0)[:, None, None]
    rows = torch.arange(B, device=q.device)
    idx = pos_vec.long().clamp(0, S - 1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[rows, idx] = torch.where(active, new.to(cache.dtype),
                                       cache[rows, idx])
    # the reference's mask: key positions below pos + 1 (and the window)
    _, l, o = _local_decode_scores(q.reshape(B, KV, H // KV, hd), k_cache,
                                   v_cache, torch.arange(S, device=q.device),
                                   pos_vec.long() + 1, window)
    out = o / l.clamp_min(1e-20)[..., None]
    return out.reshape(B, H, hd).to(q.dtype), k_cache, v_cache



def decode_attention_update_slots_paged(q, k_new, v_new, k_pool, v_pool,
                                        block_table, pos_vec, *,
                                        window: int = 0):
    """Per-slot KV write + flash-decode attention over a paged block pool.

    q: (B, H, hd); k_new/v_new: (B, KV, hd) post-RoPE; k_pool/v_pool:
    (P, page_size, KV, hd), updated IN PLACE; block_table: (B, nb) int32
    page ids (-1 = unallocated); pos_vec: (B,) int32 tokens already cached
    per row (this token is written at position pos_vec[b]). Rows with
    pos_vec < 0, or whose page is unallocated, write nothing (the
    reference's ``mode="drop"``). Returns (out (B, H, hd), k_pool, v_pool).
    """
    B, H, hd = q.shape
    P, ps, KV = k_pool.shape[:3]
    nb = block_table.shape[1]
    rows = torch.arange(B, device=q.device)
    posc = pos_vec.long().clamp_min(0)
    page = block_table[rows, (posc // ps).clamp(max=nb - 1)].long()
    ok = (pos_vec >= 0) & (page >= 0) & (page < P)
    cell = page.clamp(0, P - 1) * ps + posc % ps
    # torch has no drop mode, and a sync to select the writing rows would
    # stall the step. A dropped row is sent instead to the cell of the first
    # writing row with that row's value: duplicate indices then carry equal
    # values, so the write is exact and deterministic. With no writing row
    # at all, every row rewrites cell 0 with the value it already holds.
    # ``first`` is a 1-element index: a 0-d one would be read on the host.
    any_ok = ok.any()
    first = torch.argmax(ok.to(torch.int32), dim=0, keepdim=True)
    target = torch.where(ok, cell, torch.where(any_ok, cell[first], 0))
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        flat = pool.view(P * ps, KV, hd)
        fill = torch.where(any_ok, new[first].to(pool.dtype), flat[0])
        vals = torch.where(ok[:, None, None], new.to(pool.dtype), fill)
        flat[target] = vals
    out = ops.paged_attention(q.reshape(B, KV, H // KV, hd), k_pool, v_pool,
                              block_table, pos_vec, window=window)
    return out.reshape(B, H, hd).to(q.dtype), k_pool, v_pool



# ----------------------- static-batch decode ---------------------------- #
# One shared host-int position ``pos`` for the whole batch (the legacy
# ``Engine.prefill`` / ``decode`` API and the SPMD serve step). Under rules
# whose "kv_seq" shards the cache's sequence dim, each rank holds its
# slice of positions: the token is written on the slice that owns its
# slot, and the slices' partial softmax terms are combined (``_kv_combine``).
quantize_kv_token = quantize_kv   # one token's (B, KV, hd) -> (int8, scale)


def _kv_shard(batch: int, S_loc: int):
    """(mesh, kv_seq axes, this rank's first position) of a cache of local
    length ``S_loc`` under the active rules, or None where its sequence is
    whole here."""
    rules = active_rules()
    if rules is None:
        return None
    ax = rules.token_layout(batch, S_loc, seq_name="kv_seq")[1]
    if rules.size(ax) == 1:
        return None
    return rules.mesh, ax, rules.mesh.coord(ax) * S_loc


def _kv_combine(mesh, ax, m, l, o):
    """The slices' (m, l, o) combined by the log-sum-exp rule: the max over
    the axis, each slice's terms rescaled to it and summed (no gradient:
    the decode step's)."""
    g = mesh.get_group(ax)
    M = col.all_reduce(m, g, op="max")
    corr = torch.exp(m - M)
    l_tot = col.all_reduce(l * corr, g)
    o_tot = col.all_reduce(o * corr[..., None], g)
    return o_tot / l_tot.clamp_min(1e-20)[..., None]


def _local_decode_scores(q, k, v, key_positions, pos, window, k_scale=None,
                         v_scale=None):
    """Partial decode attention over a KV slice, before the softmax's
    normalisation. q: (B, KV, G, hd); k/v: (B, S, KV, hd), int8 with
    their (B, S, KV, 1) scales; key_positions: (S,) absolute position per
    key (-1 = empty); pos: keys below it are valid, a host int (one for
    the batch) or a (B,) tensor (one per row). Returns (m, l, o): the
    running max (B, KV, G), the sum of exponentials (B, KV, G) and the
    weighted values (B, KV, G, hd), all f32. A row with no valid key
    takes every key at the finite NEG_INF, as the reference."""
    if k_scale is not None:
        k = k.to(F32) * k_scale
        v = v.to(F32) * v_scale
    s = torch.einsum("bkgd,bskd->bkgs", q.to(F32), k.to(F32))
    s = s * (1.0 / np.sqrt(q.shape[-1]))
    kp = key_positions
    if torch.is_tensor(pos):
        kp, pos = kp[None, :], pos[:, None]
    valid = (kp >= 0) & (kp < pos)
    if window:
        valid &= kp >= pos - window
    vmask = valid[None, None, None, :] if valid.dim() == 1 \
        else valid[:, None, None, :]
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    return m, e.sum(dim=-1), torch.einsum("bkgs,bskd->bkgd", e, v.to(F32))


def _write_local(buf, new, idx: int) -> None:
    """Write one token (B, KV, hd|1) at sequence index ``idx`` of
    (B, S, KV, ...) IN PLACE, cast to the buffer's dtype; an index past
    the buffer writes nothing (the reference's ownership mask)."""
    if 0 <= idx < buf.shape[1]:
        buf[:, idx] = new.to(buf.dtype)


def decode_attention_update(q, k_new, v_new, k_cache, v_cache, pos: int, *,
                            window: int = 0, k_scale=None, v_scale=None,
                            key_positions=None, write_slot=None):
    """This token's KV write + single-token decode attention.

    q: (B, H, hd); k_new/v_new: (B, KV, hd) post-RoPE; k_cache/v_cache:
    (B, S, KV, hd), with their (B, S, KV, 1) f32 scales when int8 (the
    token is quantized on its way in); pos: tokens already cached, a host
    int (this token becomes position ``pos``); write_slot: the cache slot
    it goes to (default pos; a ring buffer passes pos % W); key_positions:
    (S,) int32 absolute position per slot (ring), updated with the write.
    Caches, scales and key_positions are updated IN PLACE.

    Under "kv_seq" rules the caches, scales and key_positions are this
    rank's slice of the positions (the token is written only where its
    slot falls) and q, k_new, v_new its batch rows.

    Returns (out (B, H, hd), k_cache, v_cache, k_scale, v_scale,
    key_positions)."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1:3]
    slot = pos if write_slot is None else write_slot
    shard = _kv_shard(B, S)
    start = shard[2] if shard is not None else 0
    idx = slot - start                  # this slice's row of the slot
    if k_scale is not None:
        (kq, ks), (vq, vs) = quantize_kv_token(k_new), quantize_kv_token(v_new)
        for buf, new in ((k_cache, kq), (v_cache, vq), (k_scale, ks),
                         (v_scale, vs)):
            _write_local(buf, new, idx)
    else:
        _write_local(k_cache, k_new, idx)
        _write_local(v_cache, v_new, idx)
    if key_positions is not None:
        if 0 <= idx < S:
            key_positions[idx] = pos
        kp = key_positions
    else:
        kp = start + torch.arange(S, device=q.device)
    m, l, o = _local_decode_scores(q.reshape(B, KV, H // KV, hd), k_cache,
                                   v_cache, kp, pos + 1, window, k_scale,
                                   v_scale)
    out = o / l.clamp_min(1e-20)[..., None] if shard is None \
        else _kv_combine(shard[0], shard[1], m, l, o)
    return (out.reshape(B, H, hd).to(q.dtype), k_cache, v_cache, k_scale,
            v_scale, key_positions)


def decode_attention(q, k_cache, v_cache, pos: int, *, window: int = 0,
                     kv_scales=None, key_positions=None):
    """Read-only single-token attention over an existing cache (the audio
    decoder's cross attention): keys below ``pos`` (a host int) are
    valid. q: (B, H, hd); k_cache/v_cache: (B, S, KV, hd); kv_scales:
    their (k_scale, v_scale) when int8. Returns (B, H, hd) in q's dtype.
    Under "kv_seq" rules the cache is this rank's slice of the positions,
    combined as ``decode_attention_update``'s."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1:3]
    k_scale, v_scale = kv_scales if kv_scales is not None else (None, None)
    shard = _kv_shard(B, S)
    kp = key_positions if key_positions is not None \
        else (shard[2] if shard is not None else 0) \
        + torch.arange(S, device=q.device)
    m, l, o = _local_decode_scores(q.reshape(B, KV, H // KV, hd), k_cache,
                                   v_cache, kp, pos, window, k_scale,
                                   v_scale)
    out = o / l.clamp_min(1e-20)[..., None] if shard is None \
        else _kv_combine(shard[0], shard[1], m, l, o)
    return out.reshape(B, H, hd).to(q.dtype)

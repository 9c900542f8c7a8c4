"""Plain PyTorch versions of the port's kernels (the allclose reference).

Each function computes what its CUDA kernel computes, on any device; the
CPU runs them, and ``chip_smoke.py`` holds each kernel against them on the
card. They mirror the reference's jnp oracles
(``repro.kernels.ref.paged_attention_ref``, ``repro.core.lora_math.bgmv``
and ``bgmv_expert``, the body of ``repro.core.lora_server.LoRAServer._step``,
and ``repro.kernels.ref``'s ``bgmv_ranked_ref``, ``sgmv_ref``,
``sgmv_ranked_ref``, ``sgmv_rank_grouped_ref``, ``fused_sgmv_ref``,
``fused_sgmv_ranked_ref`` and ``gmm_ref``), f32 inside.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

F32 = torch.float32
NEG_INF = -1e30


def paged_attention_ref(q, k_pool, v_pool, block_tables, pos, window: int = 0):
    """q: (B, KV, G, hd); k/v pool: (P, page_size, KV, hd); block_tables:
    (B, nb) int (-1 = unallocated); pos: (B,) tokens already cached (the row
    attends over key positions 0..pos[b]; pos < 0 -> zeros); ``window`` > 0
    keeps only keys with position > pos - window. -> (B, KV, G, hd) f32.

    Gathers each row's pages into (B, nb*page_size, KV, hd), then runs one
    masked softmax; masked keys are kept out of the exp-sum, so a row
    without a valid key gives exact zeros."""
    B, KV, G, hd = q.shape
    P, ps = k_pool.shape[:2]
    nb = block_tables.shape[1]
    bt = block_tables.long()
    safe = bt.clamp(0, P - 1)
    k = k_pool[safe].reshape(B, nb * ps, KV, hd)
    v = v_pool[safe].reshape(B, nb * ps, KV, hd)
    kp = (torch.arange(nb, device=q.device)[:, None] * ps
          + torch.arange(ps, device=q.device)[None, :])
    kp = torch.where(bt[:, :, None] >= 0, kp[None], -1).reshape(B, nb * ps)
    pos = pos.long()[:, None]
    s = torch.einsum("bkgd,bskd->bkgs", q.to(F32), k.to(F32))
    s = s / math.sqrt(hd)
    valid = (kp >= 0) & (kp <= pos) & (pos >= 0)
    if window:
        valid &= kp > pos - window
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=-1)
    e = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    l = e.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", e, v.to(F32))
    return o / l.clamp_min(1e-20)[..., None]


def bgmv_ref(x, A, B, ids):
    """Per-row shrink-expand (``repro.core.lora_math.bgmv``).

    x: (T, d_in); A: (N, d_in, r); B: (N, r, d_out); ids: (T,) ->
    (T, d_out) f32. Every row gathers the factors of max(ids, 0) (clamped
    to N - 1, as a jnp gather clamps) and contracts in f32; rows with
    ids < 0 then give exact 0. Needs no host sync: the decode batch has
    at most a bucket of rows."""
    safe = ids.long().clamp(0, A.shape[0] - 1)
    h = torch.einsum("td,tdr->tr", x.to(F32), A[safe].to(F32))
    y = torch.einsum("tr,tro->to", h, B[safe].to(F32))
    return torch.where((ids >= 0)[:, None], y, 0.0)


def bgmv_expert_ref(x, A, B, ids, eids, ranks: Optional[torch.Tensor] = None,
                    r_mod: int = 0):
    """Per-row shrink-expand against expert-specific adapters.

    x: (T, d_in); A: (N, E, d_in, r); B: (N, E, r, d_out); ids, eids: (T,)
    -> (T, d_out) f32. Rows with ids < 0 give exact 0. With ``ranks`` (T,),
    the f32 intermediate h is zeroed where (col % r_mod) >= ranks[t] (the
    serving hook's true-rank mask; ``r_mod`` defaults to r).

    Computes on the active rows only and scatters them back: gathering a
    factor slice for every one of the hook's E*C rows would move gigabytes
    at decode, where only T*K of them are active."""
    T = x.shape[0]
    N, E, _, r = A.shape
    d_out = B.shape[-1]
    out = torch.zeros((T, d_out), dtype=F32, device=x.device)
    # a trace on the meta device has no ids to read: every row counts
    act = (torch.arange(T, device=x.device) if x.is_meta
           else torch.nonzero(ids >= 0).reshape(-1))
    slot = ids[act].long().clamp(max=N - 1)
    e = eids[act].long().clamp(0, E - 1)
    h = torch.einsum("td,tdr->tr", x[act].to(F32), A[slot, e].to(F32))
    if ranks is not None:
        col = torch.arange(r, device=x.device)[None, :]
        h = torch.where((col % (r_mod or r)) < ranks[act].long()[:, None],
                        h, 0.0)
    out[act] = torch.einsum("tr,tro->to", h, B[slot, e].to(F32))
    return out


def lora_hook_ref(rows, A, B, slots, eids, ranks, r_pool: int):
    """The disaggregated LoRA Server's hook for one layer (the body of the
    reference's ``LoRAServer._step``): rows (R, d_in) against the slot
    pool's factors A (M, E, d_in, r2) and B (M, E, r2, d_out) of that
    layer, with each row's true rank applied as (col % r_pool) < rank —
    the fused gate|up hook is block-diagonal, so an adapter of true rank k
    fills the first k columns of each r_pool-wide block. Slots < 0 give 0."""
    return bgmv_expert_ref(rows, A, B, slots, eids, ranks=ranks,
                           r_mod=r_pool)


def _rank_mask(h, ranks):
    """h (..., r) with columns >= ranks (broadcast over the last axis)
    forced to +0.0."""
    col = torch.arange(h.shape[-1], device=h.device)
    return torch.where(col < ranks.long()[..., None], h, 0.0)


def bgmv_ranked_ref(x, A, B, ids, ranks):
    """``bgmv_ref`` with h zeroed at columns >= the row's adapter true rank
    (``ranks`` (N,) per adapter; ids past N - 1 clamp, ids < 0 give 0)."""
    safe = ids.long().clamp(0, A.shape[0] - 1)
    row_ranks = torch.where(ids >= 0, ranks.to(ids.device)[safe], 0)
    h = torch.einsum("td,tdr->tr", x.to(F32), A[safe].to(F32))
    y = torch.einsum("tr,tro->to", _rank_mask(h, row_ranks), B[safe].to(F32))
    return torch.where((ids >= 0)[:, None], y, 0.0)


def _segments(seg_rows, a, b, active, seg_rank=None):
    """One shrink-expand chain per segment against its gathered factors
    a (S, d_in, r) and b (S, r, d_out); inactive segments give 0."""
    h = torch.einsum("scd,sdr->scr", seg_rows.to(F32), a.to(F32))
    if seg_rank is not None:
        h = _rank_mask(h, seg_rank[:, None])
    y = torch.einsum("scr,sro->sco", h, b.to(F32))
    return torch.where(active[:, None, None], y, 0.0)


def sgmv_ref(seg_rows, seg_adapter, A, B):
    """seg_rows (S, cap, d_in); seg_adapter (S,) (-1 = padding segment);
    A (N, d_in, r); B (N, r, d_out) -> (S, cap, d_out) f32."""
    ids = seg_adapter.long().clamp(0, A.shape[0] - 1)
    return _segments(seg_rows, A[ids], B[ids], seg_adapter >= 0)


def sgmv_ranked_ref(seg_rows, seg_adapter, seg_rank, A, B):
    """``sgmv_ref`` with h zeroed at columns >= ``seg_rank[s]``."""
    ids = seg_adapter.long().clamp(0, A.shape[0] - 1)
    return _segments(seg_rows, A[ids], B[ids], seg_adapter >= 0, seg_rank)


def sgmv_rank_grouped_ref(seg_rows, seg_adapter, seg_rank, A, B):
    """The rank-bucketed dispatch computes the true-rank-masked SGMV,
    whatever the bucket layout."""
    return sgmv_ranked_ref(seg_rows, seg_adapter, seg_rank, A, B)


def _slot_expert(seg_slot, seg_eid, A):
    M, E = A.shape[:2]
    return (seg_slot.long().clamp(0, M - 1), seg_eid.long().clamp(0, E - 1))


def fused_sgmv_ref(seg_rows, seg_slot, seg_eid, A, B):
    """seg_rows (S, cap, d_in); seg_slot (S,) (-1 = padding segment);
    seg_eid (S,); A (M, E, d_in, r); B (M, E, r, d_out) ->
    (S, cap, d_out) f32: the fused server-hook operator."""
    m, e = _slot_expert(seg_slot, seg_eid, A)
    return _segments(seg_rows, A[m, e], B[m, e], seg_slot >= 0)


def fused_sgmv_ranked_ref(seg_rows, seg_slot, seg_eid, seg_rank, A, B):
    """``fused_sgmv_ref`` with h zeroed at columns >= ``seg_rank[s]``."""
    m, e = _slot_expert(seg_slot, seg_eid, A)
    return _segments(seg_rows, A[m, e], B[m, e], seg_slot >= 0, seg_rank)


def gmm_ref(xe, w, group_sizes=None):
    """xe (E, C, d); w (E, d, f) -> (E, C, f) f32; rows at or past
    group_sizes[e] are zeroed (ragged groups)."""
    y = torch.einsum("ecd,edf->ecf", xe.to(F32), w.to(F32))
    if group_sizes is None:
        return y
    rows = torch.arange(xe.shape[1], device=xe.device)
    return torch.where((rows[None, :] < group_sizes.long()[:, None])[..., None],
                       y, 0.0)

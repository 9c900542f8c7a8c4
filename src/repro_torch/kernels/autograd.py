"""Gradients of the LoRA shrink-expand and grouped-GEMM kernels: one
``torch.autograd.Function`` each for ``bgmv``, ``bgmv_expert`` and
``gmm``, which ``kernels.ops`` takes whenever an operand requires a
gradient (the training plane; the serving paths keep calling the kernels
directly).

Forward: the wrapper's dispatch, which ``ops`` passes in: the
hand-written kernel on a CUDA tensor, its plain twin (``ref``) on a CPU
one.

Backward of ``bgmv`` / ``bgmv_expert`` (y = (x A) B, a row's factors
picked by its adapter id, and expert id):
  - dx is itself a shrink-expand over the transposed factors,
    dx = (dy Bᵀ) Aᵀ = bgmv(dy, Bᵀ, Aᵀ, ids), through the same dispatch:
    on the card the same hand-written kernel (the factors are small, so
    their transposed copies cost little), on the CPU the twin;
  - dA and dB are per-factor sums of outer products. The rows are grouped
    by their factor (adapter, or adapter and expert), one matmul a group
    and product, batched over the groups: dB = (x A)ᵀ dy, dA = xᵀ (dy Bᵀ).
    A per-row outer product would be T x d x r floats (about 1 GB at
    T = 4096). Finding the groups reads their sizes on the host.
With the serving hook's true-rank mask, h = x A is masked the same way in
every product (dx's kernel takes the mask too).

Backward of ``gmm`` (y[e] = xe[e] w[e], rows at or past group_sizes[e]
zero): dy masked at those rows, then dx = dy wᵀ and, where the weights
train, dw = xeᵀ dy, each a batched product over the experts
(``matmul_f32``; the reference computes the base expert GEMMs as einsums
outside any kernel).

Every gradient comes back in its operand's dtype."""
from __future__ import annotations

from typing import Optional

import torch

F32 = torch.float32


def matmul_f32(a, b):
    """a @ b (2-D, or batched 3-D) with an f32 result, for f32 or bf16
    operands: two f32 ones multiply in f32, two bf16 ones in bf16 with f32
    accumulation (cuBLAS ``out_dtype`` on the card). An f32 operand that
    meets a bf16 one (a gradient meeting a bf16 weight) is split on the
    card into its bf16 high and low halves, two products: within ~2^-16
    of the f32 product, where one bf16 product of the rounded gradient
    would part from it by 2^-9. Off the card both go to f32; a trace on
    the meta device takes the card's branch."""
    mm = torch.bmm if a.dim() == 3 else torch.mm
    if a.dtype == F32 and b.dtype == F32:
        return mm(a, b)
    if a.device.type not in ("cuda", "meta"):
        return mm(a.to(F32), b.to(F32))
    if a.dtype == b.dtype:
        return mm(a, b, out_dtype=F32)

    def halves(t):
        hi = t.to(torch.bfloat16)
        return hi, (t - hi.to(F32)).to(torch.bfloat16)

    if a.dtype == F32:
        hi, lo = halves(a)
        return mm(hi, b, out_dtype=F32) + mm(lo, b, out_dtype=F32)
    hi, lo = halves(b)
    return mm(a, hi, out_dtype=F32) + mm(a, lo, out_dtype=F32)


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an op on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _t(f: torch.Tensor) -> torch.Tensor:
    """A factor with its last two dims swapped, contiguous (the kernels
    read their factors row-major)."""
    return f.transpose(-1, -2).contiguous()


# --------------------------- factor gradients --------------------------- #
def _factor_grads(x, dy, A, B, key, valid, want_a: bool, want_b: bool,
                  rank_mask=None):
    """dA, dB of y = mask(x A[key]) B[key] over the rows where ``valid``;
    A (G, d_in, r), B (G, r, d_out) are the factors flattened to one group
    index ``key`` (T,). Rows are grouped by key (a stable sort; the group
    sizes are read on the host); each product runs in f32, one batched
    matmul over the groups, each padded with zero rows to the largest.
    Training has one adapter, so ``bgmv`` has one group; an expert hook's
    groups are bounded by the capacity C, so the padded rows stay within
    the forward's E*C. ``rank_mask`` (T, r) bool masks h where the hook
    masks it."""
    dA = torch.zeros(A.shape, dtype=F32, device=A.device) if want_a \
        else None
    dB = torch.zeros(B.shape, dtype=F32, device=B.device) if want_b \
        else None
    rows = torch.nonzero(valid).reshape(-1)
    if rows.numel() == 0:
        return dA, dB
    k = key[rows]
    order = torch.argsort(k, stable=True)
    rows, k = rows[order], k[order]
    groups, counts = torch.unique_consecutive(k, return_counts=True)
    xs, dys = x[rows].to(F32), dy[rows].to(F32)
    ms = rank_mask[rows] if rank_mask is not None else None
    n_max = int(counts.max())
    gi = torch.repeat_interleave(
        torch.arange(len(groups), device=x.device), counts)
    pos = torch.arange(len(rows), device=x.device) \
        - (torch.cumsum(counts, 0) - counts)[gi]

    def pad(t):
        out = t.new_zeros((len(groups), n_max) + t.shape[1:])
        out[gi, pos] = t
        return out

    xs, dys = pad(xs), pad(dys)
    ms = None if ms is None else pad(ms)
    if want_b:
        h = torch.bmm(xs, A[groups].to(F32))
        if ms is not None:
            h = torch.where(ms, h, 0.0)
        dB[groups] = torch.bmm(h.transpose(1, 2), dys)
    if want_a:
        gh = torch.bmm(dys, B[groups].to(F32).transpose(1, 2))
        if ms is not None:
            gh = torch.where(ms, gh, 0.0)
        dA[groups] = torch.bmm(xs.transpose(1, 2), gh)
    return dA, dB


def _cast(t: Optional[torch.Tensor], like: torch.Tensor):
    return None if t is None else t.to(like.dtype)


class BgmvFn(torch.autograd.Function):
    """``ops.bgmv`` under autograd: fwd (its dispatch), x (T, d_in),
    A (N, d_in, r), B (N, r, d_out), ids (T,) int32 -> (T, d_out) f32."""

    @staticmethod
    def forward(ctx, fwd, x, A, B, ids):
        ctx.save_for_backward(x, A, B, ids)
        ctx.fwd = fwd
        return fwd(x, A, B, ids)

    @staticmethod
    def backward(ctx, dy):
        x, A, B, ids = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dA = dB = None
        if ctx.needs_input_grad[1]:
            dx = ctx.fwd(dy, _t(B), _t(A), ids).to(x.dtype)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            key = ids.long().clamp(0, A.shape[0] - 1)
            dA, dB = _factor_grads(x, dy, A, B, key, ids >= 0,
                                   ctx.needs_input_grad[2],
                                   ctx.needs_input_grad[3])
        return None, dx, _cast(dA, A), _cast(dB, B), None


class BgmvExpertFn(torch.autograd.Function):
    """``ops.bgmv_expert`` under autograd: fwd (its dispatch), x (T, d_in),
    A (N, E, d_in, r), B (N, E, r, d_out), ids/eids (T,) int32, optional
    ranks (T,) and r_mod -> (T, d_out) f32."""

    @staticmethod
    def forward(ctx, fwd, x, A, B, ids, eids, ranks, r_mod):
        ctx.save_for_backward(x, A, B, ids, eids, ranks)
        ctx.fwd, ctx.r_mod = fwd, r_mod
        return fwd(x, A, B, ids, eids, ranks, r_mod)

    @staticmethod
    def backward(ctx, dy):
        x, A, B, ids, eids, ranks = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dA = dB = None
        if ctx.needs_input_grad[1]:
            dx = ctx.fwd(dy, _t(B), _t(A), ids, eids, ranks,
                         ctx.r_mod).to(x.dtype)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            N, E, d_in, r = A.shape
            key = (ids.long().clamp(0, N - 1) * E
                   + eids.long().clamp(0, E - 1))
            mask = None
            if ranks is not None:
                col = torch.arange(r, device=x.device)[None, :]
                mask = (col % (ctx.r_mod or r)) < ranks.long()[:, None]
            dA, dB = _factor_grads(x, dy, A.reshape(N * E, d_in, r),
                                   B.reshape(N * E, r, -1), key, ids >= 0,
                                   ctx.needs_input_grad[2],
                                   ctx.needs_input_grad[3], mask)
            dA = None if dA is None else dA.reshape(A.shape)
            dB = None if dB is None else dB.reshape(B.shape)
        return None, dx, _cast(dA, A), _cast(dB, B), None, None, None, None


class GmmFn(torch.autograd.Function):
    """``ops.gmm`` under autograd: fwd (its dispatch), xe (E, C, d),
    w (E, d, f), optional group_sizes (E,) int32 -> (E, C, f) f32."""

    @staticmethod
    def forward(ctx, fwd, xe, w, group_sizes):
        ctx.save_for_backward(xe, w, group_sizes)
        return fwd(xe, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        xe, w, group_sizes = ctx.saved_tensors
        if group_sizes is not None:
            rows = torch.arange(xe.shape[1], device=dy.device)
            keep = rows[None, :] < group_sizes.long()[:, None]
            dy = torch.where(keep[..., None], dy, 0.0)
        dy = dy.to(F32)
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dx = matmul_f32(dy, w.transpose(1, 2)).to(xe.dtype)
        if ctx.needs_input_grad[2]:
            dw = matmul_f32(xe.transpose(1, 2), dy).to(w.dtype)
        return None, dx, dw, None

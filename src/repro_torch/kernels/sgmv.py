"""Segmented LoRA shrink-expand on Hopper: the layout helpers and the
wrappers of ``csrc/sgmv.cu`` for the single-index forms.

``sgmv`` ports the TPU kernel ``repro.kernels.sgmv.sgmv`` and
``sgmv_ranked`` ports ``repro.kernels.sgmv.sgmv_ranked`` (plain twins:
``ref.sgmv_ref`` and ``ref.sgmv_ranked_ref``):

  seg_rows (S, cap, d_in) | seg_adapter (S,) int32 (-1 = padding segment)
  | seg_rank (S,) int32 (ranked) | A (N, d_in, r) | B (N, r, d_out)
  -> (S, cap, d_out) f32

``sgmv_rank_grouped`` (the reference's ``repro.kernels.ops
.sgmv_rank_grouped``) launches ``sgmv`` once per distinct active rank, each
bucket reading only its rank's columns of the pool in place.

``build_segments`` and ``build_segments_ranked`` turn a flat batch of rows
with one adapter id each into that layout, on the rows' device and without
a host sync.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import (check_cuda, check_int32, dtype_code,
                                         raise_on_error)
from repro_torch.kernels.bgmv import VEC_BYTES, _check_factors
from repro_torch.kernels.paged import N_SM

INT32_MAX = 2**31 - 1


def _lib():
    lib = build.load("sgmv")
    fn = lib.sgmv_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i] + [p] * 7 + [i] * 9 + [p]
        fn.restype = ctypes.c_int
        for name in ("sgmv_max_rank", "sgmv_tile_cols", "sgmv_window_rows"):
            getattr(lib, name).restype = ctypes.c_int
        lib.sgmv_tile_cols.argtypes = [i]
    return lib


def tile_plan(windows: int, d_out: int, tile_cols: int) -> int:
    """d_out tiles per block: all of d_out in one block when the row
    windows (segments x cap / 8) fill the card (about two blocks per SM),
    else d_out split across blocks."""
    n_tiles = -(-d_out // tile_cols)
    blocks_y = min(n_tiles, max(1, -(-2 * N_SM // max(windows, 1))))
    return -(-n_tiles // blocks_y)


def launch(name: str, seg_rows, A, B, slots, eids, ranks, out, r: int):
    """One launch of ``csrc/sgmv.cu`` over the first ``r`` rank columns of
    the pool. A: (M, E, d_in, r_pool), B: (M, E, r_pool, d_out); ``eids``
    None means E = 1; ``ranks`` None means the padded form. ``out`` is
    (S, cap, d_out) f32 and contiguous. The caller counts the launch."""
    operands = [seg_rows, A, B, slots, out] + [t for t in (eids, ranks)
                                               if t is not None]
    dev = check_cuda(name, *operands)
    check_int32(name, slots, *[t for t in (eids, ranks) if t is not None])
    if seg_rows.dim() != 3 or A.dim() != 4 or B.dim() != 4:
        raise ValueError(f"{name}: seg_rows (S,cap,d_in), A (M,E,d_in,r), "
                         f"B (M,E,r,d_out)")
    S, cap, d_in = seg_rows.shape
    M, E, _, r_pool = A.shape
    d_out = B.shape[-1]
    if tuple(A.shape[2:]) != (d_in, r_pool) or \
            tuple(B.shape[:3]) != (M, E, r_pool):
        raise ValueError(f"{name}: shapes seg_rows {tuple(seg_rows.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)} disagree")
    if any(tuple(t.shape) != (S,) for t in (slots, eids, ranks)
           if t is not None):
        raise ValueError(f"{name}: segment ids and ranks must be (S,)")
    if tuple(out.shape) != (S, cap, d_out) or out.dtype != torch.float32:
        raise ValueError(f"{name}: out must be (S, cap, d_out) float32")
    lib = _lib()
    if not 0 < r <= min(r_pool, lib.sgmv_max_rank()):
        raise ValueError(f"{name}: rank columns r={r} must lie in "
                         f"1..min(r_pool={r_pool}, {lib.sgmv_max_rank()})")
    _check_factors(name, A, B, r, d_out)
    if r_pool % (VEC_BYTES // A.element_size()):
        raise ValueError(f"{name}: the pool's rank r_pool={r_pool} must be a "
                         f"multiple of the 16-byte vector")
    xvec = VEC_BYTES // seg_rows.element_size()
    if d_in % xvec or seg_rows.data_ptr() % VEC_BYTES:
        raise ValueError(f"{name}: d_in={d_in} must be a multiple of {xvec} "
                         f"and seg_rows 16-byte aligned")
    if S == 0 or cap == 0:
        return out
    windows = S * -(-cap // lib.sgmv_window_rows())
    tpb = tile_plan(windows, d_out, lib.sgmv_tile_cols(dtype_code(name, A)))
    err = lib.sgmv_launch(
        dtype_code(name, seg_rows), dtype_code(name, A),
        int(ranks is not None), seg_rows.data_ptr(), A.data_ptr(),
        B.data_ptr(), slots.data_ptr(),
        eids.data_ptr() if eids is not None else None,
        ranks.data_ptr() if ranks is not None else None, out.data_ptr(),
        S, cap, M, E, d_in, r, r_pool, d_out, tpb,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(name, err)
    return out


def _out(seg_rows, B):
    S, cap, _ = seg_rows.shape
    return torch.empty((S, cap, B.shape[-1]), dtype=torch.float32,
                       device=seg_rows.device)


def sgmv(seg_rows, seg_adapter, A, B):
    """Launch the CUDA kernel on CUDA tensors (see module docstring)."""
    out = launch("sgmv", seg_rows, A[:, None], B[:, None], seg_adapter, None,
                 None, _out(seg_rows, B), A.shape[-1])
    sgmv.launches += 1
    return out


sgmv.launches = 0


def sgmv_ranked(seg_rows, seg_adapter, seg_rank, A, B):
    """``sgmv`` with h zeroed at columns ``>= seg_rank[s]``; launches the
    CUDA kernel on CUDA tensors."""
    out = launch("sgmv_ranked", seg_rows, A[:, None], B[:, None],
                 seg_adapter, None, seg_rank, _out(seg_rows, B), A.shape[-1])
    sgmv_ranked.launches += 1
    return out


sgmv_ranked.launches = 0


def rank_buckets(seg_adapter, seg_rank, r: int, vec: int
                 ) -> List[Tuple[int, int, int]]:
    """The launches of ``sgmv_rank_grouped``: (first segment, end, rank
    columns) for each distinct rank of the active segments, the columns
    being the rank rounded up to the kernel's 16-byte vector ``vec`` (8
    bf16, 4 f32) and at most the pool rank ``r``. Each bucket must be one
    contiguous run of segments, as ``build_segments_ranked`` lays them out.
    Reads the ranks on the host (one sync, as the reference's loop)."""
    ad = seg_adapter.tolist()
    rk = seg_rank.tolist()
    runs: List[Tuple[int, int, int]] = []
    for s, (a, k) in enumerate(zip(ad, rk)):
        if a < 0:
            continue
        if runs and runs[-1][1] == s and runs[-1][2] == k:
            runs[-1] = (runs[-1][0], s + 1, k)
        else:
            runs.append((s, s + 1, k))
    if len({k for _, _, k in runs}) != len(runs):
        raise ValueError("sgmv_rank_grouped: the segments of one rank are "
                         "not contiguous (lay them out with "
                         "build_segments_ranked)")
    return [(lo, hi, min(r, max(vec, -(-int(k) // vec) * vec)))
            for lo, hi, k in runs]


def sgmv_rank_grouped(seg_rows, seg_adapter, seg_rank, A, B):
    """Rank-bucketed SGMV: one ``sgmv`` launch per distinct active rank,
    over that bucket's segments and the first columns of the pool that
    cover its rank (read in place, no copy). The segments outside every
    bucket (inactive) are set to zeros. On a prefix-zero pool it gives the
    values of ``sgmv_ranked``."""
    check_cuda("sgmv_rank_grouped", seg_rows, seg_adapter, seg_rank, A, B)
    out = _out(seg_rows, B)
    vec = VEC_BYTES // A.element_size()
    done = 0
    for lo, hi, cols in rank_buckets(seg_adapter, seg_rank, A.shape[-1], vec):
        out[done:lo].zero_()
        launch("sgmv", seg_rows[lo:hi], A[:, None], B[:, None],
               seg_adapter[lo:hi], None, None, out[lo:hi], cols)
        sgmv.launches += 1
        done = hi
    out[done:].zero_()
    return out


def build_segments(rows, row_adapter, n_adapters: int, cap: int):
    """Group rows by adapter into capacity-padded segments (the reference's
    ``repro.kernels.sgmv.build_segments``).

    rows (T, d) | row_adapter (T,) int (-1 = padding row) ->
    (seg_rows (n_adapters, cap, d), seg_adapter (n_adapters,) int32, -1 for
    an adapter without rows, scatter (T,) int32: each row's flat slot in
    seg_rows.reshape(-1, d), or n_adapters * cap for a row that was dropped
    (padding, or past cap rows of its adapter)).

    A stable sort by adapter; padding rows sort first and are kept out of
    adapter 0's count. Dropped rows are written to a sentinel row past the
    segments, which is then cut off, so the write needs no "drop" mode and
    their duplicate writes there are harmless. No host sync."""
    T, d = rows.shape
    dev = rows.device
    ra = row_adapter.long()
    order = torch.argsort(ra, stable=True)
    sorted_ad = ra[order]
    real = ra >= 0
    counts = torch.zeros(n_adapters + 1, dtype=torch.long, device=dev)
    counts.scatter_add_(0, torch.where(real, ra, n_adapters),
                        torch.ones_like(ra))
    counts = counts[:n_adapters]
    n_padding = (~real).sum()
    starts = torch.cumsum(counts, 0) - counts
    pos = (torch.arange(T, device=dev) - n_padding
           - starts[sorted_ad.clamp(min=0)])
    keep = (pos < cap) & (sorted_ad >= 0)
    sentinel = n_adapters * cap
    slot = torch.where(keep, sorted_ad.clamp(min=0) * cap + pos, sentinel)
    seg = torch.zeros((sentinel + 1, d), dtype=rows.dtype, device=dev)
    seg[slot] = rows[order]
    seg_rows = seg[:-1].reshape(n_adapters, cap, d)
    seg_adapter = torch.where(counts > 0,
                              torch.arange(n_adapters, device=dev), -1)
    scatter = torch.empty(T, dtype=torch.int32, device=dev)
    scatter[order] = slot.to(torch.int32)
    return seg_rows, seg_adapter.to(torch.int32), scatter


def build_segments_ranked(rows, row_adapter, n_adapters: int, cap: int,
                          adapter_ranks):
    """``build_segments`` plus each segment's true rank, with segments
    sorted by ascending rank and inactive ones last (stable, so equal ranks
    keep adapter order), so every rank bucket is one contiguous run (the
    reference's ``repro.kernels.sgmv.build_segments_ranked``).

    Returns (seg_rows, seg_adapter, seg_rank, scatter); the scatter is
    remapped through the permutation, so ``out.reshape(-1, d_out)[scatter]``
    gives each input row's delta as with ``build_segments``."""
    seg_rows, seg_adapter, scatter = build_segments(rows, row_adapter,
                                                    n_adapters, cap)
    dev = rows.device
    ranks = torch.as_tensor(adapter_ranks, dtype=torch.int32).to(dev)
    active = seg_adapter >= 0
    seg_rank = torch.where(active, ranks[seg_adapter.long().clamp(min=0)], 0)
    key = torch.where(active, seg_rank, INT32_MAX)
    perm = torch.argsort(key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=dev)
    sentinel = n_adapters * cap
    sc = scatter.long()
    old_seg = (sc // cap).clamp(max=n_adapters - 1)
    remapped = inv[old_seg] * cap + sc % cap
    scatter = torch.where(sc < sentinel, remapped, sentinel)
    return (seg_rows[perm], seg_adapter[perm],
            seg_rank[perm].to(torch.int32), scatter.to(torch.int32))


def gather_rows(out, scatter):
    """Each input row's result from a segmented (S, cap, d_out) output:
    ``out.reshape(-1, d_out)[scatter]``, with 0 on dropped rows (scatter
    at the sentinel S * cap)."""
    flat = out.reshape(-1, out.shape[-1])
    sc = scatter.long()
    kept = sc < flat.shape[0]
    got = flat[sc.clamp(max=flat.shape[0] - 1)]
    return torch.where(kept[:, None], got, 0.0)

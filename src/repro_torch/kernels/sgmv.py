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
bucket a list of segment indices in any order, reading only its rank's
columns of the pool in place.

``build_segments`` and ``build_segments_ranked`` turn a flat batch of rows
with one adapter id each into that layout, on the rows' device and without
a host sync.
"""
from __future__ import annotations

import bisect
import ctypes
from typing import List, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import (check_cuda, check_int32, dtype_code,
                                         raise_on_error)
from repro_torch.kernels.bgmv import _check_factors

INT32_MAX = 2**31 - 1


def _lib():
    lib = build.load("sgmv")
    fn = lib.sgmv_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i] + [p] * 9 + [i] * 10 + [p]
        fn.restype = ctypes.c_int
        for name in ("sgmv_max_rank", "sgmv_max_splits"):
            getattr(lib, name).restype = ctypes.c_int
        lib.sgmv_part_floats.argtypes = [i, i, i]
        lib.sgmv_part_floats.restype = ctypes.c_longlong
    return lib


SPLIT_ROWS = 1024   # d_in rows of a shrink item, up to the most splits


def split_plan(d_in: int, max_splits: int = 16) -> int:
    """Splits of d_in for ``csrc/sgmv.cu``'s shrink items: enough that an
    item contracts at most SPLIT_ROWS rows (4 at d_in = 4096, 2 at 1536),
    at most ``max_splits``; the items then fill the card and balance its
    persistent grid."""
    return max(1, min(max_splits, -(-d_in // SPLIT_ROWS)))


def _operands(name: str, seg_rows, A, B, slots, eids, ranks, out):
    """Checks of one call of ``csrc/sgmv.cu``; returns the library and
    (S, cap, d_in, M, E, r_pool, d_out)."""
    extra = [t for t in (eids, ranks) if t is not None]
    check_cuda(name, seg_rows, A, B, slots, out, *extra)
    check_int32(name, slots, *extra)
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
    _check_factors(name, A, B)
    return _lib(), (S, cap, d_in, M, E, r_pool, d_out)


def _check_rank(name: str, lib, r: int, r_pool: int) -> None:
    if not 0 < r <= min(r_pool, lib.sgmv_max_rank()):
        raise ValueError(f"{name}: rank columns r={r} must lie in "
                         f"1..min(r_pool={r_pool}, {lib.sgmv_max_rank()})")


def _call(name, lib, dims, seg_rows, A, B, slots, eids, ranks, index, out,
          r: int) -> None:
    """One launch of ``csrc/sgmv.cu`` on checked operands (``dims`` from
    ``_operands``) over the segments ``index`` (None: all S in order)."""
    S, cap, d_in, M, E, r_pool, d_out = dims
    _check_rank(name, lib, r, r_pool)
    n_seg = S if index is None else index.shape[0]
    if n_seg == 0 or cap == 0:
        return
    dev = out.device
    with torch.cuda.device(dev):
        splits = split_plan(d_in, lib.sgmv_max_splits())
        part = torch.empty(n_seg * lib.sgmv_part_floats(cap, r, splits),
                           dtype=torch.float32, device=dev)
        err = lib.sgmv_launch(
            dtype_code(name, seg_rows), dtype_code(name, A),
            int(ranks is not None), seg_rows.data_ptr(), A.data_ptr(),
            B.data_ptr(), slots.data_ptr(),
            eids.data_ptr() if eids is not None else None,
            ranks.data_ptr() if ranks is not None else None,
            index.data_ptr() if index is not None else None,
            out.data_ptr(), part.data_ptr(), S, n_seg, cap, M, E, d_in, r,
            r_pool, d_out, splits, torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(name, err)


def launch(name: str, seg_rows, A, B, slots, eids, ranks, out, r: int):
    """One launch of ``csrc/sgmv.cu`` over all segments and the first ``r``
    rank columns of the pool. A: (M, E, d_in, r_pool), B: (M, E, r_pool,
    d_out); ``eids`` None means E = 1; ``ranks`` None means the padded
    form. ``out`` is (S, cap, d_out) f32 and contiguous. The caller counts
    the launch."""
    lib, dims = _operands(name, seg_rows, A, B, slots, eids, ranks, out)
    _call(name, lib, dims, seg_rows, A, B, slots, eids, ranks, None, out, r)
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


def rank_buckets(seg_adapter, seg_rank, r: int
                 ) -> Tuple[torch.Tensor, List[Tuple[int, torch.Tensor]]]:
    """The launches of ``sgmv_rank_grouped``, for segments in any order:
    the inactive segments, and for each distinct rank of the active ones
    in ascending order (its rank columns, at most the pool rank ``r``; its
    segments in ascending order). The index lists are int32 slices of one
    tensor on the segments' device, sorted there; the host reads the
    sorted ranks once (one sync, as the reference's loop reads them)."""
    act = seg_adapter >= 0
    key = torch.where(act, seg_rank.clamp(min=0), -1)
    order = torch.argsort(key, stable=True).to(torch.int32)
    keys = key[order.long()].tolist()
    n_idle = lo = bisect.bisect_right(keys, -1)
    buckets = []
    while lo < len(keys):
        hi = bisect.bisect_right(keys, keys[lo], lo)
        buckets.append((min(r, int(keys[lo])), order[lo:hi]))
        lo = hi
    return order[:n_idle], buckets


def sgmv_rank_grouped(seg_rows, seg_adapter, seg_rank, A, B):
    """Rank-bucketed SGMV: one ``sgmv`` launch per distinct active rank,
    over that bucket's segments (any order: the kernel takes their
    indices) and the pool's first rank columns (read in place, no copy).
    The inactive segments ride with the first launch, which stores their
    zeros; an active segment of rank 0 gets zeros. On a prefix-zero pool it
    gives the values of ``sgmv_ranked``."""
    name = "sgmv_rank_grouped"
    out = _out(seg_rows, B)
    A, B = A[:, None], B[:, None]
    lib, dims = _operands(name, seg_rows, A, B, seg_adapter, None, seg_rank,
                          out)
    idle, buckets = rank_buckets(seg_adapter, seg_rank, A.shape[-1])
    runs = [(cols, idx) for cols, idx in buckets if cols > 0]
    if not runs or seg_rows.shape[1] == 0:
        return out.zero_()
    for cols, idx in buckets:
        if cols <= 0:
            out[idx.long()] = 0.0
    for b, (cols, idx) in enumerate(runs):
        if b == 0 and idle.shape[0]:
            idx = torch.cat((idle, idx))
        _call(name, lib, dims, seg_rows, A, B, seg_adapter, None, None, idx,
              out, cols)
    sgmv.launches += len(runs)
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

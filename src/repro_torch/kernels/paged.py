"""Paged flash-decode attention on Hopper: the wrapper of
``csrc/paged_attention.cu`` (the port of the TPU kernel
``repro.kernels.paged.paged_attention``; plain twin:
``ref.paged_attention_ref``).

  q (B, KV, G, hd) | k/v pool (P, page_size, KV, hd) | block_tables (B, nb)
  int32 (-1 = unallocated) | pos (B,) int32 -> (B, KV, G, hd) f32

The page axis is split over blocks (flash-decoding) and merged by a second
kernel; a split past a row's last valid key exits at once, so
``split_plan`` needs neither ``pos`` nor a host sync.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import (check_cuda, check_int32, dtype_code,
                                         raise_on_error)

N_SM = 132  # streaming multiprocessors of an H100 SXM


def split_plan(B: int, KV: int, nb: int):
    """(pages per split, number of splits): 8 pages (two 16-key units for
    each of a block's four warps at pages of 16) where the grid still gets
    two blocks a SM, else 4 (one unit a warp)."""
    pps = 8 if B * KV * -(-nb // 8) >= 2 * N_SM else 4
    pps = max(1, min(pps, nb))
    return pps, max(1, -(-nb // pps))


def _lib():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, p, p, p, p, p,
                       i, i, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention(q, k_pool, v_pool, block_tables, pos, *, window: int = 0):
    """Launch the CUDA kernel on CUDA tensors (see module docstring)."""
    name = "paged_attention"
    dev = check_cuda(name, q, k_pool, v_pool, block_tables, pos)
    check_int32(name, block_tables, pos)
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{name}: q (B,KV,G,hd) and equal k/v pools "
                         f"(P,ps,KV,hd) expected")
    B, KV, G, hd = q.shape
    P, ps = k_pool.shape[:2]
    if tuple(k_pool.shape[2:]) != (KV, hd) or P < 1:
        raise ValueError(f"{name}: pool {tuple(k_pool.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if k_pool.dtype != v_pool.dtype:
        raise TypeError(f"{name}: k and v pools differ in dtype")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(pos.shape) != (B,):
        raise ValueError(f"{name}: block_tables (B, nb) and pos (B,) expected")
    nb = block_tables.shape[1]
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    pps, n_split = split_plan(B, KV, nb)
    m_part = torch.empty((B, KV, n_split, G), dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B, KV, n_split, G, hd), dtype=torch.float32,
                           device=dev)
    with torch.cuda.device(dev):
        err = _lib()(
            dtype_code(name, q), dtype_code(name, k_pool), q.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
            pos.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            acc_part.data_ptr(), out.data_ptr(), B, KV, G, hd, P, ps, nb,
            int(window), pps, n_split, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(name, err)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0

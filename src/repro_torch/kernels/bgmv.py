"""LoRA shrink-expand on Hopper: the wrappers of ``csrc/bgmv.cu`` and
``csrc/bgmv_expert.cu``.

``bgmv`` ports the TPU kernel ``repro.kernels.bgmv.bgmv`` (plain twin:
``ref.bgmv_ref``) at any rank, in one launch a call below
``bgmv_pair_rows()`` rows (128) and a shrink/expand pair from there on; the
coupled plane's q/k/v/o deltas run through it.

  x (T, d_in) | A (N, d_in, r) | B (N, r, d_out) | ids (T,) int32
  -> (T, d_out) f32

``bgmv_ranked`` ports ``repro.kernels.bgmv.bgmv_ranked`` through the same
kernel (plain twin: ``ref.bgmv_ranked_ref``): h is zeroed at columns
``>= ranks[ids[t]]``, ranks (N,) int32 per adapter, and the kernel skips
those columns' factor reads.

``bgmv_expert`` ports ``repro.kernels.bgmv.bgmv_expert``, extended with the
serving hook's true-rank mask (plain twin: ``ref.bgmv_expert_ref``); the
LoRA Server's hooks and the coupled plane's expert deltas run through it.

  x (T, d_in) | A (N, E, d_in, r) | B (N, E, r, d_out) | ids, eids (T,) int32
  | ranks (T,) int32 or None | r_mod -> (T, d_out) f32
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import (check_cuda, check_int32, dtype_code,
                                         out_buffer, raise_on_error)

VEC_BYTES = 16  # the kernels stream the factors in 16-byte vectors


def _lib(name: str, n_ptr: int, n_int: int):
    """The library of ``csrc/<name>.cu`` with its launch function typed:
    two dtype codes, ``n_ptr`` pointers, ``n_int`` ints and the stream."""
    lib = build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i] + [p] * n_ptr + [i] * n_int + [p]
        fn.restype = ctypes.c_int
        splits = getattr(lib, f"{name}_splits", None)
        if splits is not None:
            splits.argtypes = [i, i, i]
            splits.restype = ctypes.c_int
        pair = getattr(lib, f"{name}_pair_rows", None)
        if pair is not None:
            pair.restype = ctypes.c_int
        cluster = getattr(lib, f"{name}_cluster_size", None)
        if cluster is not None:
            cluster.argtypes = [i] * 5
            cluster.restype = ctypes.c_int
    return lib


def _check_factors(name, A, B) -> None:
    """What the kernels' factor loads need: one dtype and 16-byte aligned
    factors. Any rank and any d_out: a 16-byte piece of a row that is not
    whole or not aligned is read one value at a time."""
    if A.dtype != B.dtype:
        raise TypeError(f"{name}: A and B differ in dtype")
    if A.data_ptr() % VEC_BYTES or B.data_ptr() % VEC_BYTES:
        raise ValueError(f"{name}: A and B must be 16-byte aligned")


def _bgmv(name, x, A, B, ids, ranks: Optional[torch.Tensor]):
    operands = [x, A, B, ids] + ([ranks] if ranks is not None else [])
    dev = check_cuda(name, *operands)
    check_int32(name, *operands[3:])
    if x.dim() != 2 or A.dim() != 3 or B.dim() != 3:
        raise ValueError(f"{name}: x (T,d_in), A (N,d_in,r), B (N,r,d_out)")
    T, d_in = x.shape
    N, _, r = A.shape
    d_out = B.shape[-1]
    if tuple(A.shape[1:]) != (d_in, r) or tuple(B.shape[:2]) != (N, r):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)} disagree")
    if tuple(ids.shape) != (T,):
        raise ValueError(f"{name}: ids must be (T,)")
    if ranks is not None and tuple(ranks.shape) != (N,):
        raise ValueError(f"{name}: ranks must be (N,), one per adapter")
    lib = _lib("bgmv", 7, 5)
    _check_factors(name, A, B)
    out = torch.empty((T, d_out), dtype=torch.float32, device=dev)
    if T == 0:
        return out
    # the shrink/expand pair's h (csrc/bgmv.cu takes it from this many rows)
    h_g = (torch.empty((T, r), dtype=torch.float32, device=dev)
           if T >= lib.bgmv_pair_rows() else None)
    with torch.cuda.device(dev):
        err = lib.bgmv_launch(
            dtype_code(name, x), dtype_code(name, A), x.data_ptr(),
            A.data_ptr(), B.data_ptr(), ids.data_ptr(),
            ranks.data_ptr() if ranks is not None else None,
            h_g.data_ptr() if h_g is not None else None, out.data_ptr(), T,
            N, d_in, r, d_out, torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(name, err)
    return out


def bgmv(x, A, B, ids):
    """Launch the CUDA kernel on CUDA tensors (see module docstring)."""
    out = _bgmv("bgmv", x, A, B, ids, None)
    if x.shape[0]:
        bgmv.launches += 1
    return out


bgmv.launches = 0


def bgmv_ranked(x, A, B, ids, ranks):
    """``bgmv`` bounded at each row's adapter true rank (``ranks`` (N,)
    int32); launches the CUDA kernel on CUDA tensors."""
    out = _bgmv("bgmv_ranked", x, A, B, ids, ranks)
    if x.shape[0]:
        bgmv_ranked.launches += 1
    return out


bgmv_ranked.launches = 0


def bgmv_expert(x, A, B, ids, eids, ranks: Optional[torch.Tensor] = None,
                r_mod: int = 0, out: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel on CUDA tensors (see module docstring); the
    kernel writes every row of ``out`` when one is given."""
    name = "bgmv_expert"
    operands = [x, A, B, ids, eids] + ([ranks] if ranks is not None else [])
    dev = check_cuda(name, *operands)
    check_int32(name, *operands[3:])
    if x.dim() != 2 or A.dim() != 4 or B.dim() != 4:
        raise ValueError(f"{name}: x (T,d_in), A (N,E,d_in,r), B (N,E,r,d_out)")
    T, d_in = x.shape
    N, E, _, r = A.shape
    d_out = B.shape[-1]
    if tuple(A.shape[2:]) != (d_in, r) or tuple(B.shape[:3]) != (N, E, r):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)} disagree")
    if any(tuple(t.shape) != (T,) for t in operands[3:]):
        raise ValueError(f"{name}: ids, eids and ranks must be (T,)")
    lib = _lib(name, 9, 7)
    _check_factors(name, A, B)
    r_mod = int(r_mod) or r
    out = out_buffer(name, out, (T, d_out), dev)
    if T == 0:
        return out
    # the kernel's d_in splits (csrc/bgmv_expert.cu plans them); the active
    # rows are found on the card, so part has room for all T rows
    splits = lib.bgmv_expert_splits(dtype_code(name, A), d_in, r)
    meta = torch.empty((T + 1, 4), dtype=torch.int32, device=dev)
    part = torch.empty((T, splits, r), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.bgmv_expert_launch(
            dtype_code(name, x), dtype_code(name, A), x.data_ptr(),
            A.data_ptr(), B.data_ptr(), ids.data_ptr(), eids.data_ptr(),
            ranks.data_ptr() if ranks is not None else None, meta.data_ptr(),
            part.data_ptr(), out.data_ptr(), T, N, E, d_in, r, d_out, r_mod,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(name, err)
    bgmv_expert.launches += 1
    return out


bgmv_expert.launches = 0

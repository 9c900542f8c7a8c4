"""Grouped expert GEMM on Hopper: the wrapper of ``csrc/gmm.cu``, the port
of the TPU kernel ``repro.kernels.gmm.gmm`` (plain twin: ``ref.gmm_ref``).
Both serving planes' base expert GEMMs (gate, up, down) run through it,
with the dispatch's group sizes (``models.moe.dispatch``).

  xe (E, C, d) | w (E, d, f) | group_sizes (E,) int32 or None
  -> (E, C, f) f32; rows at or past group_sizes[e] are exact zeros, and a
  tile of rows that all lie there reads no weight.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import (check_cuda, check_int32, dtype_code,
                                         out_buffer, raise_on_error)
from repro_torch.kernels.bgmv import VEC_BYTES


def _lib():
    lib = build.load("gmm")
    fn = lib.gmm_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def gmm(xe, w, group_sizes: Optional[torch.Tensor] = None,
        out: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel on CUDA tensors (see module docstring); the
    kernel writes every element of ``out`` when one is given."""
    name = "gmm"
    operands = [xe, w] + ([group_sizes] if group_sizes is not None else [])
    dev = check_cuda(name, *operands)
    check_int32(name, *operands[2:])
    if xe.dim() != 3 or w.dim() != 3:
        raise ValueError(f"{name}: xe (E,C,d), w (E,d,f)")
    E, C, d = xe.shape
    f = w.shape[-1]
    if tuple(w.shape[:2]) != (E, d):
        raise ValueError(f"{name}: shapes xe {tuple(xe.shape)}, w "
                         f"{tuple(w.shape)} disagree")
    if group_sizes is not None and tuple(group_sizes.shape) != (E,):
        raise ValueError(f"{name}: group_sizes must be (E,)")
    vec = VEC_BYTES // w.element_size()
    if f % vec or w.data_ptr() % VEC_BYTES:
        raise ValueError(f"{name}: f={f} must be a multiple of {vec} and w "
                         f"16-byte aligned")
    out = out_buffer(name, out, (E, C, f), dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib().gmm_launch(
            dtype_code(name, xe), dtype_code(name, w), xe.data_ptr(),
            w.data_ptr(),
            group_sizes.data_ptr() if group_sizes is not None else None,
            out.data_ptr(), E, C, d, f,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(name, err)
    gmm.launches += 1
    return out


gmm.launches = 0

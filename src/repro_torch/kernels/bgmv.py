"""Expert-LoRA shrink-expand on Hopper: the wrapper of
``csrc/bgmv_expert.cu`` (the port of the TPU kernel
``repro.kernels.bgmv.bgmv_expert``, extended with the serving hook's
true-rank mask; plain twin: ``ref.bgmv_expert_ref``).

  x (T, d_in) | A (N, E, d_in, r) | B (N, E, r, d_out) | ids, eids (T,) int32
  | ranks (T,) int32 or None | r_mod -> (T, d_out) f32
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import (check_cuda, check_int32, dtype_code,
                                         raise_on_error)

VEC_BYTES = 16  # the kernel streams the factors in 16-byte vectors


def _lib():
    lib = build.load("bgmv_expert")
    fn = lib.bgmv_expert_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, p, p, p,
                       i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.bgmv_expert_threads.restype = ctypes.c_int
    return lib


def bgmv_expert(x, A, B, ids, eids, ranks: Optional[torch.Tensor] = None,
                r_mod: int = 0):
    """Launch the CUDA kernel on CUDA tensors (see module docstring)."""
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
    if A.dtype != B.dtype:
        raise TypeError(f"{name}: A and B differ in dtype")
    lib = _lib()
    vec = VEC_BYTES // A.element_size()
    groups = r // vec if r % vec == 0 else 0
    if not groups or lib.bgmv_expert_threads() % groups or d_out % vec:
        raise ValueError(f"{name}: r={r} and d_out={d_out} must be multiples "
                         f"of {vec}, with r/{vec} dividing "
                         f"{lib.bgmv_expert_threads()}")
    if A.data_ptr() % VEC_BYTES or B.data_ptr() % VEC_BYTES:
        raise ValueError(f"{name}: A and B must be 16-byte aligned")
    r_mod = int(r_mod) or r
    out = torch.empty((T, d_out), dtype=torch.float32, device=dev)
    if T == 0:
        return out
    err = lib.bgmv_expert_launch(
        dtype_code(name, x), dtype_code(name, A), x.data_ptr(), A.data_ptr(),
        B.data_ptr(), ids.data_ptr(), eids.data_ptr(),
        ranks.data_ptr() if ranks is not None else None, out.data_ptr(),
        T, N, E, d_in, r, d_out, r_mod,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(name, err)
    bgmv_expert.launches += 1
    return out


bgmv_expert.launches = 0

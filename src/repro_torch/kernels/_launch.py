"""Checks shared by the kernel wrappers before they hand pointers to C."""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """All tensors contiguous on one sm_90 CUDA device; returns it. The
    wrapper allocates its scratch there and launches under
    ``torch.cuda.device(dev)``, so what the C side asks of the current
    device (SM count, attributes, the persistent grid) is the operands'
    card, whichever card is current."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every operand must lie on one CUDA "
                             f"device (got {t.device} and {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(f"{name}: the kernel is built for sm_90a (Hopper); "
                           f"this device is sm_{cap[0]}{cap[1]}")
    return dev


def out_buffer(name: str, out, shape, dev) -> torch.Tensor:
    """The f32 output of ``shape`` on ``dev``: ``out`` when the caller gives
    one (contiguous, every element written by the kernel), else new."""
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=dev)
    if tuple(out.shape) != tuple(shape) or out.dtype != torch.float32 or \
            out.device != dev or not out.is_contiguous():
        raise ValueError(f"{name}: out must be a contiguous float32 "
                         f"{tuple(shape)} on {dev}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    return out


def dtype_code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]


def check_int32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index operands must be int32, "
                            f"got {t.dtype}")


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")

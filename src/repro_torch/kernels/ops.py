"""Dispatch of the port's kernels: a tensor on the CPU takes the plain
PyTorch version (``ref``); a CUDA tensor launches the Hopper kernel, which
raises on what it does not take. There is no fallback from the card to the
plain version and no switch that skips the kernel."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import bgmv as _bgmv
from repro_torch.kernels import paged as _paged
from repro_torch.kernels import ref as _ref


def paged_attention(q, k_pool, v_pool, block_tables, pos, *, window: int = 0):
    """Flash-decode attention over a paged KV pool -> (B, KV, G, hd) f32
    (see kernels/paged.py)."""
    if q.device.type == "cpu":
        return _ref.paged_attention_ref(q, k_pool, v_pool, block_tables, pos,
                                        window)
    return _paged.paged_attention(q, k_pool, v_pool, block_tables, pos,
                                  window=window)


def bgmv(x, A, B, ids):
    """Per-row LoRA shrink-expand -> (T, d_out) f32 (see kernels/bgmv.py)."""
    if x.device.type == "cpu":
        return _ref.bgmv_ref(x, A, B, ids)
    return _bgmv.bgmv(x, A, B, ids)


def bgmv_expert(x, A, B, ids, eids, ranks: Optional[torch.Tensor] = None,
                r_mod: int = 0):
    """Per-row expert-LoRA shrink-expand with an optional true-rank mask
    -> (T, d_out) f32 (see kernels/bgmv.py)."""
    if x.device.type == "cpu":
        return _ref.bgmv_expert_ref(x, A, B, ids, eids, ranks, r_mod)
    return _bgmv.bgmv_expert(x, A, B, ids, eids, ranks, r_mod)

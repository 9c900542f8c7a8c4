"""Dispatch of the port's kernels: a tensor on the CPU takes the plain
PyTorch version (``ref``); a CUDA tensor launches the Hopper kernel, which
raises on what it does not take. There is no fallback from the card to the
plain version and no switch that skips the kernel.

``bgmv``, ``bgmv_expert`` and ``gmm`` go through their autograd Functions
(``kernels.autograd``, given the same dispatch for their forward and dx)
when an operand requires a gradient; otherwise they dispatch as above."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import autograd as _ag
from repro_torch.kernels import bgmv as _bgmv
from repro_torch.kernels import fused as _fused
from repro_torch.kernels import gmm as _gmm
from repro_torch.kernels import paged as _paged
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sgmv as _sgmv

build_segments = _sgmv.build_segments
build_segments_ranked = _sgmv.build_segments_ranked


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
    if _ag.needs_grad(x, A, B):
        return _ag.BgmvFn.apply(_bgmv_call, x, A, B, ids)
    return _bgmv_call(x, A, B, ids)


def _bgmv_call(x, A, B, ids):
    if x.device.type == "cpu":
        return _ref.bgmv_ref(x, A, B, ids)
    return _bgmv.bgmv(x, A, B, ids)


def bgmv_expert(x, A, B, ids, eids, ranks: Optional[torch.Tensor] = None,
                r_mod: int = 0, out: Optional[torch.Tensor] = None):
    """Per-row expert-LoRA shrink-expand with an optional true-rank mask
    -> (T, d_out) f32, written into ``out`` when given (see
    kernels/bgmv.py)."""
    if _ag.needs_grad(x, A, B):
        _no_out(out, "bgmv_expert")
        return _ag.BgmvExpertFn.apply(_bgmv_expert_call, x, A, B, ids, eids,
                                      ranks, r_mod)
    return _bgmv_expert_call(x, A, B, ids, eids, ranks, r_mod, out)


def _bgmv_expert_call(x, A, B, ids, eids, ranks=None, r_mod=0, out=None):
    if x.device.type == "cpu":
        return _into(out, _ref.bgmv_expert_ref(x, A, B, ids, eids, ranks,
                                               r_mod))
    return _bgmv.bgmv_expert(x, A, B, ids, eids, ranks, r_mod, out=out)


def bgmv_ranked(x, A, B, ids, ranks):
    """``bgmv`` bounded at each row's adapter true rank (``ranks`` (N,))."""
    if x.device.type == "cpu":
        return _ref.bgmv_ranked_ref(x, A, B, ids, ranks)
    return _bgmv.bgmv_ranked(x, A, B, ids, ranks)


def sgmv(seg_rows, seg_adapter, A, B):
    """Segmented gather shrink-expand -> (S, cap, d_out) f32 (see
    kernels/sgmv.py)."""
    if seg_rows.device.type == "cpu":
        return _ref.sgmv_ref(seg_rows, seg_adapter, A, B)
    return _sgmv.sgmv(seg_rows, seg_adapter, A, B)


def sgmv_ranked(seg_rows, seg_adapter, seg_rank, A, B):
    """``sgmv`` with per-segment true ranks."""
    if seg_rows.device.type == "cpu":
        return _ref.sgmv_ranked_ref(seg_rows, seg_adapter, seg_rank, A, B)
    return _sgmv.sgmv_ranked(seg_rows, seg_adapter, seg_rank, A, B)


def sgmv_rank_grouped(seg_rows, seg_adapter, seg_rank, A, B):
    """Rank-bucketed SGMV: one ``sgmv`` launch per distinct active rank,
    over segments in any order (see kernels/sgmv.py)."""
    if seg_rows.device.type == "cpu":
        return _ref.sgmv_rank_grouped_ref(seg_rows, seg_adapter, seg_rank,
                                          A, B)
    return _sgmv.sgmv_rank_grouped(seg_rows, seg_adapter, seg_rank, A, B)


def fused_sgmv(seg_rows, seg_slot, seg_eid, A, B):
    """The fused server-hook operator over (slot, expert) segments, one
    launch per call (see kernels/fused.py)."""
    if seg_rows.device.type == "cpu":
        return _ref.fused_sgmv_ref(seg_rows, seg_slot, seg_eid, A, B)
    return _fused.fused_sgmv(seg_rows, seg_slot, seg_eid, A, B)


def fused_sgmv_ranked(seg_rows, seg_slot, seg_eid, seg_rank, A, B):
    """``fused_sgmv`` with per-segment true ranks."""
    if seg_rows.device.type == "cpu":
        return _ref.fused_sgmv_ranked_ref(seg_rows, seg_slot, seg_eid,
                                          seg_rank, A, B)
    return _fused.fused_sgmv_ranked(seg_rows, seg_slot, seg_eid, seg_rank,
                                    A, B)


def gmm(xe, w, group_sizes: Optional[torch.Tensor] = None,
        out: Optional[torch.Tensor] = None):
    """Grouped expert GEMM -> (E, C, f) f32, rows past group_sizes zero,
    written into ``out`` when given (see kernels/gmm.py)."""
    if _ag.needs_grad(xe, w):
        _no_out(out, "gmm")
        return _ag.GmmFn.apply(_gmm_call, xe, w, group_sizes)
    return _gmm_call(xe, w, group_sizes, out)


def _gmm_call(xe, w, group_sizes=None, out=None):
    if xe.device.type == "cpu":
        return _into(out, _ref.gmm_ref(xe, w, group_sizes))
    return _gmm.gmm(xe, w, group_sizes, out=out)


def _into(out: Optional[torch.Tensor], y: torch.Tensor) -> torch.Tensor:
    """The plain version's ``y``, copied into ``out`` when one is given."""
    return y if out is None else out.copy_(y)


def _no_out(out: Optional[torch.Tensor], name: str) -> None:
    if out is not None:
        raise ValueError(f"{name}: out= is for the serving paths; an "
                         f"operand requiring a gradient takes none")


def launch_counts() -> dict:
    """{kernel wrapper: its launch count} of every CUDA kernel wrapper
    (each counts where it launches its kernel, and nowhere else)."""
    fns = (_paged.paged_attention, _bgmv.bgmv_expert, _bgmv.bgmv,
           _bgmv.bgmv_ranked, _sgmv.sgmv, _sgmv.sgmv_ranked,
           _fused.fused_sgmv, _fused.fused_sgmv_ranked, _gmm.gmm)
    return {fn.__name__: fn.launches for fn in fns}

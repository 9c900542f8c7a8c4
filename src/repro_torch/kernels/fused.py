"""The fused server-hook operator on Hopper: wrappers of ``csrc/sgmv.cu``
over (slot, expert) segments.

``fused_sgmv`` ports the TPU kernel ``repro.kernels.fused.fused_sgmv`` and
``fused_sgmv_ranked`` ports ``repro.kernels.fused.fused_sgmv_ranked``
(plain twins: ``ref.fused_sgmv_ref`` and ``ref.fused_sgmv_ranked_ref``):

  seg_rows (S, cap, d_in) | seg_slot (S,) int32 (-1 = padding segment)
  | seg_eid (S,) int32 | seg_rank (S,) int32 (ranked) | A (M, E, d_in, r)
  | B (M, E, r, d_out) -> (S, cap, d_out) f32

One launch of ``csrc/sgmv.cu`` (one kernel) per call; the shrink items'
partial h goes through the wrapper's scratch. The ranked form
masks h at ``col < seg_rank[s]``. The LoRA Server's fused gate|up hook is
block-diagonal (two r_pool-wide blocks) and masks at ``col % r_pool <
rank``, which this mask does not express: on the up hook
the path runs the padded ``fused_sgmv`` over a prefix-zero pool, where the
two agree.
"""
from __future__ import annotations

from repro_torch.kernels import sgmv as _sgmv


def fused_sgmv(seg_rows, seg_slot, seg_eid, A, B):
    """Launch the CUDA kernel on CUDA tensors (see module docstring)."""
    out = _sgmv.launch("fused_sgmv", seg_rows, A, B, seg_slot, seg_eid, None,
                       _sgmv._out(seg_rows, B), A.shape[-1])
    fused_sgmv.launches += 1
    return out


fused_sgmv.launches = 0


def fused_sgmv_ranked(seg_rows, seg_slot, seg_eid, seg_rank, A, B):
    """``fused_sgmv`` with h zeroed at columns ``>= seg_rank[s]``; launches
    the CUDA kernel on CUDA tensors."""
    out = _sgmv.launch("fused_sgmv_ranked", seg_rows, A, B, seg_slot,
                       seg_eid, seg_rank, _sgmv._out(seg_rows, B),
                       A.shape[-1])
    fused_sgmv_ranked.launches += 1
    return out


fused_sgmv_ranked.launches = 0

"""Host-side adapter staging: the CPU-assisted conversion path, the
counterpart of ``repro.store.convert`` over CPU ``torch.Tensor``s.

The disaggregated server consumes one fused 4-tensor layout per adapter
(``core.lora_server.pool_tensors_from_adapter``: gate/up concatenated at
rank 2r with a block-diagonal B). The store keeps adapters in a CANONICAL
host format instead (per target {"A", "B"} at the adapter's TRUE rank) and
builds the padded fused server layout on the CPU at staging time
(CaraServe's CPU-assisted serving: the pad/concat/block-diag work happens
off the card, overlapped with decode by the prefetcher).

Every operation here is pure data movement (slice, zero-pad, concatenate),
so staging from the canonical format is BITWISE identical to extracting
the same adapter from a live ``AdapterPool``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.adapter import AdapterPool, active_targets, target_dims

Tensors = Dict[str, torch.Tensor]


def host_tensors_from_pool(pool: AdapterPool, adapter_id: int) -> Tensors:
    """One adapter of a pool in the canonical host format:
    ``{"<target>.A": (L, [E,] d_in, r_true), "<target>.B": ...}`` CPU
    tensors TRIMMED to the adapter's true rank. A mixed-rank pool holds
    +0.0 in the rank tail (and pre-scales B), so trimming loses nothing and
    re-padding at staging time gives the pool's bytes back."""
    r = pool.rank_of(adapter_id)
    out: Tensors = {}
    for tgt, t in pool.tensors.items():
        out[f"{tgt}.A"] = t["A"][:, adapter_id][..., :r].cpu().clone(
            memory_format=torch.contiguous_format)
        out[f"{tgt}.B"] = t["B"][:, adapter_id][..., :r, :].cpu().clone(
            memory_format=torch.contiguous_format)
    return out


def host_tensor_bytes(tensors: Tensors) -> int:
    """Payload bytes of a canonical host tensor set (true-rank sizing)."""
    return sum(t.numel() * t.element_size() for t in tensors.values())


def _pad_rank(t: torch.Tensor, dim: int, r_pool: int) -> torch.Tensor:
    r = t.shape[dim]
    if r == r_pool:
        return t
    if r > r_pool:
        raise ValueError(f"adapter rank {r} exceeds pool rank {r_pool}")
    shape = list(t.shape)
    shape[dim] = r_pool - r
    return torch.cat([t, torch.zeros(shape, dtype=t.dtype)], dim=dim)


def server_tensors_from_host(cfg, tensors: Tensors, r_pool: int) -> Tensors:
    """The fused server slot layout from canonical host tensors: each
    factor zero-padded to the pool rank, the singleton expert dim added for
    non-MoE configs, and gate/up fused as rank 2r with a block-diagonal B;
    the CPU twin of ``pool_tensors_from_adapter``, byte for byte."""
    def tgt(name):
        A = _pad_rank(tensors[f"{name}.A"], -1, r_pool)
        B = _pad_rank(tensors[f"{name}.B"], -2, r_pool)
        if not cfg.is_moe:
            A, B = A[:, None], B[:, None]
        return A, B

    up_A, up_B = tgt("up")
    if cfg.gated_mlp and "gate.A" in tensors:
        g_A, g_B = tgt("gate")
        up_A = torch.cat([g_A, up_A], dim=-1)
        up_B = torch.cat(
            [torch.cat([g_B, torch.zeros_like(g_B)], dim=-1),
             torch.cat([torch.zeros_like(up_B), up_B], dim=-1)],
            dim=-2)
    dn_A, dn_B = tgt("down")
    return {"up_A": up_A, "up_B": up_B, "down_A": dn_A.contiguous(),
            "down_B": dn_B.contiguous()}


def validate_host_tensors(cfg, tensors: Tensors, r_pool: int) -> int:
    """Shape and rank checks for a dynamically registered adapter (the
    load endpoint's admission contract). Returns the adapter's rank.
    Raises ValueError on any mismatch: missing or extra targets, wrong
    layer or expert dims, factor shapes that disagree with the model
    config, or a rank above the server slot pools' capacity."""
    want = set(active_targets(cfg))
    got = {k.rsplit(".", 1)[0] for k in tensors}
    if got != want:
        raise ValueError(f"adapter targets {sorted(got)} != model targets "
                         f"{sorted(want)}")
    L, E = cfg.n_layers, max(cfg.n_experts, 1)
    rank: Optional[int] = None
    for t in sorted(want):
        if f"{t}.A" not in tensors or f"{t}.B" not in tensors:
            raise ValueError(f"target {t!r} needs both A and B factors")
        A, B = tensors[f"{t}.A"], tensors[f"{t}.B"]
        d_in, d_out, per_expert = target_dims(cfg, t)
        lead: Tuple[int, ...] = (L, E) if per_expert else (L,)
        r = int(A.shape[-1])
        if rank is None:
            rank = r
        if r != rank or int(B.shape[-2]) != rank:
            raise ValueError(f"target {t!r}: inconsistent rank (A has "
                             f"{r}, B has {B.shape[-2]}, adapter {rank})")
        if tuple(A.shape) != lead + (d_in, r):
            raise ValueError(f"target {t!r}: A shape {tuple(A.shape)} != "
                             f"{lead + (d_in, r)}")
        if tuple(B.shape) != lead + (rank, d_out):
            raise ValueError(f"target {t!r}: B shape {tuple(B.shape)} != "
                             f"{lead + (rank, d_out)}")
    if rank is None or rank < 1:
        raise ValueError("adapter has no rank dimension")
    if rank > r_pool:
        raise ValueError(f"adapter rank {rank} exceeds the pool/server "
                         f"rank {r_pool}")
    return rank


def rescale_alpha(tensors: Tensors, alpha: float, rank: int,
                  scale: float) -> Tensors:
    """The B factors rescaled from the raw alpha / rank convention into a
    pool's uniform ``scale`` (one scale a batch)."""
    if scale == 0:
        raise ValueError("pool scale is 0; cannot rescale")
    f = (float(alpha) / rank) / scale
    return {k: (v * f).to(v.dtype) if k.endswith(".B") else v
            for k, v in tensors.items()}


def random_host_tensors(cfg, rank: int, seed: int,
                        dtype=torch.bfloat16) -> Tensors:
    """A synthetic adapter in the canonical host format, drawn on the CPU
    from a ``torch.Generator`` seeded with ``seed`` (A ~ N(0, 1) / r, B ~
    N(0, 1) * 0.01, drawn in float32, then cast to ``dtype``)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    L, E = cfg.n_layers, max(cfg.n_experts, 1)
    out: Tensors = {}
    for t in active_targets(cfg):
        d_in, d_out, per_expert = target_dims(cfg, t)
        lead: Tuple[int, ...] = (L, E) if per_expert else (L,)
        A = torch.randn(lead + (d_in, rank), generator=gen) / rank
        B = torch.randn(lead + (rank, d_out), generator=gen) * 0.01
        out[f"{t}.A"] = A.to(dtype)
        out[f"{t}.B"] = B.to(dtype)
    return out

"""LoRA adapter pools, the counterpart of ``repro.core.adapter`` for the
slot families' targets: the attention projections and the FFN's
gate/up/down, expert-specific on a MoE (the disaggregated plane serves
only the expert FFN's; the coupled plane all of them).

  attention target t  : A (L, N, d_in, r)     B (L, N, r, d_out)
  dense FFN target    : A (L, N, d_in, r)     B (L, N, r, d_out)
  expert FFN target   : A (L, N, E, d, r)     B (L, N, E, r, ff)

A mixed-rank pool pads every adapter to the pool rank with exact +0.0 in
the lanes past its true rank (the prefix-zero padding contract), so the
padded product equals the true-rank product.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.models.model import resolve_device


def target_dims(cfg, target: str) -> Tuple[int, int, bool]:
    """(d_in, d_out, expert_specific) of one LoRA target."""
    d, ff = cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    moe = cfg.is_moe
    return {
        "q": (d, H * hd, False), "k": (d, KV * hd, False),
        "v": (d, KV * hd, False), "o": (H * hd, d, False),
        "gate": (d, ff, moe), "up": (d, ff, moe), "down": (ff, d, moe),
    }[target]


def active_targets(cfg) -> Tuple[str, ...]:
    """The config's LoRA targets that this model family has."""
    out = []
    for t in cfg.lora_targets:
        try:
            target_dims(cfg, t)
        except KeyError:
            continue
        out.append(t)
    return tuple(out)


@dataclasses.dataclass
class AdapterPool:
    """Stacked LoRA factors of ``n`` adapters of one model config."""
    cfg: object
    n: int
    rank: int
    scale: float
    tensors: Dict[str, Dict[str, torch.Tensor]]  # target -> {"A", "B"}
    ranks: Optional[Tuple[int, ...]] = None      # true ranks (mixed pools)

    def lora_ctx(self, ids: torch.Tensor) -> Dict:
        """The coupled decode step's ``lora_ctx`` for per-row adapter ids
        (int32, -1 = no adapter)."""
        return {"adapters": self.tensors, "ids": ids, "scale": self.scale}

    def append(self, tensors: Dict[str, torch.Tensor], rank: int) -> int:
        """Add one adapter given in the canonical host format
        ({"<target>.A": (L, [E,] d_in, r), "<target>.B": ...} at its true
        rank ``rank`` <= the pool rank, checked by the caller) as id
        ``n``: zero-padded to the pool rank (the prefix-zero contract),
        cast to the pool's dtype and copied to its device. The factors are
        new tensors; code that reads ``tensors`` at each step sees it.
        Returns its id."""
        if self.ranks is None:
            self.ranks = (int(self.rank),) * self.n
        for tgt, t in self.tensors.items():
            A, B = t["A"], t["B"]
            a = tensors[f"{tgt}.A"].to(device=A.device, dtype=A.dtype)
            b = tensors[f"{tgt}.B"].to(device=B.device, dtype=B.dtype)
            a = torch.nn.functional.pad(a, (0, self.rank - rank))
            b = torch.nn.functional.pad(b, (0, 0, 0, self.rank - rank))
            t["A"] = torch.cat([A, a[:, None]], dim=1)
            t["B"] = torch.cat([B, b[:, None]], dim=1)
        self.ranks = self.ranks + (int(rank),)
        self.n += 1
        return self.n - 1

    def bytes_per_adapter(self) -> int:
        """Padded (slot-layout) bytes of one adapter: what one device slot
        costs whatever the adapter's true rank."""
        return sum(a.numel() * a.element_size() for t in self.tensors.values()
                   for a in t.values()) // self.n

    def rank_of(self, adapter_id: int) -> int:
        """True rank of one adapter (the pool rank for uniform pools)."""
        if self.ranks is not None:
            return int(self.ranks[adapter_id])
        return int(self.rank)

    def adapter_bytes(self, adapter_id: int) -> int:
        """True-rank bytes of one adapter, what a host -> device upload
        moves: every factor's rank axis scales linearly, so this is the
        padded size times rank_of(i) / rank (``bytes_per_adapter`` for a
        uniform pool)."""
        r = self.rank_of(adapter_id)
        return sum(a.numel() // self.n // self.rank * r * a.element_size()
                   for t in self.tensors.values() for a in t.values())


def init_adapter_pool(cfg, n_adapters: int, seed: int = 0,
                      rank: Optional[int] = None, dtype=torch.bfloat16,
                      alpha: float = 16.0, device=None) -> AdapterPool:
    """A ~ N(0, 1)/r, B ~ N(0, 1) * 0.01 (visible serving deltas), drawn on
    ``device`` (default: the CUDA card) from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    r = rank or cfg.lora_rank
    L, E = cfg.n_layers, max(cfg.n_experts, 1)
    tensors = {}
    for tgt in active_targets(cfg):
        d_in, d_out, per_expert = target_dims(cfg, tgt)
        mid = (L, n_adapters, E) if per_expert else (L, n_adapters)

        def draw(shape, mul):
            return (torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=dev) * mul).to(dtype)

        tensors[tgt] = {"A": draw(mid + (d_in, r), 1.0 / r),
                        "B": draw(mid + (r, d_out), 0.01)}
    return AdapterPool(cfg, n_adapters, r, alpha / r, tensors)


def init_mixed_rank_pool(cfg, ranks: Sequence[int], seed: int = 0,
                         dtype=torch.bfloat16, alpha: float = 16.0,
                         device=None) -> AdapterPool:
    """Adapters of different true ranks in one pool of rank max(ranks):
    adapter i uses its first ranks[i] columns, the rest hold +0.0 in both A
    and B, and its B is scaled by r_max / ranks[i] so that its update keeps
    the alpha / r_i convention under the pool's alpha / r_max scale."""
    ranks = [int(r) for r in ranks]
    r_max = max(ranks)
    pool = init_adapter_pool(cfg, len(ranks), seed, rank=r_max, dtype=dtype,
                             alpha=alpha, device=device)
    dev = next(iter(pool.tensors.values()))["A"].device
    rk = torch.tensor(ranks, device=dev)
    keep = torch.arange(r_max, device=dev)[None, :] < rk[:, None]  # (N, r)
    rescale = r_max / rk.to(torch.float32)
    for t in pool.tensors.values():
        A, B = t["A"], t["B"]
        lead = (1, len(ranks)) + (1,) * (A.ndim - 4)
        a_mask = keep.reshape(lead + (1, r_max))
        b_mask = keep.reshape(lead + (r_max, 1))
        b_fac = rescale.reshape(lead + (1, 1))
        zero = torch.zeros((), dtype=A.dtype, device=dev)
        # where (not multiply): masked lanes must be +0.0 exactly
        t["A"] = torch.where(a_mask, A, zero)
        t["B"] = torch.where(b_mask, (B * b_fac).to(B.dtype), zero)
    pool.ranks = tuple(ranks)
    return pool

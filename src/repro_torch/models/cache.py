"""KV caches of the slot engine, the counterpart of the attention part of
``repro.models.cache``, in its two layouts:

  paged pool : k/v (L, n_pages, page_size, KV, hd)
  dense slab : k/v (L, n_slots, max_len, KV, hd)

In the pool a page id addresses the same block in every layer, so one
slot's block table is one int32 row of ceil(max_len / page_size) entries
(-1 = unallocated), and KV memory follows the tokens actually held. In the
slab every slot owns max_len rows, whatever its request needs.
"""
from __future__ import annotations

from typing import Dict

import torch

KV_DTYPE = torch.bfloat16


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` KV rows (0 tokens -> 0 pages)."""
    return max(0, -(-int(n_tokens) // int(page_size)))


def _zeros_kv(cfg, rows: int, cols: int, dtype, device, what: str):
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"{what} supports dense/moe/vlm, not '{cfg.family}'")
    shp = (cfg.n_layers, rows, cols, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or KV_DTYPE
    return {"k": torch.zeros(shp, dtype=dt, device=device),
            "v": torch.zeros(shp, dtype=dt, device=device)}


def init_paged_cache(cfg, n_pages: int, page_size: int, dtype=None,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """Zeroed block pools {"k", "v"} for the attention families."""
    return _zeros_kv(cfg, n_pages, page_size, dtype, device, "paged KV cache")


def init_cache(cfg, batch: int, max_len: int, dtype=None,
               device="cpu") -> Dict[str, torch.Tensor]:
    """Zeroed dense slab {"k", "v"}: ``batch`` rows (the engine's slots)
    of ``max_len`` positions each."""
    return _zeros_kv(cfg, batch, max_len, dtype, device, "dense KV cache")


def paged_cache_bytes(cfg, n_pages: int, page_size: int, dtype=None) -> int:
    itemsize = torch.empty((), dtype=dtype or KV_DTYPE).element_size()
    return (2 * cfg.n_layers * n_pages * page_size * cfg.n_kv_heads
            * cfg.head_dim * itemsize)


def dense_cache_bytes(cfg, n_slots: int, max_len: int, dtype=None) -> int:
    """Bytes a dense (L, n_slots, max_len, KV, hd) slab would take."""
    itemsize = torch.empty((), dtype=dtype or KV_DTYPE).element_size()
    return (2 * cfg.n_layers * n_slots * max_len * cfg.n_kv_heads
            * cfg.head_dim * itemsize)

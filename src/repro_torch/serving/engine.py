"""Paged slot engine for disaggregated multi-LoRA decode, the counterpart
of ``repro.serving.engine.Engine`` with ``EngineConfig(paged=True)`` and a
LoRA server on the host transport.

The engine owns ``n_slots`` persistent decode slots. A request is admitted
into a free slot at a step boundary: its prompt, all but the last token,
runs through fixed-width LoRA-free prefill chunks whose KV goes straight
into pages of the shared pool. ``step()`` decodes one token for every
occupied slot: occupied slots are packed into a power-of-two bucket,
padding rows run with position -1 and adapter -1, and each row's next page
is allocated on demand. Evicting a request returns its pages to the pool.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import disagg as disagg_mod
from repro_torch.models import cache as cache_mod
from repro_torch.models import transformer
from repro_torch.models.model import resolve_device


def _bucket(n: int, cap: int) -> int:
    """Next power of two >= n, capped at cap (>= 1)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


@dataclasses.dataclass
class EngineConfig:
    max_len: int = 256
    n_slots: int = 8
    page_size: int = 8
    prefill_chunk: int = 16        # rounded up to a page multiple


@dataclasses.dataclass
class SlotState:
    rid: int
    adapter_id: int
    pos: int            # position of the NEXT token fed to the model
    last_token: int     # next decode input


class Engine:
    """Paged, disaggregated slot engine; ``server`` satisfies the LoRA
    Server's ``compute`` contract and ``lora_scale`` multiplies its deltas
    (an AdapterPool's ``scale``)."""

    def __init__(self, cfg, params, ecfg: EngineConfig, server,
                 lora_scale: float = 1.0, device=None):
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.server = server
        self.lora_scale = float(lora_scale)
        self.device = resolve_device(device)
        ps = int(ecfg.page_size)
        if ps < 1 or ecfg.max_len % ps:
            raise ValueError(f"page_size ({ps}) must divide max_len "
                             f"({ecfg.max_len})")
        self.slots: List[Optional[SlotState]] = [None] * ecfg.n_slots
        self._by_rid: Dict[int, int] = {}
        chunk = -(-max(int(ecfg.prefill_chunk), 1) // ps) * ps
        self._chunk = min(chunk, ecfg.max_len)
        self.blocks_per_slot = ecfg.max_len // ps
        self.total_pages = ecfg.n_slots * self.blocks_per_slot
        self._bt = np.full((ecfg.n_slots, self.blocks_per_slot), -1, np.int32)
        self._free: List[int] = list(range(self.total_pages - 1, -1, -1))
        self.peak_pages = 0
        pool = cache_mod.init_paged_cache(cfg, self.total_pages, ps,
                                          device=self.device)
        self._k, self._v = pool["k"], pool["v"]

    # ----------------------- slot bookkeeping ----------------------- #
    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def free_slots(self) -> int:
        return sum(1 for s in self.slots if s is None)

    def active_rids(self) -> List[int]:
        return [s.rid for s in self.slots if s is not None]

    def kv_stats(self) -> Dict[str, int]:
        """Slot and page occupancy, and the pool's bytes against the dense
        slab it replaces."""
        ps = self.ecfg.page_size
        return {
            "n_slots": self.n_slots,
            "slots_in_use": self.n_slots - self.free_slots(),
            "dense_slab_bytes": cache_mod.dense_cache_bytes(
                self.cfg, self.n_slots, self.ecfg.max_len),
            "page_size": ps,
            "n_pages": self.total_pages,
            "pages_in_use": self.total_pages - len(self._free),
            "peak_pages": self.peak_pages,
            "pool_bytes": cache_mod.paged_cache_bytes(
                self.cfg, self.total_pages, ps),
        }

    def _alloc_page(self) -> int:
        p = self._free.pop()
        self.peak_pages = max(self.peak_pages,
                              self.total_pages - len(self._free))
        return p

    # ---------------------- admission / eviction --------------------- #
    def add_request(self, rid: int, prompt: Sequence[int],
                    adapter_id: int) -> int:
        """Admit a request into a free slot: allocate the pages of its
        prompt and prime them by chunked prefill. Returns the slot."""
        if rid in self._by_rid:
            raise ValueError(f"rid {rid} already running")
        slot = next((i for i, s in enumerate(self.slots) if s is None), None)
        if slot is None:
            raise RuntimeError("no free decode slot")
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = int(prompt.shape[0])
        if plen < 1 or plen > self.ecfg.max_len:
            raise ValueError(f"prompt length {plen} vs max_len "
                             f"{self.ecfg.max_len}")
        need = cache_mod.pages_for(plen - 1, self.ecfg.page_size)
        if need > len(self._free):
            raise RuntimeError(
                f"rid {rid}: free KV pages ({len(self._free)}) do not cover "
                f"the prompt ({need} pages)")
        for j in range(need):
            self._bt[slot, j] = self._alloc_page()
        if plen > 1:
            self._prefill_slot(slot, prompt[:-1])
        self.slots[slot] = SlotState(rid=rid, adapter_id=int(adapter_id),
                                     pos=plen - 1, last_token=int(prompt[-1]))
        self._by_rid[rid] = slot
        return slot

    def _prefill_slot(self, slot: int, toks: np.ndarray) -> None:
        """Chunked prefill of ``toks`` into the slot's pages. The last chunk
        is zero-padded; its padded positions lie past the slot's position,
        so every attention masks them until decode overwrites them."""
        n_tok = int(toks.shape[0])
        C, ps = self._chunk, self.ecfg.page_size
        L, _, _, KV, hd = self._k.shape
        dev = self.device
        for c in range(0, n_tok, C):
            w = min(C, self.ecfg.max_len - c)
            chunk = np.zeros((1, w), np.int64)
            m = min(w, n_tok - c)
            chunk[0, :m] = toks[c:c + m]
            ctx = torch.as_tensor(self._bt[slot, : c // ps], dtype=torch.long,
                                  device=dev)
            k_ctx = self._k[:, ctx].reshape(L, 1, -1, KV, hd)
            v_ctx = self._v[:, ctx].reshape(L, 1, -1, KV, hd)
            k_c, v_c = transformer.prefill_chunk(
                self.params, self.cfg, torch.as_tensor(chunk, device=dev),
                k_ctx, v_ctx)
            # the chunk's pages; unallocated ones (a padded tail) are skipped
            have = self._bt[slot, c // ps: c // ps + w // ps]
            keep = np.nonzero(have >= 0)[0]
            pages = torch.as_tensor(have[keep], dtype=torch.long, device=dev)
            sel = torch.as_tensor(keep, dtype=torch.long, device=dev)
            for pool, rows in ((self._k, k_c), (self._v, v_c)):
                pool[:, pages] = rows.reshape(L, w // ps, ps, KV, hd)[:, sel] \
                    .to(pool.dtype)

    def evict_request(self, rid: int) -> None:
        """Free a slot at a step boundary; its pages return to the pool."""
        slot = self._by_rid.pop(rid)
        self.slots[slot] = None
        self._free.extend(int(p) for p in self._bt[slot] if p >= 0)
        self._bt[slot, :] = -1

    # ---------------------------- decode ----------------------------- #
    def step(self) -> Dict[int, int]:
        """Decode one token for every occupied slot; returns {rid: token}."""
        occupied = [i for i, s in enumerate(self.slots) if s is not None]
        if not occupied:
            return {}
        nb = _bucket(len(occupied), self.n_slots)
        sel = np.zeros(nb, np.int64)
        sel[: len(occupied)] = occupied
        toks = np.zeros((nb, 1), np.int64)
        pos_vec = np.full(nb, -1, np.int32)
        ads = np.full(nb, -1, np.int32)
        for row, i in enumerate(occupied):
            s = self.slots[i]
            if s.pos >= self.ecfg.max_len:
                raise RuntimeError(
                    f"rid {s.rid} exhausted slot KV capacity "
                    f"(pos {s.pos} >= max_len {self.ecfg.max_len})")
            pidx = s.pos // self.ecfg.page_size
            if self._bt[i, pidx] < 0:
                if not self._free:
                    raise RuntimeError(
                        f"rid {s.rid}: KV page pool exhausted mid-decode")
                self._bt[i, pidx] = self._alloc_page()
            toks[row, 0] = s.last_token
            pos_vec[row] = s.pos
            ads[row] = s.adapter_id
        dev = self.device
        logits, self._k, self._v = disagg_mod.disagg_decode_step_slots(
            self.params, self.cfg, self._k, self._v,
            torch.as_tensor(toks, device=dev),
            torch.as_tensor(pos_vec, device=dev), self.server,
            torch.as_tensor(ads, device=dev), self.lora_scale,
            block_table=torch.as_tensor(self._bt[sel], device=dev))
        tok = torch.argmax(logits[:, : self.cfg.vocab_size], dim=-1).tolist()
        out: Dict[int, int] = {}
        for row, i in enumerate(occupied):
            s = self.slots[i]
            s.pos += 1
            s.last_token = int(tok[row])
            out[s.rid] = s.last_token
        return out

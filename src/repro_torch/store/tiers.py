"""The host-RAM and disk tiers under the device adapter cache, a copy of
``repro.store.tiers`` over CPU ``torch.Tensor``s.

S-LoRA's memory hierarchy (PAPERS.md): device slot tables hold the hot
working set (``LoRACache``/``ServerPool``), a byte-budgeted host-RAM tier
holds the warm set in canonical form (CPU tensors), and a per-adapter-file disk
tier backs everything else. Adapters are IMMUTABLE once registered, so the
cascade needs no writeback protocol: demotion just ensures the disk copy
exists, promotion just reads it back (bitwise, ``tensorfile``).
"""
from __future__ import annotations

import os
import shutil
import tempfile
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.store import tensorfile

Tensors = Dict[str, torch.Tensor]


class HostTier:
    """Byte-budgeted LRU of canonical host tensor sets.

    Entries may be LAZY (a loader instead of materialized arrays) so that
    registering a pool's worth of adapters does not duplicate the pool in
    RAM up front; the bytes are charged at admission either way, because
    the budget models capacity, not what happens to be materialized yet.
    ``budget_bytes=None`` = unbounded (the pre-store behavior: the whole
    universe is host-resident)."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 spill: Optional[Callable[[int, Tensors], None]] = None):
        self.budget_bytes = budget_bytes
        self._spill = spill
        # aid -> [nbytes, tensors | None, loader | None], LRU order
        self._entries: "OrderedDict[int, list]" = OrderedDict()
        self.used_bytes = 0
        self.hits = 0
        self.misses = 0
        self.demotions = 0

    def __contains__(self, adapter_id: int) -> bool:
        return adapter_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def resident_ids(self) -> List[int]:
        return list(self._entries)

    def put(self, adapter_id: int, nbytes: int,
            tensors: Optional[Tensors] = None,
            loader: Optional[Callable[[], Tensors]] = None) -> List[int]:
        """Admit (or refresh) an entry; returns the adapter ids demoted to
        make room. An entry larger than the whole budget is admitted alone
        (evicting everything else) rather than rejected — refusing would
        strand the adapter with no tier at all."""
        if tensors is None and loader is None:
            raise ValueError("HostTier.put needs tensors or a loader")
        if adapter_id in self._entries:
            self.used_bytes -= self._entries.pop(adapter_id)[0]
        self._entries[adapter_id] = [int(nbytes), tensors, loader]
        self.used_bytes += int(nbytes)
        evicted: List[int] = []
        if self.budget_bytes is not None:
            while self.used_bytes > self.budget_bytes and \
                    len(self._entries) > 1:
                victim, _ = next(iter(self._entries.items()))
                if victim == adapter_id:
                    break
                self.evict(victim)
                evicted.append(victim)
        return evicted

    def get(self, adapter_id: int) -> Optional[Tensors]:
        """Tensor set of a resident entry (LRU-touch; lazily materializes
        via the entry's loader on first access), or None."""
        ent = self._entries.get(adapter_id)
        if ent is None:
            self.misses += 1
            return None
        self.hits += 1
        self._entries.move_to_end(adapter_id)
        if ent[1] is None:
            ent[1] = ent[2]()
        return ent[1]

    def evict(self, adapter_id: int) -> None:
        """Demote one entry (spill callback first, so the disk copy exists
        before the RAM copy is dropped)."""
        ent = self._entries.get(adapter_id)
        if ent is None:
            return
        if self._spill is not None:
            tensors = ent[1] if ent[1] is not None else ent[2]()
            self._spill(adapter_id, tensors)
        del self._entries[adapter_id]
        self.used_bytes -= ent[0]
        self.demotions += 1

    def remove(self, adapter_id: int) -> None:
        """Drop an entry WITHOUT spilling (unregister path)."""
        ent = self._entries.pop(adapter_id, None)
        if ent is not None:
            self.used_bytes -= ent[0]


class DiskTier:
    """One ``tensorfile`` per adapter under a root directory.

    ``root=None`` creates a private temp directory on first write and
    removes it at ``close()`` — callers that never spill never touch the
    filesystem."""

    def __init__(self, root: Optional[str] = None):
        self._root = root
        self._owned = root is None        # we created it -> we delete it
        self._made = root is not None and os.path.isdir(root)
        self.writes = 0
        self.reads = 0

    @property
    def root(self) -> str:
        if self._root is None:
            self._root = tempfile.mkdtemp(prefix="adapter-store-")
            self._made = True
        elif not self._made:
            os.makedirs(self._root, exist_ok=True)
            self._made = True
        return self._root

    def path(self, adapter_id: int) -> str:
        return os.path.join(self.root, f"adapter_{int(adapter_id)}.tensors")

    def __contains__(self, adapter_id: int) -> bool:
        return self._root is not None and self._made and \
            os.path.isfile(self.path(adapter_id))

    def put(self, adapter_id: int, tensors: Tensors) -> int:
        if adapter_id in self:
            return 0          # immutable: an existing file is already right
        self.writes += 1
        return tensorfile.save(self.path(adapter_id), tensors)

    def get(self, adapter_id: int) -> Tensors:
        if adapter_id not in self:
            raise KeyError(f"adapter {adapter_id} has no disk copy")
        self.reads += 1
        return tensorfile.load(self.path(adapter_id))

    def remove(self, adapter_id: int) -> None:
        if adapter_id in self:
            os.remove(self.path(adapter_id))

    def close(self) -> None:
        if self._owned and self._root is not None and self._made:
            shutil.rmtree(self._root, ignore_errors=True)
            self._root, self._made = None, False

"""The hierarchical adapter store: one interface over three tiers, the
counterpart of ``repro.store.store.AdapterStore``.

    device slots   LoRACache / ServerPool (outside this module; the store
                   feeds them through ``server_tensors``)
    host RAM       HostTier: canonical true-rank CPU tensors, LRU under a
                   byte budget
    disk           DiskTier: one safetensors-style file per adapter

``AdapterStore`` backs the cluster plane: real bytes, a real prefetch
thread, and the dynamic register/unregister lifecycle. The reference's
``AnalyticStore`` (the sim plane's tensor-free twin) is not ported yet.

Pricing: a host-tier hit costs the host -> device upload ``b / host_bw``;
a disk-tier hit also pays the disk read ``b / disk_bw`` first. Bytes are
TRUE-RANK bytes: a rank-4 adapter in a rank-64 pool pays rank-4 transfers.

The prefetch worker makes no CUDA call. Host copies of a startup pool
that lives on the card are therefore taken at construction, on the
calling thread; a pool on the CPU is read lazily, on first access, as in
the reference.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

from repro_torch.core.adapter import AdapterPool
from repro_torch.store.convert import (host_tensor_bytes,
                                       host_tensors_from_pool,
                                       server_tensors_from_host,
                                       validate_host_tensors)
from repro_torch.store.prefetch import Prefetcher
from repro_torch.store.tiers import DiskTier, HostTier, Tensors


def _xfer_seconds(nbytes: int, bw: float) -> float:
    """Transfer time; 0 for a non-finite or non-positive bandwidth."""
    if bw is None or bw <= 0 or math.isinf(bw):
        return 0.0
    return nbytes / bw


class AdapterStore:
    """Host and disk tiers, async staging, and the dynamic adapter
    registry of the cluster plane.

    Thread safety: tier state is guarded by an RLock, because the prefetch
    worker stages through the same ``host_tensors`` path as the serving
    loop. Staged results cross back to the main thread only through
    ``drain_prefetched`` at round boundaries, or through
    ``server_tensors`` when an upload needs an adapter the worker is
    still staging (it waits for that result)."""

    def __init__(self, cfg, pool: AdapterPool, *,
                 host_bytes: Optional[int] = None,
                 store_dir: Optional[str] = None,
                 host_bw: float = 50e9, disk_bw: float = 5e9,
                 prefetch: bool = True):
        self.cfg = cfg
        self.pool = pool
        self.r_pool = int(pool.rank)
        self.host_bw = float(host_bw)
        self.disk_bw = float(disk_bw)
        self.prefetch_enabled = bool(prefetch)

        self._lock = threading.RLock()
        self.disk = DiskTier(store_dir)
        self.host = HostTier(host_bytes, spill=self.disk.put)
        self._prefetcher = Prefetcher(self._stage)
        self._ranks: Dict[int, int] = {}
        self._bytes: Dict[int, int] = {}
        self._staged: Dict[int, Tensors] = {}

        self.host_hits = 0
        self.disk_hits = 0
        self.staged_hits = 0
        self.sync_stages = 0

        # the startup universe: bytes are charged (and the over-budget
        # tail spills to disk) now; host copies of a CPU pool materialize
        # on first access, those of a pool on the card right here
        on_card = any(a.device.type != "cpu" for t in pool.tensors.values()
                      for a in t.values())
        for aid in range(pool.n):
            self._register_entry(
                aid, pool.rank_of(aid), pool.adapter_bytes(aid),
                tensors=host_tensors_from_pool(pool, aid) if on_card
                else None, loader=None if on_card else self._pool_loader(aid))

    # -- registry -----------------------------------------------------

    def _pool_loader(self, adapter_id: int):
        return lambda: host_tensors_from_pool(self.pool, adapter_id)

    def _register_entry(self, adapter_id: int, rank: int, nbytes: int,
                        tensors: Optional[Tensors] = None,
                        loader=None) -> None:
        with self._lock:
            self._ranks[adapter_id] = int(rank)
            self._bytes[adapter_id] = int(nbytes)
            self.host.put(adapter_id, nbytes, tensors=tensors, loader=loader)

    def register(self, adapter_id: int, tensors: Tensors, *,
                 alpha: Optional[float] = None) -> int:
        """Register an adapter at run time (the vLLM-style load endpoint).

        ``tensors`` is the canonical host format at the adapter's true
        rank; shapes are checked against the model config and the rank
        against the server slot pools. With ``alpha``, the B factors are
        rescaled from the raw alpha/r convention into the pool's uniform
        ``pool.scale`` (one scale a batch); without it they are taken as
        already in the pool's convention. Returns the adapter's rank;
        raises ValueError on any mismatch."""
        adapter_id = int(adapter_id)
        with self._lock:
            if adapter_id in self._ranks:
                raise ValueError(f"adapter {adapter_id} is already "
                                 f"registered")
        rank = validate_host_tensors(self.cfg, tensors, self.r_pool)
        if alpha is not None:
            if self.pool.scale == 0:
                raise ValueError("pool scale is 0; cannot rescale")
            f = (float(alpha) / rank) / self.pool.scale
            tensors = {k: (v * f).to(v.dtype) if k.endswith(".B") else v
                       for k, v in tensors.items()}
        tensors = {k: v.detach().cpu().contiguous()
                   for k, v in tensors.items()}
        self._register_entry(adapter_id, rank, host_tensor_bytes(tensors),
                             tensors=tensors)
        return rank

    def unregister(self, adapter_id: int) -> None:
        """Drop an adapter from every store tier (the device tier's
        eviction is the caller's job: the store knows no pins)."""
        with self._lock:
            if adapter_id not in self._ranks:
                raise ValueError(f"adapter {adapter_id} is not registered")
            del self._ranks[adapter_id]
            del self._bytes[adapter_id]
            self._staged.pop(adapter_id, None)
            self.host.remove(adapter_id)
            self.disk.remove(adapter_id)

    def has(self, adapter_id: int) -> bool:
        with self._lock:
            return adapter_id in self._ranks

    def registered_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._ranks)

    def rank_of(self, adapter_id: int) -> int:
        with self._lock:
            return self._ranks[adapter_id]

    def adapter_bytes(self, adapter_id: int) -> int:
        """True-rank payload bytes (what a host -> device upload moves)."""
        with self._lock:
            return self._bytes[adapter_id]

    # -- tier access --------------------------------------------------

    def host_tensors(self, adapter_id: int) -> Tensors:
        """Canonical tensors, promoting disk -> host on a host-tier miss."""
        with self._lock:
            if adapter_id not in self._ranks:
                raise KeyError(f"adapter {adapter_id} is not registered")
            got = self.host.get(adapter_id)
            if got is not None:
                self.host_hits += 1
                return got
            self.disk_hits += 1
            tensors = self.disk.get(adapter_id)
            self.host.put(adapter_id, self._bytes[adapter_id],
                          tensors=tensors)
            return tensors

    def _stage(self, adapter_id: int) -> Tensors:
        """The whole staging pipeline (runs on the prefetch worker): fetch
        the canonical tensors (a disk read if demoted) and build the fused
        server layout on the CPU."""
        return server_tensors_from_host(
            self.cfg, self.host_tensors(adapter_id), self.r_pool)

    def server_tensors(self, adapter_id: int) -> Tensors:
        """Fused server slot layout of one adapter: a staged prefetch
        result when one landed or is being staged, else staged
        synchronously."""
        with self._lock:
            staged = self._staged.pop(adapter_id, None)
        if staged is None and self._prefetcher.in_flight(adapter_id):
            # the worker is staging it: take that result rather than
            # staging the adapter a second time beside it
            self._land(self._prefetcher.wait(adapter_id=adapter_id))
            with self._lock:
                staged = self._staged.pop(adapter_id, None)
        if staged is not None:
            self.staged_hits += 1
            return staged
        self.sync_stages += 1
        return self._stage(adapter_id)

    # -- pricing ------------------------------------------------------

    def load_seconds(self, adapter_id: int,
                     now: Optional[float] = None) -> float:
        """Miss penalty of bringing this adapter to the card NOW, priced
        by where it lives (staged or host vs disk). ``now`` keeps the
        pricing callback's signature; the store's staging state already
        reflects elapsed time."""
        del now
        with self._lock:
            b = self._bytes.get(adapter_id)
            if b is None:
                return 0.0
            on_host = adapter_id in self._staged or adapter_id in self.host
        t = _xfer_seconds(b, self.host_bw)
        if not on_host:
            t += _xfer_seconds(b, self.disk_bw)
        return t

    # -- prefetch -----------------------------------------------------

    def prefetch(self, adapter_id: int) -> bool:
        """Hint that ``adapter_id`` is needed soon (fired at request
        arrival for an adapter no server slot holds): queues async
        staging; returns whether a job was queued."""
        if not self.prefetch_enabled:
            return False
        with self._lock:
            if adapter_id not in self._ranks or adapter_id in self._staged:
                return False
        return self._prefetcher.request(adapter_id)

    def _land(self, done) -> List[int]:
        with self._lock:
            for aid, tensors in done:
                if aid in self._ranks:     # may have been unregistered
                    self._staged[aid] = tensors
        return [aid for aid, _ in done]

    def drain_prefetched(self) -> List[int]:
        """Collect finished stagings into the staged buffer (at round
        boundaries, on the main thread); returns their adapter ids."""
        return self._land(self._prefetcher.drain())

    def wait_prefetched(self, timeout: float = 30.0) -> List[int]:
        """Blocking ``drain_prefetched`` (tests and shutdown)."""
        return self._land(self._prefetcher.wait(timeout))

    # -- telemetry / lifecycle ----------------------------------------

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "registered": len(self._ranks),
                "host_resident": len(self.host),
                "host_used_bytes": self.host.used_bytes,
                "host_budget_bytes": (self.host.budget_bytes
                                      if self.host.budget_bytes is not None
                                      else -1),
                "host_hits": self.host_hits,
                "disk_hits": self.disk_hits,
                "demotions": self.host.demotions,
                "disk_writes": self.disk.writes,
                "disk_reads": self.disk.reads,
                "prefetch_requests": self._prefetcher.requests,
                "prefetch_staged": self._prefetcher.completed,
                "staged_hits": self.staged_hits,
                "sync_stages": self.sync_stages,
            }

    def close(self) -> None:
        self._prefetcher.close()
        self.disk.close()


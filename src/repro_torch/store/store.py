"""The hierarchical adapter store: one interface over three tiers, the
counterpart of ``repro.store.store.AdapterStore``.

    device slots   LoRACache / ServerPool (outside this module; the store
                   feeds them through ``server_tensors``)
    host RAM       HostTier: canonical true-rank CPU tensors, LRU under a
                   byte budget
    disk           DiskTier: one safetensors-style file per adapter

``AdapterStore`` backs the cluster plane: real bytes, a real prefetch
thread, and the dynamic register/unregister lifecycle. ``AnalyticStore``
is its tensor-free twin on the sim plane: the same two-tier LRU accounting
and miss pricing, with no bytes, files or threads.

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
                                       rescale_alpha,
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
            tensors = rescale_alpha(tensors, alpha, rank, self.pool.scale)
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

    def host_hit_rate(self) -> Optional[float]:
        """Fraction of tier lookups served from host RAM (None before any
        lookup: the autoscaler then keeps the cold-start model)."""
        n = self.host_hits + self.disk_hits
        if n == 0:
            return None
        return self.host_hits / n

    def miss_cost_ratio(self) -> float:
        """c_host / c_disk for a mean-sized adapter, in (0, 1]: how much
        cheaper a host-tier hit is than a disk-tier hit. 1.0 when loading
        is free (non-finite bandwidths) or nothing is registered."""
        with self._lock:
            if not self._bytes:
                return 1.0
            b = sum(self._bytes.values()) / len(self._bytes)
        c_host = _xfer_seconds(b, self.host_bw)
        c_disk = c_host + _xfer_seconds(b, self.disk_bw)
        if c_disk <= 0.0 or c_host <= 0.0:
            return 1.0
        return min(c_host / c_disk, 1.0)

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



class AnalyticStore:
    """Tensor-free twin of ``AdapterStore`` for the sim plane: the same
    two-tier LRU accounting and miss pricing over per-adapter byte sizes
    (``adapter_bytes_fn(aid)``), with no real bytes, files or threads."""

    def __init__(self, adapter_bytes_fn, n_adapters: int, *,
                 host_bytes: Optional[int] = None,
                 host_bw: float = 50e9, disk_bw: float = 5e9):
        self._bytes_fn = adapter_bytes_fn
        self.host_bw = float(host_bw)
        self.disk_bw = float(disk_bw)
        self.host_budget = host_bytes
        self._ids: set = set()                # every registered adapter id
        self._resident: Dict[int, int] = {}   # aid -> bytes, LRU order
        # aid -> virtual time the async disk -> host staging completes (the
        # analytic analogue of the real store's prefetch worker)
        self._staging: Dict[int, float] = {}
        self.host_used = 0
        self.host_hits = 0
        self.disk_hits = 0
        self.demotions = 0
        self.prefetch_requests = 0
        self.staged_hits = 0
        for aid in range(n_adapters):
            self.register(aid)

    @property
    def n_adapters(self) -> int:
        return len(self._ids)

    def has(self, adapter_id: int) -> bool:
        return int(adapter_id) in self._ids

    def register(self, adapter_id: int) -> None:
        self._ids.add(int(adapter_id))
        self._touch(int(adapter_id), count=False)

    def unregister(self, adapter_id: int) -> None:
        self._ids.discard(int(adapter_id))
        self._staging.pop(int(adapter_id), None)
        b = self._resident.pop(int(adapter_id), None)
        if b is not None:
            self.host_used -= b

    def _touch(self, adapter_id: int, count: bool = True) -> bool:
        """LRU-touch; admits on a miss, demoting over budget. Returns
        whether it was a host hit."""
        b = self._resident.pop(adapter_id, None)
        hit = b is not None
        if not hit:
            b = int(self._bytes_fn(adapter_id))
            self.host_used += b
        self._resident[adapter_id] = b
        if count:
            if hit:
                self.host_hits += 1
            else:
                self.disk_hits += 1
        if self.host_budget is not None:
            while self.host_used > self.host_budget and \
                    len(self._resident) > 1:
                victim = next(iter(self._resident))
                if victim == adapter_id:
                    break
                self.host_used -= self._resident.pop(victim)
                self.demotions += 1
        return hit

    def prefetch(self, adapter_id: int, now: float) -> bool:
        """Start the async disk -> host staging of a soon-needed adapter
        (fired at request arrival). No-op for host-resident adapters;
        returns whether a new staging started."""
        aid = int(adapter_id)
        if aid not in self._ids or aid in self._resident or \
                aid in self._staging:
            return False
        b = int(self._bytes_fn(aid))
        self._staging[aid] = float(now) + _xfer_seconds(b, self.disk_bw)
        self.prefetch_requests += 1
        return True

    def load_seconds(self, adapter_id: int,
                     now: Optional[float] = None) -> float:
        """Miss penalty by current tier; the touch promotes to host. With
        ``now`` given, an in-flight staging is credited: only the disk
        time still outstanding at ``now`` is charged."""
        aid = int(adapter_id)
        b = int(self._bytes_fn(aid))
        staged_at = self._staging.pop(aid, None)
        hit = self._touch(aid)
        t = _xfer_seconds(b, self.host_bw)
        if not hit:
            disk_t = _xfer_seconds(b, self.disk_bw)
            if staged_at is not None and now is not None:
                disk_t = min(disk_t, max(staged_at - float(now), 0.0))
                if disk_t == 0.0:
                    self.staged_hits += 1
            t += disk_t
        return t

    def host_hit_rate(self) -> Optional[float]:
        n = self.host_hits + self.disk_hits
        if n == 0:
            return None
        return self.host_hits / n

    def miss_cost_ratio(self) -> float:
        if not self._ids:
            return 1.0
        b = int(self._bytes_fn(next(iter(self._ids))))
        c_host = _xfer_seconds(b, self.host_bw)
        c_disk = c_host + _xfer_seconds(b, self.disk_bw)
        if c_disk <= 0.0 or c_host <= 0.0:
            return 1.0
        return min(c_host / c_disk, 1.0)

    def stats(self) -> Dict[str, float]:
        return {
            "registered": self.n_adapters,
            "host_resident": len(self._resident),
            "host_used_bytes": self.host_used,
            "host_budget_bytes": (self.host_budget
                                  if self.host_budget is not None else -1),
            "host_hits": self.host_hits,
            "disk_hits": self.disk_hits,
            "demotions": self.demotions,
            "prefetch_requests": self.prefetch_requests,
            "staged_hits": self.staged_hits,
        }

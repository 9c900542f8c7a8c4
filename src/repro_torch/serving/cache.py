"""LoRA cache management (paper §5.3 + Fig. 4 LoRA table), a copy of
``repro.serving.cache`` (the port imports nothing of the JAX package).

Tracks adapter residency for a cache of M slots (on the LoRA Server in
disaggregated mode; per-instance in the coupled baseline), with:

  - pin/unpin by active request count (an adapter serving in-flight requests
    is not evictable — matches the coupled baseline's behavior of waiting
    for in-flight executions before reclaiming memory)
  - LRU eviction among unpinned residents
  - loading timeline: host->HBM staging at ``host_bw``; *layer-wise
    pipelined* loading makes the adapter usable after its FIRST layer-group
    arrives (the rest streams behind execution, §5.3); scheduler-driven
    prefetch starts the clock at request arrival rather than admission.

All times are simulation timestamps (seconds); the simulator advances them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.obs.trace import NULL_TRACER, Tracer


@dataclasses.dataclass
class ResidentAdapter:
    adapter_id: int
    load_start: float
    first_ready: float     # first layer-group resident (usable, pipelined)
    full_ready: float      # entire adapter resident
    last_used: float
    pins: int = 0
    prefetched: bool = False   # admitted by a hint, not yet used by a request


class LoRACache:
    def __init__(self, capacity: int, adapter_bytes: int, n_layers: int,
                 host_bw: float = 50e9, layerwise: bool = True,
                 prefetch: bool = True,
                 load_seconds_fn: Optional[Callable[[int, float],
                                           float]] = None,
                 tracer: Optional[Tracer] = None):
        self.capacity = capacity
        # adapter-staging spans land on the owning plane's tracer; the
        # timestamps are whatever virtual clock the caller passes as `now`
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.adapter_bytes = adapter_bytes
        self.n_layers = max(n_layers, 1)
        self.host_bw = host_bw
        self.layerwise = layerwise
        self.prefetch = prefetch
        # tier-aware miss pricing: when an adapter store backs this cache,
        # the full-load time depends on WHERE the adapter lives (host RAM
        # vs disk) and its true rank — the store's load_seconds supplies
        # it. None = the flat adapter_bytes/host_bw model.
        self.load_seconds_fn = load_seconds_fn
        self.resident: Dict[int, ResidentAdapter] = {}
        self.loads_in_flight = 0
        # partition-aware admission (mesh serving): when the ServerPool is
        # slot-PARTITIONED, each adapter may only reside on its affinity
        # home, so the shared cache must also bound residency per home —
        # global capacity alone would admit adapters whose home replica's
        # slot table is already full. None = unpartitioned (default).
        self._home_of: Optional[Callable[[int], int]] = None
        self._home_caps: Dict[int, int] = {}
        # residency delta since the last drain_dirty(): adapter ids inserted
        # or evicted. Consumed by ServerPool.sync so replica slot tables are
        # reconciled against only what CHANGED, not rescanned every round.
        # Bounded by the number of distinct adapters (it is a set).
        self.dirty: set = set()
        # stats
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.prefetch_hits = 0       # hits on hint-admitted residents
        self.miss_load_seconds = 0.0  # summed full-load cost of misses

    # ------------------------------------------------------------------ #
    def is_ready(self, adapter_id: int, now: float) -> bool:
        r = self.resident.get(adapter_id)
        if r is None:
            return False
        ready = r.first_ready if self.layerwise else r.full_ready
        return now >= ready

    def is_resident(self, adapter_id: int) -> bool:
        return adapter_id in self.resident

    def has_free_slot(self) -> bool:
        return len(self.resident) < self.capacity or self._evictable() is not None

    def _evictable(self, home: Optional[int] = None) -> Optional[int]:
        cand = [(r.last_used, a) for a, r in self.resident.items()
                if r.pins == 0 and (home is None
                                    or self._home_of(a) == home)]
        return min(cand)[1] if cand else None

    # ---------------------- partition-aware admission ------------------ #
    def set_partition(self, home_of: Optional[Callable[[int], int]],
                      caps: Optional[Dict[int, int]] = None) -> None:
        """Bound residency per affinity home: ``home_of(aid)`` maps an
        adapter to its home, ``caps[home]`` is that home's slot count
        (a slot-partitioned pool's affinity map and per-replica slots).
        ``home_of=None`` clears the partition."""
        self._home_of = home_of
        self._home_caps = dict(caps or {})

    def _home_count(self, home: int) -> int:
        return sum(1 for a in self.resident if self._home_of(a) == home)

    def _home_full(self, home: int) -> bool:
        return self._home_count(home) >= \
            self._home_caps.get(home, self.capacity)

    def repartition(self, home_of: Callable[[int], int],
                    caps: Dict[int, int], now: float) -> List[int]:
        """Re-home after a replica-count change: install the new partition
        map, then evict LRU unpinned residents out of any over-capacity
        home. Pinned residents are never evicted (a home may transiently
        overflow while in-flight requests drain — ``admit`` stops
        inserting into it meanwhile, exactly like a global shrink).
        Returns the evicted adapter ids."""
        self.set_partition(home_of, caps)
        evicted: List[int] = []
        for home in set(home_of(a) for a in self.resident):
            while self._home_count(home) > \
                    self._home_caps.get(home, self.capacity):
                victim = self._evictable(home)
                if victim is None:
                    break
                del self.resident[victim]
                self.evictions += 1
                self.dirty.add(victim)
                evicted.append(victim)
        return evicted

    # ------------------------------------------------------------------ #
    def admit(self, adapter_id: int, now: float) -> Optional[float]:
        """Ensure residency; returns the time the adapter becomes usable, or
        None if no slot can be freed (caller queues the request)."""
        r = self.resident.get(adapter_id)
        if r is not None:
            self.hits += 1
            if r.prefetched:
                self.prefetch_hits += 1
                r.prefetched = False
            r.last_used = now
            return r.first_ready if self.layerwise else r.full_ready
        self.misses += 1
        home = self._home_of(adapter_id) if self._home_of else None
        if home is not None and self._home_full(home) and \
                self._evictable(home) is None:
            # the adapter's home replica is full of pinned residents: no
            # global eviction can make room where THIS adapter must live,
            # so bail before mutating anything (caller queues the request)
            return None
        if len(self.resident) >= self.capacity:
            victim = self._evictable()
            if victim is None:
                return None
            # evict down BELOW capacity, not just one-for-one: after a
            # shrink left pinned residents above capacity, one-in-one-out
            # would hold the count above the target forever even once
            # every pin has released
            while victim is not None and len(self.resident) >= self.capacity:
                del self.resident[victim]
                self.evictions += 1
                self.dirty.add(victim)
                victim = self._evictable()
        if home is not None:
            while self._home_full(home):
                victim = self._evictable(home)
                if victim is None:
                    return None
                del self.resident[victim]
                self.evictions += 1
                self.dirty.add(victim)
        if self.load_seconds_fn is not None:
            # `now` lets tiered stores credit async staging work already
            # done by admission time (the prefetch overlap)
            t_full = self.load_seconds_fn(adapter_id, now)
        else:
            t_full = self.adapter_bytes / self.host_bw
        self.miss_load_seconds += t_full
        t_first = t_full / self.n_layers if self.layerwise else t_full
        if self.tracer.enabled:
            # the staging interval [admit, full residency]; first_ready
            # rides along so TTFT attribution can see the pipelined edge
            self.tracer.span("adapter", f"adapter.load a{adapter_id}",
                             now, now + t_full, adapter_id=adapter_id,
                             first_ready=now + t_first)
        r = ResidentAdapter(adapter_id, now, now + t_first, now + t_full, now)
        self.resident[adapter_id] = r
        self.dirty.add(adapter_id)
        return r.first_ready if self.layerwise else r.full_ready

    def drain_dirty(self) -> set:
        """Hand back (and clear) the residency delta since the last drain."""
        d, self.dirty = self.dirty, set()
        return d

    def resize(self, capacity: int, now: float) -> list:
        """Online capacity change (autoscaler ``resize_cache`` action).
        Growing is free; shrinking evicts LRU unpinned residents down to
        the new capacity. Pinned adapters (in-flight requests) are never
        evicted, so residency may transiently exceed a shrunken capacity —
        ``admit`` stops inserting past capacity, so it drains as pins
        release. Returns the evicted adapter ids."""
        capacity = max(int(capacity), 1)
        evicted = []
        while len(self.resident) > capacity:
            victim = self._evictable()
            if victim is None:
                break
            del self.resident[victim]
            self.evictions += 1
            self.dirty.add(victim)
            evicted.append(victim)
        self.capacity = capacity
        return evicted

    def prefetch_hint(self, adapter_id: int, now: float) -> None:
        """Scheduler-driven prefetch (§5.3): start loading at arrival.
        ``admit`` itself bails (mutation-free) when the adapter's partition
        home is full of pinned residents, so the hint stays safe under a
        partitioned pool."""
        if self.prefetch and adapter_id not in self.resident:
            if len(self.resident) < self.capacity or self._evictable() is not None:
                if self.admit(adapter_id, now) is not None:
                    self.resident[adapter_id].prefetched = True

    def invalidate(self, adapter_id: int) -> bool:
        """Force-evict one adapter (dynamic unload). Refuses pinned
        residents — the caller must reject unload while requests are in
        flight. Returns whether the adapter was resident."""
        r = self.resident.get(adapter_id)
        if r is None:
            return False
        if r.pins > 0:
            raise ValueError(f"adapter {adapter_id} is pinned by "
                             f"{r.pins} in-flight request(s)")
        del self.resident[adapter_id]
        self.evictions += 1
        self.dirty.add(adapter_id)
        return True

    def stats(self) -> Dict[str, float]:
        """Telemetry counters (surfaced through Backend.cache_stats)."""
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "prefetch_hits": self.prefetch_hits,
                "miss_load_seconds": self.miss_load_seconds}

    def pin(self, adapter_id: int) -> None:
        self.resident[adapter_id].pins += 1

    def unpin(self, adapter_id: int, now: float) -> None:
        r = self.resident[adapter_id]
        r.pins -= 1
        r.last_used = now

    def active_count(self) -> int:
        return sum(1 for r in self.resident.values() if r.pins > 0)

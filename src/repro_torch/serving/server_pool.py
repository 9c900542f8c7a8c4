"""Elastic LoRA-Server pool: N server replicas behind one interface, the
counterpart of ``repro.serving.server_pool``.

  adapter-affinity routing   : adapter ``a`` lives on (and is computed by)
                               replica ``a % n_replicas`` only, so replicas
                               partition the adapter set and the per-layer
                               hook traffic instead of duplicating it
  per-replica residency sync : the shared ``LoRACache``'s residency set is
                               mirrored into each replica's slot table
                               delta-based (``LoRACache.drain_dirty``), so a
                               quiet round costs one empty-set check
  online resize              : ``add_replica``/``remove_replica`` re-route
                               the affinity map at a round boundary; the
                               next ``sync`` is forced full, so every
                               resident adapter lands on its new home
                               before the next decode step

The compute contract is bit-compatibility: ``compute`` returns exactly what
a single server holding every adapter would return. Each active row's delta
comes from its affinity home; the other replicas contribute exact ``0.0``
rows and are skipped when they own no active row of the step. The engine
knows the step's adapter ids on the host, so the transport hands them over
once a step (``route_step``, which ``compute`` requires) and no hook
reads the device to decide which replicas to launch. The reference
decides from the dispatch rows' ids; a decode step is dropless
(T * top_k <= 4096), so every token's adapter has a dispatch row and the
two rules engage the same replicas.

A pool built with ``partition_slots=True`` (the mesh plane's layout) is
*partitioned*: each replica holds only its affinity share of the cache
(``ceil(cache_slots / n_replicas)`` slots) instead of a full duplicate, so
the replicas' capacities add up (``total_slots``), and the shared
``LoRACache`` bounds each home at its replica's slots
(``partition_caps``).

Replicas are real ``LoRAServer``s on the cluster plane (built by a factory
so the autoscaler can add them at run time) or slot tables without weights
on the analytic plane (``ServerPool.analytic``, the simulator's): residency
sync, routing and the consistency invariant run the same code on both.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.cache import LoRACache


class AnalyticReplica:
    """Slot table of a simulated server replica (no weights, no compute):
    the analytic plane's stand-in, so residency sync and the consistency
    invariant run the same code as on ``LoRAServer``. Its capacity ``M``
    is advisory: it mirrors whatever the shared cache holds, which can
    exceed a shrunken target while pinned adapters drain (the
    ``LoRACache`` enforces capacity, as on the real plane)."""

    def __init__(self, cache_slots: int):
        self.M = cache_slots
        self.slot_of: Dict[int, int] = {}
        # adapter id -> TRUE rank (LoRAServer.slot_ranks' counterpart,
        # keyed by id: there is no slot pool)
        self.ranks: Dict[int, int] = {}
        self._next_slot = 0

    def is_resident(self, adapter_id: int) -> bool:
        return adapter_id in self.slot_of

    def insert(self, adapter_id: int, tensors=None,
               rank: Optional[int] = None) -> int:
        if adapter_id not in self.slot_of:
            self.slot_of[adapter_id] = self._next_slot
            self._next_slot += 1
        if rank:
            self.ranks[adapter_id] = int(rank)
        return self.slot_of[adapter_id]

    def evict(self, adapter_id: int) -> None:
        del self.slot_of[adapter_id]
        self.ranks.pop(adapter_id, None)

    def true_rank(self, adapter_id: int) -> int:
        """TRUE rank of a resident adapter (0 = not resident / unknown)."""
        if adapter_id not in self.slot_of:
            return 0
        return self.ranks.get(adapter_id, 0)

    def resize(self, cache_slots: int) -> None:
        """Follow the autoscaler's cache target (a slot table holds no
        weights; the real plane caps the policy at its pools instead)."""
        self.M = cache_slots


class ServerPool:
    """N LoRA-Server replicas with adapter-affinity routing + delta sync."""

    def __init__(self, replicas: Sequence, factory: Optional[Callable] = None):
        if not replicas:
            raise ValueError("ServerPool needs at least one replica")
        self.replicas: List = list(replicas)
        self._factory = factory
        # each replica holds its affinity share of the cache, not all of it
        self.partitioned = False
        # rank-aware compute toggle, mirrored onto every replica (current
        # and future); False pins the padded pool-rank path
        self.rank_aware = True
        self._full_sync = True      # first sync (and any resize) is full
        self.sync_rounds = 0
        self.sync_noops = 0
        self.sync_inserts = 0
        self.sync_evictions = 0
        # monotone pool-shape/residency version: bumped on every sync that
        # changed something and on add/remove/resize (fused transport's
        # fingerprint)
        self.version = 0
        # one server launch per replica engaged by a ``compute`` call
        self.compute_calls = 0
        self.replica_launches = 0
        # replicas the current step engages (route_step); None = not
        # routed, and compute refuses
        self._engaged: Optional[Tuple[int, ...]] = None

    # ------------------------------------------------------------------ #
    # construction                                                        #
    # ------------------------------------------------------------------ #
    @classmethod
    def build(cls, model_cfg, adapter_pool, cache_slots: int,
              n_replicas: int = 1, dtype=None, device=None,
              partition_slots: bool = False) -> "ServerPool":
        """``n_replicas`` single-device ``LoRAServer``s, each sized to the
        full cache capacity (affinity partitions load, not worst-case
        residency), plus a factory for ``add_replica``.
        ``partition_slots=True`` (the mesh plane's layout) sizes each
        replica to ``ceil(cache_slots / n_replicas)`` slots instead; the
        factory keeps every replica that size (the fused transport stacks
        their pools)."""
        from repro_torch.core.lora_server import LoRAServer, ServerConfig
        if dtype is None:
            dtype = next(iter(adapter_pool.tensors.values()))["A"].dtype
        per_rep = -(-cache_slots // max(n_replicas, 1)) if partition_slots \
            else cache_slots

        def factory():
            scfg = ServerConfig(m=1, x=1, y=1, cache_slots=per_rep,
                                rank=adapter_pool.rank)
            return LoRAServer(model_cfg, scfg, dtype=dtype, device=device)

        pool = cls([factory() for _ in range(n_replicas)], factory=factory)
        pool.partitioned = partition_slots
        return pool

    @classmethod
    def analytic(cls, n_replicas: int, cache_slots: int) -> "ServerPool":
        """Sim-plane pool: slot tables only (the step-time model prices the
        replicas' capacity; see ``simulator.disagg_stall_seconds``)."""
        return cls([AnalyticReplica(cache_slots) for _ in range(n_replicas)],
                   factory=lambda: AnalyticReplica(cache_slots))

    # ------------------------------------------------------------------ #
    # shape                                                               #
    # ------------------------------------------------------------------ #
    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def min_slots(self) -> int:
        """Smallest per-replica slot capacity: the cache-size bound of a
        duplicated pool (worst case routes every resident to one replica)."""
        return min(r.M for r in self.replicas)

    @property
    def total_slots(self) -> int:
        """The cache-size bound: the replicas' capacities added when
        partitioned (each holds only its share), ``min_slots`` otherwise."""
        if self.partitioned:
            return sum(r.M for r in self.replicas)
        return self.min_slots

    def partition_caps(self) -> Dict[int, int]:
        """Per-home slot caps for the shared cache's admission
        (``LoRACache.set_partition``)."""
        return {i: r.M for i, r in enumerate(self.replicas)}

    def replica_for(self, adapter_id: int) -> int:
        """Affinity home of ``adapter_id`` (stable between resizes)."""
        return int(adapter_id) % len(self.replicas)

    def is_resident(self, adapter_id: int) -> bool:
        return self.replicas[self.replica_for(adapter_id)].is_resident(
            adapter_id)

    def set_rank_aware(self, flag: bool) -> None:
        """Toggle true-rank compute on every replica (and later ones)."""
        self.rank_aware = bool(flag)
        for rep in self.replicas:
            if hasattr(rep, "rank_aware"):
                rep.rank_aware = self.rank_aware

    def true_rank(self, adapter_id: int) -> int:
        """TRUE rank of a resident adapter via its home (0 = absent)."""
        return self.replicas[self.replica_for(adapter_id)].true_rank(
            adapter_id)

    @property
    def pool_rank(self) -> int:
        """Padded (pool) rank of the replicas' slot pools (0 on analytic
        replicas, which have none)."""
        return max(getattr(rep, "r", 0) for rep in self.replicas)

    # ------------------------------------------------------------------ #
    # elasticity                                                          #
    # ------------------------------------------------------------------ #
    def add_replica(self):
        """Scale out by one replica; the next sync is forced full."""
        if self._factory is None:
            raise RuntimeError("ServerPool built without a replica factory")
        rep = self._factory()
        if hasattr(rep, "rank_aware"):
            rep.rank_aware = self.rank_aware
        self.replicas.append(rep)
        self._full_sync = True
        self.version += 1
        return rep

    def remove_replica(self):
        """Scale in by one replica (never below one); its residents are
        re-homed by the forced full sync that follows."""
        if len(self.replicas) <= 1:
            raise RuntimeError("ServerPool cannot drop below one replica")
        rep = self.replicas.pop()
        self._full_sync = True
        self.version += 1
        return rep

    def resize_slots(self, cache_slots: int) -> None:
        """Follow an adapter-cache resize: analytic slot tables take the
        new size, preallocated slot pools keep theirs (the caller clamps
        the cache to ``total_slots``). Either way the next sync is forced
        full: a resize can re-home residency, and a stale slot table would
        route rows to the wrong slot."""
        for rep in self.replicas:
            if hasattr(rep, "resize"):
                rep.resize(cache_slots)
        self._full_sync = True
        self.version += 1

    # ------------------------------------------------------------------ #
    # residency sync (delta-based)                                        #
    # ------------------------------------------------------------------ #
    def sync(self, cache: LoRACache,
             tensors_fn: Optional[Callable[[int], object]] = None,
             rank_fn: Optional[Callable[[int], int]] = None) -> int:
        """Mirror ``cache``'s residency set into the replica slot tables:
        only the ids the cache marked dirty since the last sync, or every
        id the cache or a replica holds after a resize. ``tensors_fn(aid)``
        gives an adapter's server tensors, ``rank_fn(aid)`` its TRUE rank.
        Returns the number of ids reconciled (0 == no-op round)."""
        self.sync_rounds += 1
        if self._full_sync:
            changed = set(cache.resident)
            for rep in self.replicas:
                changed |= set(rep.slot_of)
            cache.drain_dirty()          # superseded by the full pass
            self._full_sync = False
            full = True
        else:
            full = False
            changed = cache.drain_dirty()
            if not changed:
                self.sync_noops += 1
                return 0
        # evictions first so slots free up for the inserts
        for aid in changed:
            home = self.replica_for(aid)
            want = aid in cache.resident
            for i, rep in enumerate(self.replicas):
                if rep.is_resident(aid) and (not want or i != home):
                    rep.evict(aid)
                    self.sync_evictions += 1
        for aid in changed:
            if aid not in cache.resident:
                continue
            rep = self.replicas[self.replica_for(aid)]
            if not rep.is_resident(aid):
                rep.insert(aid, tensors_fn(aid) if tensors_fn else None,
                           rank=rank_fn(aid) if rank_fn else None)
                self.sync_inserts += 1
        if full:
            self.check_consistent(cache)
        if full or changed:
            self.version += 1
        return len(changed)

    def check_consistent(self, cache: Optional[LoRACache] = None) -> None:
        """Each resident adapter sits on exactly its affinity replica, no
        replica holds a foreign or stale id, and, given the mirrored cache,
        the union of replica residents equals the cache's residency set."""
        seen: Dict[int, int] = {}
        for i, rep in enumerate(self.replicas):
            for aid in rep.slot_of:
                if aid in seen:
                    raise AssertionError(
                        f"adapter {aid} resident on replicas {seen[aid]} "
                        f"and {i}")
                if self.replica_for(aid) != i:
                    raise AssertionError(
                        f"adapter {aid} on replica {i}, affinity says "
                        f"{self.replica_for(aid)}")
                seen[aid] = i
        if cache is not None and not self._full_sync and not cache.dirty:
            if set(seen) != set(cache.resident):
                raise AssertionError(
                    f"replica residency {sorted(seen)} != cache residency "
                    f"{sorted(cache.resident)}")

    # ------------------------------------------------------------------ #
    # compute routing                                                     #
    # ------------------------------------------------------------------ #
    def route_step(self, adapter_ids) -> None:
        """Fix the replicas the coming step's hooks engage from its
        host-side adapter ids (-1 = inactive row); ``None`` forgets them."""
        if adapter_ids is None:
            self._engaged = None
            return
        ids = np.asarray(adapter_ids).reshape(-1)
        R = len(self.replicas)
        self._engaged = tuple(sorted({int(a) % R for a in ids if a >= 0}))

    def compute(self, hook: str, layer: int, rows, adapter_ids, expert_ids):
        """Drop-in for ``LoRAServer.compute`` within a routed step
        (``route_step``): every active row's delta comes from its affinity
        replica; replicas owning no active row of the step are skipped.
        One replica is a passthrough."""
        engaged = self._engaged
        if engaged is None:
            raise RuntimeError("ServerPool.compute needs the step's routing: "
                               "call route_step(adapter_ids) first")
        self.compute_calls += 1
        if len(self.replicas) == 1:
            self.replica_launches += 1
            return self.replicas[0].compute(hook, layer, rows, adapter_ids,
                                            expert_ids)
        ids = torch.as_tensor(adapter_ids)
        homes = torch.where(ids >= 0, ids % len(self.replicas), -1)
        out = None
        for i in engaged:
            self.replica_launches += 1
            delta = self.replicas[i].compute(
                hook, layer, rows, torch.where(homes == i, ids, -1),
                expert_ids)
            out = delta if out is None else out + delta
        if out is None:     # no active adapters anywhere: exact zero delta
            self.replica_launches += 1
            out = self.replicas[0].compute(hook, layer, rows,
                                           torch.full_like(ids, -1),
                                           expert_ids)
        return out

"""Token-level scheduler with a LoRA table (paper Fig. 4), a copy of
``repro.serving.scheduler`` driving the port's ``serving/cache.py``.

Used by the simulator for both systems:
  - coupled (S-LoRA): one scheduler per LLM instance, cache on the instance;
    a request can only run on the instance that owns (or can load) its
    adapter — instances are pre-assigned disjoint adapter subsets by a
    greedy load-balancer (paper §6.1).
  - disaggregated (InfiniLoRA): one global scheduler; adapters live in the
    shared LoRA Server cache; any instance can run any request, so admission
    checks the shared cache and picks the least-loaded instance.

Admission (per decode-step boundary, i.e. token level): a request is admitted
iff (a) the target engine batch has a free slot, (b) when the engine is
PAGED, the instance's KV page budget covers the request's whole footprint
(prompt + output pages — the paper's real KV-capacity bound, replacing the
"one slot = max_len rows" proxy), and (c) its adapter is resident or a slot
can be freed; otherwise it queues (FCFS, or SJF with oracle output lengths
for the S-LoRA w/ SJF baseline).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.cache import LoRACache
from repro_torch.serving.workload import Request


@dataclasses.dataclass
class InstanceState:
    iid: int
    max_batch: int
    running: List[Request] = dataclasses.field(default_factory=list)
    next_free: float = 0.0          # time the current step ends
    slowdown: float = 1.0           # straggler factor (fault-tolerance tests)
    alive: bool = True
    draining: bool = False          # scale-in: finish running, admit nothing

    @property
    def batch(self) -> int:
        return len(self.running)


def assign_adapters_greedy(n_adapters: int, popularity: np.ndarray,
                           n_instances: int) -> np.ndarray:
    """Paper §6.1: pre-assign disjoint adapter subsets balancing expected
    load (greedy largest-first)."""
    order = np.argsort(-popularity)
    load = np.zeros(n_instances)
    owner = np.zeros(n_adapters, dtype=int)
    for a in order:
        i = int(np.argmin(load))
        owner[a] = i
        load[i] += popularity[a]
    return owner


class Scheduler:
    def __init__(self, instances: Sequence[InstanceState],
                 caches: Dict[int, LoRACache], owner: Optional[np.ndarray],
                 policy: str = "fcfs", shared_cache: bool = False,
                 kv_pages: Optional[Dict[int, int]] = None,
                 kv_page_need: Optional[Callable[[Request], int]] = None):
        self.instances = {i.iid: i for i in instances}
        self.caches = caches          # iid -> cache (or {-1: shared})
        self.owner = owner            # adapter -> instance (coupled only)
        self.policy = policy
        self.shared_cache = shared_cache
        # paged-KV admission: kv_pages[iid] is the instance's page budget,
        # kv_page_need(req) the pages the request holds over its lifetime
        # (prompt + decoded tokens). None -> slot-count admission only.
        self.kv_pages = kv_pages
        self.kv_page_need = kv_page_need
        self.queues: Dict[int, List[Request]] = {i.iid: [] for i in instances}
        if shared_cache:
            self.queues[-1] = []

    # ------------------------------------------------------------------ #
    def cache_for(self, iid: int) -> LoRACache:
        return self.caches[-1] if self.shared_cache else self.caches[iid]

    def enqueue(self, req: Request, now: float):
        if self.shared_cache:
            self.queues[-1].append(req)
            self.cache_for(-1).prefetch_hint(req.adapter_id, now)
        else:
            iid = int(self.owner[req.adapter_id])
            self.queues[iid].append(req)
            self.caches[iid].prefetch_hint(req.adapter_id, now)

    def _reassign_owned(self, iid: int, weight: Dict[int, int]) -> None:
        """Coupled mode: hand instance ``iid``'s owned adapters to the
        least-loaded admitting instances (heaviest affected adapter first).
        Shared-cache mode routes through one global queue, so ownership
        does not exist and this is a no-op."""
        if self.shared_cache or self.owner is None:
            return
        survivors = [i for i in self.instances.values()
                     if i.alive and not i.draining and i.iid != iid]
        if not survivors:
            return
        load = {i.iid: i.batch + len(self.queues[i.iid])
                for i in survivors}
        orphan_adapters = [a for a in range(len(self.owner))
                           if int(self.owner[a]) == iid]
        for a in sorted(orphan_adapters, key=lambda a: -weight.get(a, 0)):
            tgt = min(load, key=lambda j: load[j])
            self.owner[a] = tgt
            load[tgt] += weight.get(a, 0)

    def add_adapter(self, adapter_id: int) -> None:
        """Coupled mode: an adapter appended to the pool (id
        ``len(owner)``) goes to the admitting instance that owns the
        fewest adapters."""
        if self.shared_cache or self.owner is None:
            return
        if adapter_id != len(self.owner):
            raise ValueError(f"adapter {adapter_id} is not the next id "
                             f"{len(self.owner)}")
        live = [i.iid for i in self.instances.values()
                if i.alive and not i.draining]
        iid = min(live, key=lambda i: (int(np.sum(self.owner == i)), i))
        self.owner = np.append(self.owner, iid)

    def requeue_instance(self, iid: int, now: float):
        """Fault handling: move a dead instance's work back to the queues.

        Coupled mode: requests route to ``owner[adapter_id]``, so simply
        re-enqueueing would put them back on the DEAD instance's own queue,
        where ``admit()`` returns [] forever — they would never finish.
        The dead instance's adapters are therefore reassigned to the
        least-loaded surviving instances first (heaviest affected adapter
        first), and anything already waiting in its queue is rerouted too.
        With no survivor the work stays queued on ``iid`` and resumes only
        if it recovers. Shared-cache (disaggregated) mode has one global
        queue, so only the running set needs requeueing."""
        inst = self.instances[iid]
        inst.alive = False
        cache = self.cache_for(iid)
        orphans = list(inst.running)
        inst.running.clear()
        stranded: List[Request] = []
        if not self.shared_cache:
            stranded = self.queues[iid]
            self.queues[iid] = []
        for r in orphans + stranded:
            r.decode_start = -1.0
            r.first_token = -1.0
            r.tokens_done = 0
            if r.reserved:
                cache.unpin(r.adapter_id, now)
                r.reserved = False
        weight: Dict[int, int] = {}
        for r in orphans + stranded:
            weight[r.adapter_id] = weight.get(r.adapter_id, 0) + 1
        self._reassign_owned(iid, weight)
        for r in orphans + stranded:
            self.enqueue(r, now)

    # ----------------------- elastic provisioning ---------------------- #
    def add_instance(self, inst: InstanceState,
                     cache: Optional[LoRACache] = None,
                     popularity: Optional[np.ndarray] = None,
                     kv_budget: Optional[int] = None,
                     now: float = 0.0) -> None:
        """Scale-out primitive: register a new instance mid-run. Coupled
        mode needs its adapter cache and (optionally) a popularity estimate
        to rebalance adapter ownership onto the newcomer; paged engines
        register their page budget so admission stays KV-bounded."""
        if inst.iid in self.instances:
            raise ValueError(f"instance {inst.iid} already registered")
        self.instances[inst.iid] = inst
        self.queues.setdefault(inst.iid, [])
        if not self.shared_cache:
            if cache is None:
                raise ValueError("coupled add_instance needs a LoRACache")
            self.caches[inst.iid] = cache
            if popularity is not None:
                self.rebalance_owners(popularity, now)
        if self.kv_pages is not None and kv_budget is not None:
            self.kv_pages[inst.iid] = kv_budget

    def drain_instance(self, iid: int, now: float) -> int:
        """Scale-in primitive (graceful ``requeue_instance``): stop
        admitting to ``iid``, reroute its queued work to the survivors
        (coupled: reassigning its owned adapters first, exactly like the
        fault path), but let in-flight requests finish in place — their
        token streams must not restart. Returns the in-flight count; the
        caller retires the instance once it reaches zero."""
        inst = self.instances[iid]
        inst.draining = True
        stranded: List[Request] = []
        if not self.shared_cache:
            stranded = self.queues[iid]
            self.queues[iid] = []
        for r in stranded:
            if r.reserved:
                self.cache_for(iid).unpin(r.adapter_id, now)
                r.reserved = False
        weight: Dict[int, int] = {}
        for r in stranded:
            weight[r.adapter_id] = weight.get(r.adapter_id, 0) + 1
        self._reassign_owned(iid, weight)
        tgts = set()
        for r in stranded:
            self.enqueue(r, now)
            tgts.add(-1 if self.shared_cache
                     else int(self.owner[r.adapter_id]))
        for t in tgts:
            # rerouted work must not fall behind later arrivals (FCFS)
            self.queues[t].sort(key=lambda r: (r.arrival, r.rid))
        return inst.batch

    def rebalance_owners(self, popularity: np.ndarray,
                         now: float = 0.0) -> None:
        """Coupled mode: recompute the greedy adapter->instance assignment
        over the currently admitting instances (paper §6.1, online) and
        reroute queued-but-unadmitted requests to their new owners. Running
        requests stay where they are — rebalancing must never perturb an
        in-flight token stream."""
        if self.shared_cache or self.owner is None:
            return
        targets = [i.iid for i in self.instances.values()
                   if i.alive and not i.draining]
        if not targets:
            return
        load = {iid: float(self.instances[iid].batch) for iid in targets}
        for a in np.argsort(-np.asarray(popularity)):
            tgt = min(load, key=lambda j: (load[j], j))
            self.owner[a] = tgt
            load[tgt] += float(popularity[a])
        moved_into = set()
        for iid in [i for i in self.queues if i != -1]:
            keep = []
            for r in self.queues[iid]:
                tgt = int(self.owner[r.adapter_id])
                if tgt != iid and tgt in self.queues:
                    if r.reserved:
                        # the pin lives on the OLD instance's cache; the new
                        # owner re-pins at its own admit
                        self.caches[iid].unpin(r.adapter_id, now)
                        r.reserved = False
                    self.queues[tgt].append(r)
                    moved_into.add(tgt)
                else:
                    keep.append(r)
            self.queues[iid] = keep
        for iid in moved_into:
            # appending rerouted requests behind later arrivals would invert
            # FCFS priority; restore arrival order on receiving queues
            self.queues[iid].sort(key=lambda r: (r.arrival, r.rid))

    def _sorted_queue(self, q: List[Request]) -> List[Request]:
        if self.policy == "sjf":  # oracle output lengths (paper baseline)
            return sorted(q, key=lambda r: r.output_len)
        return q

    # ------------------------------------------------------------------ #
    def admit(self, iid: int, now: float) -> List[Request]:
        """Admit queued requests into instance ``iid`` at a step boundary."""
        inst = self.instances[iid]
        if not inst.alive or inst.draining:
            return []
        cache = self.cache_for(iid)
        q_key = -1 if self.shared_cache else iid
        queue = self._sorted_queue(self.queues[q_key])
        admitted = []
        rest = []
        held = 0
        if self.kv_pages is not None:
            # the real KV-capacity bound: every resident request holds its
            # full prompt+output page footprint, so admission never lets
            # the pool be over-committed mid-decode (pages are physically
            # allocated lazily by the engine, but the budget is reserved
            # here)
            held = sum(self.kv_page_need(r) for r in inst.running)
        for req in queue:
            if req.arrival > now or inst.batch + len(admitted) >= inst.max_batch:
                rest.append(req)
                continue
            need = self.kv_page_need(req) if self.kv_pages is not None else 0
            if self.kv_pages is not None and \
                    held + need > self.kv_pages[iid]:
                rest.append(req)
                continue
            ready = cache.admit(req.adapter_id, now)
            if ready is None:
                rest.append(req)  # no evictable slot: stay queued
                continue
            if not req.reserved:
                # reserve the (possibly still-loading) slot so later queue
                # entries cannot evict it — prevents load thrashing
                cache.pin(req.adapter_id)
                req.reserved = True
            if ready > now:
                rest.append(req)  # layer-wise load in flight (§5.3)
                continue
            req.instance = iid
            req.decode_start = now
            admitted.append(req)
            held += need
        self.queues[q_key] = [r for r in rest]
        inst.running.extend(admitted)
        return admitted

    def step_complete(self, iid: int, now: float) -> List[Request]:
        """Per-decode-step bookkeeping shared by the analytic simulator and
        the real cluster: every running request earned one token at
        ``now``; stamp first-token / finish times, retire the finished, and
        return them. The caller is responsible for what a "step" costs
        (analytic step model vs. real JAX execution) — admission, token
        accounting, and retirement are this one implementation."""
        inst = self.instances[iid]
        finished = []
        for r in inst.running:
            r.tokens_done += 1
            if r.tokens_done == 1:
                r.first_token = now
            if r.tokens_done >= r.output_len:
                r.finish = now
                finished.append(r)
        self.retire(iid, finished, now)
        return finished

    def cancel(self, req: Request, now: float) -> Optional[str]:
        """Release ``req`` WITHOUT counting it as finished: remove it from
        whichever queue or running set holds it and drop its adapter pin so
        the slot becomes evictable again. Returns where it was found
        ("running" / "queued") or None if the scheduler no longer holds it
        (already retired, or never enqueued). ``req.finish`` stays -1 — a
        cancelled request must never look like a completion to metrics."""
        req.cancelled = True
        for iid, inst in self.instances.items():
            if req in inst.running:
                inst.running.remove(req)
                if req.reserved:
                    self.cache_for(iid).unpin(req.adapter_id, now)
                    req.reserved = False
                return "running"
        for key, q in self.queues.items():
            if req in q:
                q.remove(req)
                if req.reserved:
                    # queued-but-reserved: the pin taken while its adapter
                    # was still loading must come back too (queue keys match
                    # cache keys in both modes: -1 shared, iid otherwise)
                    self.caches[key].unpin(req.adapter_id, now)
                    req.reserved = False
                return "queued"
        return None

    def retire(self, iid: int, finished: List[Request], now: float):
        inst = self.instances[iid]
        cache = self.cache_for(iid)
        for r in finished:
            inst.running.remove(r)
            cache.unpin(r.adapter_id, now)
            r.reserved = False

    def queue_len(self) -> int:
        return sum(len(q) for q in self.queues.values())

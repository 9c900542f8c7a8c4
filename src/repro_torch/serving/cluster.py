"""The cluster: N slot-engine instances under the token-level Scheduler,
the counterpart of ``repro.serving.cluster``.

The same control plane as the reference (``Scheduler`` admission, pinning
and retirement, ``LoRACache`` residency, greedy adapter placement) drives
the port's ``Engine`` instances. Time is virtual: every global decode
round advances the clock by ``step_time``, so admission, layer-wise
adapter loading and SLO bookkeeping run the reference's code paths, while
tokens come from the model on the device the weights live on.

  coupled (S-LoRA)       : per-instance adapter caches, requests routed to
                           the instance owning their adapter (greedy
                           pre-assignment, paper §6.1), adapters applied
                           in-model
  disaggregated          : one shared LoRA cache mirrored into a
  (InfiniLoRA)             ``ServerPool`` of LoRA-Server replicas, fed by
                           the adapter store; any instance serves any
                           request, all through one transport plane

Elastic provisioning: ``ClusterConfig.autoscale`` attaches an
``Autoscaler`` (paper §4.2 / Algorithm 1 run online). At each round
boundary, on the host and before the round's decode steps, it may resize
the adapter cache, add or remove server replicas, or add or drain LLM
instances: the instance set is a dict keyed by iid, and a drained instance
finishes its in-flight work, then retires and releases its KV (and the
fused transport forgets its graphs). Scaling never changes a request's
tokens: greedy decoding depends only on the request's own prompt.

Requests are admitted at decode-step boundaries into a RUNNING batch
(continuous batching) and evicted the step they finish; greedy decoding is
deterministic, so for the same workload the planes give the same tokens
per request.

The mesh-sharded plane (``ClusterConfig.mesh_shape`` = (data, model),
disaggregated only): a grid of devices (``launch.mesh.make_serve_mesh``:
the CPU for params on the CPU, else the first data * model distinct
visible cards) over which the decode step's base expert GEMMs run
expert-parallel (``distributed.steps``), the expert weights cut into
blocks on their devices; the server pool's replicas stay single-device
and, when it is partitioned, the shared cache bounds each affinity home at
its replica's slots. The tokens are those without a mesh, bit for bit.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.adapter import AdapterPool
from repro_torch.distributed.steps import expert_parallel_ctx, \
    shard_serve_params
from repro_torch.launch.mesh import check_mesh_shape, make_serve_mesh
from repro_torch.models.cache import pages_for
from repro_torch.obs.clock import wall_time
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving.autoscaler import Autoscaler, AutoscalePolicy, \
    ScaleAction, converge_replicas, pick_drain_candidate
from repro_torch.serving.cache import LoRACache
from repro_torch.serving.engine import Engine, EngineConfig, check_family
from repro_torch.serving.scheduler import InstanceState, Scheduler, \
    assign_adapters_greedy
from repro_torch.serving.server_pool import ServerPool
from repro_torch.serving.workload import Request
from repro_torch.store import AdapterStore
from repro_torch.store.convert import rescale_alpha, validate_host_tensors
from repro_torch.transport import make_transport


@dataclasses.dataclass
class ClusterConfig:
    n_instances: int = 2
    n_slots: int = 4                 # decode slots (max batch) per instance
    max_len: int = 64
    disaggregated: bool = False
    adapter_cache_slots: int = 8     # per instance (coupled) / shared (disagg)
    policy: str = "fcfs"
    step_time: float = 1.0           # virtual seconds per decode round
    # adapter load bandwidth; inf -> load time exactly 0, so cold adapters
    # admit the SAME round (any finite bw defers admission one round)
    host_bw: float = float("inf")
    layerwise_loading: bool = True
    max_rounds: int = 100_000
    # paged KV engine: block-pool cache + page-budget admission.
    # n_pages=None sizes the pool to the dense-slab worst case.
    paged: bool = False
    page_size: int = 8
    n_pages: Optional[int] = None
    prefill_chunk: int = 16
    # elastic provisioning: run Algorithm 1 online at round boundaries
    autoscale: Optional[AutoscalePolicy] = None
    # disaggregated hook transport plane: "host" (per-hook host dispatch)
    # or "fused" (one CUDA graph a decode step; see transport/)
    transport: str = "host"
    # per-launch cost fed to the autoscaler's TPOT-budget derate (the
    # plane measures its dispatches but models their cost; 0 = no derate)
    hook_launch_us: float = 0.0
    # mesh-sharded execution plane: a (data, model) device grid over which
    # the disaggregated step's base expert GEMMs run expert-parallel
    mesh_shape: Optional[Tuple[int, int]] = None
    # hierarchical adapter store (disaggregated only): host-RAM tier byte
    # budget (None = unbounded), disk-tier directory (None = private
    # tempdir made on the first spill), disk read bandwidth for pricing
    store_host_bytes: Optional[int] = None
    store_dir: Optional[str] = None
    disk_bw: float = 5e9
    # async prefetch staging + scheduler prefetch hints; None follows
    # layerwise_loading
    prefetch: Optional[bool] = None
    # bound each row's hook contraction at its adapter's TRUE rank (padded
    # lanes are exact zeros, so the tokens do not move)
    rank_aware: bool = True

    @property
    def prefetch_on(self) -> bool:
        return self.layerwise_loading if self.prefetch is None \
            else self.prefetch


def _device_of(params):
    """The device the model's weights live on (the engines run there)."""
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


class Cluster:
    """N client instances against one adapter plane (a pool of server
    replicas, or per-instance caches); the instance set is elastic when
    autoscaling."""

    def __init__(self, cfg, params, ccfg: ClusterConfig, pool: AdapterPool,
                 server_pool: Optional[ServerPool] = None,
                 tracer: Optional[Tracer] = None):
        # span tracer: virtual round-clock timestamps, wall clock only as
        # span attributes. NULL_TRACER = record nothing.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        check_family(cfg, disaggregated=ccfg.disaggregated)
        if ccfg.mesh_shape is not None:
            check_mesh_shape(ccfg.mesh_shape, ccfg.disaggregated)
        if ccfg.disaggregated:
            if server_pool is None:
                raise ValueError(
                    "disaggregated mode needs a ServerPool (server_pool=)")
            if server_pool.total_slots < ccfg.adapter_cache_slots:
                # the shared LoRACache mirrors into the replicas' slot
                # pools: a duplicated pool is bound by its smallest replica
                # (affinity may route every resident to one), a partitioned
                # one by the sum (per-home admission bounds each share)
                kind = "aggregate" if server_pool.partitioned else "replica"
                raise ValueError(
                    f"ServerPool {kind} capacity {server_pool.total_slots} "
                    f"< adapter_cache_slots={ccfg.adapter_cache_slots}")
        self.device = _device_of(params)
        self.mesh_ctx = None
        if ccfg.mesh_shape is not None:
            params = self._shard(cfg, params, ccfg)
        self.cfg = cfg
        self.ccfg = ccfg
        self.pool = pool
        self.params = params
        self.server_pool = server_pool if ccfg.disaggregated else None
        if self.server_pool is not None:
            self.server_pool.set_rank_aware(ccfg.rank_aware)
        # hierarchical adapter store, disaggregated only: the coupled path
        # gathers adapters from the static pool inside the model
        self.store: Optional[AdapterStore] = None
        if ccfg.disaggregated:
            self.store = AdapterStore(
                cfg, pool, host_bytes=ccfg.store_host_bytes,
                store_dir=ccfg.store_dir, host_bw=ccfg.host_bw,
                disk_bw=ccfg.disk_bw, prefetch=ccfg.prefetch_on)
        # ONE transport for the whole cluster: every engine bills its stats
        # and, on the fused plane, shares its device tables and graph pool
        self.transport = None
        if ccfg.disaggregated:
            self.transport = make_transport(ccfg.transport, self.server_pool,
                                            n_adapters=pool.n)
        self._ecfg = EngineConfig(max_len=ccfg.max_len, n_slots=ccfg.n_slots,
                                  paged=ccfg.paged, page_size=ccfg.page_size,
                                  n_pages=ccfg.n_pages,
                                  prefill_chunk=ccfg.prefill_chunk)
        # engines are built by open()
        self.engines: Dict[int, Engine] = {}
        self.sched: Optional[Scheduler] = None
        self._instances: Dict[int, InstanceState] = {}
        self._caches: Dict[int, LoRACache] = {}
        self._cache_slots = ccfg.adapter_cache_slots
        self._scaler: Optional[Autoscaler] = None
        self._next_iid = ccfg.n_instances
        self.tokens: Dict[int, List[int]] = {}
        self._reqs: Dict[int, Request] = {}
        self._pending: List[Request] = []
        self._pi = 0
        self.rnd = 0

    def _shard(self, cfg, params, ccfg: ClusterConfig):
        """Build the mesh of ``ccfg.mesh_shape`` and its expert-parallel
        ctx, and cut the expert weights into its blocks (no ctx: a mesh
        with one position on the expert axis, or an E that does not
        divide, runs the plain path)."""
        data, model = ccfg.mesh_shape
        mesh = make_serve_mesh(data, model, devices=["cpu"]
                               if self.device.type == "cpu" else None)
        if mesh.first != self.device:
            raise ValueError(f"the mesh's first device {mesh.first} must "
                             f"hold the params (on {self.device})")
        self.mesh_ctx = expert_parallel_ctx(mesh, cfg)
        if self.mesh_ctx is None:
            return params
        return shard_serve_params(params, self.mesh_ctx)

    def _new_engine(self) -> Engine:
        return Engine(self.cfg, self.params, self._ecfg,
                      server=self.server_pool, pool=self.pool,
                      transport=self.transport or "host", device=self.device,
                      mesh_ctx=self.mesh_ctx)

    def _set_cache_partition(self) -> None:
        """Install the shared cache's per-home bounds from the partitioned
        pool's current replica set."""
        self._caches[-1].set_partition(self.server_pool.replica_for,
                                       self.server_pool.partition_caps())

    # ------------------------------------------------------------------ #
    def _prompt(self, req: Request) -> np.ndarray:
        """Deterministic prompt tokens for a request: the tokens it carries
        (served verbatim; ``validate`` checks they fit), or a seeded draw
        from its rid, clamped so prompt + output fit the slot."""
        if req.prompt:
            return np.asarray(req.prompt, np.int32).reshape(-1)
        room = self.ccfg.max_len - req.output_len - 1
        plen = max(1, min(req.prompt_len, room))
        rng = np.random.default_rng(7919 + req.rid)
        return rng.integers(0, self.cfg.vocab_size, plen).astype(np.int32)

    def _sync_pool(self) -> None:
        """Delta-based residency mirror: the replicas' slot tables follow
        the adapter ids the shared cache changed since the last sync;
        uploads stage through the adapter store (async-prefetched results
        first, disk-tier adapters promoted), bitwise identical to the
        direct pool extraction."""
        self.server_pool.sync(self._caches[-1],
                              tensors_fn=self.store.server_tensors,
                              rank_fn=self.store.rank_of)

    # ------------------------------------------------------------------ #
    # incremental session API (serving/api.py front door)                 #
    # ------------------------------------------------------------------ #
    def validate(self, req: Request) -> None:
        """Admission-contract checks, raised BEFORE a request enters the
        session (the front door turns these into REJECTED handles)."""
        ccfg = self.ccfg
        plen = len(req.prompt) if req.prompt else 1
        if plen + req.output_len > ccfg.max_len + 1:
            raise ValueError(
                f"request {req.rid}: prompt_len {plen} + output_len "
                f"{req.output_len} cannot fit a max_len={ccfg.max_len} "
                f"slot")
        if self.store is not None:
            if not self.store.has(req.adapter_id):
                raise ValueError(
                    f"request {req.rid}: adapter_id {req.adapter_id} is "
                    f"not registered in the adapter store")
        elif not 0 <= req.adapter_id < self.pool.n:
            # the gather kernels would clamp an out-of-range id to the last
            # adapter's weights
            raise ValueError(
                f"request {req.rid}: adapter_id {req.adapter_id} outside "
                f"pool of {self.pool.n}")
        if ccfg.paged:
            need = pages_for(int(self._prompt(req).shape[0])
                             + req.output_len - 1, ccfg.page_size)
            budget = next(iter(self.engines.values())).total_pages
            if need > budget:
                raise ValueError(
                    f"request {req.rid}: needs {need} KV pages but the "
                    f"pool has {budget} — it could never be admitted")

    def open(self, requests: Sequence[Request] = ()) -> None:
        """Start a serving session: build the engines and the scheduler and
        cache control plane. ``requests``, when known up front (the batch
        path), seed the coupled plane's greedy adapter -> instance
        assignment with the true per-adapter load; a streaming session
        assigns from uniform weights over the pool."""
        ccfg = self.ccfg
        n_adapters = max(self.pool.n,
                         max((r.adapter_id for r in requests), default=0) + 1)
        self._instances = {i: InstanceState(i, ccfg.n_slots)
                           for i in range(ccfg.n_instances)}
        self.engines = {i: self._new_engine()
                        for i in range(ccfg.n_instances)}
        self._next_iid = ccfg.n_instances
        self._cache_slots = ccfg.adapter_cache_slots
        if ccfg.disaggregated:
            self._caches = {-1: self._mk_cache()}
            if self.server_pool.partitioned:
                self._set_cache_partition()
            owner = None
        else:
            counts = np.bincount([r.adapter_id for r in requests],
                                 minlength=n_adapters).astype(float)
            if not len(requests):
                counts += 1.0           # uniform expected load
            owner = assign_adapters_greedy(n_adapters, counts,
                                           ccfg.n_instances)
            self._caches = {i: self._mk_cache()
                            for i in range(ccfg.n_instances)}
        kv_pages = kv_need = None
        if ccfg.paged:
            # a resident request's page footprint: prompt positions plus
            # one page-row per decoded token (the last emitted token is
            # never written, hence -1); memoized by rid
            kv_pages = {i: self.engines[i].total_pages
                        for i in range(ccfg.n_instances)}
            self._need_by_rid: Dict[int, int] = {}

            def kv_need(r: Request) -> int:
                if r.rid not in self._need_by_rid:
                    plen = int(self._prompt(r).shape[0])
                    self._need_by_rid[r.rid] = pages_for(
                        plen + r.output_len - 1, ccfg.page_size)
                return self._need_by_rid[r.rid]
        self.sched = Scheduler(list(self._instances.values()), self._caches,
                               owner, policy=ccfg.policy,
                               shared_cache=ccfg.disaggregated,
                               kv_pages=kv_pages, kv_page_need=kv_need)
        self._scaler = None
        if ccfg.autoscale is not None:
            pol = ccfg.autoscale
            if self.server_pool is not None and \
                    pol.max_cache_slots > self.server_pool.total_slots:
                # cap the policy at the pool's slot capacity, or the control
                # loop would chase an unreachable cache target every tick
                pol = dataclasses.replace(
                    pol, max_cache_slots=self.server_pool.total_slots)
            self._scaler = Autoscaler(pol, self.cfg, max_batch=ccfg.n_slots,
                                      has_server=self.server_pool is not None,
                                      transport=ccfg.transport,
                                      hook_launch_us=ccfg.hook_launch_us)
        self.tokens = {}
        self._reqs = {}
        self._pending = []
        self._pi = 0
        self.rnd = 0

    def _mk_cache(self) -> LoRACache:
        return LoRACache(self._cache_slots,
                         self.pool.bytes_per_adapter(), self.cfg.n_layers,
                         host_bw=self.ccfg.host_bw,
                         layerwise=self.ccfg.layerwise_loading,
                         prefetch=self.ccfg.prefetch_on,
                         load_seconds_fn=self.store.load_seconds
                         if self.store is not None else None,
                         tracer=self.tracer)

    @property
    def now(self) -> float:
        """Virtual time of the NEXT round boundary."""
        return self.rnd * self.ccfg.step_time

    def submit(self, req: Request) -> Request:
        """Add one request to the open session (takes ownership of
        ``req``). May be called mid-run: the request joins the queue at
        the next round boundary."""
        if self.sched is None:
            raise RuntimeError("Cluster.open() before submit()")
        if req.rid in self._reqs:
            raise ValueError(f"rid {req.rid} already submitted")
        self.validate(req)
        self._reqs[req.rid] = req
        self.tokens[req.rid] = []
        # keep pending sorted by (arrival, rid); mid-run submissions land
        # after the consumed prefix so past arrivals enqueue next round
        lo = self._pi
        while lo < len(self._pending) and \
                (self._pending[lo].arrival, self._pending[lo].rid) <= \
                (req.arrival, req.rid):
            lo += 1
        self._pending.insert(lo, req)
        return req

    def cancel(self, rid: int) -> bool:
        """Cancel a submitted request at a round boundary: its scheduler
        state (queue place or running set + adapter pin) and its engine
        slot and KV pages come back now. Partial tokens stay in
        ``tokens[rid]``; the request never gets a finish stamp. False if
        the rid is unknown or already terminal."""
        req = self._reqs.get(rid)
        if req is None or req.finish >= 0 or req.cancelled:
            return False
        where = self.sched.cancel(req, self.now)   # also sets req.cancelled
        if where is None:
            # still pending (a future arrival): drop it from the arrivals
            for i in range(self._pi, len(self._pending)):
                if self._pending[i].rid == rid:
                    del self._pending[i]
                    break
        for eng in self.engines.values():
            if eng.has_request(rid):
                eng.evict_request(rid)
                break
        return True

    # ------------------------- elastic control ------------------------- #
    def _n_admitting(self) -> int:
        return sum(1 for i in self._instances.values()
                   if i.alive and not i.draining)

    def _run_control(self, now: float) -> List[ScaleAction]:
        """One autoscaler tick (when due): its inputs from the scheduler,
        the pool, the store and the transport's rank telemetry; its actions
        applied at once, on the host, before the round's decode steps."""
        if self._scaler is None or not self._scaler.due(now):
            return []
        in_flight = sum(i.batch for i in self._instances.values()
                        if i.alive)
        mean_rank = None
        if self.transport is not None and self.ccfg.rank_aware:
            observed = self.transport.stats.mean_active_rank()
            mean_rank = observed if observed > 0 else None
        actions = self._scaler.control(
            now, in_flight=in_flight, queued=self.sched.queue_len(),
            cache_slots=self._cache_slots,
            n_instances=self._n_admitting(),
            n_replicas=self.server_pool.n_replicas
            if self.server_pool else 1,
            host_hit_rate=self.store.host_hit_rate()
            if self.store else None,
            miss_cost_ratio=self.store.miss_cost_ratio()
            if self.store else 1.0,
            mean_active_rank=mean_rank)
        for act in actions:
            self._apply_action(act, now)
        return actions

    def _apply_action(self, act: ScaleAction, now: float) -> None:
        pol = self._scaler.policy if self._scaler else AutoscalePolicy()
        if act.kind == "resize_cache":
            target = act.target
            if self.server_pool is not None:
                # the replicas' slot pools bound the cache (open() already
                # caps the policy at them)
                target = min(target, self.server_pool.total_slots)
            self._cache_slots = max(target, 1)
            for c in self._caches.values():
                c.resize(self._cache_slots, now)
            if self.server_pool is not None:
                # flush a shrink's evictions into the replicas' slot tables
                # now, not at the next admission: on a quiet stream the
                # freed adapters' weights would stay resident
                self._sync_pool()
        elif act.kind == "add_instance":
            while self._n_admitting() < min(act.target, pol.max_instances):
                self._add_instance(now)
        elif act.kind == "drain_instance":
            floor = max(act.target, pol.min_instances, 1)
            while self._n_admitting() > floor:
                cand = pick_drain_candidate(self._instances.values(),
                                            self.sched.queues)
                self.sched.drain_instance(cand.iid, now)
        elif act.kind in ("add_replica", "remove_replica"):
            if self.server_pool is None:
                return              # the coupled plane has no replicas
            if converge_replicas(self.server_pool, act.target):
                if self.server_pool.partitioned:
                    # the affinity map changed and each home's bound with
                    # it: evict any home's overflow before the sync
                    # mirrors residency into the replicas' slot tables
                    self._caches[-1].repartition(
                        self.server_pool.replica_for,
                        self.server_pool.partition_caps(), now)
                # re-home now: running requests' adapters must sit on their
                # new affinity replicas before the next decode step
                self._sync_pool()

    def _add_instance(self, now: float) -> int:
        iid = self._next_iid
        self._next_iid += 1
        inst = InstanceState(iid, self.ccfg.n_slots)
        self._instances[iid] = inst
        eng = self._new_engine()
        self.engines[iid] = eng
        cache = None if self.ccfg.disaggregated else self._mk_cache()
        pop = None
        if not self.ccfg.disaggregated and self._scaler is not None:
            pop = self._scaler.popularity(self.pool.n)
        self.sched.add_instance(
            inst, cache=cache, popularity=pop,
            kv_budget=eng.total_pages if self.ccfg.paged else None, now=now)
        return iid

    def _retire_drained(self) -> List[int]:
        """Remove drained-dry instances entirely: their engine releases its
        KV (and the fused transport forgets the engine's graphs), and the
        instance records leave the scheduler, so an elastic session that
        cycles capacity leaks neither memory nor per-round scans (iids are
        never reused)."""
        retired = []
        for iid, inst in self._instances.items():
            if (inst.draining and inst.alive and inst.batch == 0
                    and not self.engines[iid].active_rids()):
                inst.alive = False
                self.engines[iid].release_kv()
                retired.append(iid)
        for iid in retired:
            del self.engines[iid]
            del self._instances[iid]
            self.sched.instances.pop(iid, None)
            self.sched.queues.pop(iid, None)
            if self.sched.kv_pages is not None:
                self.sched.kv_pages.pop(iid, None)
            self._caches.pop(iid, None)
        return retired

    # ------------------------------------------------------------------ #
    def step_round(self) -> Dict:
        """Advance ONE global decode round: run the autoscaler's control
        loop (if attached), enqueue due arrivals, admit at the step
        boundary (least-loaded instance first), run one engine step per
        busy instance, retire finishers and drained-dry instances. Returns
        the round report: {"now", "step_end", "enqueued", "admitted",
        "tokens": {rid: tok}, "finished", "scale", "idle"}."""
        ccfg = self.ccfg
        now = self.now
        if self.store is not None:
            # land async-staged adapters at the round boundary, before any
            # sync of this round consumes them (main thread only)
            self.store.drain_prefetched()
        scale_actions = self._run_control(now)
        enqueued: List[Request] = []
        while self._pi < len(self._pending) and \
                self._pending[self._pi].arrival <= now:
            r = self._pending[self._pi]
            self._pi += 1
            if not r.cancelled:             # cancelled while still pending
                self.sched.enqueue(r, now)
                if self.store is not None and \
                        not self.server_pool.is_resident(r.adapter_id):
                    # start the real staging (disk read + CPU fusion) at
                    # arrival, overlapped with this round's decode; an
                    # adapter a server slot holds needs none
                    self.store.prefetch(r.adapter_id)
                    if self.tracer.enabled:
                        self.tracer.instant(
                            "store", f"prefetch a{r.adapter_id}", now,
                            rid=r.rid, adapter_id=r.adapter_id)
                if self._scaler is not None:
                    self._scaler.observe_arrival(now, r.adapter_id)
                enqueued.append(r)
        # admission at the step boundary, least-loaded instance first
        admitted_all: List[Request] = []
        for iid in sorted(self.engines,
                          key=lambda i: (self._instances[i].batch, i)):
            admitted = self.sched.admit(iid, now)
            if admitted and ccfg.disaggregated:
                self._sync_pool()
            for r in admitted:
                self.engines[iid].add_request(r.rid, self._prompt(r),
                                              r.adapter_id)
                if self.tracer.enabled and self.ccfg.paged:
                    self.tracer.instant(
                        "kv", f"kv.alloc r{r.rid}", now, rid=r.rid,
                        iid=iid, pages=self._need_by_rid.get(r.rid))
            admitted_all.extend(admitted)
        # one decode step per busy instance; requests admitted above are
        # already in the running batch (continuous batching)
        step_end = (self.rnd + 1) * ccfg.step_time
        busy = False
        round_tokens: Dict[int, int] = {}
        finished: List[Request] = []
        for iid in sorted(self.engines):
            eng = self.engines[iid]
            if not eng.active_rids():
                continue
            busy = True
            traced = self.tracer.enabled
            if traced:
                batch = len(eng.active_rids())
                w0 = wall_time()
            for rid, tok in eng.step().items():
                self.tokens[rid].append(tok)
                round_tokens[rid] = tok
            if traced:
                # span edges are the VIRTUAL round window; the measured
                # engine wall time rides along as an attribute
                self.tracer.span(
                    f"inst:{iid}", "decode.step", now, step_end,
                    batch=batch, wall_ms=(wall_time() - w0) * 1e3)
            for r in self.sched.step_complete(iid, step_end):
                eng.evict_request(r.rid)
                finished.append(r)
                if self._scaler is not None:
                    self._scaler.observe_finish(step_end,
                                                r.finish - r.arrival)
        self._retire_drained()
        self.rnd += 1
        if self.tracer.enabled:
            self.tracer.counter("sched", "queue_depth", step_end,
                                float(self.sched.queue_len()))
        idle = (not busy and self._pi >= len(self._pending)
                and self.sched.queue_len() == 0)
        return {"now": now, "step_end": step_end, "enqueued": enqueued,
                "admitted": admitted_all, "tokens": round_tokens,
                "finished": finished, "scale": scale_actions, "idle": idle}

    def idle(self) -> bool:
        """No running work, no queued work, no pending arrivals."""
        if self.sched is None:
            return True
        return (self._pi >= len(self._pending)
                and self.sched.queue_len() == 0
                and not any(eng.active_rids()
                            for eng in self.engines.values()))

    def cache_stats(self) -> Dict:
        """Device-tier counters per cache (-1 = the shared disagg cache)
        and the adapter store's host/disk tier counters."""
        return {"caches": {k: c.stats() for k, c in self._caches.items()},
                "store": self.store.stats() if self.store else {}}

    # --------------------- dynamic adapter lifecycle -------------------- #
    def load_adapter(self, adapter_id: int, tensors, *,
                     alpha: Optional[float] = None) -> int:
        """Register a new adapter mid-run (vLLM-style dynamic load): its
        shapes and rank are checked against the model config, then the id
        is targetable at once. Returns its rank. The disaggregated plane
        registers it in the adapter store; the coupled plane, which
        gathers from the static pool in-model, appends it to the pool
        (its id must be the pool's next, ``pool.n``) and routes it to the
        instance owning the fewest adapters."""
        if self.store is not None:
            return self.store.register(adapter_id, tensors, alpha=alpha)
        if int(adapter_id) != self.pool.n:
            raise ValueError(
                f"the coupled plane appends to its static pool: the next "
                f"adapter id is {self.pool.n}, not {adapter_id}")
        rank = validate_host_tensors(self.pool.cfg, tensors, self.pool.rank)
        if alpha is not None:
            tensors = rescale_alpha(tensors, alpha, rank, self.pool.scale)
        # a pool of the cluster's own: the caller's pool is left as it was
        pool = dataclasses.replace(self.pool, tensors={
            t: dict(ab) for t, ab in self.pool.tensors.items()})
        pool.append(tensors, rank)
        self.pool = pool
        for eng in self.engines.values():
            eng.pool = pool
        if self.sched is not None:
            self.sched.add_adapter(int(adapter_id))
        return rank

    def unload_adapter(self, adapter_id: int) -> None:
        """Remove an adapter from every tier. Refused while any submitted
        request still references it (queued, running or pinned)."""
        if self.store is None:
            raise ValueError(
                "dynamic adapter unload requires the disaggregated plane")
        if not self.store.has(adapter_id):
            raise ValueError(f"adapter {adapter_id} is not registered")
        for r in self._reqs.values():
            if r.adapter_id == adapter_id and r.finish < 0 \
                    and not r.cancelled:
                raise ValueError(
                    f"adapter {adapter_id} is in use by unfinished "
                    f"request {r.rid}")
        cache = self._caches.get(-1)
        if cache is not None:
            cache.invalidate(adapter_id)   # raises if somehow pinned
            # flush the eviction into the replica slot tables now, so the
            # fused transport's tables stop mapping this id before the
            # next decode step
            self._sync_pool()
        self.store.unregister(adapter_id)

    def close(self) -> None:
        """Tear down the adapter store (prefetch thread + owned tempdir)."""
        if self.store is not None:
            self.store.close()

    def kv_stats(self) -> Dict[int, Dict]:
        return {i: eng.kv_stats() for i, eng in self.engines.items()}

    def queue_depth(self) -> int:
        """Requests waiting for admission (0 before open())."""
        return self.sched.queue_len() if self.sched is not None else 0

    def transport_stats(self) -> Dict:
        """Launch accounting of the disaggregated transport (every engine
        bills the one shared transport). Empty on the coupled plane."""
        return self.transport.stats.as_dict() if self.transport else {}

    def scale_history(self) -> List[Dict]:
        """The autoscaler's per-control-tick record (empty when static)."""
        return list(self._scaler.history) if self._scaler else []

    # ------------------------------------------------------------------ #
    def run(self, requests: Sequence[Request]) -> Dict:
        """Serve ``requests`` to completion (or ``max_rounds``): returns
        {"tokens": {rid: [token, ...]}, "requests": ..., "rounds": n,
        "cache_stats": ...} (+ "kv_stats" when paged). The batch entry
        point, a loop over the session API; the caller's Request objects
        are not mutated (the runtime fields land on copies)."""
        requests = [copy.copy(r) for r in requests]
        self.open(requests)
        for r in requests:
            self.submit(r)
        while self.rnd < self.ccfg.max_rounds:
            if self.step_round()["idle"]:
                break
        unfinished = [r.rid for r in requests
                      if r.finish < 0 and not r.cancelled]
        if unfinished:
            raise RuntimeError(
                f"cluster run ended after {self.rnd} rounds with unfinished "
                f"requests {unfinished} (queue={self.sched.queue_len()}) — "
                f"adapter cache too small or max_rounds exhausted?")
        out = {"tokens": self.tokens, "requests": list(requests),
               "rounds": self.rnd, "cache_stats": self.cache_stats()}
        if self.ccfg.paged:
            out["kv_stats"] = self.kv_stats()
        if self._scaler is not None:
            out["scale_history"] = self.scale_history()
        return out

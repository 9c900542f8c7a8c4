"""Discrete-event cluster simulator for multi-LoRA serving, a copy of
``repro.serving.simulator`` over the port's control plane.

The control plane (scheduler, LoRA table, cache manager, placement,
provisioning) is the port's own code, the same the cluster runs; only the
data-plane step time comes from the analytic cost model, priced by default
with the nominal ``H100`` constants of ``core/cost_model.py`` (modelled
numbers, not measurements) — the same modeling the paper validates in
§6.3.2. It reproduces the paper's end-to-end quantities (P95 TTFT, TPOT,
throughput, SLO attainment) for both systems:

  coupled (S-LoRA)      : per-instance adapter cache, LoRA computed serially
                          on the instance after the base GEMMs
  disaggregated         : shared LoRA Server cache; per-layer
  (InfiniLoRA)            send->compute->recv overlapped with the base GEMM

Optimization flags map 1:1 to the paper's ablation (Fig. 14): +disagg,
+overlap, +loading (layer-wise pipelined), +kernel (hardware-specialized).

Fault tolerance: instance failure/recovery and straggler slowdown events;
failed instances requeue their in-flight work, recovery pays a weight-reload
delay, and straggler mitigation steers admission away from slow instances.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cost_model
from repro_torch.core.cost_model import H100, Hardware
from repro_torch.core.placement import Placement
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving.autoscaler import Autoscaler, AutoscalePolicy, \
    ScaleAction, converge_replicas, pick_drain_candidate
from repro_torch.serving.cache import LoRACache
from repro_torch.serving.scheduler import InstanceState, Scheduler, \
    assign_adapters_greedy
from repro_torch.serving.server_pool import ServerPool
from repro_torch.serving.workload import Request, zipf_popularity
from repro_torch.store import AnalyticStore


@dataclasses.dataclass
class SimConfig:
    n_instances: int = 4
    gpus_per_instance: int = 2
    max_batch: int = 128
    duration: float = 300.0
    # LoRA serving mode
    disaggregated: bool = False
    server_gpus: int = 0
    server_cache_slots: int = 64
    server_replicas: int = 1            # LoRA-Server replicas (ServerPool)
    placement_x: Optional[int] = None   # EP degree (default intra-node = 4)
    instance_cache_slots: int = 16      # coupled: per-instance slots
    # critical-path optimizations (paper Fig. 14 ablation)
    overlap: bool = True
    layerwise_loading: bool = True
    fast_kernels: bool = True
    # analytic efficiency penalty of generic (non-hardware-specialized) LoRA
    # kernels: without ``fast_kernels`` the server-side compute term is
    # stretched by this factor, calibrated so the "+kernel" ablation step
    # reproduces the Fig. 14 gap between cuBLAS-style batched GEMMs and the
    # paper's specialized kernels at the evaluation shapes. Promoted from a
    # hard-coded constant so ablations can sweep it.
    slow_kernel_eff_scale: float = 2.8
    protocol: str = "push"
    policy: str = "fcfs"                # or "sjf" (oracle)
    # hook transport plane (disaggregated only): "host" pays a per-launch
    # tail of 2 x n_layers + replicas CPU-initiated dispatches per decode
    # step; "fused" (one CUDA graph replay) pays ONE. hook_launch_us prices one
    # launch; 0 (default) keeps the legacy calibration where launch cost
    # was folded into step_overhead — transport benches sweep it.
    transport: str = "host"
    hook_launch_us: float = 0.0
    # environment
    hw: Hardware = H100
    lora_rank: Optional[int] = None
    zipf_s: float = 1.2
    n_adapters: int = 512
    step_overhead: float = 0.004        # s, per decode step (launch+sync)
    # fault tolerance
    failures: Tuple[Tuple[float, int], ...] = ()      # (time, iid)
    recoveries: Tuple[Tuple[float, int], ...] = ()    # (time, iid)
    stragglers: Tuple[Tuple[float, int, float], ...] = ()  # (t, iid, factor)
    straggler_mitigation: bool = True
    # elastic provisioning: run Algorithm 1 online at event boundaries
    autoscale: Optional[AutoscalePolicy] = None
    # hierarchical adapter store (disaggregated only): host-RAM tier byte
    # budget (None = unbounded = every adapter host-resident, the legacy
    # one-tier model). Disk reads price at ``hw.disk_bw``.
    store_host_bytes: Optional[int] = None
    # scheduler prefetch hints; None follows layerwise_loading (the legacy
    # coupling of the two knobs)
    prefetch: Optional[bool] = None
    # rank-aware compute pricing: per-adapter TRUE ranks (None = every
    # adapter at the pool rank) and whether the hook-FLOP terms price the
    # batch's mean effective rank instead of the padded pool rank —
    # the analytic twin of the cluster plane's rank-bounded kernels
    adapter_ranks: Optional[Tuple[int, ...]] = None
    rank_aware: bool = True

    @property
    def prefetch_on(self) -> bool:
        return self.layerwise_loading if self.prefetch is None \
            else self.prefetch


# ----------------------------- step model ------------------------------- #
def base_step_seconds(cfg: ModelConfig, batch: int, p: int, ctx: float,
                      hw: Hardware, overhead: float) -> float:
    """One decode step of the base model on a p-chip instance (memory-bound:
    weights actually touched + KV read; MoE reads only activated experts)."""
    total = cfg.param_count()
    if cfg.is_moe:
        n_mats = 3 if cfg.gated_mlp else 2
        expert_total = cfg.n_layers * cfg.n_experts * n_mats * \
            cfg.d_model * cfg.d_ff
        frac = min(batch * cfg.top_k, cfg.n_experts) / cfg.n_experts
        w_bytes = 2 * (total - expert_total) + 2 * frac * expert_total
    else:
        w_bytes = 2 * total
    kv_per_tok = (2 * cfg.n_kv_heads * cfg.head_dim * 2 *
                  (cfg.n_layers if not cfg.is_ssm else 0))
    kv_bytes = batch * ctx * kv_per_tok
    t_mem = (w_bytes + kv_bytes) / (hw.hbm_bw * p)
    t_flops = 2 * cfg.active_param_count() * batch / (hw.flops * 0.5 * p)
    return max(t_mem, t_flops) + overhead


def coupled_lora_seconds(cfg: ModelConfig, batch: int, p: int,
                         distinct: float, rank: int, hw: Hardware,
                         fast_kernels: bool) -> float:
    """S-LoRA: LoRA kernels run serially on the instance, all layers."""
    eff = 0.7 if fast_kernels else 0.25
    rows = batch * max(cfg.top_k, 1) / p
    per_layer = cost_model.lora_compute_seconds(
        cfg, rows, distinct * max(cfg.n_experts, 1) / p, rank, hw,
        kernel_eff=eff)
    return per_layer * cfg.n_layers


def disagg_stall_seconds(cfg: ModelConfig, placement: Placement, batch: int,
                         p: int, n_instances: int, distinct: float,
                         rank: int, hw: Hardware, overlap: bool,
                         fast_kernels: bool, protocol: str,
                         eff_scale_slow: float = 2.8,
                         n_server_replicas: int = 1) -> float:
    """Non-hidden LoRA time per step under disaggregation.

    ``eff_scale_slow`` is ``SimConfig.slow_kernel_eff_scale`` (generic-
    kernel penalty); ``n_server_replicas`` divides the shared-server
    capacity term — replicas partition the adapter set by affinity
    (``ServerPool``), so each serves 1/R of the hook traffic."""
    eff_scale = 1.0 if fast_kernels else eff_scale_slow
    lat = cost_model.latency_breakdown(cfg, placement, batch, p, distinct,
                                       rank=rank, hw=hw, protocol=protocol)
    roundtrip = lat["recv"] + lat["comp"] * eff_scale + lat["send"]
    gemm = cost_model.base_moe_gemm_seconds(cfg, batch, p, hw)
    hidden = gemm if overlap else 0.0
    stall = max(roundtrip - hidden, 0.0)
    # shared-server capacity (paper Eq. 6): the pipeline must serve all L
    # instances within one layer window; when oversubscribed the steady
    # state stretches each layer to the server's service time.
    bottleneck = max(lat["recv"], lat["comp"] * eff_scale, lat["send"])
    layer_base = base_step_seconds(cfg, batch, p, 0, hw, 0) / max(
        cfg.n_layers, 1)
    capacity = max(placement.y, 1) * max(n_server_replicas, 1)
    layer_eff = max(layer_base + stall,
                    n_instances * bottleneck / capacity)
    return (layer_eff - layer_base) * cfg.n_layers


# ------------------------------ simulator ------------------------------- #
class Simulation:
    """Steppable discrete-event simulation with a request lifecycle.

    The front door (``serving/api.py``) drives this incrementally:
    ``submit`` requests (before or during the run), ``cancel`` them
    mid-flight, and ``step`` one event at a time — each step returns the
    lifecycle events it produced as ``(time, rid, kind)`` tuples with kind
    in {"queued", "prefill", "token", "finished", "cancelled"}, so both
    execution planes (this analytic one and the real cluster driver) are
    observationally identical to ``metrics.summarize`` and to streaming
    consumers. ``simulate`` below is the legacy batch wrapper."""

    def __init__(self, cfg: ModelConfig, sim: SimConfig,
                 server_pool: Optional[ServerPool] = None,
                 tracer: Optional[Tracer] = None):
        self.cfg = cfg
        self.sim = sim
        # span tracer (obs/): timestamps are this plane's virtual
        # event-heap clock. NULL_TRACER = record nothing.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if sim.transport not in ("host", "fused"):
            raise ValueError(f"unknown transport {sim.transport!r} "
                             f"(expected 'host' or 'fused')")
        self.rank = sim.lora_rank or cfg.lora_rank
        self._adapter_bytes = cfg.lora_adapter_bytes(self.rank)
        # per-adapter true ranks (clamped into [1, pool rank]); uniform
        # pools price every adapter at the padded pool rank
        if sim.adapter_ranks is not None:
            ranks = np.asarray(sim.adapter_ranks, np.int64)
            if ranks.shape != (sim.n_adapters,):
                raise ValueError(
                    f"adapter_ranks must have one entry per adapter "
                    f"({sim.n_adapters}), got shape {ranks.shape}")
            self.adapter_ranks = np.clip(ranks, 1, self.rank)
        else:
            self.adapter_ranks = np.full(sim.n_adapters, self.rank,
                                         np.int64)
        # effective-rank telemetry (mirrors TransportStats.observe_ranks)
        self._rank_rows = 0
        self._rank_sum = 0
        self._max_rank = 0
        # analytic host/disk tier accounting (disaggregated only): prices
        # each cache miss by where the adapter lives, mirroring the cluster
        # plane's AdapterStore without tensors, files, or threads
        self.store: Optional[AnalyticStore] = None
        if sim.disaggregated:
            # tier bytes are TRUE-RANK bytes (the cluster plane's store
            # trims the rank tail before any host/disk transfer); device
            # cache slots stay pool-rank padded in _mk_cache
            self.store = AnalyticStore(
                lambda aid: cfg.lora_adapter_bytes(
                    int(self.adapter_ranks[aid]))
                if 0 <= aid < sim.n_adapters else self._adapter_bytes,
                sim.n_adapters,
                host_bytes=sim.store_host_bytes,
                host_bw=sim.hw.host_bw, disk_bw=sim.hw.disk_bw)
        pop = zipf_popularity(sim.n_adapters, sim.zipf_s)
        self.instances = [InstanceState(i, sim.max_batch)
                          for i in range(sim.n_instances)]
        self._cache_slots = sim.server_cache_slots if sim.disaggregated \
            else sim.instance_cache_slots
        if sim.disaggregated:
            self.caches = {-1: self._mk_cache()}
            self.owner = None
            self.placement = Placement.make(
                "hybrid", max(sim.server_gpus, 1), sim.n_adapters,
                cfg.n_layers, max(cfg.n_experts, 1), x=sim.placement_x)
            # the analytic replica pool: slot tables only; the step model
            # prices its capacity via n_server_replicas in the stall term
            self.server_pool = server_pool or ServerPool.analytic(
                max(sim.server_replicas, 1), sim.server_cache_slots)
        else:
            self.caches = {i: self._mk_cache()
                           for i in range(sim.n_instances)}
            self.owner = assign_adapters_greedy(sim.n_adapters, pop,
                                                sim.n_instances)
            self.placement = None
            self.server_pool = None
        self.sched = Scheduler(self.instances, self.caches, self.owner,
                               policy=sim.policy,
                               shared_cache=sim.disaggregated)
        self._scaler: Optional[Autoscaler] = None
        if sim.autoscale is not None:
            self._scaler = Autoscaler(
                sim.autoscale, cfg, max_batch=sim.max_batch,
                gpus_per_instance=sim.gpus_per_instance, hw=sim.hw,
                has_server=sim.disaggregated,
                transport=sim.transport,
                hook_launch_us=sim.hook_launch_us)
        self._control_pending = False
        # event queue: (time, seq, kind, payload)
        self._ev: List[Tuple[float, int, str, object]] = []
        self._seq = 0
        self.now = 0.0
        self.requests: List[Request] = []
        self._by_rid: Dict[int, Request] = {}
        self.batch_log: List[Tuple[float, int]] = []
        self.active_log: List[Tuple[float, int]] = []
        self.scale_log: List[Tuple[float, str, int]] = []
        self.n_decode_steps = 0         # feeds modeled transport_stats()
        self._modeled_dispatches = 0    # accumulated at each step with the
        #                                 replica count in effect THEN
        self._stepping = {i.iid: False for i in self.instances}
        self._out: List[Tuple[float, int, str]] = []   # current-step events
        self._retry_at: Dict[int, Optional[float]] = \
            {i.iid: None for i in self.instances}
        self._halted = False
        # fault events are pushed lazily on the first step so a batch
        # wrapper's arrivals keep their legacy heap tie-break priority
        self._faults_pushed = False

    def _mk_cache(self) -> LoRACache:
        return LoRACache(self._cache_slots, self._adapter_bytes,
                         self.cfg.n_layers, self.sim.hw.host_bw,
                         layerwise=self.sim.layerwise_loading,
                         prefetch=self.sim.prefetch_on,
                         load_seconds_fn=self.store.load_seconds
                         if self.store is not None else None,
                         tracer=self.tracer)

    # -------------------------- client surface ------------------------- #
    def submit(self, req: Request) -> Request:
        if req.rid in self._by_rid:
            raise ValueError(f"rid {req.rid} already submitted")
        if self.store is not None:
            # dynamic universe: any id the store currently knows is legal
            if not self.store.has(req.adapter_id):
                raise ValueError(
                    f"request {req.rid}: adapter_id {req.adapter_id} is "
                    f"not registered in the adapter store")
        elif not 0 <= req.adapter_id < self.sim.n_adapters:
            # coupled mode would IndexError on the owner lookup mid-run (or
            # silently wrap a negative id); match the cluster plane's
            # up-front rejection
            raise ValueError(
                f"request {req.rid}: adapter_id {req.adapter_id} outside "
                f"{self.sim.n_adapters} adapters")
        self.requests.append(req)
        self._by_rid[req.rid] = req
        # a mid-run submit with a past arrival must not rewind virtual time
        # (events would be stamped before ones already processed); it joins
        # NOW, keeping its arrival stamp for TTFT — same as the cluster
        # plane, which enqueues past arrivals at the next round boundary
        self._push(max(req.arrival, self.now), "arrive", req)
        return req

    def cancel(self, rid: int, at: Optional[float] = None) -> bool:
        """Schedule a cancellation at virtual time ``at`` (>= now). The
        request is released when the event fires: dropped from its queue or
        running set, its adapter pin freed, never counted finished."""
        if rid not in self._by_rid:
            return False
        self._push(max(at if at is not None else self.now, self.now),
                   "cancel", rid)
        return True

    def load_adapter(self, adapter_id: int) -> None:
        """Register a new adapter id mid-run (analytic twin of the cluster
        plane's dynamic load — no tensors to validate here). Disaggregated
        only: the coupled plane's owner map is sized at startup."""
        if self.store is None:
            raise ValueError(
                "dynamic adapter load requires the disaggregated plane "
                "(the coupled owner map is frozen at startup)")
        if self.store.has(adapter_id):
            raise ValueError(f"adapter {adapter_id} is already registered")
        self.store.register(adapter_id)

    def unload_adapter(self, adapter_id: int) -> None:
        """Remove an adapter. Refused while any submitted request still
        references it (queued, running, or pinned)."""
        if self.store is None:
            raise ValueError(
                "dynamic adapter unload requires the disaggregated plane")
        if not self.store.has(adapter_id):
            raise ValueError(f"adapter {adapter_id} is not registered")
        for r in self.requests:
            if r.adapter_id == adapter_id and r.finish < 0 \
                    and not r.cancelled:
                raise ValueError(
                    f"adapter {adapter_id} is in use by unfinished "
                    f"request {r.rid}")
        cache = self.caches.get(-1)
        if cache is not None:
            cache.invalidate(adapter_id)   # raises if somehow pinned
            self.server_pool.sync(cache)   # flush out of replica tables
        self.store.unregister(adapter_id)

    def idle(self) -> bool:
        return self._halted or not self._ev

    def step(self) -> List[Tuple[float, int, str]]:
        """Process ONE event; returns the lifecycle events it emitted."""
        if not self._faults_pushed:
            self._faults_pushed = True
            for t, iid in self.sim.failures:
                self._push(t, "fail", iid)
            for t, iid in self.sim.recoveries:
                self._push(t, "recover", iid)
            for t, iid, f in self.sim.stragglers:
                self._push(t, "slow", (iid, f))
            self._arm_control(self.now)
        if self.idle():
            return []
        self._out = []
        now, _, kind, payload = heapq.heappop(self._ev)
        if now > self.sim.duration * 4:
            self._halted = True     # runaway queue: stop expanding events
            return []
        self.now = now
        self._handle(kind, payload, now)
        return self._out

    def run(self) -> None:
        while not self.idle():
            self.step()

    def _dispatches_per_step(self) -> int:
        """Modeled host launches of ONE decode step at the CURRENT replica
        count: 2L hook calls x engaged replicas + 3 overhead launches
        ("host", the measured ledger's upper bound) or 1 ("fused").
        Coupled mode has no hook transport — 0."""
        if not self.sim.disaggregated:
            return 0
        if self.sim.transport == "fused":
            return 1
        return 2 * self.cfg.n_layers * self.server_pool.n_replicas + 3

    def queue_depth(self) -> int:
        """Requests waiting for admission."""
        return self.sched.queue_len()

    def transport_stats(self) -> Dict:
        """Modeled launch accounting, observationally matching the cluster
        plane's measured ``TransportStats.as_dict()`` keys. Dispatches are
        accumulated per step with the replica count in effect THEN, so the
        ledger stays consistent with the step-time model under mid-run
        replica scaling; LUT uploads are the pool's non-noop residency
        syncs."""
        sim = self.sim
        if not sim.disaggregated:
            return {}
        uploads = 0 if sim.transport == "host" else \
            self.server_pool.sync_rounds - self.server_pool.sync_noops
        mean_rank = self._rank_sum / self._rank_rows \
            if self._rank_rows else 0.0
        savings = 1.0 - mean_rank / self.rank \
            if self._rank_rows and self.rank else 0.0
        return {
            "transport": sim.transport,
            "steps": self.n_decode_steps,
            "host_dispatches": self._modeled_dispatches,
            "device_programs": self._modeled_dispatches,
            "hook_dispatches": (2 * self.cfg.n_layers * self.n_decode_steps
                                if sim.transport == "host" else 0),
            "lut_uploads": uploads,
            "host_dispatches_per_step": round(
                self._modeled_dispatches / max(self.n_decode_steps, 1), 3),
            "mean_active_rank": round(mean_rank, 3),
            "max_active_rank": self._max_rank,
            "rank_flop_savings": round(savings, 4),
        }

    def result(self) -> Dict:
        return {
            "requests": list(self.requests),
            "batch_log": self.batch_log,
            "active_adapters_log": self.active_log,
            "scale_log": list(self.scale_log),
            "cache_stats": {
                "caches": {k: c.stats() for k, c in self.caches.items()},
                "store": self.store.stats() if self.store else {},
            },
        }

    # ----------------------------- internals --------------------------- #
    def _push(self, t, kind, payload=None):
        heapq.heappush(self._ev, (t, self._seq, kind, payload))
        self._seq += 1

    def _emit(self, t: float, rid: int, kind: str):
        self._out.append((t, rid, kind))

    def _distinct_adapters(self, inst: InstanceState) -> float:
        return max(len({r.adapter_id for r in inst.running}), 1)

    def _adapter_rank(self, aid: int) -> int:
        """TRUE rank of one adapter (pool rank for out-of-universe ids
        registered mid-run through load_adapter)."""
        if 0 <= aid < self.sim.n_adapters:
            return int(self.adapter_ranks[aid])
        return self.rank

    def _effective_rank(self, inst: InstanceState) -> float:
        """The rank the hook-FLOP terms pay for this batch: the mean TRUE
        rank over running rows when rank-aware (the segmented kernels
        bound each row's contraction at its adapter's rank), the padded
        pool rank otherwise."""
        if not self.sim.rank_aware or not inst.running:
            return float(self.rank)
        return float(np.mean([self._adapter_rank(r.adapter_id)
                              for r in inst.running]))

    def _step_seconds(self, inst: InstanceState) -> float:
        cfg, sim = self.cfg, self.sim
        b = inst.batch
        ctx = float(np.mean([r.prompt_len + r.tokens_done
                             for r in inst.running])) if b else 0.0
        t = base_step_seconds(cfg, b, sim.gpus_per_instance, ctx, sim.hw,
                              sim.step_overhead)
        dist = self._distinct_adapters(inst)
        eff_rank = self._effective_rank(inst)
        if sim.disaggregated:
            live = sum(1 for i in self.instances if i.alive)
            t += disagg_stall_seconds(
                cfg, self.placement, b, sim.gpus_per_instance,
                max(live, 1), dist, eff_rank, sim.hw, sim.overlap,
                sim.fast_kernels, sim.protocol,
                eff_scale_slow=sim.slow_kernel_eff_scale,
                n_server_replicas=self.server_pool.n_replicas)
            t += cost_model.transport_dispatch_seconds(
                cfg.n_layers, self.server_pool.n_replicas, sim.transport,
                sim.hook_launch_us)
        else:
            t += coupled_lora_seconds(cfg, b, sim.gpus_per_instance, dist,
                                      eff_rank, sim.hw, sim.fast_kernels)
        return t * inst.slowdown

    def _kick(self, iid: int, now: float):
        inst = self.sched.instances.get(iid)
        if inst is None:            # retired: a stale kick event fired
            return
        if self._stepping[iid] or not inst.alive:
            return
        admitted = self.sched.admit(iid, now)
        if admitted and self.server_pool is not None:
            # delta-based per-replica residency sync (same invariant as the
            # cluster plane: an admitted adapter sits on its home replica)
            self.server_pool.sync(self.caches[-1])
        for r in admitted:
            self._emit(now, r.rid, "prefill")
        if inst.batch == 0:
            if inst.draining:
                self._retire(inst)      # drained dry
                return
            self._schedule_load_retry(iid, now)
            return
        self._stepping[iid] = True
        if self.tracer.enabled:
            self.tracer.begin(f"inst:{iid}", "decode.step", now,
                              batch=inst.batch)
        self._push(now + self._step_seconds(inst), "step_end", iid)

    def _schedule_load_retry(self, iid: int, now: float):
        """An IDLE instance whose queued work is waiting only on adapter
        loads has no future step_end to re-kick it; without a wake-up at
        the load-completion time that work strands in QUEUED forever (only
        visible through the per-request API — batch workloads re-kick via
        later arrivals)."""
        cache = self.sched.cache_for(iid)
        q_key = -1 if self.sched.shared_cache else iid
        times = []
        for r in self.sched.queues[q_key]:
            if r.arrival > now:
                continue
            res = cache.resident.get(r.adapter_id)
            if res is None:
                continue
            t = res.first_ready if cache.layerwise else res.full_ready
            if t > now:
                times.append(t)
        if not times:
            return
        t = min(times)
        pend = self._retry_at.get(iid)
        if pend is not None and pend <= t:
            return          # an earlier wake-up is already scheduled
        self._retry_at[iid] = t
        self._push(t, "kick", iid)

    def _pick_instance(self, now: float) -> Optional[int]:
        """Disaggregated: least-loaded admitting instance (straggler- and
        drain-aware)."""
        alive = [i for i in self.instances if i.alive and not i.draining]
        if not alive:
            return None
        if self.sim.straggler_mitigation:
            fastest = min(i.slowdown for i in alive)
            pref = [i for i in alive if i.slowdown <= 2 * fastest]
            alive = pref or alive
        return min(alive, key=lambda i: (i.batch, i.slowdown)).iid

    # ------------------------- elastic control ------------------------- #
    def _arm_control(self, now: float):
        """Schedule the next autoscaler tick (idempotent)."""
        if self._scaler is None or self._control_pending:
            return
        self._control_pending = True
        self._push(now + self._scaler.policy.control_interval,
                   "control", None)

    def _admitting(self) -> List[InstanceState]:
        return [i for i in self.instances if i.alive and not i.draining]

    def _retire(self, inst: InstanceState):
        """Remove a drained-dry instance entirely (see Cluster's twin):
        elastic sessions cycle capacity, and dead entries would leak scan
        work in every step_end kick loop. ``_stepping``/``_retry_at`` keep
        tombstones — they mint the next fresh iid."""
        inst.alive = False
        if inst in self.instances:
            self.instances.remove(inst)
        self.sched.instances.pop(inst.iid, None)
        self.sched.queues.pop(inst.iid, None)
        self.caches.pop(inst.iid, None)

    def _do_control(self, now: float):
        in_flight = sum(i.batch for i in self.instances if i.alive)
        mean_rank = None
        if self.sim.disaggregated and self.sim.rank_aware \
                and self._rank_rows:
            mean_rank = self._rank_sum / self._rank_rows
        actions = self._scaler.control(
            now, in_flight=in_flight, queued=self.sched.queue_len(),
            cache_slots=self._cache_slots,
            n_instances=len(self._admitting()),
            n_replicas=self.server_pool.n_replicas
            if self.server_pool else 1,
            host_hit_rate=self.store.host_hit_rate()
            if self.store else None,
            miss_cost_ratio=self.store.miss_cost_ratio()
            if self.store else 1.0,
            mean_active_rank=mean_rank)
        for act in actions:
            self._apply_action(act, now)
            self.scale_log.append((now, act.kind, act.target))
            self._emit(now, -1, f"scale:{act.kind}")

    def _apply_action(self, act: ScaleAction, now: float):
        sim, pol = self.sim, self._scaler.policy
        if act.kind == "resize_cache":
            self._cache_slots = max(act.target, 1)
            for c in self.caches.values():
                c.resize(self._cache_slots, now)
            if self.server_pool is not None:
                self.server_pool.resize_slots(self._cache_slots)
                self.server_pool.sync(self.caches[-1])  # flush evictions
        elif act.kind == "add_instance":
            while len(self._admitting()) < min(act.target,
                                               pol.max_instances):
                iid = max(self._stepping) + 1
                inst = InstanceState(iid, sim.max_batch)
                self.instances.append(inst)
                self._stepping[iid] = False
                self._retry_at[iid] = None
                cache = pop = None
                if not sim.disaggregated:
                    cache = self._mk_cache()
                    pop = self._scaler.popularity(sim.n_adapters)
                self.sched.add_instance(inst, cache=cache, popularity=pop,
                                        now=now)
                self._kick(iid, now)
        elif act.kind == "drain_instance":
            floor = max(act.target, pol.min_instances, 1)
            while len(self._admitting()) > floor:
                cand = pick_drain_candidate(self.instances,
                                            self.sched.queues)
                self.sched.drain_instance(cand.iid, now)
                if cand.batch == 0:
                    self._retire(cand)      # nothing in flight
                elif not self._stepping[cand.iid]:
                    self._kick(cand.iid, now)   # finish the in-flight work
        elif act.kind in ("add_replica", "remove_replica"):
            if self.server_pool is None:
                return                      # coupled plane has no replicas
            if converge_replicas(self.server_pool, act.target):
                self.server_pool.sync(self.caches[-1])  # full re-route

    def _handle(self, kind: str, payload, now: float):
        sim, sched = self.sim, self.sched
        if kind == "arrive":
            if payload.cancelled:       # cancelled before it ever arrived
                return
            if self.store is not None and self.sim.prefetch_on:
                # start the async disk->host staging BEFORE the enqueue
                # hint can promote the adapter: by the time the request
                # clears the queue, the disk leg is (partly) done
                self.store.prefetch(payload.adapter_id, now)
                if self.tracer.enabled:
                    self.tracer.instant(
                        "store", f"prefetch a{payload.adapter_id}", now,
                        rid=payload.rid, adapter_id=payload.adapter_id)
            sched.enqueue(payload, now)
            if self._scaler is not None:
                self._scaler.observe_arrival(now, payload.adapter_id)
                self._arm_control(now)
            self._emit(now, payload.rid, "queued")
            if sim.disaggregated:
                iid = self._pick_instance(now)
                if iid is not None:
                    self._kick(iid, now)
            else:
                self._kick(int(self.owner[payload.adapter_id]), now)
        elif kind == "control":
            self._control_pending = False
            self._do_control(now)
            if any(r.finish < 0 and not r.cancelled for r in self.requests):
                self._arm_control(now)
            # freshly added instances may be able to pull queued work
            for inst in self._admitting():
                if not self._stepping[inst.iid]:
                    self._kick(inst.iid, now)
        elif kind == "cancel":
            req = self._by_rid[payload]
            if req.finish >= 0 or req.cancelled:
                return                  # finished first / double cancel
            sched.cancel(req, now)      # also sets req.cancelled
            self._emit(now, req.rid, "cancelled")
        elif kind == "fail":
            if payload in sched.instances:      # retired: nothing to fail
                sched.requeue_instance(payload, now)
        elif kind == "recover":
            reload_t = 2 * self.cfg.param_count() / sim.hw.host_bw
            self._push(now + reload_t, "recovered", payload)
        elif kind == "recovered":
            if payload in sched.instances:
                sched.instances[payload].alive = True
                self._kick(payload, now)
        elif kind == "slow":
            iid, f = payload
            if iid in sched.instances:
                sched.instances[iid].slowdown = f
        elif kind == "kick":
            self._retry_at[payload] = None
            self._kick(payload, now)
        elif kind == "step_end":
            iid = payload
            inst = sched.instances.get(iid)
            self._stepping[iid] = False
            if self.tracer.enabled:
                self.tracer.end(f"inst:{iid}", "decode.step", now)
                self.tracer.counter("sched", "queue_depth", now,
                                    float(sched.queue_len()))
            if inst is None:                    # retired mid-event
                return
            if not inst.alive:
                return
            stepped = list(inst.running)    # every running row earns a token
            self.n_decode_steps += 1
            self._modeled_dispatches += self._dispatches_per_step()
            if sim.disaggregated and stepped:
                # bill every active row at the rank the hook compute pays
                # (mirrors TransportStats.observe_ranks on the real plane)
                paid = [self._adapter_rank(r.adapter_id)
                        if sim.rank_aware else self.rank for r in stepped]
                self._rank_rows += len(paid)
                self._rank_sum += int(sum(paid))
                self._max_rank = max(self._max_rank, max(paid))
            finished = sched.step_complete(iid, now)
            for r in stepped:
                self._emit(now, r.rid, "token")
            for r in finished:
                self._emit(now, r.rid, "finished")
                if self._scaler is not None:
                    self._scaler.observe_finish(now, r.finish - r.arrival)
            self.batch_log.append((now, inst.batch))
            if sim.disaggregated:
                self.active_log.append((now, self.caches[-1].active_count()))
            self._kick(iid, now)
            # idle instances may now be able to pull queued work (iterate a
            # copy: a kick can retire a drained-dry instance mid-loop)
            for other in list(self.instances):
                if other.iid != iid and not self._stepping[other.iid]:
                    self._kick(other.iid, now)


def simulate(cfg: ModelConfig, requests: Sequence[Request],
             sim: SimConfig) -> Dict:
    """Legacy batch entrypoint: run ``requests`` through a ``Simulation``
    to completion and return the result dict (kept for existing callers;
    new code goes through ``serving/api.py``)."""
    s = Simulation(cfg, sim)
    for r in requests:
        s.submit(r)
    s.run()
    return s.result()

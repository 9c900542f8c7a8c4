"""The serving front door of the port: ``ServeConfig`` -> ``Backend`` ->
``RequestHandle``, the counterpart of ``repro.serving.api`` over both of
its planes, the analytic simulator and the slot-engine ``Cluster``:

    ServeConfig ──> build_system(cfg, model, ...) ──> ServeSystem
                                                          │ submit()
                                                          ▼
                  Backend (protocol)                 RequestHandle
                  ├── SimBackend    (analytic plane) states, tokens,
                  └── ClusterBackend (the engines)   cancel(), iter()

Request lifecycle (``metrics.summarize`` reads the same fields):

    QUEUED ──> PREFILLING ──> DECODING ──> FINISHED
      │             │             │
      └──────────── ┴──── cancel()┴──────> CANCELLED
    submit() that violates the admission contract ───> REJECTED

Streaming: every decoded token reaches the handle the round it is made,
through ``handle.on_token(cb)`` or ``for tok in handle`` (the iterator
pumps the system). The analytic plane emits token events with
``token=None``: it models time, not token ids. Cancellation
(``handle.cancel()``) takes effect at the next round or event boundary:
the decode slot, the KV pages and the scheduler's adapter pin come back at
once, and the request never counts as finished.

Time is virtual on both planes: the cluster's ``step_time`` a round (so
its TTFT and TPOT are in rounds, as in the reference), the simulator's
event clock priced by the cost model (``hw``, a nominal H100 by default:
modelled seconds, not measurements). ``autoscale`` runs Algorithm 1
online on either plane; its actions surface as ``scale:<kind>`` events
(``rid=-1``) and in ``scale_history()``.

``mesh_shape`` = (data, model) (cluster backend, disaggregated plane) runs
the base expert GEMMs expert-parallel over a grid of devices, with the
server replicas' slot tables partitioned; the tokens are those without a
mesh, bit for bit.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Callable, Dict, Iterator, List, Optional, Protocol, \
    Sequence, Tuple

from repro_torch.core.cost_model import H100, Hardware
from repro_torch.launch.mesh import check_mesh_shape
from repro_torch.obs.hub import Observability, ObservabilityHub
from repro_torch.obs.trace import NULL_TRACER, TimelineTracer
from repro_torch.serving import metrics
from repro_torch.serving.autoscaler import Autoscaler, AutoscalePolicy, \
    ScaleAction
from repro_torch.serving.cluster import Cluster, ClusterConfig
from repro_torch.serving.engine import EngineConfig, check_family
from repro_torch.serving.metrics import Summary
from repro_torch.serving.server_pool import ServerPool
from repro_torch.serving.simulator import SimConfig, Simulation
from repro_torch.serving.workload import Request

__all__ = [
    "ServeConfig", "Backend", "SimBackend", "ClusterBackend", "ServeSystem",
    "RequestHandle", "RequestState", "Event", "SLOClass", "INTERACTIVE",
    "BATCH", "TERMINAL_STATES", "build_system", "Request", "Summary",
    "AutoscalePolicy", "Autoscaler", "ScaleAction", "Observability",
]


# --------------------------- request lifecycle --------------------------- #
class RequestState(enum.Enum):
    """Lifecycle state of one submitted request: QUEUED -> PREFILLING ->
    DECODING -> FINISHED, with CANCELLED reachable from any live state and
    REJECTED terminal at submit()."""
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    REJECTED = "rejected"


TERMINAL_STATES = frozenset({RequestState.FINISHED, RequestState.CANCELLED,
                             RequestState.REJECTED})


@dataclasses.dataclass(frozen=True)
class Event:
    """One observable lifecycle step, the same on both planes. Scaling
    events have ``rid=-1`` and ``kind="scale:<action>"``."""
    time: float
    rid: int
    kind: str                    # queued|prefill|token|finished|cancelled
    #                              |scale:<action> (autoscaler, rid=-1)
    token: Optional[int] = None  # token id (cluster) / None (sim)
    detail: Optional[str] = None  # scale events: the autoscaler's reason


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """Per-request latency class (paper §6.1 SLOs are the default)."""
    name: str
    ttft_slo: float
    tpot_slo: float


INTERACTIVE = SLOClass("interactive", metrics.TTFT_SLO, metrics.TPOT_SLO)
BATCH = SLOClass("batch", 4 * metrics.TTFT_SLO, 4 * metrics.TPOT_SLO)


# ------------------------------ ServeConfig ------------------------------ #
@dataclasses.dataclass
class ServeConfig:
    """The one serving config: derives ``EngineConfig``, ``ClusterConfig``
    and ``SimConfig`` (the reference's names and defaults, except ``hw``:
    a nominal H100)."""
    # execution plane: "cluster" (the port's engines) | "sim" (analytic)
    backend: str = "cluster"
    disaggregated: bool = False
    # disaggregated hook transport: "host" = per-hook host dispatch
    # (2 x n_layers a decode step), "fused" = one CUDA graph a decode step;
    # the token streams are bit-identical across both
    transport: str = "host"
    # capacity
    n_instances: int = 1
    max_batch: int = 4              # decode slots per instance
    max_len: int = 64               # KV rows per slot
    adapter_cache_slots: int = 8    # per instance (coupled) / shared (disagg)
    policy: str = "fcfs"            # or "sjf" (oracle output lengths)
    # KV layout
    paged: bool = False
    page_size: int = 8
    n_pages: Optional[int] = None
    prefill_chunk: int = 16
    # timing / adapter loading
    step_time: float = 1.0          # virtual seconds per round
    host_bw: float = float("inf")   # adapter load bandwidth
    layerwise_loading: bool = True
    max_rounds: int = 100_000
    # hierarchical adapter store (disaggregated only): host-RAM tier byte
    # budget (None = unbounded), disk-tier directory (None = a private
    # tempdir made on the first spill), disk read bandwidth for pricing
    store_host_bytes: Optional[int] = None
    store_dir: Optional[str] = None
    disk_bw: float = 5e9
    # async prefetch staging + scheduler prefetch hints at arrival; None
    # follows layerwise_loading
    prefetch: Optional[bool] = None
    # elastic provisioning (both planes): LoRA-Server replicas at start,
    # and the online Algorithm-1 control loop when ``autoscale`` carries an
    # AutoscalePolicy (None = static provisioning)
    server_replicas: int = 1
    autoscale: Optional[AutoscalePolicy] = None
    # analytic plane (sim backend) only
    gpus_per_instance: int = 8
    server_gpus: int = 8
    placement_x: Optional[int] = None
    duration: float = 300.0
    overlap: bool = True
    fast_kernels: bool = True
    slow_kernel_eff_scale: float = 2.8  # generic-kernel penalty (ablations)
    protocol: str = "push"
    hw: Hardware = H100             # nominal data-sheet constants
    lora_rank: Optional[int] = None
    zipf_s: float = 1.2
    n_adapters: int = 512
    step_overhead: float = 0.004
    # per-launch hook dispatch cost: prices the sim plane's launch tail
    # and derates the autoscaler's TPOT budget on both planes (0 = off)
    hook_launch_us: float = 0.0
    # mesh-sharded execution plane (cluster backend, disaggregated only):
    # a (data, model) device grid; the base expert GEMMs run over its
    # "data" axis and the server replicas' slot tables are partitioned
    mesh_shape: Optional[Tuple[int, int]] = None
    failures: Tuple[Tuple[float, int], ...] = ()
    recoveries: Tuple[Tuple[float, int], ...] = ()
    stragglers: Tuple[Tuple[float, int, float], ...] = ()
    straggler_mitigation: bool = True
    # rank-aware hook compute (both planes): each row's contraction bounded
    # at its adapter's TRUE rank (bitwise-neutral on the tokens); the sim
    # plane prices the batch's mean effective rank from ``adapter_ranks``
    rank_aware: bool = True
    adapter_ranks: Optional[Tuple[int, ...]] = None
    # observability: True records per-request spans on a TimelineTracer
    # and feeds the metrics registry (ServeSystem.observability()); the
    # tokens are bitwise the same either way
    trace: bool = False

    def __post_init__(self):
        if self.backend not in ("cluster", "sim"):
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(expected 'sim' or 'cluster')")
        if self.transport not in ("host", "fused"):
            raise ValueError(f"unknown transport {self.transport!r} "
                             f"(expected 'host' or 'fused')")
        if self.mesh_shape is not None:
            if self.backend != "cluster":
                raise ValueError(
                    "mesh_shape drives real sharded execution: it needs "
                    "backend='cluster' (the sim plane prices parallelism "
                    "via placement_x instead)")
            check_mesh_shape(self.mesh_shape, self.disaggregated)

    # ------------------------- derivations --------------------------- #
    def engine_config(self) -> EngineConfig:
        return EngineConfig(max_len=self.max_len, n_slots=self.max_batch,
                            paged=self.paged, page_size=self.page_size,
                            n_pages=self.n_pages,
                            prefill_chunk=self.prefill_chunk)

    def cluster_config(self) -> ClusterConfig:
        return ClusterConfig(
            n_instances=self.n_instances, n_slots=self.max_batch,
            max_len=self.max_len, disaggregated=self.disaggregated,
            adapter_cache_slots=self.adapter_cache_slots, policy=self.policy,
            step_time=self.step_time, host_bw=self.host_bw,
            layerwise_loading=self.layerwise_loading,
            max_rounds=self.max_rounds, paged=self.paged,
            page_size=self.page_size, n_pages=self.n_pages,
            prefill_chunk=self.prefill_chunk, autoscale=self.autoscale,
            transport=self.transport, hook_launch_us=self.hook_launch_us,
            mesh_shape=self.mesh_shape,
            store_host_bytes=self.store_host_bytes,
            store_dir=self.store_dir, disk_bw=self.disk_bw,
            prefetch=self.prefetch, rank_aware=self.rank_aware)

    def sim_config(self) -> SimConfig:
        return SimConfig(
            n_instances=self.n_instances,
            gpus_per_instance=self.gpus_per_instance,
            max_batch=self.max_batch, duration=self.duration,
            disaggregated=self.disaggregated, server_gpus=self.server_gpus,
            server_cache_slots=self.adapter_cache_slots,
            server_replicas=self.server_replicas,
            placement_x=self.placement_x,
            instance_cache_slots=self.adapter_cache_slots,
            overlap=self.overlap,
            layerwise_loading=self.layerwise_loading,
            fast_kernels=self.fast_kernels,
            slow_kernel_eff_scale=self.slow_kernel_eff_scale,
            protocol=self.protocol,
            policy=self.policy,
            hw=dataclasses.replace(self.hw, disk_bw=self.disk_bw),
            lora_rank=self.lora_rank,
            zipf_s=self.zipf_s, n_adapters=self.n_adapters,
            step_overhead=self.step_overhead, failures=self.failures,
            recoveries=self.recoveries, stragglers=self.stragglers,
            straggler_mitigation=self.straggler_mitigation,
            autoscale=self.autoscale, transport=self.transport,
            hook_launch_us=self.hook_launch_us,
            store_host_bytes=self.store_host_bytes,
            prefetch=self.prefetch,
            adapter_ranks=self.adapter_ranks,
            rank_aware=self.rank_aware)

    # ------------------------ migration shims ------------------------ #
    @classmethod
    def from_sim(cls, sim: SimConfig, **overrides) -> "ServeConfig":
        """Lift a ``SimConfig`` (e.g. the S-LoRA presets) into the front
        door."""
        slots = sim.server_cache_slots if sim.disaggregated \
            else sim.instance_cache_slots
        kw = dict(
            backend="sim", disaggregated=sim.disaggregated,
            n_instances=sim.n_instances, max_batch=sim.max_batch,
            adapter_cache_slots=slots, policy=sim.policy,
            gpus_per_instance=sim.gpus_per_instance,
            server_gpus=sim.server_gpus,
            server_replicas=sim.server_replicas,
            placement_x=sim.placement_x,
            duration=sim.duration, overlap=sim.overlap,
            layerwise_loading=sim.layerwise_loading,
            fast_kernels=sim.fast_kernels,
            slow_kernel_eff_scale=sim.slow_kernel_eff_scale,
            protocol=sim.protocol,
            hw=sim.hw, lora_rank=sim.lora_rank, zipf_s=sim.zipf_s,
            n_adapters=sim.n_adapters, step_overhead=sim.step_overhead,
            failures=sim.failures, recoveries=sim.recoveries,
            stragglers=sim.stragglers,
            straggler_mitigation=sim.straggler_mitigation,
            autoscale=sim.autoscale, transport=sim.transport,
            hook_launch_us=sim.hook_launch_us,
            store_host_bytes=sim.store_host_bytes,
            disk_bw=sim.hw.disk_bw, prefetch=sim.prefetch,
            adapter_ranks=sim.adapter_ranks, rank_aware=sim.rank_aware)
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def from_cluster(cls, ccfg: ClusterConfig, **overrides) -> "ServeConfig":
        """Lift a ``ClusterConfig`` into the front door."""
        kw = dict(
            backend="cluster", disaggregated=ccfg.disaggregated,
            n_instances=ccfg.n_instances, max_batch=ccfg.n_slots,
            max_len=ccfg.max_len,
            adapter_cache_slots=ccfg.adapter_cache_slots,
            policy=ccfg.policy, step_time=ccfg.step_time,
            host_bw=ccfg.host_bw, layerwise_loading=ccfg.layerwise_loading,
            max_rounds=ccfg.max_rounds, paged=ccfg.paged,
            page_size=ccfg.page_size, n_pages=ccfg.n_pages,
            prefill_chunk=ccfg.prefill_chunk, autoscale=ccfg.autoscale,
            transport=ccfg.transport, hook_launch_us=ccfg.hook_launch_us,
            mesh_shape=ccfg.mesh_shape,
            store_host_bytes=ccfg.store_host_bytes,
            store_dir=ccfg.store_dir, disk_bw=ccfg.disk_bw,
            prefetch=ccfg.prefetch, rank_aware=ccfg.rank_aware)
        kw.update(overrides)
        return cls(**kw)


# ------------------------------- backends -------------------------------- #
class Backend(Protocol):
    """An execution plane the front door drives: takes requests, advances
    virtual time in steps, emits lifecycle ``Event``s, and can release an
    in-flight request."""

    def submit(self, req: Request) -> None: ...

    def cancel(self, rid: int, at: Optional[float] = None) -> List[Event]: ...

    def step(self) -> List[Event]: ...

    def idle(self) -> bool: ...

    @property
    def now(self) -> float: ...

    def requests(self) -> List[Request]: ...

    def kv_stats(self) -> Dict: ...

    def cache_stats(self) -> Dict: ...

    def transport_stats(self) -> Dict: ...

    def default_duration(self) -> float: ...

    def scale_history(self) -> List[Dict]: ...

    def load_adapter(self, adapter_id: int, tensors=None, *,
                     alpha: Optional[float] = None) -> Optional[int]: ...

    def unload_adapter(self, adapter_id: int) -> None: ...

    def close(self) -> None: ...


class SimBackend:
    """The analytic discrete-event plane (wraps ``simulator.Simulation``).
    Token events carry ``token=None``: this plane models time (TTFT, TPOT,
    SLO attainment at cluster scale), not token ids."""

    def __init__(self, model, cfg: ServeConfig, tracer=None):
        self.sim = Simulation(model, cfg.sim_config(), tracer=tracer)
        self._duration = cfg.duration

    def submit(self, req: Request) -> None:
        self.sim.submit(req)

    def cancel(self, rid: int, at: Optional[float] = None) -> List[Event]:
        self.sim.cancel(rid, at=at)
        return []                   # the CANCELLED event arrives via step()

    def step(self) -> List[Event]:
        return [Event(t, rid, kind) for t, rid, kind in self.sim.step()]

    def idle(self) -> bool:
        return self.sim.idle()

    @property
    def now(self) -> float:
        return self.sim.now

    def requests(self) -> List[Request]:
        return list(self.sim.requests)

    def kv_stats(self) -> Dict:
        return {}                   # the analytic plane holds no KV

    def cache_stats(self) -> Dict:
        return {"caches": {k: c.stats() for k, c in self.sim.caches.items()},
                "store": self.sim.store.stats() if self.sim.store else {}}

    def transport_stats(self) -> Dict:
        return self.sim.transport_stats()   # modelled launch counts

    def default_duration(self) -> float:
        return self._duration

    def scale_history(self) -> List[Dict]:
        sc = self.sim._scaler
        return list(sc.history) if sc is not None else []

    def load_adapter(self, adapter_id: int, tensors=None, *,
                     alpha: Optional[float] = None) -> Optional[int]:
        # the analytic plane has no tensors to check: only the id joins
        self.sim.load_adapter(adapter_id)
        return None

    def unload_adapter(self, adapter_id: int) -> None:
        self.sim.unload_adapter(adapter_id)

    def close(self) -> None:
        pass                        # nothing real to tear down


def _device_of_pool(pool):
    return next(iter(pool.tensors.values()))["A"].device


class ClusterBackend:
    """The real plane (wraps a ``Cluster`` session): decode steps on the
    device of the weights, real token ids, paged or dense KV."""

    def __init__(self, model, params, cfg: ServeConfig, pool, tracer=None):
        server_pool = self._make_server_pool(model, cfg, pool) \
            if cfg.disaggregated else None
        self.cluster = Cluster(model, params, cfg.cluster_config(), pool,
                               server_pool=server_pool, tracer=tracer)
        self.cluster.open()
        self.max_rounds = cfg.max_rounds
        self.step_time = cfg.step_time
        self._reqs: List[Request] = []
        self._req_by_rid: Dict[int, Request] = {}
        self._cancels: List[Tuple[float, int]] = []   # (at, rid) scheduled

    @staticmethod
    def _make_server_pool(model, cfg: ServeConfig, pool) -> ServerPool:
        """The pool of single-device LoRA-Server replicas at the pool's
        rank, on the pool's device (the slots take the adapters' true ranks
        at insert): ``adapter_cache_slots`` slots each, or, when
        autoscaling, enough for the policy's cache ceiling (at most one
        slot per adapter of the pool). Under a mesh the slot tables are
        partitioned: each replica holds its affinity share of them."""
        slots = cfg.adapter_cache_slots
        if cfg.autoscale is not None:
            slots = max(slots, min(cfg.autoscale.max_cache_slots, pool.n))
        return ServerPool.build(model, pool, cache_slots=slots,
                                n_replicas=max(cfg.server_replicas, 1),
                                device=_device_of_pool(pool),
                                partition_slots=cfg.mesh_shape is not None)

    def submit(self, req: Request) -> None:
        self.cluster.submit(req)    # raises ValueError -> REJECTED
        self._reqs.append(req)
        self._req_by_rid[req.rid] = req

    def _live_cancels(self) -> List[Tuple[float, int]]:
        """Scheduled cancels whose target is still in flight (a cancel that
        outlives its request must not keep the backend awake)."""
        return [(t, rid) for t, rid in self._cancels
                if (r := self._req_by_rid.get(rid)) is not None
                and r.finish < 0 and not r.cancelled]

    def cancel(self, rid: int, at: Optional[float] = None) -> List[Event]:
        now = self.cluster.now
        if at is not None and at > now:
            self._cancels.append((at, rid))
            return []
        if self.cluster.cancel(rid):
            return [Event(now, rid, "cancelled")]
        return []

    def step(self) -> List[Event]:
        if self.cluster.rnd >= self.max_rounds:
            raise RuntimeError(
                f"cluster exceeded max_rounds={self.max_rounds} with "
                f"unfinished work — adapter cache too small?")
        evs: List[Event] = []
        now = self.cluster.now
        self._cancels = self._live_cancels()
        due = [(t, rid) for t, rid in self._cancels if t <= now]
        self._cancels = [(t, rid) for t, rid in self._cancels if t > now]
        for t, rid in due:
            evs.extend(self.cancel(rid))
        rep = self.cluster.step_round()
        evs.extend(Event(rep["now"], -1, f"scale:{a.kind}", detail=a.reason)
                   for a in rep["scale"])
        evs.extend(Event(rep["now"], r.rid, "queued")
                   for r in rep["enqueued"])
        evs.extend(Event(rep["now"], r.rid, "prefill")
                   for r in rep["admitted"])
        evs.extend(Event(rep["step_end"], rid, "token", token=tok)
                   for rid, tok in rep["tokens"].items())
        evs.extend(Event(rep["step_end"], r.rid, "finished")
                   for r in rep["finished"])
        return evs

    def idle(self) -> bool:
        return self.cluster.idle() and not self._live_cancels()

    @property
    def now(self) -> float:
        return self.cluster.now

    def requests(self) -> List[Request]:
        return list(self._reqs)

    def kv_stats(self) -> Dict:
        return self.cluster.kv_stats()

    def cache_stats(self) -> Dict:
        return self.cluster.cache_stats()

    def transport_stats(self) -> Dict:
        return self.cluster.transport_stats()   # measured launch counts

    def default_duration(self) -> float:
        return max(self.cluster.rnd, 1) * self.step_time

    def scale_history(self) -> List[Dict]:
        return self.cluster.scale_history()

    def load_adapter(self, adapter_id: int, tensors=None, *,
                     alpha: Optional[float] = None) -> Optional[int]:
        if tensors is None:
            raise ValueError(
                "the cluster plane loads REAL weights: pass tensors= in "
                "the canonical host format ({'<target>.A'/'<target>.B'})")
        return self.cluster.load_adapter(adapter_id, tensors, alpha=alpha)

    def unload_adapter(self, adapter_id: int) -> None:
        self.cluster.unload_adapter(adapter_id)

    def close(self) -> None:
        self.cluster.close()


# ---------------------------- request handle ----------------------------- #
class RequestHandle:
    """Client-side view of one submitted request: live state, the token
    stream so far, per-token callbacks, an iterator that pumps the system,
    and ``cancel()``."""

    def __init__(self, system: "ServeSystem", request: Request,
                 slo_class: SLOClass):
        self._system = system
        self.request = request
        self.rid = request.rid
        self.slo_class = slo_class
        self.state = RequestState.QUEUED
        self.tokens: List[int] = []          # token ids (cluster plane)
        self.n_tokens = 0                    # lifecycle count (both planes)
        self.events: List[Event] = []
        self.error: Optional[str] = None
        self._stream: List[Optional[int]] = []
        self._cbs: List[Callable[["RequestHandle", Optional[int]], None]] = []

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    def on_token(self, cb: Callable[["RequestHandle", Optional[int]], None]
                 ) -> "RequestHandle":
        """Register a per-token callback ``cb(handle, token)``; it fires
        the round each token is decoded."""
        self._cbs.append(cb)
        return self

    def result(self) -> List[int]:
        """Pump the system until this request is terminal (or the backend
        runs dry); returns the tokens decoded so far."""
        while not self.done and not self._system.backend.idle():
            self._system.step()
        return self.tokens

    def __iter__(self) -> Iterator[Optional[int]]:
        """Stream tokens as they are decoded (None on the analytic plane),
        pumping the system between yields, while OTHER requests are
        admitted and evicted around this one."""
        sent = 0
        while True:
            while sent < len(self._stream):
                yield self._stream[sent]
                sent += 1
            if self.done or self._system.backend.idle():
                return
            self._system.step()

    def cancel(self, at: Optional[float] = None) -> bool:
        """Cancel this request (now, or at virtual time ``at``). Its
        decode slot, KV pages and adapter pin come back at the next round
        boundary; it never counts as finished."""
        if self.done:
            return False
        return self._system.cancel(self.rid, at=at)

    @property
    def ttft(self) -> float:
        return self.request.ttft

    @property
    def tpot(self) -> float:
        return self.request.tpot

    def __repr__(self):
        return (f"RequestHandle(rid={self.rid}, state={self.state.name}, "
                f"tokens={self.n_tokens}/{self.request.output_len})")

    def _reject(self, reason: str) -> None:
        self.state = RequestState.REJECTED
        self.error = reason

    def _apply(self, ev: Event) -> None:
        self.events.append(ev)
        if ev.kind == "queued":
            if self.state == RequestState.QUEUED:
                return               # submit() already set it
            self.state = RequestState.QUEUED   # requeued after a failure
        elif ev.kind == "prefill":
            self.state = RequestState.PREFILLING
        elif ev.kind == "token":
            self.state = RequestState.DECODING
            self.n_tokens += 1
            self._stream.append(ev.token)
            if ev.token is not None:
                self.tokens.append(ev.token)
            for cb in self._cbs:
                cb(self, ev.token)
        elif ev.kind == "finished":
            self.state = RequestState.FINISHED
        elif ev.kind == "cancelled":
            self.state = RequestState.CANCELLED


# ------------------------------ the system ------------------------------- #
class ServeSystem:
    """The front door: owns a backend, assigns rids, fans lifecycle events
    out to handles, and summarizes SLO metrics."""

    def __init__(self, cfg: ServeConfig, model, params=None, pool=None):
        self.cfg = cfg
        self.model = model
        # one tracer threads through the cluster, caches and engines; the
        # hub folds the event stream into request-stage spans + metrics.
        # trace=False wires the zero-cost NULL_TRACER
        self.tracer = TimelineTracer() if cfg.trace else NULL_TRACER
        self._hub = ObservabilityHub(self.tracer)
        if cfg.backend == "sim":
            self.backend: Backend = SimBackend(model, cfg, tracer=self.tracer)
        else:
            # a family or plane the engines cannot serve is refused before
            # the server pool's weights are made
            check_family(model, disaggregated=cfg.disaggregated)
            if params is None or pool is None:
                raise ValueError("backend='cluster' runs the real model: "
                                 "pass params= and pool= (or use "
                                 "backend='sim' for the analytic plane)")
            self.backend = ClusterBackend(model, params, cfg, pool,
                                          tracer=self.tracer)
        self.handles: Dict[int, RequestHandle] = {}
        # the scale:* events also land here (and, traced, on the hub's
        # "control" track)
        self.scale_events: List[Event] = []
        self._rid = itertools.count()

    # --------------------------- submission -------------------------- #
    def submit(self, prompt: Optional[Sequence[int]] = None,
               adapter_id: int = 0, *, max_new_tokens: int = 8,
               prompt_len: Optional[int] = None,
               arrival: Optional[float] = None,
               slo_class: SLOClass = INTERACTIVE,
               on_token: Optional[Callable] = None,
               rid: Optional[int] = None) -> RequestHandle:
        """Submit one request; returns its handle at once (state QUEUED,
        or REJECTED if it violates the admission contract: a bad request
        never raises). ``prompt`` is token ids; without one, ``prompt_len``
        makes a deterministic prompt from the rid."""
        if prompt is None and prompt_len is None:
            raise TypeError("submit() needs prompt= or prompt_len=")
        rid = next(self._rid) if rid is None else rid
        # materialize first: `if prompt` is ambiguous on arrays and would
        # drop an explicit empty prompt
        ids = tuple(int(t) for t in prompt) if prompt is not None else ()
        plen = len(ids) if prompt is not None else int(prompt_len)
        req = Request(rid, int(adapter_id),
                      arrival=self.backend.now if arrival is None
                      else float(arrival),
                      prompt_len=plen, output_len=int(max_new_tokens),
                      prompt=ids)
        handle = RequestHandle(self, req, slo_class)
        if on_token is not None:
            handle.on_token(on_token)
        if prompt is not None and plen == 0:
            handle._reject(f"request {rid}: empty prompt")
            return handle
        try:
            self.backend.submit(req)
        except ValueError as e:       # admission contract violation
            handle._reject(str(e))
            return handle
        self.handles[rid] = handle
        return handle

    def submit_workload(self, requests: Sequence[Request],
                        slo_class: SLOClass = INTERACTIVE
                        ) -> List[RequestHandle]:
        """Replay a generated workload (``workload.generate``) through the
        front door, keeping each request's rid and arrival time."""
        handles = [self.submit(adapter_id=r.adapter_id,
                               prompt=r.prompt or None,
                               prompt_len=r.prompt_len,
                               max_new_tokens=r.output_len,
                               arrival=r.arrival, rid=r.rid,
                               slo_class=slo_class)
                   for r in requests]
        # keep auto-rids collision-free, never rewinding the counter
        top = max((r.rid for r in requests), default=-1)
        self._rid = itertools.count(max(top + 1, next(self._rid)))
        return handles

    # ---------------------------- pumping ----------------------------- #
    def step(self) -> List[Event]:
        """Advance the backend one round; route events to handles (and,
        with tracing on, to the observability hub)."""
        evs = self.backend.step()
        traced = self.tracer.enabled
        for ev in evs:
            if traced:
                self._hub.on_event(ev)
            if ev.kind.startswith("scale"):
                self.scale_events.append(ev)
                continue
            h = self.handles.get(ev.rid)
            if h is not None:
                h._apply(ev)
        return evs

    def drain(self) -> None:
        """Run until the backend is idle (every request terminal)."""
        while not self.backend.idle():
            self.step()

    def cancel(self, rid: int, at: Optional[float] = None) -> bool:
        h = self.handles.get(rid)
        if h is None or h.done:
            return False
        for ev in self.backend.cancel(rid, at=at):
            self.handles[ev.rid]._apply(ev)
        return True

    @property
    def now(self) -> float:
        return self.backend.now

    # ----------------------- adapter lifecycle ------------------------ #
    def load_adapter(self, adapter_id: int, tensors=None, *,
                     alpha: Optional[float] = None) -> Optional[int]:
        """Register a new adapter mid-run: the id becomes targetable by
        later ``submit`` calls. ``tensors`` is the canonical host format
        ({"<target>.A"/"<target>.B"} CPU tensors at the adapter's true
        rank), checked against the model config; ``alpha`` rescales from
        the raw alpha/r convention into the pool's scale. Returns the
        adapter's rank. On a coupled system the adapter is appended to the
        static pool, so its id must be the pool's next. ValueError on
        invalid tensors or ids."""
        return self.backend.load_adapter(adapter_id, tensors, alpha=alpha)

    def unload_adapter(self, adapter_id: int) -> None:
        """Remove an adapter from every store tier and the device cache.
        Refused (ValueError) while an unfinished request references it."""
        self.backend.unload_adapter(adapter_id)

    def close(self) -> None:
        """Tear down the adapter store's prefetch thread and its owned
        disk-tier tempdir. Idempotent."""
        self.backend.close()

    # ---------------------------- metrics ----------------------------- #
    def kv_stats(self) -> Dict:
        return self.backend.kv_stats()

    def cache_stats(self) -> Dict:
        """Adapter-plane telemetry: per-cache device-tier counters (under
        "caches") and the store's host/disk tier counters ("store")."""
        return self.backend.cache_stats()

    def transport_stats(self) -> Dict:
        """Hook-transport launch accounting (host dispatches, device
        programs, table uploads, per-step rate); empty when coupled."""
        return self.backend.transport_stats()

    def scale_history(self) -> List[Dict]:
        """The autoscaler's per-control-tick record (rate, LB, targets,
        actions); empty when static."""
        return self.backend.scale_history()

    def summary(self, duration: Optional[float] = None,
                slo_class: Optional[SLOClass] = None,
                warmup: float = 0.1) -> Summary:
        """SLO summary over the live request objects. ``slo_class``
        filters to that class's requests and applies its thresholds;
        default: all requests, the paper's SLOs."""
        reqs = self.backend.requests()
        if slo_class is not None:
            keep = {h.rid for h in self.handles.values()
                    if h.slo_class.name == slo_class.name}
            reqs = [r for r in reqs if r.rid in keep]
        sc = slo_class or INTERACTIVE
        s = metrics.summarize(
            reqs, duration if duration is not None
            else self.backend.default_duration(),
            ttft_slo=sc.ttft_slo, tpot_slo=sc.tpot_slo, warmup=warmup,
            cache_stats=self.backend.cache_stats(),
            transport_stats=self.backend.transport_stats())
        if self.tracer.enabled:
            self._hub.publish_summary(s)
        return s

    def observability(self) -> Observability:
        """Tracer + metrics registry + the Perfetto/Prometheus/JSONL
        exporters."""
        return Observability(self._hub, self.backend)


def build_system(cfg: ServeConfig, model, *, params=None,
                 pool=None) -> ServeSystem:
    """Build the serving front door: sim/cluster x coupled/disaggregated x
    dense/paged KV x host/fused transport x static/elastic. The cluster
    plane's LoRA-Server pool is built from ``cfg`` (``server_replicas``,
    ``adapter_cache_slots``, the autoscaler's cache ceiling) on the device
    of ``pool``."""
    return ServeSystem(cfg, model, params=params, pool=pool)

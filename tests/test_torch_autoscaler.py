"""The port's elastic plane against the JAX reference's (after
``tests/test_autoscaler.py``), on the CPU:

  - ``serving/server_pool.py``'s analytic pool: delta sync, affinity
    homes, the full re-home after a resize, the reference's counters
  - ``serving/autoscaler.py``: the same observation sequence into both
    packages gives the same actions and ``history`` (the IAR column within
    the reference's float32 error), priced on a port ``Hardware`` with the
    reference's default constants
  - ``serving/simulator.py``: ``Simulation.result()``, the ``Summary`` and
    the modelled transport stats equal the reference's exactly for the
    coupled and the disaggregated plane, a failure with recovery, a
    straggler, the store's host tier and per-adapter ranks; with the
    autoscaler on a load shift, the action histories
  - ``baselines/slora.py``: the presets equal the reference's
  - ``serving/cluster.py`` on the reduced config: an aggressive policy
    (cache resizes and instance scaling mid-decode) gives the static
    run's tokens and the reference's tokens and actions, coupled dense,
    disaggregated paged on the host and on the fused transport (eager on
    the CPU); a drain mid-decode retires the engine completely; a
    ``resize_cache`` shrink flushes the pool; ``open()`` caps the policy
    at the pool; an undersized replica is refused; a retired engine's
    fused graphs are forgotten; the replica count moves 1 -> 2 -> 1
    mid-decode with the tokens unchanged

Weights come from the JAX initialisers, bridged through numpy."""
import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import slora as jslora
from repro.configs import get_config
from repro.core import adapter as jadapter
from repro.core import cost_model as jcm
from repro.models import model as jmodel
from repro.serving import api as japi
from repro.serving import autoscaler as jauto
from repro.serving import metrics as jmetrics
from repro.serving import simulator as jsim
from repro.serving import workload as jworkload
from repro.serving.cache import LoRACache as JLoRACache
from repro.serving.server_pool import ServerPool as JServerPool
from repro_torch import bridge
from repro_torch.baselines import slora
from repro_torch.core import cost_model as cm
from repro_torch.serving import metrics, simulator
from repro_torch.serving.api import ServeConfig, build_system
from repro_torch.serving.autoscaler import Autoscaler, AutoscalePolicy, \
    ScaleAction, converge_replicas, pick_drain_candidate
from repro_torch.serving.cache import LoRACache
from repro_torch.serving.cluster import Cluster, ClusterConfig
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import InstanceState
from repro_torch.serving.server_pool import AnalyticReplica, ServerPool
from repro_torch.serving.workload import Request
from repro_torch.transport.fused import FusedTransport

MX = get_config("mixtral-8x7b")
TMX = bridge.config_from(MX)
# a port Hardware with the reference's default constants
REF_HW = cm.Hardware(**dataclasses.asdict(jcm.V5E))
REF_IAR_TOL = 1e-4     # history rounds IAR to 4 places


def _same(a, b) -> bool:
    """Equality that takes nan == nan (Summary's telemetry fields)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _same_history(got, want) -> None:
    """Control-tick records equal, the IAR column to its rounding."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g["iar"] - w["iar"]) <= REF_IAR_TOL, (g, w)
        assert {k: v for k, v in g.items() if k != "iar"} == \
            {k: v for k, v in w.items() if k != "iar"}, (g, w)


def _port_request(r) -> Request:
    return Request(**dataclasses.asdict(r))


# ------------------------------ ServerPool -------------------------------- #
def test_analytic_pool_delta_sync_equals_reference():
    """The analytic pool's delta sync, affinity homes and forced full
    re-home after add/remove_replica, step for step against the
    reference's counters."""
    sides = [(LoRACache(4, adapter_bytes=0.0, n_layers=4, layerwise=False,
                        prefetch=False), ServerPool.analytic(2, 4)),
             (JLoRACache(4, adapter_bytes=0.0, n_layers=4, layerwise=False,
                         prefetch=False), JServerPool.analytic(2, 4))]
    script = [("admit", 0), ("admit", 1), ("sync",), ("sync",),
              ("admit", 5), ("sync",), ("admit", 2), ("admit", 3),
              ("admit", 9), ("sync",), ("add",), ("sync",), ("remove",),
              ("sync",), ("resize", 6), ("sync",)]
    trace = []
    for cache, pool in sides:
        out = []
        for t, op in enumerate(script):
            if op[0] == "admit":
                cache.admit(op[1], float(t))
            elif op[0] == "sync":
                out.append(pool.sync(cache))
                pool.check_consistent(cache)
            elif op[0] == "add":
                pool.add_replica()
            elif op[0] == "remove":
                pool.remove_replica()
            else:
                pool.resize_slots(op[1])
            out.append((pool.n_replicas, pool.version, pool.min_slots,
                        sorted(sorted(r.slot_of) for r in pool.replicas)))
        out.append((pool.sync_rounds, pool.sync_noops, pool.sync_inserts,
                    pool.sync_evictions, pool.pool_rank))
        trace.append(out)
    assert trace[0] == trace[1]
    pool = sides[0][1]
    pool.remove_replica()
    with pytest.raises(RuntimeError):
        pool.remove_replica()
    assert all(isinstance(r, AnalyticReplica) for r in pool.replicas)


def test_converge_replicas_and_drain_candidate():
    pool = ServerPool.analytic(1, 4)
    assert converge_replicas(pool, 3) and pool.n_replicas == 3
    assert not converge_replicas(pool, 3)
    assert converge_replicas(pool, 0) and pool.n_replicas == 1
    insts = [InstanceState(i, 4) for i in range(3)]
    insts[0].running = [object()] * 2
    insts[2].draining = True
    assert pick_drain_candidate(insts, {1: [object()]}).iid == 1
    assert pick_drain_candidate(insts, {1: [object()] * 3}).iid == 0
    with pytest.raises(ValueError):
        ScaleAction("explode", 3)


# ------------------------------ Autoscaler -------------------------------- #
def _both(pol_kw, max_batch, feed, controls):
    """Run one observation sequence through both packages' autoscalers:
    ``feed(scaler)`` observes, ``controls`` are (now, kwargs) ticks.
    Returns ((port actions, history), (reference actions, history))."""
    out = []
    for side in ("torch", "jax"):
        if side == "torch":
            sc = Autoscaler(AutoscalePolicy(**pol_kw), TMX,
                            max_batch=max_batch, hw=REF_HW)
        else:
            sc = jauto.Autoscaler(jauto.AutoscalePolicy(**pol_kw), MX,
                                  max_batch=max_batch)
        feed(sc)
        acts = [[(a.kind, a.target, a.reason) for a in sc.control(now, **kw)]
                for now, kw in controls]
        out.append((acts, sc.history))
    return out


def test_autoscaler_up_immediately_down_with_patience_equals_reference():
    def feed(sc):
        for i in range(40):
            sc.observe_arrival(10.0 * i / 40, i % 16)
    kw = dict(cache_slots=16, n_replicas=1)
    (got, gh), (want, wh) = _both(
        dict(control_interval=5.0, window=30.0, max_instances=8,
             scale_down_patience=2, target_utilization=1.0), 8, feed,
        [(10.0, dict(in_flight=30, queued=10, n_instances=1, **kw)),
         (15.0, dict(in_flight=2, queued=0, n_instances=5, **kw)),
         (20.0, dict(in_flight=2, queued=0, n_instances=5, **kw)),
         (21.0, dict(in_flight=2, queued=0, n_instances=5, **kw))])
    assert got == want
    _same_history(gh, wh)
    assert ("add_instance", 5) in [(k, t) for k, t, _ in got[0]]
    assert not any(k == "drain_instance" for k, _, _ in got[1])
    assert any(k == "drain_instance" for k, _, _ in got[2])
    assert got[3] == [] and len(gh) == 3


def test_autoscaler_cache_target_equals_reference():
    def feed(sc):
        rng = np.random.default_rng(0)
        for i in range(300):
            sc.observe_arrival(i * 0.1, int(rng.integers(0, 64)))
    (got, gh), (want, wh) = _both(
        dict(control_interval=1.0, window=30.0, max_cache_slots=512,
             resize_deadband=0.0), 128, feed,
        [(30.0, dict(in_flight=100, queued=0, cache_slots=4, n_instances=1,
                     n_replicas=1)),
         (31.0, dict(in_flight=10, queued=0, cache_slots=60, n_instances=1,
                     n_replicas=1, host_hit_rate=0.5,
                     miss_cost_ratio=0.2))])
    assert got == want
    _same_history(gh, wh)
    resize = [t for k, t, _ in got[0] if k == "resize_cache"]
    assert resize and resize[0] >= 50


@pytest.mark.parametrize("rank", [None, 4.0])
def test_autoscaler_prices_mean_effective_rank_equals_reference(rank):
    def feed(sc):
        for i in range(400):
            sc.observe_arrival(30.0 * i / 400, i % 64)
    (got, gh), (want, wh) = _both(
        dict(control_interval=1.0, window=30.0, slo_tpot=0.01,
             max_replicas=8, resize_deadband=0.0, max_instances=4), 64,
        feed, [(30.0, dict(in_flight=200, queued=40, cache_slots=64,
                           n_instances=4, n_replicas=1,
                           mean_active_rank=rank))])
    assert got == want
    _same_history(gh, wh)
    assert gh[-1]["mean_active_rank"] == rank


def test_autoscaler_on_the_h100_needs_no_more_replicas():
    """The nominal H100 prices the same low-rank mix at no more replicas
    than the reference's machine; a low-rank mix needs fewer than a
    padded one."""
    reps = {}
    for name, hw in (("h100", cm.H100), ("ref", REF_HW)):
        for rank in (None, 4.0):
            sc = Autoscaler(AutoscalePolicy(control_interval=1.0,
                                            slo_tpot=0.01, max_replicas=8,
                                            max_instances=4,
                                            gpus_per_replica=1), TMX,
                            max_batch=64, hw=hw)
            for i in range(400):
                sc.observe_arrival(30.0 * i / 400, i % 64)
            sc.control(30.0, in_flight=200, queued=40, cache_slots=64,
                       n_instances=4, n_replicas=1, mean_active_rank=rank)
            reps[name, rank] = sc.history[-1]["targets"]["replicas"]
    assert reps["h100", None] <= reps["ref", None]
    assert reps["ref", 4.0] < reps["ref", None]


# ------------------------------ simulator --------------------------------- #
def _sim_pair(reqs, **kw):
    """Run ``reqs`` through both packages' ``Simulation`` of the same
    SimConfig fields (the port's on the reference's constants)."""
    jpol = kw.pop("autoscale", None)
    pol = None if jpol is None else AutoscalePolicy(
        **dataclasses.asdict(jpol))
    port = simulator.Simulation(TMX, simulator.SimConfig(
        hw=REF_HW, autoscale=pol, **kw))
    ref = jsim.Simulation(MX, jsim.SimConfig(autoscale=jpol, **kw))
    events = []
    for sim, req_of in ((port, _port_request), (ref, copy.copy)):
        for r in reqs:
            sim.submit(req_of(r))
        ev = []
        while not sim.idle():
            ev.extend(sim.step())
        events.append(ev)
    return port, ref, events


def _summary(mod, sim, duration):
    res = sim.result()
    return dataclasses.asdict(mod.summarize(
        res["requests"], duration, cache_stats=res["cache_stats"],
        transport_stats=sim.transport_stats()))


def _result_equal(port, ref, duration) -> None:
    got, want = port.result(), ref.result()
    assert [dataclasses.asdict(r) for r in got["requests"]] == \
        [dataclasses.asdict(r) for r in want["requests"]]
    for key in ("batch_log", "active_adapters_log", "scale_log",
                "cache_stats"):
        assert got[key] == want[key], key
    assert port.transport_stats() == ref.transport_stats()
    assert _same(_summary(metrics, port, duration),
                 _summary(jmetrics, ref, duration))


SIM_CELLS = {
    "coupled": dict(disaggregated=False, n_instances=4, max_batch=128,
                    instance_cache_slots=12),
    "disagg": dict(disaggregated=True, n_instances=3, max_batch=128,
                   server_gpus=8, server_cache_slots=24, placement_x=4),
    "failure_recovery": dict(disaggregated=True, n_instances=3,
                             max_batch=64, server_gpus=8,
                             server_cache_slots=24,
                             failures=((6.0, 0),), recoveries=((9.0, 0),)),
    "straggler": dict(disaggregated=True, n_instances=3, max_batch=64,
                      server_gpus=8, server_cache_slots=24,
                      stragglers=((4.0, 1, 5.0),)),
    "host_tier": dict(disaggregated=True, n_instances=2, max_batch=64,
                      server_gpus=4, server_cache_slots=8,
                      store_host_bytes=6 * MX.lora_adapter_bytes(),
                      transport="host", hook_launch_us=5.0),
    "adapter_ranks": dict(disaggregated=True, n_instances=2, max_batch=64,
                          server_gpus=4, server_cache_slots=16,
                          transport="fused", hook_launch_us=5.0,
                          adapter_ranks=tuple([4, 8, 16, 64] * 12)),
}


@pytest.mark.parametrize("cell", sorted(SIM_CELLS))
def test_simulation_equals_reference(cell):
    kw = dict(SIM_CELLS[cell], n_adapters=48, duration=20.0)
    reqs = jworkload.generate(48, rate=12, duration=20, seed=2)
    port, ref, events = _sim_pair(reqs, **kw)
    assert events[0] == events[1]
    _result_equal(port, ref, 20.0)
    assert any(r.finish >= 0 for r in port.requests)
    if cell == "failure_recovery":
        # the failed instance's running requests were admitted again
        prefills = [rid for _, rid, k in events[0] if k == "prefill"]
        assert len(prefills) > len(set(prefills))
    if cell == "host_tier":
        st = port.store.stats()
        assert st["disk_hits"] > 0 and st["demotions"] > 0
    if cell == "adapter_ranks":
        ts = port.transport_stats()
        assert 0 < ts["mean_active_rank"] < 64
        assert ts["host_dispatches_per_step"] == 1.0


def test_simulation_autoscale_on_a_load_shift_equals_reference():
    """Traffic steps 4 -> 22 requests/s at t = 20 s: the autoscaler adds
    instances and grows the cache; both packages take the same actions
    (any difference would have to come from the reference's float32 IAR:
    none here) and serve the same requests at the same times."""
    reqs = jworkload.generate_load_shift(n_adapters=48, lo_rate=4,
                                         hi_rate=22, t_shift=20.0,
                                         duration=50.0)
    pol = jauto.AutoscalePolicy(control_interval=5.0, window=15.0,
                                min_instances=1, max_instances=4,
                                max_cache_slots=48, max_replicas=2,
                                target_utilization=0.6)
    port, ref, events = _sim_pair(
        reqs, disaggregated=True, n_instances=1, max_batch=128,
        server_cache_slots=12, n_adapters=48, duration=50.0, server_gpus=8,
        placement_x=4, autoscale=pol)
    assert port.scale_log == ref.scale_log
    assert {a for _, a, _ in port.scale_log} >= {"add_instance",
                                                 "resize_cache"}
    _same_history(port._scaler.history, ref._scaler.history)
    assert events[0] == events[1]
    _result_equal(port, ref, 50.0)
    port.server_pool.check_consistent(port.caches[-1])


def test_slora_presets_equal_reference():
    for cfg, ref in ((TMX, MX),
                     (bridge.config_from(get_config("qwen3-moe-235b-a22b")),
                      get_config("qwen3-moe-235b-a22b"))):
        for gpus, frac in ((8, 0.5), (4, 0.4)):
            assert slora.instance_cache_slots(cfg, gpus, frac, REF_HW) == \
                jslora.instance_cache_slots(ref, gpus, frac)
        got = dataclasses.asdict(slora.slora_config(cfg, 4, 8, 64, 30.0,
                                                    sjf=True))
        want = dataclasses.asdict(jslora.slora_config(ref, 4, 8, 64, 30.0,
                                                      sjf=True))
        for d in (got, want):
            del d["hw"], d["instance_cache_slots"]
        assert got == want
        got = dataclasses.asdict(slora.infinilora_config(
            cfg, 3, 8, 8, 64, 30.0, hw=REF_HW, rank=16))
        want = dataclasses.asdict(jslora.infinilora_config(
            ref, 3, 8, 8, 64, 30.0, rank=16))
        del got["hw"], want["hw"]
        assert got == want
    # the H100's 80 GB hold more adapters than the reference's default
    assert slora.instance_cache_slots(TMX, 8, 0.5) > \
        slora.instance_cache_slots(TMX, 8, 0.5, REF_HW)


# ------------------------------ cluster ----------------------------------- #
@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                               lora_targets=("gate", "up", "down"),
                               lora_rank=8)
    key = jax.random.PRNGKey(0)
    params = jmodel.init_params(jcfg, key, dtype="float32")
    pool = jadapter.init_mixed_rank_pool(jcfg, [2, 8, 4, 8],
                                         jax.random.fold_in(key, 1),
                                         dtype=jnp.float32)
    tcfg = bridge.config_from(jcfg)
    tparams = bridge.tree_to_tensors(jax.tree_util.tree_map(np.asarray,
                                                            params))
    tpool = bridge.adapter_pool(
        tcfg, jax.tree_util.tree_map(np.asarray, pool.tensors), pool.rank,
        pool.scale, pool.ranks)
    return dict(jcfg=jcfg, params=params, pool=pool, tcfg=tcfg,
                tparams=tparams, tpool=tpool, runs={})


SPECS = [(0, 0.0, 5, 6), (1, 0.0, 4, 4), (2, 2.0, 6, 5), (3, 5.0, 3, 4)]
AGGRESSIVE = dict(control_interval=2.0, window=10.0, min_instances=1,
                  max_instances=3, min_cache_slots=2, max_cache_slots=4,
                  max_replicas=2, scale_down_patience=1, resize_deadband=0.0)


def _run_cluster(setup, side, disagg, paged=False, autoscale=None, **kw):
    """One drained run of SPECS through the front door, cached: (tokens,
    scale history, scale event kinds)."""
    key = (side, disagg, paged, autoscale is not None,
           tuple(sorted(kw.items())))
    if key in setup["runs"]:
        return setup["runs"][key]
    sc_kw = dict(backend="cluster", disaggregated=disagg, n_instances=1,
                 max_batch=2, max_len=32, adapter_cache_slots=4,
                 paged=paged, page_size=4, n_pages=8, prefill_chunk=8, **kw)
    if side == "jax":
        pol = None if autoscale is None else \
            jauto.AutoscalePolicy(**autoscale)
        system = japi.build_system(japi.ServeConfig(autoscale=pol, **sc_kw),
                                   setup["jcfg"], params=setup["params"],
                                   pool=setup["pool"])
    else:
        pol = None if autoscale is None else AutoscalePolicy(**autoscale)
        system = build_system(ServeConfig(autoscale=pol, **sc_kw),
                              setup["tcfg"], params=setup["tparams"],
                              pool=setup["tpool"])
    handles = [system.submit(adapter_id=a, arrival=t, prompt_len=p,
                             max_new_tokens=o) for a, t, p, o in SPECS]
    system.drain()
    assert all(h.state.name == "FINISHED" for h in handles)
    out = ({h.rid: list(h.tokens) for h in handles}, system.scale_history(),
           [ev.kind for ev in system.scale_events])
    system.close()
    setup["runs"][key] = out
    return out


@pytest.mark.parametrize("disagg,paged,transport",
                         [(False, False, "host"), (True, True, "host"),
                          (True, True, "fused")],
                         ids=["coupled_dense", "disagg_paged_host",
                              "disagg_paged_fused"])
def test_cluster_tokens_invariant_under_autoscaling(setup, disagg, paged,
                                                    transport):
    """An aggressive policy (2-round control interval, tiny bounds, no
    deadband: it resizes the cache and scales instances while requests
    decode) changes no token against the static run, and its tokens and
    actions are the reference's (whose fused plane acts as its host
    plane: the transport enters the control loop only through
    ``hook_launch_us``, 0 here)."""
    static = _run_cluster(setup, "torch", False)[0]
    tokens, hist, kinds = _run_cluster(setup, "torch", disagg, paged,
                                       AGGRESSIVE, transport=transport)
    assert tokens == static
    want_tokens, want_hist, want_kinds = _run_cluster(
        setup, "jax", disagg, paged, AGGRESSIVE)
    assert tokens == want_tokens
    _same_history(hist, want_hist)
    assert kinds == want_kinds
    assert hist and kinds and all(k.startswith("scale:") for k in kinds)


def _cluster(setup, n_instances=1, replicas=1, transport="host", **kw):
    sp = ServerPool.build(setup["tcfg"], setup["tpool"], cache_slots=4,
                          n_replicas=replicas, device="cpu")
    ccfg = ClusterConfig(n_instances=n_instances, n_slots=2, max_len=32,
                         disaggregated=True, adapter_cache_slots=4,
                         transport=transport, **kw)
    return Cluster(setup["tcfg"], setup["tparams"], ccfg, setup["tpool"],
                   server_pool=sp)


def _requests():
    return [Request(i, a, arrival=t, prompt_len=p, output_len=o)
            for i, (a, t, p, o) in enumerate(SPECS)]


def test_cluster_drain_while_requests_in_flight(setup):
    """Draining an instance with requests mid-decode lets them finish in
    place (the static tokens), and retires the instance completely:
    engine, KV, instance record and scheduler entries."""
    static = _run_cluster(setup, "torch", False)[0]
    cluster = _cluster(setup, n_instances=2, paged=True, page_size=4,
                       n_pages=8, prefill_chunk=8)
    reqs = _requests()
    cluster.open(reqs)
    for r in reqs:
        cluster.submit(r)
    for _ in range(2):
        cluster.step_round()
    busy = max(cluster._instances.values(), key=lambda i: i.batch)
    assert busy.batch > 0
    eng = cluster.engines[busy.iid]
    n_before = {rid: len(t) for rid, t in cluster.tokens.items()}
    cluster.sched.drain_instance(busy.iid, cluster.now)
    while not cluster.step_round()["idle"]:
        pass
    assert cluster.tokens == static
    assert all(r.finish >= 0 for r in reqs)
    for rid, n in n_before.items():
        assert len(cluster.tokens[rid]) >= n
    assert not busy.alive
    assert busy.iid not in cluster.engines
    assert busy.iid not in cluster._instances
    assert busy.iid not in cluster.sched.instances
    assert busy.iid not in cluster.sched.kv_pages
    assert eng._k is None and eng._v is None    # its KV came back


def test_cluster_resize_action_flushes_pool_evictions(setup):
    cluster = _cluster(setup)
    cluster.open()
    sp, cache = cluster.server_pool, cluster._caches[-1]
    cache.admit(0, 0.0)
    cache.admit(1, 0.0)
    cluster._sync_pool()
    assert sp.is_resident(0) and sp.is_resident(1)
    cluster._apply_action(ScaleAction("resize_cache", 1), 1.0)
    sp.check_consistent(cache)
    assert sum(len(r.slot_of) for r in sp.replicas) == 1
    cluster.close()


def test_open_caps_the_policy_at_the_pool(setup):
    cluster = _cluster(setup, autoscale=AutoscalePolicy(max_cache_slots=512))
    cluster.open()
    assert cluster._scaler.policy.max_cache_slots == 4
    assert cluster._scaler.hw == cm.H100
    cluster.close()


def test_cluster_rejects_undersized_replica():
    sp = ServerPool([AnalyticReplica(2)])
    with pytest.raises(ValueError, match="capacity 2"):
        Cluster(TMX, None, ClusterConfig(disaggregated=True,
                                         adapter_cache_slots=8),
                pool=None, server_pool=sp)


def test_fused_transport_forgets_a_released_engines_graphs(setup):
    """A retired engine's captured graphs are dropped with its KV (on the
    card they hold graph-pool memory, and the allocator may hand the same
    KV address to the next engine): keys of its KV buffers go, the other
    engines' stay."""
    sp = ServerPool.build(setup["tcfg"], setup["tpool"], cache_slots=4,
                          device="cpu")
    tr = FusedTransport(sp, n_adapters=4)
    engines = [Engine(setup["tcfg"], setup["tparams"],
                      EngineConfig(max_len=32, n_slots=2, paged=True,
                                   page_size=4, n_pages=8, prefill_chunk=8),
                      server=sp, pool=setup["tpool"], transport=tr,
                      device="cpu") for _ in range(2)]
    for i, eng in enumerate(engines):
        eng.add_request(i, [3, 1, 4], -1)
        eng.evict_request(i)
        for B in (1, 2):
            tr._graphs[(B, 2, eng._k.data_ptr(), eng._v.data_ptr(),
                        tuple(eng._k.shape), 0, None)] = object()
    keep = {k for k in tr._graphs if k[2] == engines[1]._k.data_ptr()}
    engines[0].release_kv()
    assert set(tr._graphs) == keep and len(keep) == 2
    engines[1].release_kv()
    assert tr._graphs == {}
    engines[1].add_request(5, [2, 7], -1)      # KV comes back on demand
    assert engines[1]._k is not None


def test_cluster_replicas_one_two_one_mid_decode(setup):
    """add_replica then remove_replica while requests decode, on the
    fused transport: running requests' adapters are re-homed (aid % R)
    before the next step, and the tokens stay the static run's."""
    static = _run_cluster(setup, "torch", False)[0]
    cluster = _cluster(setup, transport="fused", paged=True, page_size=4,
                       n_pages=8, prefill_chunk=8)
    reqs = _requests()
    cluster.open(reqs)
    for r in reqs:
        cluster.submit(r)
    sp, cache = cluster.server_pool, cluster._caches[-1]
    for rnd, act in ((2, ScaleAction("add_replica", 2)),
                     (5, ScaleAction("remove_replica", 1))):
        while cluster.rnd < rnd:
            cluster.step_round()
        uploads = cluster.transport.stats.lut_uploads
        cluster._apply_action(act, cluster.now)
        assert sp.n_replicas == act.target
        sp.check_consistent(cache)
        for rid in cluster.engines[0].active_rids():
            aid = cluster._reqs[rid].adapter_id
            assert sp.replicas[aid % act.target].is_resident(aid)
        cluster.step_round()
        assert cluster.transport.stats.lut_uploads == uploads + 1
    while not cluster.step_round()["idle"]:
        pass
    assert cluster.tokens == static
    cluster.close()

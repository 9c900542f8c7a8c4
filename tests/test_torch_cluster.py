"""The port's control plane and cluster against the JAX reference:

  - ``serving/workload.py``: ``generate`` and ``generate_load_shift`` give
    the reference's request lists; ``Request.ttft``/``tpot`` its values
  - ``serving/metrics.py``: ``summarize`` gives the reference's ``Summary``
    field for field on the same requests and stats
  - ``serving/scheduler.py``: the ``Scheduler`` admits, retires and
    cancels as the reference's does on a generated workload (shared cache
    with a page budget, and per-instance caches with greedy ownership)
  - ``serving/cluster.py``: ``Cluster.run`` gives the reference cluster's
    tokens, rounds, cache and KV stats (coupled dense, disaggregated paged
    fused), and the reference's invariants hold inside the port under
    churn: coupled == disagg, tokens independent of the batch's
    composition, paged == dense, a tight page budget, prefill chunk-width
    invariance, tracing on == off; the prefetch thread stages only
    adapters no server slot holds, each once
  - ``mesh_shape`` is accepted (the mesh plane's own tests are
    ``tests/test_torch_mesh.py``)

Weights come from the JAX initialisers, bridged through numpy."""
import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.core import adapter as jadapter
from repro.core import lora_server as jls
from repro.models import model as jmodel
from repro.serving import cache as jcache
from repro.serving import cluster as jcluster
from repro.serving import metrics as jmetrics
from repro.serving import scheduler as jsched
from repro.serving import workload as jworkload
from repro_torch import bridge
from repro_torch.serving import cache as tcache
from repro_torch.serving import cluster as tcluster
from repro_torch.serving import metrics as tmetrics
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import workload as tworkload
from repro_torch.serving.server_pool import ServerPool


def _same(a, b) -> bool:
    """Equality that takes nan == nan (Summary's telemetry fields)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def _fields(obj) -> dict:
    return dataclasses.asdict(obj)


# ------------------------------- workload -------------------------------- #
@pytest.mark.parametrize("seed", [0, 7, 11])
def test_generate_equals_reference(seed):
    want = jworkload.generate(16, rate=5.0, duration=30.0, seed=seed)
    got = tworkload.generate(16, rate=5.0, duration=30.0, seed=seed)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert len(got) > 50
    np.testing.assert_array_equal(tworkload.zipf_popularity(9, 1.1),
                                  jworkload.zipf_popularity(9, 1.1))


def test_generate_load_shift_equals_reference():
    want = jworkload.generate_load_shift(8, 2.0, 9.0, 10.0, 25.0)
    got = tworkload.generate_load_shift(8, 2.0, 9.0, 10.0, 25.0)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert any(r.rid >= 10_000 for r in got)


def test_request_ttft_tpot_equal_reference():
    cases = [(-1.0, -1.0, 4), (2.5, -1.0, 4), (2.5, 7.5, 4), (-1.0, 7.5, 4),
             (2.5, 7.5, 1)]
    for first, finish, out in cases:
        pair = []
        for mod in (jworkload, tworkload):
            r = mod.Request(0, 1, arrival=1.0, prompt_len=3, output_len=out)
            r.first_token, r.finish = first, finish
            pair.append((r.ttft, r.tpot))
        assert pair[0] == pair[1]


# ------------------------------- metrics --------------------------------- #
def _stamped(mod, seed=3):
    """A generated workload with first-token/finish stamps drawn from a
    seed: some finished, some censored, some cancelled, one corrupt."""
    reqs = mod.generate(12, rate=4.0, duration=40.0, seed=seed)
    rng = np.random.default_rng(seed)
    for i, r in enumerate(reqs):
        kind = i % 7
        if kind == 5:
            continue                        # never got a first token
        r.first_token = r.arrival + float(rng.exponential(0.2))
        if kind == 6:
            r.cancelled = True
            continue
        if kind == 4 and i % 3 == 0:
            r.first_token = -1.0            # corrupt: finish without first
        r.finish = max(r.first_token, r.arrival) + \
            float(rng.exponential(0.08)) * r.output_len
    return reqs


def test_summarize_equals_reference():
    cache_stats = {"caches": {-1: {"hits": 9, "misses": 3,
                                   "prefetch_hits": 2,
                                   "miss_load_seconds": 0.6}},
                   "store": {"host_hits": 4, "disk_hits": 1}}
    transport_stats = {"mean_active_rank": 5.5, "rank_flop_savings": 0.31}
    for kw in ({}, dict(warmup=0.0, ttft_slo=0.5, tpot_slo=0.2),
               dict(cache_stats=cache_stats,
                    transport_stats=transport_stats)):
        got = tmetrics.summarize(_stamped(tworkload), 40.0, **kw)
        want = jmetrics.summarize(_stamped(jworkload), 40.0, **kw)
        assert _same(_fields(got), _fields(want)), kw
        assert got.meets_slos() == want.meets_slos()
    empty = tmetrics.summarize([], 10.0)
    assert _same(_fields(empty), _fields(jmetrics.summarize([], 10.0)))
    assert (tmetrics.TTFT_SLO, tmetrics.TPOT_SLO) == \
        (jmetrics.TTFT_SLO, jmetrics.TPOT_SLO)


def test_max_serviceable_rate_equals_reference():
    def run_fn(mod):
        def run(rate):
            reqs = mod.generate(6, rate=rate, duration=30.0, seed=1)
            for r in reqs:
                r.first_token = r.arrival + 0.02 * rate
                r.finish = r.first_token + 0.01 * rate * r.output_len
            return mod_metrics[mod].summarize(reqs, 30.0)
        return run

    mod_metrics = {tworkload: tmetrics, jworkload: jmetrics}
    rates = [1.0, 2.0, 4.0, 8.0, 16.0]
    got = tmetrics.max_serviceable_rate(run_fn(tworkload), rates)
    assert got == jmetrics.max_serviceable_rate(run_fn(jworkload), rates)
    assert 0.0 < got < 16.0


# ------------------------------ scheduler -------------------------------- #
def _schedule(mods, shared: bool, seed: int):
    """Drive one Scheduler over a generated workload a round at a time
    (admit, then one token for every running request; every 5th round
    cancel the oldest running request). Returns the admissions, finishes
    and cancels per round and the caches' stats."""
    wl, sc, ca = mods
    reqs = wl.generate(10, rate=3.0, duration=12.0, seed=seed)
    n_inst = 2
    insts = [sc.InstanceState(i, max_batch=3) for i in range(n_inst)]
    mk = lambda: ca.LoRACache(3, adapter_bytes=2e9, n_layers=4,  # noqa: E731
                              host_bw=1e10)
    if shared:
        caches, owner = {-1: mk()}, None
        kv_pages = {i: 12 for i in range(n_inst)}
        def need(r):
            return -(-(r.prompt_len % 20 + r.output_len % 9) // 8)
    else:
        caches = {i: mk() for i in range(n_inst)}
        pop = wl.zipf_popularity(10)
        owner = sc.assign_adapters_greedy(10, pop, n_inst)
        kv_pages = need = None
    sched = sc.Scheduler(insts, caches, owner, shared_cache=shared,
                         kv_pages=kv_pages, kv_page_need=need)
    log, pi, now = [], 0, 0.0
    for rnd in range(60):
        now = rnd * 0.5
        while pi < len(reqs) and reqs[pi].arrival <= now:
            sched.enqueue(reqs[pi], now)
            pi += 1
        adm = {i.iid: [r.rid for r in sched.admit(i.iid, now)]
               for i in insts}
        fin = {i.iid: [r.rid for r in sched.step_complete(i.iid, now + 0.5)]
               for i in insts}
        cancelled = []
        if rnd % 5 == 4:
            running = [r for i in insts for r in i.running]
            if running:
                victim = min(running, key=lambda r: r.rid)
                cancelled.append((victim.rid, sched.cancel(victim, now)))
        log.append((adm, fin, cancelled, sched.queue_len()))
    stats = {k: c.stats() for k, c in caches.items()}
    stamps = [(r.rid, r.instance, r.decode_start, r.first_token, r.finish,
               r.cancelled) for r in reqs]
    return log, stats, stamps


@pytest.mark.parametrize("shared", [True, False],
                         ids=["shared_cache", "per_instance"])
@pytest.mark.parametrize("seed", [0, 5])
def test_scheduler_admissions_equal_reference(shared, seed):
    got = _schedule((tworkload, tsched, tcache), shared, seed)
    want = _schedule((jworkload, jsched, jcache), shared, seed)
    assert got == want
    log = got[0]
    assert sum(len(v) for a, _, _, _ in log for v in a.values()) > 5
    assert any(c for _, _, c, _ in log)


def test_assign_adapters_greedy_equals_reference():
    pop = tworkload.zipf_popularity(17, 1.3)
    for n in (1, 3, 4):
        np.testing.assert_array_equal(
            tsched.assign_adapters_greedy(17, pop, n),
            jsched.assign_adapters_greedy(17, pop, n))


# ------------------------------- cluster --------------------------------- #
CLUSTER_SPECS = [(0, 0, 0.0, 5, 6), (1, 1, 0.0, 4, 4), (2, 2, 2.0, 6, 5),
                 (3, 3, 5.0, 3, 4)]


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
                tparams=tparams, tpool=tpool)


def _reqs(mod, specs=CLUSTER_SPECS):
    return [mod.Request(rid, a, arrival=t, prompt_len=p, output_len=o)
            for rid, a, t, p, o in specs]


def _server_pool(setup, slots=4):
    """One LoRA-Server replica of ``slots`` slots at the pool's rank."""
    return ServerPool.build(setup["tcfg"], setup["tpool"], cache_slots=slots,
                            device="cpu")


def _run(setup, side, disagg, n_slots=2, specs=CLUSTER_SPECS, **kw):
    """One ``Cluster.run`` of ``specs`` with the prefetch thread off unless
    ``kw`` turns it on; disaggregated runs get one LoRA Server of 4 slots
    (the reference's as a bare server, the port's in a one-replica
    ``ServerPool``)."""
    kw = {"prefetch": False, **kw}
    if side == "jax":
        server = jls.LoRAServer(setup["jcfg"], jls.ServerConfig(
            m=1, x=1, y=1, cache_slots=4, rank=8), dtype=jnp.float32) \
            if disagg else None
        cl = jcluster.Cluster(setup["jcfg"], setup["params"],
                              jcluster.ClusterConfig(
                                  n_instances=1, n_slots=n_slots, max_len=32,
                                  disaggregated=disagg,
                                  adapter_cache_slots=4, **kw),
                              setup["pool"], server=server)
        reqs = _reqs(jworkload, specs)
    else:
        cl = tcluster.Cluster(setup["tcfg"], setup["tparams"],
                              tcluster.ClusterConfig(
                                  n_instances=1, n_slots=n_slots, max_len=32,
                                  disaggregated=disagg,
                                  adapter_cache_slots=4, **kw),
                              setup["tpool"], server_pool=_server_pool(
                                  setup) if disagg else None)
        reqs = _reqs(tworkload, specs)
    try:
        return cl.run(reqs), cl
    finally:
        cl.close()


PAGED = dict(paged=True, page_size=4, n_pages=8, prefill_chunk=8)


@pytest.mark.parametrize("disagg,kw", [(False, {}),
                                       (True, dict(PAGED, transport="fused"))],
                         ids=["coupled-dense", "disagg-paged-fused"])
def test_cluster_run_equals_reference(setup, disagg, kw):
    """Cluster.run: the reference cluster's tokens, rounds, request stamps,
    cache stats (the store's too) and KV stats."""
    want, _ = _run(setup, "jax", disagg, **kw)
    got, cl = _run(setup, "torch", disagg, **kw)
    assert got["tokens"] == want["tokens"]
    assert got["rounds"] == want["rounds"]
    assert [_fields(r) for r in got["requests"]] == \
        [_fields(r) for r in want["requests"]]
    assert got["cache_stats"] == want["cache_stats"]
    assert got.get("kv_stats") == want.get("kv_stats")
    if disagg:
        st = cl.transport_stats()
        assert st["host_dispatches"] == st["steps"] > 0
        assert st["hook_dispatches"] == 0


def test_cluster_coupled_equals_disagg_under_churn(setup):
    out_c, _ = _run(setup, "torch", False)
    out_d, _ = _run(setup, "torch", True)
    assert out_c["tokens"] == out_d["tokens"]
    for out in (out_c, out_d):
        for rid, _, _, _, o in CLUSTER_SPECS:
            assert len(out["tokens"][rid]) == o
        reqs = {r.rid: r for r in out["requests"]}
        assert reqs[2].decode_start >= 2.0
        assert reqs[3].decode_start >= min(reqs[0].finish, reqs[1].finish)
        assert all(r.finish >= 0 for r in out["requests"])


def test_cluster_tokens_independent_of_batch_composition(setup):
    seq, _ = _run(setup, "torch", False, n_slots=1)
    par, _ = _run(setup, "torch", False, n_slots=4)
    assert seq["tokens"] == par["tokens"]
    assert par["rounds"] < seq["rounds"]


@pytest.mark.parametrize("disagg", [False, True], ids=["coupled", "disagg"])
def test_cluster_paged_equals_dense_under_churn(setup, disagg):
    dense, _ = _run(setup, "torch", disagg)
    paged, cl = _run(setup, "torch", disagg, **PAGED)
    assert paged["tokens"] == dense["tokens"]
    st = paged["kv_stats"][0]
    assert st["pool_bytes"] < st["dense_slab_bytes"]
    assert 0 < st["peak_pages"] <= 8
    assert st["pages_in_use"] == 0
    assert cl.engines[0].free_pages() == 8


def test_cluster_paged_tight_page_budget_serializes_but_completes(setup):
    dense, _ = _run(setup, "torch", False)
    paged, _ = _run(setup, "torch", False, paged=True, page_size=4,
                    n_pages=4, prefill_chunk=8)
    assert paged["tokens"] == dense["tokens"]
    assert paged["rounds"] > dense["rounds"]


def test_cluster_paged_chunked_prefill_chunk_width_invariance(setup):
    dense, _ = _run(setup, "torch", False)
    narrow_dense, _ = _run(setup, "torch", False, prefill_chunk=2)
    narrow, _ = _run(setup, "torch", False, paged=True, page_size=4,
                     n_pages=16, prefill_chunk=4)
    wide, _ = _run(setup, "torch", False, paged=True, page_size=4,
                   n_pages=16, prefill_chunk=32)
    assert narrow_dense["tokens"] == narrow["tokens"] == wide["tokens"] == \
        dense["tokens"]


def test_cluster_run_leaves_callers_requests_untouched(setup):
    reqs = _reqs(tworkload)
    before = [_fields(r) for r in reqs]
    cl = tcluster.Cluster(setup["tcfg"], setup["tparams"],
                          tcluster.ClusterConfig(n_instances=2, n_slots=2,
                                                 max_len=32),
                          setup["tpool"])
    out = cl.run(reqs)
    assert [_fields(r) for r in reqs] == before
    assert all(r.finish >= 0 for r in out["requests"])
    assert set(out["cache_stats"]["caches"]) == {0, 1}


def test_cluster_refuses_unported_options_and_small_pools(setup):
    """No option is refused any more (the autoscaler, ROADMAP A6, and the
    mesh plane, A8, are ported); a missing or too small server pool
    still is."""
    from repro_torch.serving.autoscaler import AutoscalePolicy
    assert tcluster.ClusterConfig(
        autoscale=AutoscalePolicy()).autoscale == AutoscalePolicy()
    assert tcluster.ClusterConfig(disaggregated=True,
                                  mesh_shape=(2, 1)).mesh_shape == (2, 1)
    with pytest.raises(ValueError, match="ServerPool"):
        tcluster.Cluster(setup["tcfg"], setup["tparams"],
                         tcluster.ClusterConfig(disaggregated=True),
                         setup["tpool"])
    with pytest.raises(ValueError, match="capacity 2"):
        tcluster.Cluster(setup["tcfg"], setup["tparams"],
                         tcluster.ClusterConfig(disaggregated=True,
                                                adapter_cache_slots=4),
                         setup["tpool"], server_pool=_server_pool(setup, 2))


def test_cluster_cancel_and_prompts_equal_reference(setup):
    """The seeded prompt of a request without tokens (7919 + rid) and a
    cancel mid-decode that frees the slot and pages at once."""
    cl = tcluster.Cluster(setup["tcfg"], setup["tparams"],
                          tcluster.ClusterConfig(n_instances=1, n_slots=2,
                                                 max_len=32, **PAGED),
                          setup["tpool"])
    jcl = jcluster.Cluster.__new__(jcluster.Cluster)
    jcl.ccfg, jcl.cfg = jcluster.ClusterConfig(max_len=32), setup["jcfg"]
    for r in _reqs(tworkload):
        want = jcl._prompt(copy.copy(r))
        np.testing.assert_array_equal(cl._prompt(r), want)
    cl.open()
    for r in _reqs(tworkload)[:2]:
        cl.submit(r)
    cl.step_round()
    cl.step_round()
    before = cl.kv_stats()[0]
    assert before["slots_in_use"] == 2
    assert cl.cancel(0) and not cl.cancel(0)
    after = cl.kv_stats()[0]
    assert after["slots_in_use"] == 1
    assert after["pages_in_use"] < before["pages_in_use"]
    assert len(cl.tokens[0]) == 2 and cl._reqs[0].finish < 0


def test_cluster_tracing_on_off_tokens_bit_identical(setup):
    from repro_torch.obs.trace import TimelineTracer
    off, _ = _run(setup, "torch", True, **PAGED)
    tr = TimelineTracer()
    cl = tcluster.Cluster(setup["tcfg"], setup["tparams"],
                          tcluster.ClusterConfig(
                              n_instances=1, n_slots=2, max_len=32,
                              disaggregated=True, adapter_cache_slots=4,
                              prefetch=False, **PAGED),
                          setup["tpool"], server_pool=_server_pool(setup),
                          tracer=tr)
    on = cl.run(_reqs(tworkload))
    cl.close()
    assert on["tokens"] == off["tokens"]
    steps = [s for s in tr.spans if s.name == "decode.step"]
    assert len(steps) == on["rounds"] - 1       # the last round is idle
    assert all(s.args["wall_ms"] >= 0.0 for s in steps)
    kv = [i for i in tr.instants if i.track == "kv"]
    assert len(kv) == len(CLUSTER_SPECS)


def test_cluster_prefetches_only_what_no_server_slot_holds(setup):
    """The prefetch thread stages an adapter only when no server slot holds
    it, and an upload of an adapter the thread is staging takes that
    result: rids 4 and 5 arrive on resident adapters and queue nothing,
    every staging is consumed by one insert, none is done twice, and the
    tokens are the run's without the thread."""
    specs = CLUSTER_SPECS + [(4, 0, 9.0, 3, 3), (5, 1, 9.0, 4, 3)]
    off, _ = _run(setup, "torch", True, specs=specs, **PAGED)
    on, cl = _run(setup, "torch", True, specs=specs, prefetch=True, **PAGED)
    assert on["tokens"] == off["tokens"]
    st = on["cache_stats"]["store"]
    assert cl.server_pool.sync_inserts == 4
    assert st["prefetch_requests"] == st["prefetch_staged"] == \
        st["staged_hits"] == 4
    assert st["sync_stages"] == 0
    assert cl.store._staged == {}

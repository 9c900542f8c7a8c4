"""The port's transport planes and elastic LoRA-Server pool against the JAX
reference (``repro.transport``, ``repro.serving.server_pool``,
``repro.serving.cache``):

  - the port's ``Engine(..., server=ServerPool, transport=...)`` gives the
    JAX engine's greedy tokens exactly and the same ``transport_stats()``,
    over transport {host, fused} x replicas {1, 2} x layout {paged, dense},
    and under adapter-cache eviction churn (2 slots)
  - the fused plane is one host dispatch a step with no hook dispatch, its
    device tables uploaded only on residency changes
  - the slot tables (server LUT, pool sync, the LoRA cache) behave as the
    reference's; ``DeviceLoraView.compute`` equals ``ServerPool.compute``
    bit for bit and the JAX ``fused_hook_delta`` within 1e-6
  - on the card (tests marked ``gpu``): graph capture, replay == eager bit
    for bit, a table rewritten in place seen by a replay without a new
    capture, and the graph pool's bytes

Inputs are made with numpy from a seed and bridged (``bridge.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import adapter as jadapter
from repro.core import lora_server as jls
from repro.models import model as jmodel
from repro.serving import cache as jcache
from repro.serving import engine as jengine
from repro.serving import server_pool as jserver_pool
from repro.transport import FusedTransport as JFused
from repro.transport import fused_hook_delta as j_fused_hook_delta
from repro_torch import bridge
from repro_torch.core import lora_server as tls
from repro_torch.launch import serve as tserve
from repro_torch.serving import engine as tengine
from repro_torch.serving.api import build_system
from repro_torch.serving.cache import LoRACache
from repro_torch.serving.server_pool import ServerPool
from repro_torch.transport import (DeviceLoraView, FusedTransport,
                                   HostTransport, fused_hook_delta,
                                   make_transport)

# (rid, prompt length, adapter, arrives after this many decode steps)
REQUESTS = [(0, 7, 0, 0), (1, 5, 1, 0), (2, 9, 2, 0), (3, 6, 3, 2),
            (4, 4, 0, 3), (5, 8, 1, 3)]
NEW_TOKENS = 4
ENGINE = dict(max_len=32, n_slots=4, page_size=4, prefill_chunk=8)
RANKS = [2, 8, 4, 8]


class _Residency:
    """A LoRA cache (LRU among unpinned residents) in front of a server
    pool, the control plane the reference's cluster runs around one
    engine: a request is admitted only once its adapter is resident
    (pinned while it runs), and before every decode step the replicas'
    slot tables follow the cache. Works over the reference package's cache
    and pool too: they have the same methods."""

    def __init__(self, server_pool, adapter_pool, capacity: int,
                 cache=None, tensors_fn=None):
        self.pool = server_pool
        self.cache = cache if cache is not None else LoRACache(
            capacity, adapter_bytes=0, n_layers=adapter_pool.cfg.n_layers,
            layerwise=False, prefetch=False)
        self.tensors_fn = tensors_fn or (
            lambda a: tls.pool_tensors_from_adapter(adapter_pool, a))
        self.rank_fn = adapter_pool.rank_of
        self.clock = 0.0        # one tick a decode step (the LRU's time)

    def acquire(self, adapter_id: int) -> bool:
        if self.cache.admit(adapter_id, self.clock) is None:
            return False
        self.cache.pin(adapter_id)
        return True

    def release(self, adapter_id: int) -> None:
        self.cache.unpin(adapter_id, self.clock)

    def sync(self) -> int:
        self.clock += 1.0
        return self.pool.sync(self.cache, self.tensors_fn, self.rank_fn)


def _drive(engine, residency, prompts):
    """The reference cluster's loop on one engine: requests queue in
    arrival order and are admitted while a slot is free and their adapter
    can be made resident (pinned while they run); the server pool follows
    the cache before every step."""
    out = {rid: [] for rid, *_ in REQUESTS}
    waiting, step = [], 0
    while any(len(v) < NEW_TOKENS for v in out.values()):
        waiting += [(rid, aid) for rid, _, aid, at in REQUESTS if at == step]
        while waiting and engine.free_slots() and \
                residency.acquire(waiting[0][1]):
            rid, aid = waiting.pop(0)
            engine.add_request(rid, prompts[rid], aid)
        residency.sync()
        for rid, t in engine.step().items():
            out[rid].append(int(t))
            if len(out[rid]) == NEW_TOKENS:
                engine.evict_request(rid)
                residency.release(REQUESTS[rid][2])
        step += 1
    return out


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                               lora_targets=("gate", "up", "down"),
                               lora_rank=8)
    key = jax.random.PRNGKey(0)
    params = jmodel.init_params(jcfg, key, dtype="float32")
    pool = jadapter.init_mixed_rank_pool(jcfg, RANKS,
                                         jax.random.fold_in(key, 1),
                                         dtype=jnp.float32)
    rng = np.random.default_rng(0)
    prompts = {rid: rng.integers(0, jcfg.vocab_size, n).tolist()
               for rid, n, _, _ in REQUESTS}
    tcfg = bridge.config_from(jcfg)
    tparams = bridge.tree_to_tensors(jax.tree_util.tree_map(np.asarray,
                                                            params))
    tpool = bridge.adapter_pool(
        tcfg, jax.tree_util.tree_map(np.asarray, pool.tensors), pool.rank,
        pool.scale, pool.ranks)
    return dict(jcfg=jcfg, params=params, pool=pool, prompts=prompts,
                tcfg=tcfg, tparams=tparams, tpool=tpool, runs={})


def _run(setup, side, transport, replicas, paged, slots=4,
         rank_aware=True):
    """One served run, cached per argument tuple: (tokens, stats, engine,
    server pool)."""
    key = (side, transport, replicas, paged, slots, rank_aware)
    if key in setup["runs"]:
        return setup["runs"][key]
    if side == "jax":
        sp = jserver_pool.ServerPool.build(setup["jcfg"], setup["pool"],
                                           cache_slots=slots,
                                           n_replicas=replicas,
                                           dtype=jnp.float32)
        res = _Residency(
            sp, setup["pool"], slots,
            cache=jcache.LoRACache(slots, adapter_bytes=0, n_layers=2,
                                   layerwise=False, prefetch=False),
            tensors_fn=lambda a: jls.pool_tensors_from_adapter(
                setup["pool"], a))
        eng = jengine.Engine(setup["jcfg"], setup["params"],
                             jengine.EngineConfig(paged=paged, **ENGINE),
                             pool=setup["pool"], server=sp,
                             transport=transport)
    else:
        sp = ServerPool.build(setup["tcfg"], setup["tpool"],
                              cache_slots=slots, n_replicas=replicas,
                              dtype=torch.float32, device="cpu")
        res = _Residency(sp, setup["tpool"], slots)
        eng = tengine.Engine(setup["tcfg"], setup["tparams"],
                             tengine.EngineConfig(paged=paged, **ENGINE),
                             sp, device="cpu", pool=setup["tpool"],
                             transport=transport)
    sp.set_rank_aware(rank_aware)
    tokens = _drive(eng, res, setup["prompts"])
    setup["runs"][key] = (tokens, eng.transport_stats(), eng, sp)
    return setup["runs"][key]


PLANES = [(t, r, p) for t in ("host", "fused") for r in (1, 2)
          for p in (True, False)]


def _ids(case):
    t, r, p = case
    return f"{t}-R{r}-{'paged' if p else 'dense'}"


# ------------------------ engine parity with JAX ------------------------ #
@pytest.mark.parametrize("case", PLANES, ids=[_ids(c) for c in PLANES])
def test_transport_engine_matches_reference(setup, case):
    """Greedy tokens equal the JAX engine's exactly on the same plane, and
    the launch ledger equals the JAX transport's field for field."""
    transport, replicas, paged = case
    want, jstats, _, _ = _run(setup, "jax", transport, replicas, paged)
    got, stats, _, _ = _run(setup, "torch", transport, replicas, paged)
    assert got == want
    assert stats == jstats
    if transport == "fused":
        assert stats["host_dispatches"] == stats["steps"] > 0
        assert stats["hook_dispatches"] == 0
        assert 0 < stats["lut_uploads"] < stats["steps"]
    else:
        assert stats["hook_dispatches"] == 2 * 2 * stats["steps"]


@pytest.mark.parametrize("replicas,paged", [(1, True), (1, False),
                                            (2, True), (2, False)],
                         ids=["R1-paged", "R1-dense", "R2-paged",
                              "R2-dense"])
def test_fused_tokens_equal_host_tokens(setup, replicas, paged):
    host = _run(setup, "torch", "host", replicas, paged)[0]
    assert _run(setup, "torch", "fused", replicas, paged)[0] == host


@pytest.mark.parametrize("transport", ["host", "fused"])
def test_eviction_churn_keeps_tokens(setup, transport):
    """A 2-slot cache forces evictions and slot reuse mid-run: tokens stay
    those of the run with every adapter resident (and the JAX engine's
    under the same churn), and the fused plane re-uploads its tables on
    every residency change."""
    base = _run(setup, "torch", "host", 2, True)[0]
    want, jstats, _, _ = _run(setup, "jax", transport, 2, True, slots=2)
    got, stats, _, sp = _run(setup, "torch", transport, 2, True, slots=2)
    assert got == want == base
    assert stats == jstats
    assert sp.sync_evictions > 0
    if transport == "fused":
        assert stats["lut_uploads"] > 2


@pytest.mark.parametrize("transport", ["host", "fused"])
def test_rank_aware_off_keeps_tokens(setup, transport):
    """Padded pool-rank compute gives the true-rank compute's tokens and
    bills every active row at the pool rank."""
    base = _run(setup, "torch", "host", 2, True)[0]
    got, stats, _, _ = _run(setup, "torch", transport, 2, True,
                            rank_aware=False)
    assert got == base
    assert stats["mean_active_rank"] == stats["max_active_rank"] == 8
    assert stats["rank_flop_savings"] == 0.0


def test_fused_uploads_only_on_residency_change(setup):
    *_, eng, sp = _run(setup, "torch", "fused", 1, True)
    tr = eng.transport
    n = tr.stats.lut_uploads
    assert tr.refresh() is False and tr.stats.lut_uploads == n
    sp.replicas[0].evict(3)
    assert tr.refresh() is True and tr.stats.lut_uploads == n + 1
    assert int(tr.view.slot_lut[3]) == -1


def test_fused_refresh_copies_only_written_slots(tiny_cfg, setup):
    """With R > 1 the stacked view is copied whole once; after that a
    refresh copies only the slots whose weights were written (an evict
    and a re-insert elsewhere), and the view stays equal to the
    replicas' pools."""
    tpool = setup["tpool"]
    sp = ServerPool.build(tiny_cfg, tpool, cache_slots=3, n_replicas=2,
                          dtype=torch.float32, device="cpu")
    res = _Residency(sp, tpool, 4)
    for aid in range(4):
        res.acquire(aid)
        res.release(aid)
    res.sync()
    tr = FusedTransport(sp, n_adapters=4)

    def stacked_equal():
        for n, t in tr.view.pools.items():
            want = torch.cat([rep.pool[n][0] for rep in sp.replicas], 1)
            assert torch.equal(t, want)

    assert tr.refresh()
    slot = sum(t[:, 0].numel() * 4 for t in tr.view.pools.values())
    assert tr.copied_bytes == 2 * 3 * slot
    stacked_equal()
    assert tr.refresh() is False and tr.copied_bytes == 6 * slot
    rep = sp.replicas[1]
    rep.evict(3)
    rep.insert(3, {n: 2 * t for n, t in
                   tls.pool_tensors_from_adapter(tpool, 3).items()},
               rank=tpool.rank_of(3))
    assert tr.refresh() and tr.copied_bytes == 7 * slot
    stacked_equal()
    rep.evict(1)                             # no weight written
    assert tr.refresh() and tr.copied_bytes == 7 * slot
    assert int(tr.view.slot_lut[1]) == -1


# --------------------------- slot-table units --------------------------- #
@pytest.fixture(scope="module")
def tiny_cfg(setup):
    return dataclasses.replace(setup["tcfg"], n_layers=1)


def _server(cfg, slots=4, rank=4):
    return tls.LoRAServer(cfg, tls.ServerConfig(m=1, x=1, y=1,
                                                cache_slots=slots,
                                                rank=rank),
                          dtype=torch.float32, device="cpu")


def _resolve(srv, ids):
    return srv.resolve_slots(torch.tensor(ids)).tolist()


def test_resolve_slots_lut_invalidated_on_insert_and_evict(tiny_cfg):
    """The device id -> slot table follows every insert and evict, in
    place: reusing a slot for another adapter never routes its rows to
    the evicted adapter's weights."""
    srv = _server(tiny_cfg, slots=2)
    lut, ranks = srv._lut.data_ptr(), srv._ranks_dev.data_ptr()
    s7 = srv.insert(7)
    assert _resolve(srv, [7, 3]) == [s7, -1]
    s3 = srv.insert(3)                       # insert AFTER a resolve
    assert _resolve(srv, [7, 3]) == [s7, s3]
    srv.evict(7)
    assert _resolve(srv, [7, 3]) == [-1, s3]
    s9 = srv.insert(9, rank=2)               # recycles adapter 7's slot
    assert s9 == s7
    assert _resolve(srv, [9, 7, 3]) == [s9, -1, s3]
    assert _resolve(srv, [-1, 10_000]) == [-1, -1]
    assert (srv._lut.data_ptr(), srv._ranks_dev.data_ptr()) == (lut, ranks)
    assert srv.row_ranks(torch.tensor([s9, s3, -1],
                                      dtype=torch.int32)).tolist() == [2, 4, 4]
    assert srv.mutations == 4 and srv.true_rank(9) == 2
    srv.evict(3)
    s200 = srv.insert(200)                   # a table that must grow
    assert srv._lut.data_ptr() != lut
    assert _resolve(srv, [200, 9, 3]) == [s200, s9, -1]


def test_resolve_slots_lut_rehomed_after_pool_resize(tiny_cfg, setup):
    """``resize_slots`` and replica add/remove force a full re-home sync;
    every replica's table reflects its post-re-home residency."""
    sp = ServerPool.build(tiny_cfg, setup["tpool"], cache_slots=6,
                          n_replicas=2, dtype=torch.float32, device="cpu")
    cache = LoRACache(6, adapter_bytes=0.0, n_layers=2, layerwise=False,
                      prefetch=False)
    for aid in (0, 1, 2, 3):
        cache.admit(aid, 0.0)
    sp.sync(cache)
    sp.check_consistent(cache)
    v0 = sp.version
    assert _resolve(sp.replicas[1], [1, 3]) != [-1, -1]
    sp.resize_slots(6)
    assert sp.version > v0 and sp._full_sync
    sp.sync(cache)
    sp.check_consistent(cache)
    sp.remove_replica()
    sp.sync(cache)
    sp.check_consistent(cache)
    assert all(s >= 0 for s in _resolve(sp.replicas[0], [0, 1, 2, 3]))


def test_make_transport_rejects_unknown_plane():
    with pytest.raises(ValueError, match="unknown transport"):
        make_transport("quantum", server=None)
    assert isinstance(make_transport("host", None), HostTransport)


def test_fused_transport_rejects_replicas_without_pools():
    class SlotTable:
        slot_of, mutations = {}, 0

    with pytest.raises(ValueError, match="slot pools"):
        FusedTransport(SlotTable()).refresh()


def test_device_view_matches_server_pool_compute(tiny_cfg):
    """``DeviceLoraView.compute`` (one call over the stacked pool) equals
    ``ServerPool.compute`` (one call per engaged replica, summed) bit for
    bit, and the JAX view's ``fused_hook_delta`` within 1e-6."""
    jcfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                               lora_targets=("gate", "up", "down"),
                               lora_rank=8)
    jpool = jadapter.init_adapter_pool(jcfg, 4, jax.random.PRNGKey(1),
                                       rank=4, dtype=jnp.float32)
    tcfg = bridge.config_from(jcfg)
    tpool = bridge.adapter_pool(
        tcfg, jax.tree_util.tree_map(np.asarray, jpool.tensors), jpool.rank,
        jpool.scale)
    jsp = jserver_pool.ServerPool.build(jcfg, jpool, cache_slots=4,
                                        n_replicas=2)
    tsp = ServerPool.build(tcfg, tpool, cache_slots=4, n_replicas=2,
                           dtype=torch.float32, device="cpu")
    for sp, fn in ((jsp, lambda a: jls.pool_tensors_from_adapter(jpool, a)),
                   (tsp, lambda a: tls.pool_tensors_from_adapter(tpool, a))):
        cache = LoRACache(4, adapter_bytes=0.0, n_layers=2, layerwise=False,
                          prefetch=False)
        for aid in range(4):
            cache.admit(aid, 0.0)
        sp.sync(cache, tensors_fn=fn)
    jtr, ttr = JFused(jsp, n_adapters=4), FusedTransport(tsp, n_adapters=4)
    jtr.refresh()
    ttr.refresh()
    assert isinstance(ttr.view, DeviceLoraView)
    rng = np.random.default_rng(0)
    E = tcfg.n_experts
    ads = np.array([0, 1, 2, 3, -1, 0, 3, 1], np.int32)
    eids = rng.integers(0, E, 8).astype(np.int32)
    tsp.route_step(ads)
    for hook, d_in in (("up", tcfg.d_model), ("down", tcfg.d_ff)):
        rows = rng.normal(size=(8, d_in)).astype(np.float32)
        for layer in range(tcfg.n_layers):
            args = (torch.from_numpy(rows), torch.from_numpy(ads),
                    torch.from_numpy(eids))
            want = tsp.compute(hook, layer, *args)
            got = fused_hook_delta(ttr.view, hook, layer, *args)
            assert torch.equal(got, want)
            ref = j_fused_hook_delta(jtr._view, hook, layer,
                                     jnp.asarray(rows), jnp.asarray(ads),
                                     jnp.asarray(eids))
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=0, atol=1e-6)


def test_server_pool_routes_from_host_ids(tiny_cfg, setup):
    """With the step's host-side ids handed over, ``compute`` engages only
    the replicas that own an active row (one launch each), else one; an
    unrouted call is refused rather than read the ids from the device."""
    sp = ServerPool.build(tiny_cfg, setup["tpool"], cache_slots=4,
                          n_replicas=2, dtype=torch.float32, device="cpu")
    rows = torch.zeros(4, tiny_cfg.d_model)
    eids = torch.zeros(4, dtype=torch.int32)
    sp.route_step(np.array([2, 4, -1, -1]))
    sp.compute("up", 0, rows, torch.tensor([2, 4, -1, -1]), eids)
    assert sp.replica_launches == 1
    sp.route_step(np.array([1, 2, -1, -1]))
    sp.compute("up", 0, rows, torch.tensor([1, 2, -1, -1]), eids)
    assert sp.replica_launches == 3
    sp.route_step(np.full(4, -1))
    sp.compute("up", 0, rows, torch.full((4,), -1), eids)
    assert sp.replica_launches == 4 and sp.compute_calls == 3
    sp.route_step(None)
    with pytest.raises(RuntimeError, match="route_step"):
        sp.compute("up", 0, rows, torch.tensor([1, 2, -1, -1]), eids)
    assert sp.replica_launches == 4 and sp.compute_calls == 3


# ---------------------- server pool and LoRA cache ---------------------- #
def _cache(slots=8):
    return LoRACache(slots, adapter_bytes=0.0, n_layers=4, layerwise=False,
                     prefetch=False)


def _pool(cfg, setup, replicas, slots=8):
    return ServerPool.build(cfg, setup["tpool"], cache_slots=slots,
                            n_replicas=replicas, dtype=torch.float32,
                            device="cpu")


def test_server_pool_delta_sync_and_noop_rounds(tiny_cfg, setup):
    cache, pool = _cache(4), _pool(tiny_cfg, setup, 2, 4)
    cache.admit(0, 0.0)
    cache.admit(1, 0.0)
    assert pool.sync(cache) == 2
    pool.check_consistent(cache)
    assert pool.sync(cache) == 0 and pool.sync_noops == 1
    cache.admit(5, 1.0)
    assert pool.sync(cache) == 1
    cache.admit(2, 2.0)
    cache.admit(3, 3.0)
    cache.admit(9, 4.0)                      # evicts adapter 0 (LRU)
    assert not cache.is_resident(0)
    assert pool.sync(cache) >= 2
    assert not pool.is_resident(0) and pool.is_resident(9)
    pool.check_consistent(cache)


def test_server_pool_affinity_partitions_adapters(tiny_cfg, setup):
    cache, pool = _cache(8), _pool(tiny_cfg, setup, 3)
    for aid in range(6):
        cache.admit(aid, 0.0)
    pool.sync(cache)
    for aid in range(6):
        for i, rep in enumerate(pool.replicas):
            assert rep.is_resident(aid) == (i == aid % 3)
    pool.check_consistent(cache)


def test_server_pool_resize_forces_full_rehome(tiny_cfg, setup):
    cache, pool = _cache(8), _pool(tiny_cfg, setup, 1)
    for aid in range(5):
        cache.admit(aid, 0.0)
    pool.sync(cache)
    pool.add_replica()
    pool.sync(cache)
    pool.check_consistent(cache)
    assert pool.replicas[1].is_resident(1) and pool.replicas[1].is_resident(3)
    assert not pool.replicas[0].is_resident(1)
    pool.remove_replica()
    pool.sync(cache)
    assert all(pool.replicas[0].is_resident(a) for a in range(5))
    with pytest.raises(RuntimeError):
        pool.remove_replica()


def test_server_pool_rank_surface(tiny_cfg, setup):
    pool = ServerPool.build(tiny_cfg, setup["tpool"], cache_slots=3,
                            n_replicas=3, dtype=torch.float32, device="cpu")
    assert pool.min_slots == 3
    pool.add_replica()
    assert pool.n_replicas == 4 and pool.min_slots == 3
    assert pool.pool_rank == setup["tpool"].rank
    pool.set_rank_aware(False)
    assert not any(rep.rank_aware for rep in pool.replicas)
    pool.replicas[1].insert(6, rank=2)
    assert pool.true_rank(6) == 0            # read on 6's home, replica 2
    pool.replicas[1].insert(5, rank=2)
    assert pool.true_rank(5) == 2
    assert pool.replicas[0].cache_bytes() == sum(
        t.numel() * 4 for t in pool.replicas[0].pool.values())


def test_cache_pin_evict_lru():
    c = LoRACache(capacity=2, adapter_bytes=1e9, n_layers=10,
                  layerwise=False, prefetch=False)
    assert c.admit(1, now=0.0) is not None
    assert c.admit(2, now=1.0) is not None
    c.pin(1)
    assert c.admit(3, now=2.0) is not None  # 2 is LRU-unpinned: evicted
    assert c.is_resident(1) and c.is_resident(3) and not c.is_resident(2)
    c.pin(3)
    assert c.admit(4, now=3.0) is None      # everything pinned
    c.unpin(1, now=4.0)
    assert c.admit(4, now=5.0) is not None
    assert c.drain_dirty() == {1, 2, 3, 4} and c.drain_dirty() == set()


def test_cache_layerwise_loading_is_l_times_faster_to_first_use():
    kw = dict(capacity=4, adapter_bytes=32 * 50e9, n_layers=32)
    assert LoRACache(layerwise=False, **kw).admit(0, 0.0) == \
        pytest.approx(32.0)
    assert LoRACache(layerwise=True, **kw).admit(0, 0.0) == \
        pytest.approx(1.0)


def test_cache_resize_shrink_converges_after_pins_release():
    c = _cache(8)
    for a in range(8):
        c.admit(a, 0.0)
        c.pin(a)
    assert c.resize(3, 1.0) == []
    assert len(c.resident) == 8
    for a in range(8):
        c.unpin(a, 2.0)
    assert c.admit(100, 3.0) is not None
    assert len(c.resident) == 3


def test_cache_per_home_admission():
    cache = LoRACache(4, adapter_bytes=1, n_layers=1, host_bw=float("inf"))
    cache.set_partition(lambda a: a % 2, {0: 1, 1: 1})
    assert cache.admit(0, 0.0) is not None
    assert cache.admit(1, 0.0) is not None
    cache.pin(0)
    ev = cache.evictions
    assert cache.admit(2, 1.0) is None
    assert cache.evictions == ev and 0 in cache.resident
    cache.unpin(0, 1.0)
    assert cache.admit(2, 2.0) is not None
    assert 0 not in cache.resident and 2 in cache.resident
    cache.drain_dirty()
    evicted = cache.repartition(lambda a: 0, {0: 1}, 3.0)
    assert len(evicted) == 1 and len(cache.resident) == 1
    assert set(evicted) <= cache.dirty


def test_cache_invalidate_refuses_pinned_adapter():
    cache = LoRACache(capacity=2, adapter_bytes=1 << 20, n_layers=4)
    cache.admit(0, now=0.0)
    cache.pin(0)
    with pytest.raises(ValueError):
        cache.invalidate(0)
    cache.unpin(0, now=1.0)
    assert cache.invalidate(0) is True and not cache.is_resident(0)
    assert cache.stats()["evictions"] == 1
    assert cache.invalidate(0) is False


# --------------------------- engine surface ----------------------------- #
def test_engine_surface(setup):
    """n_pages, free_pages, has_request, release_kv, and no transport on
    the coupled plane."""
    cfg, params = setup["tcfg"], setup["tparams"]
    ecfg = tengine.EngineConfig(n_pages=5, **ENGINE)
    eng = tengine.Engine(cfg, params, ecfg, device="cpu")
    assert eng.transport is None and eng.transport_stats() == {}
    assert eng.free_pages() == 5
    eng.add_request(0, setup["prompts"][0], 0)
    assert eng.has_request(0) and eng.free_pages() == 3
    with pytest.raises(RuntimeError, match="resident"):
        eng.release_kv()
    eng.evict_request(0)
    eng.release_kv()
    assert eng._k is None and eng.free_pages() == 5
    eng.add_request(1, setup["prompts"][1], 1)
    assert eng._k is not None and eng.step()
    dense = tengine.Engine(cfg, params, tengine.EngineConfig(
        paged=False, **ENGINE), device="cpu")
    with pytest.raises(RuntimeError, match="paged"):
        dense.free_pages()


def test_serve_fused_replicas_on_cpu(capsys):
    assert tserve.main(["--reduced", "--device", "cpu", "--transport",
                        "fused", "--replicas", "2"]) == 0
    out = capsys.readouterr().out
    assert '"transport": "fused"' in out and "generated:" in out


def test_serve_residency_churn_keeps_tokens():
    """Serving through the front door with a 2-slot cache in front of a
    pool of 2 replicas (requests wait for residency, adapters are evicted
    and brought back) gives the tokens of the engine-level run with every
    adapter resident, on both transports."""
    traffic = dataclasses.replace(tserve.Traffic(), n_requests=6,
                                  prompt_len=(6, 20), new_tokens=4,
                                  second_wave_after=2)
    cfg, params, _, ecfg = tserve.build(
        "qwen3-moe-235b-a22b", layers=1, reduced=True, device="cpu",
        traffic=traffic, mode="coupled")
    reqs = tserve.make_requests(cfg, traffic)
    full = tserve.build_pool(cfg, traffic.adapter_ranks, 1, device="cpu",
                             dtype=torch.float32)
    want = tserve.serve(tengine.Engine(cfg, params, ecfg, device="cpu",
                                       **full), reqs, traffic)["tokens"]
    for transport in ("host", "fused"):
        system = build_system(tserve.serve_config(
            traffic, transport=transport, replicas=2,
            adapter_cache_slots=2), cfg, params=params, pool=full["pool"])
        res = tserve.serve_system(system, reqs, traffic)
        system.close()
        assert res["tokens"] == want
        assert system.backend.cluster.server_pool.sync_evictions > 0


# ------------------------------ on the card ----------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs)")
    return torch.device("cuda")


def _card_engine(setup, transport, replicas=1, paged=True):
    dev = "cuda"
    params = bridge.tree_to_tensors(jax.tree_util.tree_map(
        np.asarray, setup["params"]), device=dev)
    pool = bridge.adapter_pool(
        setup["tcfg"], jax.tree_util.tree_map(np.asarray,
                                              setup["pool"].tensors),
        setup["pool"].rank, setup["pool"].scale, setup["pool"].ranks,
        device=dev)
    sp = ServerPool.build(setup["tcfg"], pool, cache_slots=4,
                          n_replicas=replicas, dtype=torch.float32,
                          device=dev)
    res = _Residency(sp, pool, 4)
    for aid in range(pool.n):               # every adapter resident
        res.acquire(aid)
        res.release(aid)
    eng = tengine.Engine(setup["tcfg"], params, tengine.EngineConfig(
        paged=paged, **ENGINE), sp, device=dev, pool=pool,
        transport=transport)
    return eng, res


@pytest.mark.gpu
@pytest.mark.parametrize("replicas,paged", [(1, True), (2, True),
                                            (1, False)],
                         ids=["R1-paged", "R2-paged", "R1-dense"])
def test_graph_replay_equals_eager(cuda_device, setup, replicas, paged):
    """Captured graphs replayed give the host plane's eager tokens bit for
    bit, one capture a bucket, and each capture holds one step's kernels;
    the graph pool's bytes are counted."""
    host, hres = _card_engine(setup, "host", replicas, paged)
    fused, fres = _card_engine(setup, "fused", replicas, paged)
    want = _drive(host, hres, setup["prompts"])
    assert _drive(fused, fres, setup["prompts"]) == want
    caps = fused.transport.captures
    assert len(caps) == len({c["bucket"] for c in caps}) > 0
    L = setup["tcfg"].n_layers
    per_step = {"gmm": 3 * L, "bgmv_expert": 2 * L,
                **({"paged_attention": L} if paged else {})}
    assert all(c["launches"] == per_step for c in caps)
    assert sum(c["pool_bytes_added"] for c in caps) > 0
    st = fused.transport_stats()
    assert st["host_dispatches"] == st["steps"] and st["hook_dispatches"] == 0


@pytest.mark.gpu
def test_replay_sees_in_place_table_update(cuda_device, setup):
    """An evict + insert between steps rewrites the view's tables in place:
    the next replay reads them, with no new capture, and gives the host
    plane's tokens for the same residency."""
    outs = []
    for transport in ("host", "fused"):
        eng, res = _card_engine(setup, transport)
        res.sync()
        eng.add_request(0, setup["prompts"][0], 0)
        eng.add_request(1, setup["prompts"][1], 3)
        toks = [eng.step()]
        sp = eng.server
        sp.replicas[0].evict(3)                # adapter 3 leaves ...
        sp.replicas[0].insert(3, tls.pool_tensors_from_adapter(
            eng.pool, 0), rank=2)              # ... and returns as 0's
        toks.append(eng.step())
        outs.append(toks)
        if transport == "fused":
            assert len(eng.transport.captures) == 1
            assert eng.transport.stats.lut_uploads == 2
    assert outs[0] == outs[1]

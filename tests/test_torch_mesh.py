"""The port's mesh-sharded serving plane (``ServeConfig.mesh_shape``)
against the JAX reference, and against the port's own plane without a
mesh:

  - ``ShardingRules.spec`` and ``rules_for`` for train, prefill and decode
    equal the reference's on a fake mesh, for four grids and every
    registered config (the divisibility dropping included);
    ``expert_parallel_ctx`` gives the reference's axis and size;
    ``Placement.from_mesh_shape`` equals the reference's
  - ``make_serve_mesh`` (the "needs n devices" error without cards, a grid
    on the CPU), ``carve_server_submesh`` and ``instance_submesh``
  - the ``mesh_shape`` validation messages, the partitioned
    ``ServerPool`` and the cache's per-home admission (the reference's
    numbers, after ``tests/test_distributed.py``)
  - the base expert GEMMs over blocks of 2 and 4 experts == one call,
    bit for bit; ``Engine(mesh_ctx=)`` cuts the params into blocks once
  - the EP x PP LoRA Server == the flat one (``torch.equal``) and within
    1e-6 of the reference's flat server
  - serving under a mesh on the CPU (grids (2, 1), (4, 1), (2, 2) of one
    device): the tokens of the port's run without a mesh, bit for bit,
    dense and paged x host and fused, under churn and an autoscaler
    resize, one dispatch a fused step; one cell also against the
    reference's tokens
The card's tests of the plane are ``tests/test_torch_mesh_card.py``.

Weights come from the JAX initialisers, bridged through numpy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs
from repro.core import adapter as jadapter
from repro.core import lora_server as jls
from repro.core.placement import Placement as JPlacement
from repro.distributed import sharding as jsharding
from repro.distributed import steps as jsteps
from repro.models import model as jmodel
from repro.serving import api as japi
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.core import lora_server as tls
from repro_torch.core.placement import Placement
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed import steps as tsteps
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve
from repro_torch.models import moe as tmoe
from repro_torch.serving.api import ServeConfig, build_system
from repro_torch.serving.autoscaler import AutoscalePolicy
from repro_torch.serving.cache import LoRACache
from repro_torch.serving.cluster import Cluster, ClusterConfig
from repro_torch.serving.engine import Engine
from repro_torch.serving.server_pool import AnalyticReplica, ServerPool

GRIDS = [(2, 1), (4, 1), (2, 2), (4, 4)]
# (adapter, arrival, prompt_len, output_len), tests/test_distributed.py's
SPECS = [(0, 0.0, 5, 6), (1, 0.0, 4, 4), (2, 2.0, 6, 5), (3, 5.0, 3, 4)]
RANKS = [2, 8, 4, 8]
CPU = ["cpu"]


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread is as fast alone, and
    spares the other test workers on the host its threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------- rules and meshes --------------------------- #
def _logical_cases(cfg):
    """(logical axes, shape) pairs over the config's widths."""
    d, H, E = cfg.d_model, cfg.n_heads, max(cfg.n_experts, 1)
    hd, ff, V = cfg.head_dim, cfg.d_ff, cfg.vocab_size
    return [
        (("batch", "seq", "embed"), (8, 64, d)),
        (("batch", None, "heads", None), (8, 16, H, hd)),
        (("batch", "kv_seq", "kv_heads", None), (8, 128, cfg.n_kv_heads,
                                                 hd)),
        (("fsdp", "qkv_out"), (d, (H + 2 * cfg.n_kv_heads) * hd)),
        (("layers", "experts", "embed", "moe_ff"), (cfg.n_layers, E, d, ff)),
        (("layers", "experts", "moe_ff", "embed"), (cfg.n_layers, E, ff, d)),
        (("fsdp", "mlp"), (d, ff)),
        (("embed", "vocab"), (d, V)),
        (("batch", "seq", "vocab"), (8, 64, V)),
        (("lora_adapters", "embed", "lora_rank"), (16, d, 8)),
        (("batch", "seq", "ssm_inner"), (8, 64, 2 * d)),
        (("experts", "moe_ff"), (E, None)),
        (("batch", "seq", "embed"), None),
    ]


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_rules_equal_reference_for_every_config(grid):
    fake = FakeMesh(grid, ("data", "model"))
    for arch in list_archs():
        jcfg = get_config(arch)
        tcfg = tget_config(arch)
        for kind in ("train", "prefill", "decode"):
            jr = jsteps.rules_for(fake, kind, jcfg)
            tr = tsteps.rules_for(fake, kind, tcfg)
            assert tr.rules == jr.rules, (arch, kind)
            for axes, shape in _logical_cases(tcfg):
                assert tr.spec(axes, shape) == tuple(jr.spec(axes, shape)), \
                    (arch, kind, axes, shape)
    with pytest.raises(ValueError):
        tsteps.rules_for(fake, "serve", tcfg)


def test_rules_divisibility_dropping():
    r = tsharding.ShardingRules(FakeMesh((4, 4), ("data", "model")))
    jr = jsharding.ShardingRules(FakeMesh((4, 4), ("data", "model")))
    # 15 heads cannot shard 4 ways -> replicated
    assert r.spec(("batch", None, "heads", None), (8, 16, 15, 64))[2] is None
    assert r.spec(("batch", None, "heads", None), (8, 16, 16, 64))[2] == \
        "model"
    # one mesh axis never covers two dims
    spec = r.spec(("batch", "seq", "embed"), (8, 64, 128))
    flat = [a for s in spec if s is not None
            for a in ((s,) if isinstance(s, str) else s)]
    assert len(flat) == len(set(flat))
    # a pod axis the mesh lacks is dropped; overrides apply
    o = {"batch": ("pod", "data", "model"), "experts": None}
    r2 = tsharding.ShardingRules(FakeMesh((2, 4), ("data", "model")), o)
    j2 = jsharding.ShardingRules(FakeMesh((2, 4), ("data", "model")), o)
    for axes, shape in ((("batch", "experts"), (16, 8)),
                        (("batch", "experts"), (6, 8)),
                        (("batch", "batch"), (16, 16))):
        assert r2.spec(axes, shape) == tuple(j2.spec(axes, shape))
        assert r.spec(axes, shape) == tuple(jr.spec(axes, shape))
    # the active rules and mesh_axis_size
    assert tsharding.active_rules() is None
    assert tsharding.mesh_axis_size("model") == 1
    with tsharding.use_rules(r2):
        assert tsharding.active_rules() is r2
        assert tsharding.mesh_axis_size("model") == 4
        assert tsharding.mesh_axis_size("pod") == 1
    assert tsharding.active_rules() is None


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "mixtral-8x7b",
                                  "dbrx-132b"])
def test_expert_parallel_ctx_equals_reference(arch):
    for grid in GRIDS + [(1, 1), (1, 4), (3, 1), (8, 2)]:
        fake = FakeMesh(grid, ("data", "model"))
        jctx = jsteps.expert_parallel_ctx(fake, get_config(arch))
        tctx = tsteps.expert_parallel_ctx(fake, tget_config(arch))
        if jctx is None:
            assert tctx is None, (arch, grid)
            continue
        assert (tctx.axis, tctx.size) == (jctx.axis, jctx.size), (arch, grid)
        assert len(tctx.devices) == tctx.size
    # the blocks' devices in axis order, at index 0 of the model axis
    cards = [torch.device("cuda", i) for i in range(8)]
    mesh = tmesh.Mesh(tmesh.grid(cards, (4, 2)), ("data", "model"))
    ctx = tsteps.expert_parallel_ctx(mesh, tget_config(arch))
    assert ctx.devices == tuple(cards[0::2])


def test_placement_from_mesh_shape_equals_reference():
    p = Placement.from_mesh_shape((4, 1), 16, 2, 8)
    assert p.describe() == "EP4-PP1" and p.m == 4
    for shape in ((1, 1), (2, 1), (4, 1), (2, 2), (8, 4), (0, 1)):
        tp = Placement.from_mesh_shape(shape, 16, 6, 8)
        jp = JPlacement.from_mesh_shape(shape, 16, 6, 8)
        assert (tp.describe(), tp.m, tp.x, tp.y) == \
            (jp.describe(), jp.m, jp.x, jp.y)
        for a, l, e in np.ndindex(5, 6, 8):
            assert tp.owner(a, l, e) == jp.owner(a, l, e)


def test_serve_mesh_and_submeshes():
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match=r"needs 2 devices but only 0"):
            tmesh.make_serve_mesh(2, 1)
    m = tmesh.make_serve_mesh(2, 2, devices=CPU)
    assert m.shape == {"data": 2, "model": 2}
    assert set(m.devices.flat) == {torch.device("cpu")}
    cards = [torch.device("cuda", i) for i in range(8)]
    pod = tmesh.Mesh(tmesh.grid(cards, (2, 4)), ("data", "model"))
    srv = tmesh.carve_server_submesh(pod, 2, 1)
    assert srv.axis_names == ("ep", "pp")
    assert list(srv.devices.flat) == cards[-2:]
    inst = tmesh.instance_submesh(pod, 2, 3, 2)
    assert inst.shape == {"data": 3, "model": 2}
    assert list(inst.devices.flat) == cards[:6]
    with pytest.raises(ValueError):
        tmesh.instance_submesh(pod, 3, 3, 2)
    with pytest.raises(ValueError):
        tmesh.carve_server_submesh(pod, 3, 3)
    with pytest.raises(ValueError, match="needs 4 devices, 2 given"):
        tmesh.make_serve_mesh(2, 2, devices=cards[:2])
    srv = tls.make_server_mesh(2, 2, devices=CPU)
    assert srv.shape == {"ep": 2, "pp": 2}


# ------------------------- validation and pools ------------------------- #
def test_mesh_shape_validation(setup):
    for bad, msg in (
            (dict(backend="cluster", disaggregated=False, mesh_shape=(2, 1)),
             "disaggregated"),
            (dict(backend="sim", disaggregated=True, mesh_shape=(2, 1)),
             "cluster"),
            (dict(backend="cluster", disaggregated=True, mesh_shape=(0, 1)),
             "positive"),
            (dict(backend="cluster", disaggregated=True,
                  mesh_shape=(2, 1, 1)), "two positive ints")):
        with pytest.raises(ValueError, match=msg) as got:
            ServeConfig(**bad)
        with pytest.raises(ValueError) as want:
            japi.ServeConfig(**bad)
        assert str(got.value) == str(want.value)
    sc = ServeConfig(disaggregated=True, mesh_shape=(2, 1))
    assert sc.cluster_config().mesh_shape == (2, 1)
    # the cluster: coupled and non-positive grids refused with the
    # front door's messages (one validator, launch.mesh.check_mesh_shape)
    with pytest.raises(ValueError, match="requires disaggregated=True"):
        Cluster(setup["tcfg"], setup["tparams"],
                ClusterConfig(mesh_shape=(2, 1)), setup["tpool"])
    with pytest.raises(ValueError, match="two positive ints"):
        Cluster(setup["tcfg"], setup["tparams"],
                ClusterConfig(disaggregated=True, mesh_shape=(2, 0)),
                setup["tpool"])


def test_server_pool_partitioning(setup):
    pool = ServerPool([AnalyticReplica(3) for _ in range(3)],
                      factory=lambda: AnalyticReplica(3))
    assert not pool.partitioned
    assert pool.total_slots == pool.min_slots == 3
    pool.partitioned = True
    assert pool.total_slots == 9             # capacities add when partitioned
    assert pool.partition_caps() == {0: 3, 1: 3, 2: 3}
    pool.add_replica()             # the factory keeps replica sizes equal
    assert pool.total_slots == 12
    # the real plane's build: ceil(5 / 2) = 3 slots a replica
    cfg, tpool = setup["tcfg"], setup["tpool"]
    sp = ServerPool.build(cfg, tpool, cache_slots=5, n_replicas=2,
                          device="cpu", partition_slots=True)
    assert sp.partitioned and [r.M for r in sp.replicas] == [3, 3]
    assert sp.total_slots == 6 and sp.partition_caps() == {0: 3, 1: 3}
    sp.add_replica()
    assert [r.M for r in sp.replicas] == [3, 3, 3]
    dup = ServerPool.build(cfg, tpool, cache_slots=5, n_replicas=2,
                           device="cpu")
    assert not dup.partitioned and dup.total_slots == 5
    # a partitioned pool's bound is the sum: 4 slots fit 2 x 2
    two = ServerPool.build(cfg, tpool, cache_slots=4, n_replicas=2,
                           device="cpu", partition_slots=True)
    Cluster(cfg, setup["tparams"],
            ClusterConfig(disaggregated=True, adapter_cache_slots=4,
                          mesh_shape=(2, 1)), tpool, server_pool=two)
    with pytest.raises(ValueError, match="aggregate capacity 4"):
        Cluster(cfg, setup["tparams"],
                ClusterConfig(disaggregated=True, adapter_cache_slots=5,
                              mesh_shape=(2, 1)), tpool, server_pool=two)


def test_cache_per_home_admission():
    cache = LoRACache(4, adapter_bytes=1, n_layers=1, host_bw=float("inf"))
    cache.set_partition(lambda a: a % 2, {0: 1, 1: 1})
    assert cache.admit(0, 0.0) is not None   # home 0
    assert cache.admit(1, 0.0) is not None   # home 1
    cache.pin(0)
    # home 0 full of pinned residents: admit bails without evicting
    ev_before = cache.evictions
    assert cache.admit(2, 1.0) is None
    assert cache.evictions == ev_before and 0 in cache.resident
    # an unpinned home resident is evicted for a same-home id
    cache.unpin(0, 1.0)
    assert cache.admit(2, 2.0) is not None
    assert 0 not in cache.resident and 2 in cache.resident
    # repartition to one home of cap 1: the LRU unpinned overflow goes
    cache.drain_dirty()
    evicted = cache.repartition(lambda a: 0, {0: 1}, 3.0)
    assert len(evicted) == 1
    assert sum(1 for _ in cache.resident) == 1
    assert set(evicted) <= cache.dirty       # evictions reach the next sync


# ------------------------------ the GEMMs ------------------------------- #
def _dispatch(E, C, d, f, seed):
    rng = np.random.default_rng(seed)
    xe = torch.from_numpy(rng.standard_normal((E, C, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, d, f)).astype(np.float32))
    sizes = torch.from_numpy(rng.integers(0, C + 1, E).astype(np.int32))
    sizes[1] = 0                              # an empty expert
    return xe, w, sizes


@pytest.mark.parametrize("data", [2, 4])
def test_ep_gmm_mapped_equals_plain(data):
    """The hook layer's base GEMMs (``moe.expert_gmm``) over the params'
    expert blocks == one ``ops.gmm`` over every expert, bit for bit."""
    ctx = tsteps.expert_parallel_ctx(tmesh.make_serve_mesh(data, 1, CPU),
                                     tget_config("qwen3-moe-235b-a22b"))
    assert ctx.size == data
    for E, C, d, f in ((8, 12, 64, 48), (4, 4, 128, 256)):
        xe, w, sizes = _dispatch(E, C, d, f, seed=E + data)
        want = ops.gmm(xe, w, sizes)
        blocks = tmoe.ExpertBlocks.cut(w, ctx.devices)
        assert [b.shape[0] for b in blocks.blocks] == [E // data] * data
        assert blocks.blocks[0].data_ptr() == w.data_ptr()   # views
        assert torch.equal(tmoe.expert_gmm(xe, blocks, sizes), want)
        assert torch.equal(tmoe.expert_gmm(xe, blocks, None),
                           ops.gmm(xe, w, None))
        # the same blocks through shard_serve_params and a layer's index
        params = {"layers": {"moe": {"gate": w[None]}}}
        sharded = tsteps.shard_serve_params(params, ctx)
        gate = sharded["layers"]["moe"]["gate"]
        assert torch.equal(tmoe.expert_gmm(xe, gate[0], sizes), want)


def test_ep_gmm_takes_the_plain_path_where_e_does_not_divide(monkeypatch):
    """A weight whose E does not divide the ctx's size stays whole in the
    params, and its GEMM is the plain call."""
    ctx = tsteps.expert_parallel_ctx(tmesh.make_serve_mesh(4, 1, CPU),
                                     tget_config("qwen3-moe-235b-a22b"))

    def no_cut(*a, **k):
        raise AssertionError("cut a weight whose E does not divide")

    monkeypatch.setattr(tmoe.ExpertBlocks, "cut", no_cut)
    xe, w, sizes = _dispatch(6, 8, 32, 16, seed=3)
    params = {"layers": {"moe": {"gate": w[None]}}}
    kept = tsteps.shard_serve_params(params, ctx)["layers"]["moe"]["gate"]
    assert isinstance(kept, torch.Tensor)
    assert torch.equal(tmoe.expert_gmm(xe, kept[0], sizes),
                       ops.gmm(xe, w, sizes))


def test_engine_under_a_mesh_shards_its_params_once(setup):
    """``Engine(mesh_ctx=)`` cuts raw params into the ctx's blocks once,
    keeps blocks the params already hold, leaves the caller's tree as it
    is, and refuses a mesh without a server with the reference's
    message."""
    cfg, params = setup["tcfg"], setup["tparams"]
    ctx = tsteps.expert_parallel_ctx(tmesh.make_serve_mesh(2, 1, CPU), cfg)
    lora = serve.build_pool(cfg, RANKS, 2, dtype=torch.float32,
                            device="cpu", partition_slots=True)
    eng = Engine(cfg, params, serve.ENGINE, device="cpu", mesh_ctx=ctx,
                 **lora)
    for name in ("gate", "up", "down"):
        blk = eng.params["layers"]["moe"][name]
        assert isinstance(blk, tmoe.ExpertBlocks) and len(blk.blocks) == 2
        assert isinstance(params["layers"]["moe"][name], torch.Tensor)
    pre = tsteps.shard_serve_params(params, ctx)
    again = Engine(cfg, pre, serve.ENGINE, device="cpu", mesh_ctx=ctx,
                   **lora)
    assert again.params["layers"]["moe"]["up"] is pre["layers"]["moe"]["up"]
    with pytest.raises(ValueError, match="requires the disaggregated "
                                         "plane") as got:
        Engine(cfg, params, serve.ENGINE, device="cpu", mesh_ctx=ctx)
    assert "reassociates floats" in str(got.value)


def test_shard_serve_params_views_and_values(setup):
    params = setup["tparams"]
    cfg = setup["tcfg"]
    ctx = tsteps.expert_parallel_ctx(tmesh.make_serve_mesh(2, 1, CPU), cfg)
    sharded = tsteps.shard_serve_params(params, ctx)
    moe = params["layers"]["moe"]
    for name in ("gate", "up", "down"):
        blk = sharded["layers"]["moe"][name]
        assert isinstance(blk, tmoe.ExpertBlocks)
        assert tuple(blk.shape) == tuple(moe[name].shape)
        assert torch.equal(torch.cat(blk.blocks, dim=1), moe[name])
        assert blk.blocks[1].data_ptr() == moe[name][:, 2].data_ptr()
    # everything else is the same tensor; the caller's tree is untouched
    assert sharded["layers"]["moe"]["router"] is moe["router"]
    assert sharded["embed"] is params["embed"]
    assert isinstance(params["layers"]["moe"]["gate"], torch.Tensor)
    odd = tsteps.ExpertParallelCtx(ctx.mesh, "data", 3, ctx.devices * 2)
    kept = tsteps.shard_serve_params(params, odd)  # E = 4 does not split
    assert kept["layers"]["moe"]["gate"] is moe["gate"]


# ------------------------- the EP x PP LoRA Server ----------------------- #
@pytest.mark.parametrize("xy", [(2, 1), (1, 2), (2, 2)], ids=str)
def test_ep_pp_server_equals_flat_and_reference(xy):
    x, y = xy
    jcfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                               n_layers=4)
    tcfg = bridge.config_from(jcfg)
    L, E, d, ff, r = jcfg.n_layers, jcfg.n_experts, jcfg.d_model, \
        jcfg.d_ff, 8
    rng = np.random.default_rng(sum(xy))
    shapes = {"up_A": (L, E, d, 2 * r), "up_B": (L, E, 2 * r, 2 * ff),
              "down_A": (L, E, ff, r), "down_B": (L, E, r, d)}
    adapters = {a: {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
                    for n, s in shapes.items()} for a in range(4)}
    jscfg = jls.ServerConfig(m=x * y, x=x, y=y, cache_slots=4, rank=r)
    jsrv = jls.LoRAServer(jcfg, jscfg, dtype=jnp.float32)
    tscfg = tls.ServerConfig(m=x * y, x=x, y=y, cache_slots=4, rank=r)
    flat = tls.LoRAServer(tcfg, tscfg, dtype=torch.float32, device="cpu")
    mesh = tls.LoRAServer(tcfg, tscfg, dtype=torch.float32,
                          mesh=tls.make_server_mesh(x, y, CPU))
    assert mesh.placement().describe() == jsrv.placement().describe()
    assert mesh.cache_bytes() == flat.cache_bytes()
    for a, rank in zip(range(4), RANKS):
        jsrv.insert(a, {n: jnp.asarray(t) for n, t in adapters[a].items()},
                    rank=rank)
        for srv in (flat, mesh):
            srv.insert(a, {n: torch.from_numpy(t)
                           for n, t in adapters[a].items()}, rank=rank)
    C = 6
    eids = np.arange(E * C, dtype=np.int32) // C      # expert-major rows
    ids = rng.integers(-1, 4, E * C).astype(np.int32)
    for hook, d_in in (("up", d), ("down", ff)):
        rows = rng.standard_normal((E * C, d_in)).astype(np.float32)
        args = [torch.from_numpy(a) for a in (rows, ids, eids)]
        for layer in range(L):
            want = flat.compute(hook, layer, *args)
            got = mesh.compute(hook, layer, *args)
            assert torch.equal(got, want), (hook, layer)
            jgot = np.asarray(jsrv.compute(hook, layer, jnp.asarray(rows),
                                           ids, eids))
            np.testing.assert_allclose(got.numpy(), jgot, rtol=0, atol=1e-6)
    # an evicted adapter's rows give exact zeros on both paths
    for srv in (flat, mesh):
        srv.evict(1)
    rows = torch.from_numpy(rng.standard_normal((E * C, d))
                            .astype(np.float32))
    one = torch.full((E * C,), 1, dtype=torch.int32)
    assert not mesh.compute("up", 1, rows, one, torch.from_numpy(eids)).any()
    if x > 1:
        with pytest.raises(ValueError, match="do not split"):
            mesh.compute("up", 0, rows[:-1], one[:-1],
                         torch.from_numpy(eids[:-1]))


# --------------------------- mesh serving ------------------------------ #
@pytest.fixture(scope="module")
def setup():
    """tests/test_distributed.py's serving cell: reduced qwen3-moe in f32,
    adapters on gate/up/down of true ranks [2, 8, 4, 8] in a rank-8 pool."""
    jcfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                               lora_targets=("gate", "up", "down"),
                               lora_rank=8)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0),
                                dtype="float32")
    pool = jadapter.init_mixed_rank_pool(jcfg, RANKS, jax.random.PRNGKey(1),
                                         dtype="float32")
    tcfg = bridge.config_from(jcfg)
    tparams = bridge.tree_to_tensors(jax.tree_util.tree_map(np.asarray,
                                                            params))
    tpool = bridge.adapter_pool(
        tcfg, jax.tree_util.tree_map(np.asarray, pool.tensors), pool.rank,
        pool.scale, pool.ranks)
    return dict(jcfg=jcfg, params=params, pool=pool, tcfg=tcfg,
                tparams=tparams, tpool=tpool, runs={})


def _serve_kw(transport, mesh_shape, paged, cache_slots, autoscale):
    return dict(backend="cluster", disaggregated=True, n_instances=1,
                max_batch=2, max_len=32, adapter_cache_slots=cache_slots,
                transport=transport, server_replicas=2, paged=paged,
                page_size=4, n_pages=8, prefill_chunk=8, autoscale=autoscale,
                mesh_shape=mesh_shape)


def _serve(setup, transport, mesh_shape, paged=False, cache_slots=4,
           autoscale=None):
    """One drained run of SPECS through the port's front door, cached:
    (tokens per rid, transport stats)."""
    key = (transport, mesh_shape, paged, cache_slots, autoscale is not None)
    if key not in setup["runs"]:
        sc = ServeConfig(**_serve_kw(transport, mesh_shape, paged,
                                     cache_slots, autoscale))
        system = build_system(sc, setup["tcfg"], params=setup["tparams"],
                              pool=setup["tpool"])
        hs = [system.submit(adapter_id=a, prompt_len=p, max_new_tokens=o,
                            arrival=t) for a, t, p, o in SPECS]
        system.drain()
        setup["runs"][key] = ({h.rid: tuple(h.tokens) for h in hs},
                              system.transport_stats())
    return setup["runs"][key]


def _policy():
    return AutoscalePolicy(control_interval=2.0, window=10.0,
                           min_instances=1, max_instances=2,
                           min_cache_slots=2, max_cache_slots=4,
                           max_replicas=2, scale_down_patience=1,
                           resize_deadband=0.0)


@pytest.mark.parametrize("data", [2, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("transport", ["host", "fused"])
def test_mesh_serving_equals_single_device(setup, data, paged, transport):
    ref, _ = _serve(setup, transport, None, paged)
    got, st = _serve(setup, transport, (data, 1), paged)
    assert all(len(t) > 0 for t in got.values())
    assert got == ref
    if transport == "fused":
        assert st["host_dispatches_per_step"] == 1.0, st


def test_mesh_serving_equals_reference_tokens(setup):
    """(paged, fused, (2, 1)) against the reference's single-device run,
    which the reference's own test pins to its mesh run."""
    got, _ = _serve(setup, "fused", (2, 1), True)
    sc = japi.ServeConfig(**_serve_kw("fused", None, True, 4, None))
    system = japi.build_system(sc, setup["jcfg"], params=setup["params"],
                               pool=setup["pool"])
    hs = [system.submit(adapter_id=a, prompt_len=p, max_new_tokens=o,
                        arrival=t) for a, t, p, o in SPECS]
    system.drain()
    assert got == {h.rid: tuple(h.tokens) for h in hs}


@pytest.mark.parametrize("case", ["churn", "autoscale", "grid_2x2"])
def test_mesh_serving_under_churn_resize_and_a_square_grid(setup, case):
    if case == "churn":     # a cache smaller than the adapter set
        ref, _ = _serve(setup, "fused", None, True, cache_slots=2)
        got, st = _serve(setup, "fused", (2, 1), True, cache_slots=2)
    elif case == "autoscale":
        ref, _ = _serve(setup, "fused", None, True, autoscale=_policy())
        got, st = _serve(setup, "fused", (2, 1), True, autoscale=_policy())
    else:                   # (2, 2) stripes experts over "data" at 2
        ref, _ = _serve(setup, "fused", None, True)
        got, st = _serve(setup, "fused", (2, 2), True)
    assert got == ref
    assert st["host_dispatches_per_step"] == 1.0, st


def test_mesh_cluster_partitions_the_cache(setup):
    """Under a mesh the front door's pool is partitioned and the shared
    cache bounds each home at its replica's slots; an add_replica
    repartitions it."""
    sc = ServeConfig(**_serve_kw("host", (2, 1), True, 4, None))
    system = build_system(sc, setup["tcfg"], params=setup["tparams"],
                          pool=setup["tpool"])
    cl = system.backend.cluster
    sp = cl.server_pool
    assert sp.partitioned and [r.M for r in sp.replicas] == [2, 2]
    assert cl.mesh_ctx.size == 2 and cl.mesh_ctx.devices[0].type == "cpu"
    assert isinstance(cl.params["layers"]["moe"]["up"], tmoe.ExpertBlocks)
    cache = cl._caches[-1]
    assert cache.admit(0, 0.0) is not None and cache.admit(2, 0.0) \
        is not None
    cache.pin(0)
    cache.pin(2)
    assert cache.admit(4, 0.0) is None          # home 0 holds 2 pinned
    assert cache.admit(1, 0.0) is not None      # home 1 has room

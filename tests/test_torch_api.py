"""The port's serving front door (``repro_torch.serving.api``) against the
JAX reference's (``repro.serving.api``) on the same workload:

  - the same tokens per rid, ``summary()`` field for field, and the same
    ``cache_stats()``, ``kv_stats()`` and ``transport_stats()``, for
    {coupled, disagg} x {dense, paged} and disagg x {host, fused}, under
    churn (2 adapter-cache slots for 4 adapters, 2 decode slots, a request
    joining mid-decode and one waiting for an eviction)
  - cancellation mid-decode (slot and pages back at once) and while
    queued, streaming by callback and iterator, rejected submits, the
    scheduled-cancel and pending-arrival regressions
  - the adapter lifecycle under a host budget that spills to disk: load a
    new adapter mid-run, serve it, unload (refused while in flight), load
    it again; the reference's tokens
  - front door == ``Cluster.run``; ``mesh_shape`` accepted (the mesh
    plane's own tests are ``tests/test_torch_mesh.py``); the
    observability exports; the quickstart and serving
    entry points on the CPU (``--cluster`` too)
  - the analytic backend (``backend="sim"``, after ``tests/test_api.py``):
    ``from_sim``/``sim_config``/``from_cluster`` against the reference's,
    and the lifecycle, a cancel mid-flight, the lone cold adapter, a
    mid-run submit and an out-of-range adapter giving the reference's
    events and ``Summary``

Weights come from the JAX initialisers, bridged through numpy."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import adapter as jadapter
from repro.models import model as jmodel
from repro.core import cost_model as jcm
from repro.serving import api as japi
from repro.serving import cluster as jcluster
from repro.serving import simulator as jsim
from repro.serving import workload as jworkload
from repro.store import random_host_tensors as j_random_host_tensors
from repro_torch import bridge
from repro_torch.core.cost_model import H100, Hardware
from repro_torch.serving import simulator as tsim
from repro_torch.serving.api import RequestState, ServeConfig, build_system
from repro_torch.serving.autoscaler import AutoscalePolicy
from repro_torch.serving.cluster import Cluster, ClusterConfig
from repro_torch.serving.workload import Request

# (adapter, arrival, prompt_len, output_len): rid 2 joins mid-decode, rid 3
# needs an eviction to get a slot
SPECS = [(0, 0.0, 5, 6), (1, 0.0, 4, 4), (2, 2.0, 6, 5), (3, 5.0, 3, 4)]
# the store's counters that move with the prefetch thread's timing (in the
# reference too): left out where the thread runs
TIMED = {"host_hits", "prefetch_requests", "prefetch_staged", "staged_hits",
         "sync_stages"}


def _same(a, b) -> bool:
    """Equality that takes nan == nan (Summary's telemetry fields)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def _t(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


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


def _system(setup, side, disagg, paged=False, **kw):
    kw.setdefault("n_pages", 8)
    kw.setdefault("adapter_cache_slots", 4)
    sc_kw = dict(backend="cluster", disaggregated=disagg, n_instances=1,
                 max_batch=2, max_len=32, paged=paged, page_size=4,
                 prefill_chunk=8, **kw)
    if side == "jax":
        return japi.build_system(japi.ServeConfig(**sc_kw), setup["jcfg"],
                                 params=setup["params"], pool=setup["pool"])
    return build_system(ServeConfig(**sc_kw), setup["tcfg"],
                        params=setup["tparams"], pool=setup["tpool"])


def _submit_specs(system, specs=SPECS):
    return [system.submit(adapter_id=a, arrival=t, prompt_len=p,
                          max_new_tokens=o) for a, t, p, o in specs]


def _served(setup, side, disagg, paged=False, **kw):
    """One drained run of SPECS, cached per arguments: (tokens, summary,
    cache stats, kv stats, transport stats, request stamps)."""
    key = (side, disagg, paged, tuple(sorted(kw.items())))
    if key not in setup["runs"]:
        system = _system(setup, side, disagg, paged, **kw)
        handles = _submit_specs(system)
        system.drain()
        assert all(h.state.name == "FINISHED" for h in handles)
        setup["runs"][key] = (
            {h.rid: list(h.tokens) for h in handles},
            dataclasses.asdict(system.summary()), system.cache_stats(),
            system.kv_stats(), system.transport_stats(),
            [dataclasses.asdict(h.request) for h in handles])
        system.close()
    return setup["runs"][key]


PLANES = [(False, False, "host"), (False, True, "host"),
          (True, False, "host"), (True, True, "host"), (True, True, "fused")]


@pytest.mark.parametrize(
    "disagg,paged,transport", PLANES,
    ids=[f"{'disagg' if d else 'coupled'}-{'paged' if p else 'dense'}"
         f"{'-' + t if d else ''}" for d, p, t in PLANES])
def test_front_door_matches_reference_under_churn(setup, disagg, paged,
                                                  transport):
    """Tokens, Summary, cache / KV / transport stats and every request's
    stamps equal the reference front door's on the same churn workload
    (2 adapter-cache slots for 4 adapters)."""
    kw = dict(transport=transport, adapter_cache_slots=2)
    want = _served(setup, "jax", disagg, paged, **kw)
    got = _served(setup, "torch", disagg, paged, **kw)
    tokens, summary, cache, kv, transport_stats, stamps = got
    assert tokens == want[0]
    assert _same(summary, want[1])
    assert cache["caches"] == want[2]["caches"]
    assert {k: v for k, v in cache["store"].items() if k not in TIMED} == \
        {k: v for k, v in want[2]["store"].items() if k not in TIMED}
    assert kv == want[3]
    assert transport_stats == want[4]
    assert stamps == want[5]
    assert sum(c["evictions"] for c in cache["caches"].values()) > 0
    for rid, (_, _, _, out) in enumerate(SPECS):
        assert len(tokens[rid]) == out
    if disagg and transport == "fused":
        assert transport_stats["host_dispatches"] == transport_stats["steps"]
        assert transport_stats["hook_dispatches"] == 0


def test_front_door_store_stats_without_prefetch_equal_reference(setup):
    """With the prefetch thread off, the store's counters are all
    deterministic and equal the reference's."""
    want = _served(setup, "jax", True, True, adapter_cache_slots=2,
                   prefetch=False, store_host_bytes=1)
    got = _served(setup, "torch", True, True, adapter_cache_slots=2,
                  prefetch=False, store_host_bytes=1)
    assert got[0] == want[0]
    assert got[2] == want[2]
    assert got[2]["store"]["disk_reads"] > 0


def test_front_door_coupled_equals_disagg_and_paged_equals_dense(setup):
    runs = [_served(setup, "torch", d, p, transport="host",
                    adapter_cache_slots=2)[0]
            for d in (False, True) for p in (False, True)]
    assert all(r == runs[0] for r in runs)


# ------------------------------ cancellation ----------------------------- #
@pytest.mark.parametrize("disagg", [False, True], ids=["coupled", "disagg"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cancel_mid_decode_frees_slot_and_pages_under_churn(
        setup, disagg, paged):
    system = _system(setup, "torch", disagg, paged=paged)
    handles = _submit_specs(system)
    h0 = handles[0]
    while h0.n_tokens < 2:
        system.step()
    before = system.kv_stats()[0]
    assert before["slots_in_use"] == 2
    assert h0.cancel()
    after = system.kv_stats()[0]
    assert after["slots_in_use"] == before["slots_in_use"] - 1
    if paged:
        assert after["pages_in_use"] < before["pages_in_use"]
    assert h0.state == RequestState.CANCELLED
    assert not h0.cancel()
    system.drain()
    for h in handles[1:]:
        assert h.state == RequestState.FINISHED
        assert len(h.tokens) == h.request.output_len
    final = system.kv_stats()[0]
    assert final["slots_in_use"] == 0
    if paged:
        assert final["pages_in_use"] == 0
        assert system.backend.cluster.engines[0].free_pages() == 8
    assert h0.request.finish < 0 and h0.request.cancelled
    s = system.summary(duration=10.0, warmup=0.0)
    assert s.n_finished == len(SPECS) - 1
    assert s.n_cancelled == 1
    system.close()


def test_cancel_mid_decode_equals_reference(setup):
    """The same cancel on both front doors: the same tokens, KV stats and
    Summary after the drain."""
    out = []
    for side in ("jax", "torch"):
        system = _system(setup, side, True, paged=True)
        handles = _submit_specs(system)
        while handles[0].n_tokens < 2:
            system.step()
        handles[0].cancel()
        mid = system.kv_stats()
        system.drain()
        out.append(({h.rid: list(h.tokens) for h in handles}, mid,
                    system.kv_stats(),
                    dataclasses.asdict(system.summary(warmup=0.0)),
                    [h.state.name for h in handles]))
        system.close()
    assert out[0][:3] == out[1][:3] and out[0][4] == out[1][4]
    assert _same(out[0][3], out[1][3])


def test_cancel_while_queued_never_occupies_a_slot(setup):
    system = _system(setup, "torch", False)
    handles = _submit_specs(system)
    h3 = handles[3]
    assert h3.cancel()
    system.drain()
    assert h3.state == RequestState.CANCELLED and h3.n_tokens == 0
    for h in handles[:3]:
        assert h.state == RequestState.FINISHED


def test_streaming_callback_and_iterator(setup):
    system = _system(setup, "torch", True, paged=True, transport="fused")
    seen = []
    handles = _submit_specs(system)
    handles[0].on_token(lambda h, tok: seen.append(tok))
    streamed = list(handles[0])
    assert streamed == handles[0].tokens == seen
    assert len(streamed) == handles[0].request.output_len
    assert handles[0].state == RequestState.FINISHED
    system.drain()
    assert all(h.state == RequestState.FINISHED for h in handles)
    want = _served(setup, "jax", True, True, transport="fused")[0]
    assert {h.rid: h.tokens for h in handles} == want
    assert handles[1].result() == want[1]


def test_scheduled_cancel_outliving_its_request_is_dropped(setup):
    system = _system(setup, "torch", False)
    h = system.submit(adapter_id=0, prompt_len=4, max_new_tokens=4)
    h.cancel(at=500.0)
    system.drain()
    assert h.state == RequestState.FINISHED
    assert system.backend.cluster.rnd < 50


def test_scheduled_cancel_fires_at_its_time(setup):
    system = _system(setup, "torch", False)
    h = system.submit(adapter_id=0, prompt_len=4, max_new_tokens=12)
    assert h.cancel(at=3.0)
    system.drain()
    assert h.state == RequestState.CANCELLED
    assert 0 < h.n_tokens < 12


def test_submit_accepts_array_prompts_and_rejects_empty(setup):
    system = _system(setup, "torch", False)
    h = system.submit(np.asarray([1, 2, 3], np.int32), adapter_id=0,
                      max_new_tokens=4)
    assert h.state == RequestState.QUEUED
    empty = system.submit([], adapter_id=0, max_new_tokens=4)
    assert empty.state == RequestState.REJECTED
    assert "empty prompt" in empty.error
    with pytest.raises(TypeError):
        system.submit(adapter_id=0)
    system.drain()
    assert h.state == RequestState.FINISHED and len(h.tokens) == 4


def test_cancel_pending_future_arrival_does_not_spin_rounds(setup):
    system = _system(setup, "torch", False, max_rounds=20)
    live = system.submit(adapter_id=0, prompt_len=4, max_new_tokens=4)
    ghost = system.submit(adapter_id=1, prompt_len=4, max_new_tokens=4,
                          arrival=50.0)
    assert ghost.cancel()
    system.drain()
    assert live.state == RequestState.FINISHED
    assert ghost.state == RequestState.CANCELLED and ghost.n_tokens == 0
    assert system.backend.cluster.rnd < 20


@pytest.mark.parametrize("disagg", [False, True], ids=["coupled", "disagg"])
def test_rejected_submit_never_raises_and_serves_the_rest(setup, disagg):
    system = _system(setup, "torch", disagg, paged=True, n_pages=4)
    ok = system.submit(adapter_id=0, prompt_len=4, max_new_tokens=4)
    too_long = system.submit(adapter_id=0, prompt=list(range(30)),
                             max_new_tokens=30)
    bad_adapter = system.submit(adapter_id=99, prompt_len=4,
                                max_new_tokens=4)
    too_many_pages = system.submit(adapter_id=1, prompt=list(range(12)),
                                   max_new_tokens=12)
    assert too_long.state == RequestState.REJECTED
    assert "max_len" in too_long.error
    assert bad_adapter.state == RequestState.REJECTED
    assert "adapter_id" in bad_adapter.error
    assert too_many_pages.state == RequestState.REJECTED
    assert "KV pages" in too_many_pages.error
    assert set(system.handles) == {ok.rid}
    system.drain()
    assert ok.state == RequestState.FINISHED


def test_front_door_matches_legacy_cluster_run(setup):
    reqs = [Request(i, a, arrival=t, prompt_len=p, output_len=o)
            for i, (a, t, p, o) in enumerate(SPECS)]
    legacy = Cluster(setup["tcfg"], setup["tparams"], ClusterConfig(
        n_instances=1, n_slots=2, max_len=32, adapter_cache_slots=4),
        setup["tpool"]).run(reqs)
    system = _system(setup, "torch", False)
    handles = system.submit_workload(reqs)
    system.drain()
    assert {h.rid: h.tokens for h in handles} == legacy["tokens"]
    nxt = system.submit(adapter_id=0, prompt_len=3, max_new_tokens=2)
    assert nxt.rid == len(SPECS)            # auto-rids past the workload


# ---------------------------- config surface ----------------------------- #
def test_serve_config_derives_engine_and_cluster_configs():
    kw = dict(n_instances=3, max_batch=7, max_len=128, disaggregated=True,
              adapter_cache_slots=11, policy="sjf", paged=True, page_size=16,
              n_pages=40, prefill_chunk=32, step_time=0.5, transport="fused",
              store_host_bytes=123, disk_bw=1e9, prefetch=False,
              rank_aware=False)
    sc, jsc = ServeConfig(**kw), japi.ServeConfig(**kw)
    assert dataclasses.asdict(sc.engine_config()) == \
        {k: v for k, v in dataclasses.asdict(jsc.engine_config()).items()
         if k in dataclasses.asdict(sc.engine_config())}
    jc = dataclasses.asdict(jsc.cluster_config())
    assert all(jc[k] == v for k, v in
               dataclasses.asdict(sc.cluster_config()).items())
    for f in dataclasses.fields(ServeConfig):   # the reference's defaults
        if f.name == "hw":      # the port's: a nominal H100
            assert ServeConfig().hw == H100
            continue
        assert getattr(ServeConfig(), f.name) == \
            getattr(japi.ServeConfig(), f.name), f.name


def test_unported_planes_are_refused_with_their_item(setup):
    """No plane is refused any more: the analytic backend, the autoscaler
    (ROADMAP A6) and the mesh plane (A8) are ported; a bad transport or
    backend still is."""
    assert ServeConfig(backend="sim").sim_config().hw == H100
    assert ServeConfig(disaggregated=True,
                       autoscale=AutoscalePolicy()).cluster_config() \
        .autoscale == AutoscalePolicy()
    assert ServeConfig(disaggregated=True, mesh_shape=(2, 2)) \
        .cluster_config().mesh_shape == (2, 2)
    with pytest.raises(ValueError, match="unknown transport"):
        ServeConfig(transport="carrier-pigeon")
    with pytest.raises(ValueError, match="unknown backend"):
        ServeConfig(backend="nope")
    with pytest.raises(ValueError, match="params= and pool="):
        build_system(ServeConfig(), setup["tcfg"])


# ---------------------------- adapter lifecycle -------------------------- #
def _lifecycle(setup, side, transport="host", paged=False):
    """The reference's churn bit-identity sequence: load adapter 4 (rank
    4, alpha 16) mid-run under a host budget of two adapters, serve SPECS
    and one request on it, unload it (a submit to it is then rejected),
    load the same weights again and serve the request again."""
    bytes1 = setup["tpool"].adapter_bytes(1)
    system = _system(setup, side, True, paged=paged, transport=transport,
                     adapter_cache_slots=2, store_host_bytes=2 * bytes1,
                     host_bw=1e9)
    try:
        tensors = j_random_host_tensors(setup["jcfg"], 4, seed=7)
        if side == "torch":
            tensors = {k: _t(v) for k, v in tensors.items()}
        assert system.load_adapter(4, tensors, alpha=16.0) == 4
        prompt = (11, 7, 3, 19, 5)
        handles = _submit_specs(system)
        extra = system.submit(adapter_id=4, arrival=6.0, prompt=prompt,
                              max_new_tokens=5)
        system.drain()
        static = {h.rid: tuple(h.tokens) for h in handles}
        first = tuple(extra.tokens)
        assert len(first) == 5
        system.unload_adapter(4)
        rejected = system.submit(adapter_id=4, arrival=20.0, prompt_len=3,
                                 max_new_tokens=3)
        assert rejected.state.name == "REJECTED"
        assert system.load_adapter(4, tensors, alpha=16.0) == 4
        h = system.submit(adapter_id=4, arrival=30.0, prompt=prompt,
                          max_new_tokens=5)
        system.drain()
        assert tuple(h.tokens) == first
        store = system.cache_stats()["store"]
        return static, first, store
    finally:
        system.close()


@pytest.fixture(scope="module")
def lifecycle_reference(setup):
    return _lifecycle(setup, "jax")


@pytest.mark.parametrize("transport", ["host", "fused"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense-kv", "paged-kv"])
def test_churn_bit_identity_equals_reference(setup, lifecycle_reference,
                                             transport, paged):
    """Load a new adapter mid-run, serve it, unload it, load it again and
    serve it again under a host budget that spills to disk: the static
    workload's and the new adapter's tokens are the reference's, on both
    transports and both KV layouts."""
    static, first, store = _lifecycle(setup, "torch", transport, paged)
    assert static == lifecycle_reference[0]
    assert first == lifecycle_reference[1]
    assert store["demotions"] > 0 and store["disk_writes"] > 0
    static_c = _served(setup, "torch", False, False, transport="host")[0]
    assert {r: list(t) for r, t in static.items()} == static_c


def test_unload_refused_while_request_in_flight(setup):
    system = _system(setup, "torch", True, adapter_cache_slots=2)
    try:
        h = system.submit(adapter_id=1, arrival=0.0, prompt_len=4,
                          max_new_tokens=6)
        it = iter(h)
        next(it)
        with pytest.raises(ValueError, match="in use"):
            system.unload_adapter(1)
        system.drain()
        assert h.state == RequestState.FINISHED
        system.unload_adapter(1)
        rej = system.submit(adapter_id=1, arrival=50.0, prompt_len=3,
                            max_new_tokens=3)
        assert rej.state == RequestState.REJECTED
        with pytest.raises(ValueError, match="not registered"):
            system.unload_adapter(1)
        cl = system.backend.cluster
        assert not cl.server_pool.is_resident(1)
    finally:
        system.close()


def test_coupled_plane_refuses_dynamic_load(setup):
    """The coupled plane appends a loaded adapter to its static pool: an id
    other than the pool's next is refused, and so is an unload."""
    system = _system(setup, "torch", False)
    from repro_torch.store import random_host_tensors
    try:
        with pytest.raises(ValueError, match="next adapter id is 4"):
            system.load_adapter(9, random_host_tensors(setup["tcfg"], 4, 1),
                                alpha=16.0)
        with pytest.raises(ValueError, match="disaggregated"):
            system.unload_adapter(0)
    finally:
        system.close()


def test_cluster_load_validates_tensors(setup):
    from repro_torch.store import random_host_tensors
    system = _system(setup, "torch", True, adapter_cache_slots=2)
    try:
        with pytest.raises(ValueError):
            system.load_adapter(9)
        bad = random_host_tensors(setup["tcfg"], 16, seed=3)
        with pytest.raises(ValueError):
            system.load_adapter(9, bad, alpha=16.0)
        with pytest.raises(ValueError):
            system.load_adapter(0, random_host_tensors(setup["tcfg"], 4, 4),
                                alpha=16.0)
    finally:
        system.close()


# ------------------------------ observability ---------------------------- #
def test_tracing_on_off_tokens_and_exports(setup):
    off = _served(setup, "torch", True, True, transport="fused")[0]
    system = _system(setup, "torch", True, paged=True, transport="fused",
                     trace=True)
    handles = _submit_specs(system)
    system.drain()
    assert {h.rid: h.tokens for h in handles} == off
    obs = system.observability()
    system.summary()
    text = obs.prometheus()
    for name in ("requests_finished_total", "ttft_seconds_bucket",
                 "queue_depth", "kv_slots_in_use", "cache_caches",
                 "transport_steps", "summary_n_finished"):
        assert name in text, name
    trace = obs.perfetto()
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"queued", "prefill", "decode", "decode.step",
            "queue_depth"} <= names
    for h in handles:
        spans = {s.name: s for s in obs.tracer.spans_for(f"req:{h.rid}")}
        assert spans["prefill"].end - spans["queued"].start == \
            pytest.approx(h.request.first_token - h.request.arrival)
    assert obs.jsonl().count("\n") == len(obs.tracer.spans) + \
        len(obs.tracer.instants) + len(obs.tracer.counters)
    system.close()


# ------------------------------ entry points ----------------------------- #
def test_quickstart_on_cpu(capsys):
    from repro_torch.launch import quickstart
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "adapter 0 streams:" in out
    n = int(out.split(" / 32 tokens differ")[0].rsplit("\n", 1)[-1])
    assert n > 0
    assert out.rstrip().endswith("[cancelled]; slots in use: 0")
    assert "'host_dispatches_per_step': 1.0" in out


@pytest.mark.parametrize("args", [["--mode", "coupled", "--dense"],
                                  ["--transport", "fused", "--replicas", "2"]],
                         ids=["coupled-dense", "fused-R2"])
def test_serve_cli_through_the_front_door(capsys, args):
    from repro_torch.launch import serve
    assert serve.main(["--reduced", "--device", "cpu", *args]) == 0
    out = capsys.readouterr().out.splitlines()
    import json
    first, second = json.loads(out[0]), json.loads(out[1])
    assert first["generated_tokens"] == 6 * 6
    assert first["summary"]["n_cancelled"] == 0
    assert all(s["slots_in_use"] == 0 for s in second["kv_stats"].values())
    if "fused" in args:
        assert second["transport"]["host_dispatches_per_step"] == 1.0
        assert second["transport"]["hook_dispatches"] == 0
    assert out[2].startswith("generated:")


def test_serve_cli_cluster_comparison_on_the_sim_plane(capsys):
    """``--cluster``: S-LoRA vs InfiniLoRA on the analytic plane at the
    full config, labelled as the nominal H100's modelled numbers."""
    from repro_torch.launch import serve
    assert serve.main(["--cluster", "--duration", "8", "--rate", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    import json
    assert out[0].startswith("s-lora") and out[1].startswith("infinilora")
    assert all("(analytic, H100 nominal)" in ln for ln in out[:2])
    res = json.loads(out[2])
    assert set(res) == {"s-lora", "infinilora"}
    assert all(r["n_finished"] > 0 for r in res.values())


# ----------------------- sim backend (analytic plane) -------------------- #
# the port prices with a nominal H100; against the reference it prices the
# reference's default machine, so both planes model the same cluster
REF_HW = Hardware(**dataclasses.asdict(jcm.V5E))
MX = get_config("mixtral-8x7b")
TMX = bridge.config_from(MX)


def test_sim_serve_config_round_trips_equal_reference():
    kw = dict(n_instances=3, max_batch=7, max_len=128, disaggregated=True,
              adapter_cache_slots=11, policy="sjf", paged=True, page_size=16,
              n_pages=40, prefill_chunk=32, step_time=0.5, n_adapters=64,
              duration=45.0, server_replicas=2, gpus_per_instance=4,
              server_gpus=4, placement_x=2, fast_kernels=False,
              store_host_bytes=10**9, disk_bw=2e9, transport="fused",
              hook_launch_us=3.0, failures=((1.0, 0),),
              stragglers=((2.0, 1, 3.0),), adapter_ranks=(4, 8) * 32)
    got = dataclasses.asdict(ServeConfig(hw=REF_HW, **kw).sim_config())
    want = dataclasses.asdict(japi.ServeConfig(**kw).sim_config())
    assert got.pop("hw") == want.pop("hw")
    assert got == want
    sim = tsim.SimConfig(n_instances=5, max_batch=96, disaggregated=True,
                         server_cache_slots=33, duration=77.0, policy="sjf",
                         n_adapters=128, fast_kernels=False)
    lifted = ServeConfig.from_sim(sim)
    assert lifted.backend == "sim" and lifted.hw == H100
    # ServeConfig unifies the two cache-slot knobs; the one the mode never
    # reads (here the coupled per-instance slots) does not round-trip
    assert lifted.sim_config() == dataclasses.replace(
        sim, instance_cache_slots=sim.server_cache_slots)
    jlifted = japi.ServeConfig.from_sim(jsim.SimConfig(
        **{f: getattr(sim, f) for f in ("n_instances", "max_batch",
                                        "disaggregated", "server_cache_slots",
                                        "duration", "policy", "n_adapters",
                                        "fast_kernels")}))
    a, b = dataclasses.asdict(lifted), dataclasses.asdict(jlifted)
    a.pop("hw"), b.pop("hw")
    assert a == b
    ccfg = ClusterConfig(n_instances=3, n_slots=2, disaggregated=True,
                         paged=True, transport="fused", hook_launch_us=2.0,
                         autoscale=AutoscalePolicy(max_replicas=3))
    up = ServeConfig.from_cluster(ccfg)
    assert up.cluster_config() == ccfg
    jup = japi.ServeConfig.from_cluster(jcluster.ClusterConfig(
        n_instances=3, n_slots=2, disaggregated=True, paged=True,
        transport="fused", hook_launch_us=2.0))
    a, b = dataclasses.asdict(up), dataclasses.asdict(jup)
    assert a.pop("autoscale") == {**dataclasses.asdict(AutoscalePolicy()),
                                  "max_replicas": 3}
    b.pop("autoscale"), a.pop("hw"), b.pop("hw")
    assert a == b


def _sim_pair(disagg, **kw):
    base = dict(backend="sim", disaggregated=disagg,
                n_instances=3 if disagg else 4, max_batch=128,
                adapter_cache_slots=64, n_adapters=64, duration=30.0,
                server_gpus=8)
    base.update(kw)
    return (build_system(ServeConfig(hw=REF_HW, **base), TMX),
            japi.build_system(japi.ServeConfig(**base), MX))


def _events(handles):
    return [[(e.time, e.rid, e.kind, e.token, e.detail) for e in h.events]
            for h in handles]


@pytest.mark.parametrize("disagg", [False, True], ids=["coupled", "disagg"])
def test_sim_backend_lifecycle_equals_reference(disagg):
    """Every request walks QUEUED -> PREFILLING -> DECODING -> FINISHED
    with output_len token events (token=None), as the reference's events
    and Summary."""
    reqs = jworkload.generate(64, rate=10, duration=30, seed=2)
    got, want = [], []
    for i, (system, out) in enumerate(zip(_sim_pair(disagg), (got, want))):
        handles = system.submit_workload(
            [Request(**dataclasses.asdict(r)) for r in reqs] if i == 0
            else reqs)
        system.drain()
        out.extend([_events(handles), dataclasses.asdict(system.summary()),
                    system.cache_stats(), system.transport_stats()])
        for h in handles:
            assert h.state.name == "FINISHED"
            assert h.n_tokens == h.request.output_len
            assert h.tokens == [] and list(h) == [None] * h.n_tokens
    assert got[0] == want[0]
    assert _same(got[1], want[1])
    assert got[2:] == want[2:]
    assert got[1]["n_finished"] > 0 and got[1]["n_censored"] == 0


def test_sim_backend_cancellation_mid_flight_equals_reference():
    reqs = jworkload.generate(64, rate=10, duration=30, seed=2)
    res = []
    for i, system in enumerate(_sim_pair(True)):
        handles = system.submit_workload(
            [Request(**dataclasses.asdict(r)) for r in reqs] if i == 0
            else reqs)
        victim = handles[10]
        victim.cancel(at=victim.request.arrival + 0.05)
        system.drain()
        assert victim.state.name == "CANCELLED"
        assert victim.n_tokens < victim.request.output_len
        assert victim.request.finish < 0
        assert all(h.state.name == "FINISHED" for h in handles
                   if h is not victim)
        assert all(c.active_count() == 0
                   for c in system.backend.sim.caches.values())
        s = system.summary(duration=40.0, warmup=0.0)
        assert s.n_finished == len(handles) - 1 and s.n_cancelled == 1
        res.append((_events(handles), dataclasses.asdict(s)))
    assert res[0][0] == res[1][0]
    assert _same(res[0][1], res[1][1])


def test_sim_lone_cold_adapter_mid_run_submit_and_bad_ids_equal_reference():
    """The reference's regressions on both packages, event for event: a
    lone request whose adapter was mid-load at admission still finishes;
    a mid-run submit with a past arrival joins NOW; out-of-range ids are
    REJECTED at submit."""
    out = []
    for i, (port, ref) in enumerate([
            (build_system(ServeConfig(backend="sim", n_instances=1,
                                      max_batch=8, adapter_cache_slots=4,
                                      n_adapters=4, duration=30.0,
                                      hw=REF_HW), TMX),
             japi.build_system(japi.ServeConfig(
                 backend="sim", n_instances=1, max_batch=8,
                 adapter_cache_slots=4, n_adapters=4, duration=30.0), MX)),
            _sim_pair(False)]):
        evs = []
        for system in (port, ref):
            if i == 0:
                h = system.submit(prompt_len=64, adapter_id=1,
                                  max_new_tokens=8, arrival=0.0)
                system.drain()
                assert h.state.name == "FINISHED" and h.n_tokens == 8
                assert h.request.ttft > 0
                evs.append(_events([h]))
                continue
            h1 = system.submit(prompt_len=32, adapter_id=0,
                               max_new_tokens=8, arrival=0.0)
            while system.now < 0.01 and not system.backend.idle():
                system.step()
            t = system.now
            h2 = system.submit(prompt_len=32, adapter_id=1,
                               max_new_tokens=8, arrival=0.0)
            bad = [system.submit(prompt_len=8, adapter_id=a,
                                 max_new_tokens=4) for a in (6400, -1)]
            system.drain()
            assert h1.state.name == h2.state.name == "FINISHED"
            assert h2.request.decode_start >= t > 0
            assert h2.request.arrival == 0.0
            assert all(b.state.name == "REJECTED" and "adapter_id" in b.error
                       for b in bad)
            evs.append((_events([h1, h2]), [b.error for b in bad]))
        out.append(evs)
    for got, want in out:
        assert got == want

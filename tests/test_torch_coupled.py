"""Parity of the port's coupled (S-LoRA) plane and dense KV layout with the
JAX reference, on the reduced qwen3-moe config in f32 with all seven LoRA
targets (q/k/v/o through ``bgmv``, gate/up/down through ``bgmv_expert``).

Weights, adapter pools and inputs come from the reference's initialisers
and numpy seeds and reach the port through ``repro_torch.bridge``.
Tolerances: kernel twins 1e-6 abs (the f32 rounding spread between two
summation orders at these shapes), logits and KV 1e-4 abs (f32, d=128, two
layers); token streams exact. Inside the port, coupled == disaggregated on
a pool of expert-FFN targets only (the disaggregated plane serves no
attention target), and paged == dense, in greedy tokens.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import adapter as jadapter
from repro.core import lora_math
from repro.core import lora_server as jls
from repro.kernels import ops as jops
from repro.models import cache as jcache
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.serving import engine as jengine
from repro_torch import bridge
from repro_torch.core import adapter as tadapter
from repro_torch.core import lora_server as tls
from repro_torch.kernels import bgmv as tbgmv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import cache as tcache
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.serving import engine as tengine

KERNEL_TOL = 1e-6
LOGIT_TOL = 1e-4
RANKS = [2, 8, 4, 8]
FFN = ("gate", "up", "down")
# (rid, prompt length, adapter, admitted after this many decode steps)
REQUESTS = [(0, 7, 0, 0), (1, 5, 1, 0), (2, 9, 2, 0), (3, 6, 3, 2)]
NEW_TOKENS = 5
ENGINE = dict(max_len=32, n_slots=4, page_size=4, prefill_chunk=8)
LAYOUTS = pytest.mark.parametrize("paged", [True, False],
                                  ids=["paged", "dense"])


def _drive(engine, prompts):
    """Admit REQUESTS in two waves, decode NEW_TOKENS each, evict when
    done (the schedule of tests/test_torch_engine.py)."""
    out = {rid: [] for rid, *_ in REQUESTS}
    step = 0
    while any(len(v) < NEW_TOKENS for v in out.values()):
        for rid, _, aid, at in REQUESTS:
            if at == step:
                engine.add_request(rid, prompts[rid], aid)
        for rid, t in engine.step().items():
            out[rid].append(int(t))
            if len(out[rid]) == NEW_TOKENS:
                engine.evict_request(rid)
        step += 1
    return out


@pytest.fixture(scope="module")
def setup():
    """The reference's config, params and mixed-rank pool over all seven
    targets, their bridges, and the prompts."""
    jcfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                               lora_rank=8)
    assert set(jcfg.lora_targets) == {"q", "k", "v", "o"} | set(FFN)
    key = jax.random.PRNGKey(0)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jcfg, key, dtype="float32"))
    pool = jadapter.init_mixed_rank_pool(jcfg, RANKS,
                                         jax.random.fold_in(key, 1),
                                         dtype=jnp.float32)
    tcfg = bridge.config_from(jcfg)
    tparams = bridge.tree_to_tensors(params)
    tpool = bridge.adapter_pool(
        tcfg, jax.tree_util.tree_map(np.asarray, pool.tensors), pool.rank,
        pool.scale, pool.ranks)
    rng = np.random.default_rng(0)
    prompts = {rid: rng.integers(0, jcfg.vocab_size, n).tolist()
               for rid, n, _, _ in REQUESTS}
    return jcfg, params, pool, tcfg, tparams, tpool, prompts


def _ffn_pool(tpool):
    """The same adapters restricted to the expert-FFN targets."""
    return dataclasses.replace(
        tpool, cfg=dataclasses.replace(tpool.cfg, lora_targets=FFN),
        tensors={t: tpool.tensors[t] for t in FFN})


# ------------------------------- kernels -------------------------------- #
def _bgmv_inputs(mixed: bool, seed=11):
    rng = np.random.default_rng(seed)
    T, N, d_in, r, d_out = 9, 4, 24, 8, 40
    x = rng.standard_normal((T, d_in)).astype(np.float32)
    A = (rng.standard_normal((N, d_in, r)) / r).astype(np.float32)
    B = (rng.standard_normal((N, r, d_out)) * 0.1).astype(np.float32)
    if mixed:  # true ranks 2/8/4/8 padded to 8 with exact +0.0
        for n, rank in enumerate(RANKS):
            A[n, :, rank:] = 0.0
            B[n, rank:, :] = 0.0
    ids = np.array([0, -1, 3, 1, 2, -1, 3, 0, 2], np.int32)
    return x, A, B, ids


def _jnp(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
def test_bgmv_ref_matches_pallas_and_oracle(monkeypatch, mixed):
    """bgmv_ref against the reference's jnp contract and its Pallas kernel
    (interpret mode), padding rows (ids = -1) exact zeros."""
    x, A, B, ids = _bgmv_inputs(mixed)
    got = tref.bgmv_ref(*map(torch.from_numpy, (x, A, B, ids))).numpy()
    oracle = np.asarray(lora_math.bgmv(*_jnp(x, A, B, ids)))
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    pallas = np.asarray(jops.bgmv(*_jnp(x, A, B, ids)))
    assert got.shape == (9, 40) and got.dtype == np.float32
    np.testing.assert_allclose(got, oracle, rtol=0, atol=KERNEL_TOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=KERNEL_TOL)
    assert np.all(got[ids < 0] == 0.0)


def test_ops_bgmv_takes_the_plain_version_on_the_cpu():
    x, A, B, ids = map(torch.from_numpy, _bgmv_inputs(False))
    before = tbgmv.bgmv.launches
    assert torch.equal(tops.bgmv(x, A, B, ids), tref.bgmv_ref(x, A, B, ids))
    assert tbgmv.bgmv.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tbgmv.bgmv(x, A, B, ids)


# ------------------------------- modules -------------------------------- #
def test_adapter_pool_bridge_carries_attention_targets(setup):
    """The bridged pool holds every target bitwise, its lora_ctx is the
    reference's, and the port draws the same target set."""
    jcfg, _, pool, tcfg, _, tpool, _ = setup
    assert tadapter.active_targets(tcfg) == jadapter.active_targets(jcfg)
    assert set(tpool.tensors) == set(pool.tensors)
    for t, ab in pool.tensors.items():
        for f in ("A", "B"):
            np.testing.assert_array_equal(tpool.tensors[t][f].numpy(),
                                          np.asarray(ab[f]))
    ids = torch.tensor([1, -1, 3], dtype=torch.int32)
    ctx = tpool.lora_ctx(ids)
    assert ctx["adapters"] is tpool.tensors and ctx["ids"] is ids
    assert ctx["scale"] == pool.lora_ctx(jnp.asarray(ids.numpy()))["scale"]
    drawn = tadapter.init_mixed_rank_pool(tcfg, RANKS, seed=1,
                                          dtype=torch.float32, device="cpu")
    for t in jcfg.lora_targets:
        for f in ("A", "B"):
            assert drawn.tensors[t][f].shape == tpool.tensors[t][f].shape


def test_dense_cache_matches_reference_layout(setup):
    jcfg, _, _, tcfg, _, _, _ = setup
    want = jcache.init_cache(jcfg, 3, 16)
    got = tcache.init_cache(tcfg, 3, 16)
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape
        assert got[name].dtype == torch.bfloat16 and not got[name].any()
    assert tcache.dense_cache_bytes(tcfg, 3, 16) == \
        jcache.dense_cache_bytes(jcfg, 3, 16)


def test_moe_block_with_expert_lora_matches(setup):
    """One layer's MoE with the coupled plane's expert deltas (three
    bgmv_expert launches), tokens of every adapter and none mixed."""
    jcfg, params, pool, tcfg, tparams, tpool, _ = setup
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 2, jcfg.d_model)).astype(np.float32)
    ids = np.array([0, 3, -1, 1, 2, 0], np.int32)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[1]),
                                params["layers"]["moe"])
    jl = {t: {f: jnp.asarray(pool.tensors[t][f][1]) for f in ("A", "B")}
          for t in FFN}
    want = np.asarray(jmoe.moe_block(jnp.asarray(x), jp, jcfg, kind="decode",
                                     lora=jl, ids_tok=jnp.asarray(ids),
                                     lora_scale=pool.scale))
    tp = {k: v[1] for k, v in tparams["layers"]["moe"].items()}
    tl = {t: {f: tpool.tensors[t][f][1] for f in ("A", "B")} for t in FFN}
    got = tmoe.moe_block(torch.from_numpy(x), tp, tcfg, lora=tl,
                         ids_tok=torch.from_numpy(ids),
                         lora_scale=tpool.scale).numpy()
    base = tmoe.moe_block(torch.from_numpy(x), tp, tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    assert np.abs(got - base).max() > 1e-3   # the deltas are visible


def _step_inputs(jcfg, paged: bool, seed=6):
    """KV caches in one layout, a 4-row batch with one padding row."""
    rng = np.random.default_rng(seed)
    L, KV, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    if paged:
        shape, bt = (L, 10, 4, KV, hd), np.array(
            [[3, 7, -1], [0, -1, -1], [5, 6, 1], [3, 7, -1]], np.int32)
    else:
        shape, bt = (L, 4, 12, KV, hd), None
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    pos = np.array([5, 2, 9, -1], np.int32)       # row 3 is padding
    toks = rng.integers(0, jcfg.vocab_size, (4, 1)).astype(np.int32)
    ads = np.array([1, 3, 0, -1], np.int32)
    return k, v, bt, pos, toks, ads


@LAYOUTS
def test_coupled_decode_step_logits_match(setup, paged):
    """One coupled decode step with all seven targets: logits of the
    active rows and the KV written, against the reference."""
    jcfg, params, pool, tcfg, tparams, tpool, _ = setup
    k, v, bt, pos, toks, ads = _step_inputs(jcfg, paged)
    jl, jk, jv = jtransformer.decode_step_slots(
        params, jcfg, jnp.asarray(k), jnp.asarray(v), jnp.asarray(toks),
        jnp.asarray(pos), pool.lora_ctx(jnp.asarray(ads)),
        block_table=None if bt is None else jnp.asarray(bt))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tl, tk, tv = ttransformer.decode_step_slots(
        tparams, tcfg, tk, tv, torch.from_numpy(toks).long(),
        torch.from_numpy(pos), tpool.lora_ctx(torch.from_numpy(ads)),
        block_table=None if bt is None else torch.from_numpy(bt))
    assert tuple(tl.shape) == (4, jcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=LOGIT_TOL)
    # the adapters move the logits: LoRA-free differs
    base, _, _ = ttransformer.decode_step_slots(
        tparams, tcfg, torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
        torch.from_numpy(toks).long(), torch.from_numpy(pos),
        block_table=None if bt is None else torch.from_numpy(bt))
    assert (base[:3] - tl[:3]).abs().max() > 1e-3


# ------------------------------- engines -------------------------------- #
def _port_engine(setup, paged: bool, disagg: bool):
    _, _, _, tcfg, tparams, tpool, _ = setup
    ecfg = tengine.EngineConfig(paged=paged, **ENGINE)
    if not disagg:
        return tengine.Engine(tcfg, tparams, ecfg, pool=tpool, device="cpu")
    ffn = _ffn_pool(tpool)
    server = tls.LoRAServer(tcfg, tls.ServerConfig(m=1, x=1, y=1,
                                                   cache_slots=4, rank=8),
                            dtype=torch.float32, device="cpu")
    for aid in range(ffn.n):
        server.insert(aid, tls.pool_tensors_from_adapter(ffn, aid),
                      rank=ffn.rank_of(aid))
    return tengine.Engine(tcfg, tparams, ecfg, server, lora_scale=ffn.scale,
                          device="cpu")


@LAYOUTS
def test_coupled_engine_tokens_match_reference(setup, paged):
    """Greedy tokens of the coupled engine equal the reference's coupled
    Engine's, with mid-decode admission, mixed ranks, all seven targets."""
    jcfg, params, pool, *_, prompts = setup
    jeng = jengine.Engine(jcfg, params,
                          jengine.EngineConfig(paged=paged, **ENGINE),
                          pool=pool)
    want = _drive(jeng, prompts)
    eng = _port_engine(setup, paged, disagg=False)
    assert _drive(eng, prompts) == want
    assert eng.kv_stats() == jeng.kv_stats()


@LAYOUTS
def test_coupled_equals_disagg_in_port(setup, paged):
    """On a pool of expert-FFN targets the two planes compute the same
    deltas, so their greedy tokens agree."""
    _, _, _, tcfg, tparams, tpool, prompts = setup
    coupled = tengine.Engine(tcfg, tparams,
                             tengine.EngineConfig(paged=paged, **ENGINE),
                             pool=_ffn_pool(tpool), device="cpu")
    assert _drive(coupled, prompts) == \
        _drive(_port_engine(setup, paged, disagg=True), prompts)


@pytest.mark.parametrize("disagg", [False, True],
                         ids=["coupled", "disagg"])
def test_paged_equals_dense_in_port(setup, disagg):
    _, _, _, _, _, _, prompts = setup
    assert _drive(_port_engine(setup, True, disagg), prompts) == \
        _drive(_port_engine(setup, False, disagg), prompts)


def test_engine_takes_the_pool_scale_with_a_server(setup):
    """Engine(server=..., pool=...) serves the deltas at the pool's scale, as
    the reference's engine does (its cluster builds engines so); a
    lora_scale that disagrees with the pool is refused; a server without a
    pool keeps lora_scale (default 1.0)."""
    _, _, _, tcfg, tparams, tpool, prompts = setup
    ffn = _ffn_pool(tpool)
    by_scale = _port_engine(setup, True, disagg=True)
    ecfg = tengine.EngineConfig(paged=True, **ENGINE)
    by_pool = tengine.Engine(tcfg, tparams, ecfg, by_scale.server,
                             device="cpu", pool=ffn)
    assert by_pool.lora_scale == ffn.scale != 1.0
    assert _drive(by_pool, prompts) == _drive(by_scale, prompts)
    assert tengine.Engine(tcfg, tparams, ecfg, by_scale.server,
                          lora_scale=ffn.scale, pool=ffn,
                          device="cpu").lora_scale == ffn.scale
    with pytest.raises(ValueError, match="disagrees"):
        tengine.Engine(tcfg, tparams, ecfg, by_scale.server, lora_scale=1.0,
                       pool=ffn, device="cpu")
    assert tengine.Engine(tcfg, tparams, ecfg, by_scale.server,
                          device="cpu").lora_scale == 1.0


@pytest.mark.parametrize("disagg", [False, True], ids=["coupled", "disagg"])
def test_rank4_bf16_pool_serves_reference_tokens(disagg):
    """A bf16 pool of rank 4 (half a 16-byte vector of bf16) on a bf16 model
    serves through the port's engine with the JAX engine's greedy tokens:
    the coupled plane on all seven targets, the disaggregated one through a
    rank-4 LoRA Server (the engines take the pool's scale)."""
    targets = FFN if disagg else ("q", "k", "v", "o") + FFN
    jcfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                               lora_targets=targets, lora_rank=4)
    key = jax.random.PRNGKey(3)
    params = jmodel.init_params(jcfg, key, dtype="bfloat16")
    pool = jadapter.init_adapter_pool(jcfg, 4, jax.random.fold_in(key, 1),
                                      rank=4, dtype=jnp.bfloat16)
    tcfg = bridge.config_from(jcfg)
    bf16 = torch.bfloat16
    tparams = bridge.tree_to_tensors(
        jax.tree_util.tree_map(np.asarray, params), dtype=bf16)
    tpool = bridge.adapter_pool(
        tcfg, jax.tree_util.tree_map(np.asarray, pool.tensors), pool.rank,
        pool.scale, dtype=bf16)
    jserver = tserver = None
    if disagg:
        scfg = dict(m=1, x=1, y=1, cache_slots=4, rank=4)
        jserver = jls.LoRAServer(jcfg, jls.ServerConfig(**scfg),
                                 dtype=jnp.bfloat16)
        tserver = tls.LoRAServer(tcfg, tls.ServerConfig(**scfg), dtype=bf16,
                                 device="cpu")
        for aid in range(pool.n):
            jserver.insert(aid, jls.pool_tensors_from_adapter(pool, aid))
            tserver.insert(aid, tls.pool_tensors_from_adapter(tpool, aid))
    rng = np.random.default_rng(1)
    prompts = {rid: rng.integers(0, jcfg.vocab_size, n).tolist()
               for rid, n, _, _ in REQUESTS}
    want = _drive(jengine.Engine(jcfg, params, jengine.EngineConfig(
        paged=True, **ENGINE), pool=pool, server=jserver), prompts)
    got = _drive(tengine.Engine(tcfg, tparams, tengine.EngineConfig(
        paged=True, **ENGINE), tserver, device="cpu", pool=tpool), prompts)
    assert got == want


@pytest.mark.parametrize("extra", [[], ["--dense"]], ids=["paged", "dense"])
def test_serve_coupled_entry_point_runs_on_cpu(capsys, extra):
    assert tserve.main(["--reduced", "--layers", "1", "--requests", "3",
                        "--mode", "coupled", "--device", "cpu",
                        *extra]) == 0
    out = capsys.readouterr().out
    assert '"mode": "coupled"' in out and "generated:" in out


def test_build_lora_planes():
    """disagg: a server pool of the FFN hooks holding every adapter, with
    the FFN pool it serves; coupled: a pool of every target; both with the
    traffic's true ranks."""
    cfg = dataclasses.replace(bridge.config_from(
        get_config("qwen3-moe-235b-a22b").reduced()), n_layers=1)
    ranks = (2, 4)
    c = tserve.build_lora(cfg, "coupled", ranks, dtype=torch.float32,
                          device="cpu")
    assert set(c) == {"pool"} and c["pool"].ranks == ranks
    assert set(c["pool"].tensors) == set(cfg.lora_targets)
    d = tserve.build_lora(cfg, "disagg", ranks, dtype=torch.float32,
                          device="cpu")
    assert set(d) == {"server", "pool"} and d["server"].n_replicas == 1
    assert [d["server"].true_rank(a) for a in range(2)] == list(ranks)
    assert set(d["pool"].tensors) == set(tserve.FFN_TARGETS)
    assert d["pool"].ranks == ranks
    with pytest.raises(ValueError, match="mode"):
        tserve.build_lora(cfg, "fused", ranks, device="cpu")


# ------------------------------ on the card ----------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card (CUDA kernel)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bgmv_kernel_matches_plain_on_card(cuda_device, dtype):
    for mixed in (False, True):
        x, A, B, ids = (torch.from_numpy(a).to(cuda_device)
                        for a in _bgmv_inputs(mixed))
        x, A, B = x.to(dtype), A.to(dtype), B.to(dtype)
        got = tbgmv.bgmv(x, A, B, ids)
        torch.testing.assert_close(got, tref.bgmv_ref(x, A, B, ids), rtol=0,
                                   atol=1e-5)
        assert torch.all(got[ids < 0] == 0)
        assert torch.equal(got, tbgmv.bgmv(x, A, B, ids))  # same bits


def _any_rank_inputs(r, device, seed=12):
    """A bf16 pool of rank r with true ranks 1, r // 2, r and 3 (+0.0 past
    each), d_in = 200 and d_out = 48; rows of every adapter, two padding
    rows and an id past the pool."""
    rng = np.random.default_rng(seed)
    T, N, d_in, d_out = 9, 4, 200, 48
    ranks = np.array([1, r // 2, r, min(3, r)], np.int32)
    A = (rng.standard_normal((N, d_in, r)) / r).astype(np.float32)
    B = (rng.standard_normal((N, r, d_out)) * 0.1).astype(np.float32)
    for n, k in enumerate(ranks):
        A[n, :, k:] = 0.0
        B[n, k:] = 0.0
    x = rng.standard_normal((T, d_in)).astype(np.float32)
    ids = np.array([0, -1, 3, 1, 2, -1, 3, 0, 9], np.int32)
    x, A, B = (torch.from_numpy(a).to(device, torch.bfloat16)
               for a in (x, A, B))
    return x, A, B, torch.from_numpy(ids).to(device), \
        torch.from_numpy(ranks).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [4, 24])
def test_bgmv_kernels_take_any_rank_on_card(cuda_device, r):
    """bf16 ranks that are not a multiple of the 8-value vector (4) or
    whose 3 vector groups do not divide the block (24): bgmv and
    bgmv_ranked against their twins, padding rows exact 0, the same bits
    twice, and ranked == padded on the prefix-zero pool; at 9 rows (the
    clusters) and at 144 (the shrink/expand pair)."""
    x, A, B, ids, ranks = _any_rank_inputs(r, cuda_device)
    for reps in (1, 16):
        x, ids = x[:9].repeat(reps, 1), ids[:9].repeat(reps)
        got = tbgmv.bgmv(x, A, B, ids)
        torch.testing.assert_close(got, tref.bgmv_ref(x, A, B, ids), rtol=0,
                                   atol=1e-5)
        ranked = tbgmv.bgmv_ranked(x, A, B, ids, ranks)
        torch.testing.assert_close(ranked, tref.bgmv_ranked_ref(
            x, A, B, ids, ranks), rtol=0, atol=1e-5)
        assert torch.all(got[ids < 0] == 0)
        assert torch.equal(got, tbgmv.bgmv(x, A, B, ids))
        assert torch.equal(ranked, got)


@pytest.mark.gpu
def test_bgmv_is_one_launch_a_call_on_card(cuda_device):
    """One kernel a call below 128 rows, by the launch counter and by the
    profiler, at the coupled plane's q shape (T = 8, d 4096 -> r 32 -> 8192:
    clusters of 16 blocks a row) and at T = 40 (clusters of 2); at T = 200
    the shrink/expand pair, one call by the counter; padding rows in
    each."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(13)
    cases = []
    for T, d_in, r, d_out in ((8, 4096, 32, 8192), (40, 256, 16, 128),
                              (200, 512, 24, 1024)):
        A = torch.from_numpy((rng.standard_normal((4, d_in, r)) / r)
                             .astype(np.float32)).to(cuda_device).bfloat16()
        B = torch.from_numpy((rng.standard_normal((4, r, d_out)) * 0.01)
                             .astype(np.float32)).to(cuda_device).bfloat16()
        x = torch.randn(T, d_in, device=cuda_device).bfloat16()
        ids = torch.from_numpy(rng.integers(-1, 4, T).astype(np.int32)
                               ).to(cuda_device)
        cases.append((x, A, B, ids))
    for args in cases:
        tbgmv.bgmv(*args)
    torch.cuda.synchronize()
    before = tbgmv.bgmv.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for args in cases + cases:
            got = tbgmv.bgmv(*args)
            torch.testing.assert_close(got, tref.bgmv_ref(*args), rtol=0,
                                       atol=1e-4)
        torch.cuda.synchronize()
    assert tbgmv.bgmv.launches - before == 6
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    count = {k: sum(bool(re.search(rf"\bbgmv_{k}_kernel\b", n))
                    for n in names)
             for k in ("cluster", "shrink", "expand")}
    assert count == {"cluster": 4, "shrink": 2, "expand": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [32, 1024])
def test_bgmv_cluster_plan_fills_the_card(cuda_device, dtype, r):
    """csrc/bgmv.cu plans the clusters: about one block an SM (T * kc <= SMs,
    and twice kc would not fit) up to 16 blocks a row, 8 where a 16-block
    cluster does not fit; rank 1024 takes 68 KiB of dynamic shared memory,
    past the default limit, and the kernel still matches its twin there."""
    lib = tbgmv._lib("bgmv", 7, 5)
    code = 1 if dtype == torch.bfloat16 else 0
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    top = lib.bgmv_cluster_size(code, code, 1, r, 1 << 20)
    assert top in (8, 16)
    for T in (1, 8, 40, 127):
        kc = lib.bgmv_cluster_size(code, code, T, r, n_sm)
        assert kc in (1, 2, 4, 8, 16) and kc <= top
        assert kc == 1 or T * kc <= n_sm
        assert kc == top or 2 * kc * T > n_sm
    rng = np.random.default_rng(14)
    T, d_in, d_out = 8, 256, 128
    A = torch.from_numpy((rng.standard_normal((3, d_in, r)) / r)
                         .astype(np.float32)).to(cuda_device, dtype)
    B = torch.from_numpy((rng.standard_normal((3, r, d_out)) * 0.01)
                         .astype(np.float32)).to(cuda_device, dtype)
    x = torch.randn(T, d_in, device=cuda_device).to(dtype)
    ids = torch.tensor([0, 2, -1, 1, 1, 0, 2, -1], dtype=torch.int32,
                       device=cuda_device)
    torch.testing.assert_close(tbgmv.bgmv(x, A, B, ids),
                               tref.bgmv_ref(x, A, B, ids), rtol=0,
                               atol=1e-4)

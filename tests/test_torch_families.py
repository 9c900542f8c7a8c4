"""The port's dense, vlm and other moe configs against the JAX reference, on
the CPU in f32, each at a reduced size with its distinguishing shape put
back (plain ``reduced()`` fixes 4 heads over 2 KV heads of 32 and zero qkv
biases, which makes qwen2, smollm and internvl2 one model):

  - qwen2 (qkv bias, tied head), with biases drawn non-zero in both
    packages; starcoder2 (GELU MLP, no ``gate`` target); smollm (6 heads
    over 2, hd 64); internvl2 (vlm, 7 heads over 1, hd 64); mixtral (8
    experts, top-2); gpt-oss (hd 64, so H*hd != d)
  - ``layers.mlp`` and ``transformer._mlp_with_lora`` against the
    reference's; the GELU is the reference's tanh form
  - one coupled ``decode_step_slots`` on all the config's targets, logits
    and KV within LOGIT_TOL
  - the engine's greedy tokens against the reference engine's on every
    plane the reference serves the family on: coupled, paged and dense,
    for dense and vlm; disaggregated on the host and the fused transport,
    and coupled on the same expert-FFN pool, for moe
  - a dense pool's layout and bytes; ``expert_ffn``'s GELU branch; the
    quickstart on a dense arch
  - a non-MoE model on the disaggregated plane is refused with its
    message: by the engine, the cluster, the front door and the launcher;
    an ssm model's first slot admission with the reference's message
  - ``param_specs`` of the ssm, hybrid and audio families equals the
    reference's tree
  - on the card (``gpu``): the same engine runs through the kernels

Weights, adapter pools and prompts are numpy draws from a fixed seed at the
reference initialisers' scales (qkv biases non-zero), given to the
reference as they are and to the port through ``repro_torch.bridge``.
Tolerances: logits and KV 1e-4 abs (f32, two layers, as
tests/test_torch_model.py), the MLPs 1e-5 abs; token streams exact."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import adapter as jadapter
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.serving import engine as jengine
from repro_torch import bridge
from repro_torch.core import adapter as tadapter
from repro_torch.core import lora_server as tls
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.serving import engine as tengine
from repro_torch.serving.api import ServeConfig, build_system
from repro_torch.serving.cache import LoRACache
from repro_torch.serving.cluster import Cluster, ClusterConfig
from repro_torch.serving.server_pool import ServerPool

LOGIT_TOL = 1e-4
MLP_TOL = 1e-5
RANKS = [2, 8, 4, 8]
FFN = ("gate", "up", "down")
# (rid, prompt length, adapter, admitted after this many decode steps)
REQUESTS = [(0, 7, 0, 0), (1, 5, 1, 0), (2, 9, 2, 0), (3, 6, 3, 2)]
NEW_TOKENS = 5
ENGINE = dict(max_len=32, n_slots=4, page_size=4, prefill_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread is as fast
    alone, and spares the other test workers on the host its threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _restored(name, **shape):
    return lambda: dataclasses.replace(get_config(name).reduced(),
                                       lora_rank=8, **shape)


# each config's distinguishing shape on top of the reference's reduced()
CASES = {
    "qwen2": _restored("qwen2-1.5b"),
    "starcoder2": _restored("starcoder2-15b"),
    "smollm": _restored("smollm-360m", n_heads=6, n_kv_heads=2, head_dim=64),
    "internvl2": _restored("internvl2-1b", n_heads=7, n_kv_heads=1,
                           head_dim=64),
    "mixtral": _restored("mixtral-8x7b", n_experts=8, top_k=2),
    "gpt-oss": _restored("gpt-oss-20b", head_dim=64),
}
DENSE = ("qwen2", "starcoder2", "smollm", "internvl2")
MOE = ("mixtral", "gpt-oss")


def _draw_params(jcfg, rng):
    """The reference's parameter tree (``param_specs``) drawn with numpy at
    its init scales (normal 0.02 or small 0.006, at most 1 / sqrt(fan_in);
    zeros), except the qkv biases: drawn non-zero, since a zero bias hides
    a missing add."""
    def make(path, spec):
        name = jax.tree_util.keystr(path)
        if spec.init == "zeros" and not any(f"'{b}'" in name
                                            for b in ("bq", "bk", "bv")):
            return np.zeros(spec.shape, np.float32)
        scale = 0.2 if spec.init == "zeros" else \
            0.02 if spec.init == "normal" else 0.006
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        if spec.init != "zeros":
            scale = min(scale, 1.0 / np.sqrt(max(fan_in, 1)))
        return (rng.standard_normal(spec.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        make, jmodel.param_specs(jcfg),
        is_leaf=lambda x: isinstance(x, jmodel.PSpec))


def _draw_pool(jcfg, rng, alpha=16.0):
    """A mixed-rank pool over the config's targets, drawn with numpy at the
    reference initialiser's scales (A ~ N(0, 1) / r, B ~ N(0, 1) * 0.01
    times r / r_i), +0.0 past each adapter's true rank: the reference's
    ``AdapterPool`` (its factors as jax arrays) and the factors as numpy."""
    r, n = max(RANKS), len(RANKS)
    keep = np.arange(r)[None, :] < np.asarray(RANKS)[:, None]    # (N, r)
    tensors = {}
    for tgt in jadapter.active_targets(jcfg):
        d_in, d_out, per_expert = jadapter.target_dims(jcfg, tgt)
        mid = (jcfg.n_layers, n) + ((jcfg.n_experts,) if per_expert else ())
        lead = (1, n) + (1,) * (len(mid) - 2)
        A = rng.standard_normal(mid + (d_in, r)) / r
        B = rng.standard_normal(mid + (r, d_out)) * 0.01 * \
            (r / np.asarray(RANKS, np.float64)).reshape(lead + (1, 1))
        tensors[tgt] = {
            "A": np.where(keep.reshape(lead + (1, r)), A, 0.0)
            .astype(np.float32),
            "B": np.where(keep.reshape(lead + (r, 1)), B, 0.0)
            .astype(np.float32)}
    pool = jadapter.AdapterPool(
        jcfg, n, r, alpha / r,
        jax.tree_util.tree_map(jnp.asarray, tensors), tuple(RANKS))
    return pool, tensors


@functools.lru_cache(maxsize=None)
def _setup(case):
    """The reference's config, its params and mixed-rank pool over all the
    config's targets (numpy draws from a seed, the same for both
    packages), their bridges, and the prompts."""
    jcfg = CASES[case]()
    rng = np.random.default_rng(0)
    params = _draw_params(jcfg, rng)
    pool, pool_np = _draw_pool(jcfg, rng)
    tcfg = bridge.config_from(jcfg)
    tparams = bridge.tree_to_tensors(params)
    tpool = bridge.adapter_pool(tcfg, pool_np, pool.rank, pool.scale,
                                pool.ranks)
    prompts = {rid: rng.integers(0, jcfg.vocab_size, n).tolist()
               for rid, n, _, _ in REQUESTS}
    return jcfg, params, pool, tcfg, tparams, tpool, prompts


def test_restored_shapes_are_distinct_models():
    """The cases differ where plain reduced() makes them one model."""
    shapes = {}
    for case in CASES:
        c = _setup(case)[3]
        shapes[case] = (c.family, c.n_heads, c.n_kv_heads, c.head_dim,
                        c.qkv_bias, c.tie_embeddings, c.gated_mlp,
                        c.n_experts, c.lora_targets)
    assert len(set(shapes.values())) == len(CASES)
    gpt = _setup("gpt-oss")[3]
    assert gpt.n_heads * gpt.head_dim != gpt.d_model
    assert _setup("internvl2")[3].family == "vlm"
    assert "gate" not in _setup("starcoder2")[3].lora_targets


# --------------------------------- MLP ---------------------------------- #
def test_gelu_is_the_tanh_form():
    """jax.nn.gelu's default is the tanh approximation; torch's default is
    erf. At x = -3 the two forms differ by ~3.6e-4."""
    x = np.array([-3.0, -0.7, 0.5, 2.5], np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tlayers.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert abs(erf[0] - want[0]) > 1e-4


def _mlp_inputs(case, seed=4):
    jcfg, params, pool, tcfg, tparams, tpool, _ = _setup(case)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 2, jcfg.d_model)).astype(np.float32)
    ids = np.array([0, 3, -1, 1, 2, 0], np.int32)
    jp = {k: jnp.asarray(v[1]) for k, v in params["layers"]["mlp"].items()}
    tp = {k: v[1] for k, v in tparams["layers"]["mlp"].items()}
    return jcfg, tcfg, x, ids, jp, tp, pool, tpool


@pytest.mark.parametrize("case", DENSE)
def test_mlp_matches_reference(case):
    jcfg, tcfg, x, _, jp, tp, _, _ = _mlp_inputs(case)
    want = np.asarray(jlayers.mlp(jnp.asarray(x), jp, jcfg))
    got = tlayers.mlp(torch.from_numpy(x), tp, tcfg).numpy()
    assert set(tp) == ({"up", "down"} | ({"gate"} if tcfg.gated_mlp
                                          else set()))
    np.testing.assert_allclose(got, want, rtol=0, atol=MLP_TOL)


@pytest.mark.parametrize("case", DENSE)
def test_mlp_with_lora_matches_reference(case):
    """The MLP with its gate/up/down adapters, rows of every adapter and a
    row of none; the deltas are visible."""
    jcfg, tcfg, x, ids, jp, tp, pool, tpool = _mlp_inputs(case)
    tgts = [t for t in FFN if t in pool.tensors]
    jl = {t: {f: jnp.asarray(pool.tensors[t][f][1]) for f in ("A", "B")}
          for t in tgts}
    tl = {t: {f: tpool.tensors[t][f][1] for f in ("A", "B")} for t in tgts}
    want = np.asarray(jtransformer._mlp_with_lora(
        jnp.asarray(x), jp, jcfg, jl, jnp.asarray(ids), pool.scale))
    got = ttransformer._mlp_with_lora(torch.from_numpy(x), tp, tcfg, tl,
                                      torch.from_numpy(ids),
                                      tpool.scale).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MLP_TOL)
    base = tlayers.mlp(torch.from_numpy(x), tp, tcfg).numpy()
    assert np.abs(got - base).max() > 1e-3


# ------------------------------ decode step ----------------------------- #
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
    pos = np.array([5, 2, 9, -1], np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (4, 1)).astype(np.int32)
    ads = np.array([1, 3, 0, -1], np.int32)
    return k, v, bt, pos, toks, ads


def _port_step(tcfg, tparams, k, v, bt, pos, toks, ctx):
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    return ttransformer.decode_step_slots(
        tparams, tcfg, tk, tv, torch.from_numpy(toks).long(),
        torch.from_numpy(pos), ctx,
        block_table=None if bt is None else torch.from_numpy(bt))


# every config on the paged pool; the dense slab's attention is shared by
# all families (the engines' dense runs hold its tokens)
STEP_CASES = [(c, True) for c in CASES] + [("qwen2", False)]


@pytest.mark.parametrize("case,paged", STEP_CASES,
                         ids=[f"{c}-{'paged' if p else 'dense'}"
                              for c, p in STEP_CASES])
def test_decode_step_logits_match(case, paged):
    """One coupled decode step on all the config's targets: the active
    rows' logits and the KV written, against the reference; the adapters
    and (where the config has them) the qkv biases move the logits."""
    jcfg, params, pool, tcfg, tparams, tpool, _ = _setup(case)
    k, v, bt, pos, toks, ads = _step_inputs(jcfg, paged)
    jl, jk, jv = jtransformer.decode_step_slots(
        params, jcfg, jnp.asarray(k), jnp.asarray(v), jnp.asarray(toks),
        jnp.asarray(pos), pool.lora_ctx(jnp.asarray(ads)),
        block_table=None if bt is None else jnp.asarray(bt))
    tl, tk, tv = _port_step(tcfg, tparams, k, v, bt, pos, toks,
                            tpool.lora_ctx(torch.from_numpy(ads)))
    assert tuple(tl.shape) == (4, jcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=LOGIT_TOL)
    base, _, _ = _port_step(tcfg, tparams, k, v, bt, pos, toks, None)
    assert (base[:3] - tl[:3]).abs().max() > 1e-3
    if tcfg.qkv_bias:
        attn = tparams["layers"]["attn"]
        unbiased = {**tparams, "layers": {**tparams["layers"], "attn": {
            **attn, **{b: torch.zeros_like(attn[b])
                       for b in ("bq", "bk", "bv")}}}}
        nob, _, _ = _port_step(tcfg, unbiased, k, v, bt, pos, toks, None)
        assert (base[:3] - nob[:3]).abs().max() > 1e-3


# -------------------------------- engines ------------------------------- #
def _drive(engine, prompts):
    """Admit REQUESTS in two waves, decode NEW_TOKENS each, evict when
    done (the schedule of tests/test_torch_coupled.py)."""
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


def _ffn(pool):
    """The same adapters restricted to the expert-FFN targets (the LoRA
    Server's hooks), in either package."""
    return dataclasses.replace(
        pool, cfg=dataclasses.replace(pool.cfg, lora_targets=FFN),
        tensors={t: pool.tensors[t] for t in FFN})


@functools.lru_cache(maxsize=None)
def _reference_tokens(case):
    """The reference engine's greedy tokens on the paged layout, coupled:
    a dense or vlm config with all its targets, a moe config with its
    expert-FFN pool (the adapters the LoRA Server holds; the reference's
    coupled plane gives its disaggregated planes' tokens on that pool)."""
    jcfg, params, pool, *_, prompts = _setup(case)
    return _drive(jengine.Engine(
        jcfg, params, jengine.EngineConfig(paged=True, **ENGINE),
        pool=_ffn(pool) if jcfg.is_moe else pool), prompts)


def _port_engine(case, plane, paged, device="cpu"):
    """The port's engine on ``plane``: "coupled" (all the config's targets,
    or a moe config's FFN pool), or "host" / "fused" (the disaggregated
    plane over that transport)."""
    _, _, _, tcfg, tparams, tpool, _ = _setup(case)
    dev = torch.device(device)
    to = functools.partial(jax.tree_util.tree_map, lambda t: t.to(dev))
    tparams = to(tparams)
    tpool = dataclasses.replace(tpool, tensors=to(tpool.tensors))
    ecfg = tengine.EngineConfig(paged=paged, **ENGINE)
    if plane == "coupled":
        return tengine.Engine(tcfg, tparams, ecfg, device=dev, pool=_ffn(
            tpool) if tcfg.is_moe else tpool)
    # every adapter resident in a one-replica server pool
    ffn = _ffn(tpool)
    sp = ServerPool.build(tcfg, ffn, cache_slots=ffn.n, dtype=torch.float32,
                          device=dev)
    every = LoRACache(ffn.n, adapter_bytes=0, n_layers=tcfg.n_layers,
                      layerwise=False, prefetch=False)
    for aid in range(ffn.n):
        every.admit(aid, 0.0)
    sp.sync(every, lambda a: tls.pool_tensors_from_adapter(ffn, a),
            ffn.rank_of)
    return tengine.Engine(tcfg, tparams, ecfg, sp, pool=ffn, device=dev,
                          transport=plane)


# (case, port plane, paged): the planes the reference serves each family on
ENGINE_CASES = ([(c, "coupled", p) for c in DENSE for p in (True, False)]
                + [(c, plane, True) for c in MOE
                   for plane in ("host", "fused", "coupled")])


def _engine_id(case):
    c, plane, paged = case
    return f"{c}-{plane}-{'paged' if paged else 'dense'}"


@pytest.mark.parametrize("case", ENGINE_CASES,
                         ids=[_engine_id(c) for c in ENGINE_CASES])
def test_engine_tokens_match_reference(case):
    """Greedy tokens of the port's engine equal the reference engine's,
    with mid-decode admission and mixed ranks (the reference's paged ==
    dense and its coupled == disaggregated on an FFN pool, so each plane
    is held to one reference run)."""
    name, plane, paged = case
    want = _reference_tokens(name)
    eng = _port_engine(name, plane, paged)
    assert _drive(eng, _setup(name)[-1]) == want
    if plane == "fused":
        stats = eng.transport_stats()
        assert stats["host_dispatches"] == stats["steps"] > 0
        assert stats["hook_dispatches"] == 0


@pytest.mark.parametrize("case", ["qwen2", "starcoder2", "internvl2"])
def test_dense_pool_layout_and_bytes(case):
    """A dense pool's FFN targets carry no expert axis: the port draws the
    reference's shapes, keeps +0.0 past each true rank, and counts the
    reference's bytes (padded and true-rank) on the bridged pool."""
    jcfg, _, pool, tcfg, _, tpool, _ = _setup(case)
    drawn = tadapter.init_mixed_rank_pool(tcfg, RANKS, seed=1,
                                          dtype=torch.float32, device="cpu")
    r = max(RANKS)
    for t, ab in pool.tensors.items():
        assert ab["A"].ndim == 4
        for f in ("A", "B"):
            assert tuple(drawn.tensors[t][f].shape) == ab[f].shape
        for n, rank in enumerate(RANKS):
            A, B = drawn.tensors[t]["A"][:, n], drawn.tensors[t]["B"][:, n]
            assert torch.all(A[..., rank:] == 0) and \
                torch.all(B[..., rank:r, :] == 0)
    assert tpool.bytes_per_adapter() == pool.bytes_per_adapter()
    for aid in range(len(RANKS)):
        assert tpool.adapter_bytes(aid) == pool.adapter_bytes(aid)
    assert tcfg.lora_adapter_bytes(r, "float32") == \
        pool.bytes_per_adapter() == jcfg.lora_adapter_bytes(r, "float32")


# the reference's GELU experts as one XLA program (op by op, it would
# compile each of its ops)
_REF_GELU_FFN = jax.jit(functools.partial(jmoe.expert_ffn, gated=False,
                                          lora_scale=2.0))


def test_gelu_expert_ffn_matches_reference():
    """``expert_ffn``'s non-gated (GELU) branch, with expert deltas on up
    and down, against the reference's (no registered config reaches it)."""
    rng = np.random.default_rng(9)
    E, C, d, f, N, r = 3, 4, 16, 24, 2, 4
    xe = rng.standard_normal((E, C, d)).astype(np.float32)
    wu = (rng.standard_normal((E, d, f)) * 0.2).astype(np.float32)
    wd = (rng.standard_normal((E, f, d)) * 0.2).astype(np.float32)
    lora = {t: {"A": (rng.standard_normal((N, E, a, r)) / r)
                .astype(np.float32),
                "B": (rng.standard_normal((N, E, r, b)) * 0.1)
                .astype(np.float32)}
            for t, a, b in (("up", d, f), ("down", f, d))}
    ads = rng.integers(-1, N, E * C).astype(np.int32)
    want = np.asarray(_REF_GELU_FFN(xe, None, wu, wd, lora=lora,
                                    row_adapter=ads))
    got = tmoe.expert_ffn(
        torch.from_numpy(xe), None, torch.from_numpy(wu),
        torch.from_numpy(wd), lora=bridge.tree_to_tensors(lora),
        row_adapter=torch.from_numpy(ads), lora_scale=2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MLP_TOL)


def test_quickstart_serves_a_dense_arch_on_the_cpu(capsys):
    from repro_torch.launch import quickstart
    assert quickstart.main(["--device", "cpu", "--arch", "smollm-360m"]) \
        == 0
    out = capsys.readouterr().out
    assert "dense MLP" in out and "[cancelled]; slots in use: 0" in out


# ------------------------------- refusals ------------------------------- #
MOE_ONLY = "disaggregated hooks target MoE"


def test_engine_refuses_non_moe_server_before_allocating():
    """A server with a dense model is refused at construction, before any
    KV is made. An ssm model's engine is made (it serves the legacy
    static-batch API), and its first slot admission is refused with the
    reference's message, before any KV is made."""
    _, _, _, tcfg, tparams, tpool, _ = _setup("qwen2")
    ecfg = tengine.EngineConfig(**ENGINE)
    with pytest.raises(ValueError, match=MOE_ONLY):
        tengine.Engine(tcfg, tparams, ecfg, server=object(), device="cpu")
    ssm = dataclasses.replace(tcfg, family="ssm")
    eng = tengine.Engine(ssm, tparams, ecfg, pool=tpool, device="cpu")
    with pytest.raises(ValueError, match="Use the legacy prefill/decode API "
                                         "for ssm/hybrid/audio models"):
        eng.add_request(0, [1, 2, 3], 0)
    assert eng._k is None and eng.free_slots() == eng.n_slots


def test_front_door_and_cluster_refuse_disaggregated_dense():
    """``ServeConfig(disaggregated=True)`` on a dense model is refused at
    build_system (before the server pool's weights); the coupled plane
    serves it; the analytic plane prices it."""
    _, _, _, tcfg, tparams, tpool, prompts = _setup("qwen2")
    sc = dict(backend="cluster", n_instances=1, max_batch=4, max_len=32,
              paged=True, page_size=4, adapter_cache_slots=4)
    with pytest.raises(ValueError, match=MOE_ONLY):
        build_system(ServeConfig(disaggregated=True, **sc), tcfg)
    with pytest.raises(ValueError, match=MOE_ONLY):
        Cluster(tcfg, tparams, ClusterConfig(disaggregated=True), tpool)
    system = build_system(ServeConfig(disaggregated=False, **sc), tcfg,
                          params=tparams, pool=tpool)
    try:
        h = system.submit(prompts[0], adapter_id=1, max_new_tokens=3)
        system.drain()
        assert h.state.name == "FINISHED" and len(h.tokens) == 3
    finally:
        system.close()


def test_launcher_refuses_disagg_on_a_dense_arch(capsys):
    with pytest.raises(SystemExit, match="disaggregated hooks target MoE "
                                         "archs; use coupled"):
        tserve.main(["--arch", "qwen2-72b", "--mode", "disagg",
                     "--device", "cpu"])


def _spec_tree(specs):
    """{path: (shape, init)} of a ``param_specs`` tree (either package's)."""
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": s for p, s in _spec_tree(v).items()})
        else:
            out[k] = (tuple(v.shape), v.init)
    return out


def test_param_specs_take_the_slot_families():
    """The dense/vlm tree: an ``mlp`` subtree (no gate when not gated), no
    ``moe``. The ssm, hybrid and audio trees (rwkv's mixes, the hybrid's
    (G, every) mamba stack and its ``shared_attn``, the audio
    ``enc_layers``, ``enc_norm``, ``cross`` and ``ln3``) are the
    reference's, shapes and init kinds, full and reduced."""
    for case in DENSE:
        jcfg, params, _, tcfg, *_ = _setup(case)
        specs = tmodel.param_specs(tcfg)
        assert "moe" not in specs["layers"]
        got = {k: v.shape for k, v in specs["layers"]["mlp"].items()}
        assert got == {k: v.shape for k, v in
                       params["layers"]["mlp"].items()}
    for name in ("rwkv6-3b", "zamba2-2.7b", "seamless-m4t-large-v2"):
        for jcfg in (get_config(name), get_config(name).reduced()):
            assert _spec_tree(tmodel.param_specs(
                bridge.config_from(jcfg))) == \
                _spec_tree(jmodel.param_specs(jcfg))


# ------------------------------ on the card ----------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card (CUDA kernels)")
    return "cuda"


GPU_CASES = [("qwen2", "coupled"), ("starcoder2", "coupled"),
             ("internvl2", "coupled"), ("mixtral", "fused"),
             ("gpt-oss", "coupled")]


@pytest.mark.gpu
@pytest.mark.parametrize("case,plane", GPU_CASES,
                         ids=[f"{c}-{p}" for c, p in GPU_CASES])
def test_engine_on_card_gives_the_reference_tokens(cuda_device, case, plane):
    """The same engine on the card, through the kernels (f32 weights), gives
    the reference's tokens."""
    want = _reference_tokens(case)
    eng = _port_engine(case, plane, True, device=cuda_device)
    assert _drive(eng, _setup(case)[-1]) == want

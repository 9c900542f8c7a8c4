"""The port's static-batch API against the JAX reference, on the CPU in f32
at the reference's reduced configs (the decoder families; the ssm,
hybrid and audio ones are tests/test_torch_ssm.py's):

  - ``transformer.decode_step`` over 10 tokens against the reference's
    (jitted once a config) and against the port's own ``forward`` over
    the same tokens, logits and caches within TOL (the reference's
    tests/test_models.py:18-36), for smollm, qwen2, dbrx and qwen3-moe
  - int8 KV: ``quantize_kv`` gives the reference's codes and scales on the
    same inputs, ties included; a ``kv_quant`` decode gives the
    reference's logits within TOL, codes at most one apart (where the two
    packages' f32 inputs straddle a rounding boundary) and scales within
    1e-6 relative; its softmax within 0.05 of the unquantized decode's
    (tests/test_models.py:100-113)
  - ``decode_attention_update``'s ring buffer equals the full window
  - ``Engine.prefill``'s parallel mode equals its token replay, with and
    without ``kv_quant``, and gives the reference's cache and tokens
    (tests/test_system.py:51-86)
  - ``Engine.prefill`` / ``decode`` on reduced dbrx with a gate/up/down
    pool of rank 4: coupled == disaggregated through a ``LoRAServer`` and
    through a 2-replica ``ServerPool``, both the reference's tokens
    (tests/test_system.py:18-49)
  - refusals: the legacy disaggregated decode over an int8 cache; the
    slot engine's two, with the reference's messages

Weights are numpy draws at the reference initialisers' scales, the
zero- and one-initialised leaves (norms, biases) drawn around their value
so that a missing term shows; given to the reference as they are and to
the port through ``repro_torch.bridge``. TOL = 1e-4 abs (f32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import adapter as jadapter
from repro.models import cache as jcache
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro.serving import engine as jengine
from repro_torch import bridge
from repro_torch.core import lora_server as tls
from repro_torch.core.lora_server import pool_tensors_from_adapter
from repro_torch.models import cache as tcache
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.serving import engine as tengine
from repro_torch.serving.cache import LoRACache
from repro_torch.serving.server_pool import ServerPool

TOL = 1e-4
STEPS = 10
DECODER_ARCHS = ["smollm-360m", "qwen2-1.5b", "dbrx-132b",
                 "qwen3-moe-235b-a22b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and spares the other
    test workers on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draw_params(jcfg, seed: int = 0):
    """The reference's parameter tree drawn with numpy at its init scales
    (normal 0.02 or small 0.006, at most 1 / sqrt(fan_in)); the zero and
    one leaves drawn at 0.2 around 0 and 1."""
    rng = np.random.default_rng(seed)

    def make(path, spec):
        if spec.init in ("zeros", "ones"):
            base, scale = float(spec.init == "ones"), 0.2
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else \
                spec.shape[-1]
            base = 0.0
            scale = min(0.02 if spec.init == "normal" else 0.006,
                        1.0 / np.sqrt(max(fan_in, 1)))
        return (base + rng.standard_normal(spec.shape) * scale) \
            .astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        make, jmodel.param_specs(jcfg),
        is_leaf=lambda x: isinstance(x, jmodel.PSpec))


def both(jcfg, seed: int = 0):
    """(reference params, port config, port params) from one draw."""
    params = draw_params(jcfg, seed)
    return params, bridge.config_from(jcfg), bridge.tree_to_tensors(params)


# the reference's decode step, jitted once (a trace a config)
_ref_decode = jax.jit(jtransformer.decode_step, static_argnames=("cfg",))


def decode_both(jcfg, params, tcfg, tparams, toks, jc, tc):
    """STEPS decode steps of both packages from their caches ``jc``/``tc``:
    (reference logits (B, S, V), port logits, final caches)."""
    jl, tl = [], []
    for t in range(toks.shape[1]):
        a, jc = _ref_decode(params, cfg=jcfg, cache=jc,
                            tokens=jnp.asarray(toks[:, t:t + 1]))
        b, tc = ttransformer.decode_step(tparams, tcfg, tc,
                                         torch.as_tensor(toks[:, t:t + 1]))
        jl.append(np.asarray(a))
        tl.append(b.numpy())
    return np.stack(jl, 1), np.stack(tl, 1), jc, tc


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_decode_matches_reference_and_forward(arch):
    jcfg = get_config(arch).reduced()
    params, tcfg, tparams = both(jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, STEPS))
    jl, tl, jc, tc = decode_both(
        jcfg, params, tcfg, tparams, toks,
        jcache.init_cache(jcfg, 2, STEPS + 2, dtype=jnp.float32),
        tcache.init_cache(tcfg, 2, STEPS + 2, dtype=torch.float32))
    assert np.abs(jl - tl).max() < TOL
    fwd, _ = ttransformer.forward(tparams, tcfg, torch.as_tensor(toks))
    assert np.abs(fwd.numpy() - tl).max() < TOL
    got, want = bridge.cache_to_numpy(tc), jax.tree_util.tree_map(
        np.asarray, jc)
    assert got.keys() == want.keys() and got["pos"] == want["pos"] == STEPS
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name], want[name], atol=TOL)


def test_quantize_kv_equals_reference_on_the_same_inputs():
    """Codes and scales of both packages' quantizers on one f32 input,
    with exact ties x / scale = n + 1/2 planted (both round half to
    even), all-zero rows (the 1e-6 floor) and +-127 at the row's max."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 1, 1] = np.arange(16, dtype=np.float32) - 7.5      # ties at 127
    x[2, 2, 0, :4] = [127.0, 0.5, 1.5, -2.5]
    jq, js = jcache.quantize_kv(jnp.asarray(x))
    tq, ts = tcache.quantize_kv(torch.as_tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    kq, ks = tlayers.quantize_kv_token(torch.as_tensor(x[0]))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(
        jlayers.quantize_kv_token(jnp.asarray(x[0]))[0]))


def test_int8_decode_matches_reference():
    jcfg = get_config("smollm-360m").reduced()
    params, tcfg, tparams = both(jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 6))
    jl, tl, jc, tc = decode_both(
        jcfg, params, tcfg, tparams, toks,
        jcache.init_cache(jcfg, 2, 8, kv_quant=True),
        tcache.init_cache(tcfg, 2, 8, kv_quant=True))
    assert np.abs(jl - tl).max() < TOL
    got, want = bridge.cache_to_numpy(tc), jax.tree_util.tree_map(
        np.asarray, jc)
    for name in ("k", "v"):
        assert got[name].dtype == np.int8 == want[name].dtype
        diff = np.abs(got[name].astype(np.int32) - want[name])
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        np.testing.assert_allclose(got[name + "_scale"],
                                   want[name + "_scale"], rtol=1e-6)
    # int8 against the unquantized KV, the reference's own bound
    _, full, _, _ = decode_both(
        jcfg, params, tcfg, tparams, toks,
        jcache.init_cache(jcfg, 2, 8, dtype=jnp.float32),
        tcache.init_cache(tcfg, 2, 8, dtype=torch.float32))
    p_q = torch.softmax(torch.as_tensor(tl[:, -1]), -1)
    p_f = torch.softmax(torch.as_tensor(full[:, -1]), -1)
    assert (p_q - p_f).abs().max().item() < 0.05


def test_ring_buffer_equals_full_window_decode():
    """The hybrid's ring buffer (write_slot = pos % W, key_positions) gives
    the full cache's windowed attention, and the reference's."""
    B, KV, hd, W, T = 1, 2, 8, 4, 10
    g = torch.Generator().manual_seed(0)
    full = [torch.zeros(B, T, KV, hd) for _ in range(2)]
    ring = [torch.zeros(B, W, KV, hd) for _ in range(2)]
    kp = torch.full((W,), -1, dtype=torch.int32)
    jring = [jnp.zeros((B, W, KV, hd)) for _ in range(2)]
    jkp = jnp.full((W,), -1, jnp.int32)
    for t in range(T):
        k, v, q = (torch.randn(B, KV, hd, generator=g) for _ in range(3))
        o_full = tlayers.decode_attention_update(q, k, v, *full, t,
                                                 window=W)[0]
        o_ring = tlayers.decode_attention_update(
            q, k, v, *ring, t, window=W, key_positions=kp,
            write_slot=t % W)[0]
        o_ref, *jring, _, _, jkp = jlayers.decode_attention_update(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
            jnp.asarray(v.numpy()), *jring, jnp.int32(t), window=W,
            key_positions=jkp, write_slot=jnp.int32(t % W))
        torch.testing.assert_close(o_ring, o_full, atol=1e-5, rtol=0)
        np.testing.assert_allclose(o_ring.numpy(), np.asarray(o_ref),
                                   atol=1e-5)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_prefill_parallel_equals_replay(quant):
    """``Engine.prefill``'s one parallel forward gives the cache of a
    token-by-token replay through ``decode_step`` (int8: the dequantized
    values), and the same decoded tokens from either; the reference's
    cache and tokens too."""
    jcfg = get_config("qwen2-1.5b").reduced()
    params, tcfg, tparams = both(jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 5))
    eng = tengine.Engine(tcfg, tparams, tengine.EngineConfig(
        max_len=16, kv_quant=quant), device="cpu")
    fast = eng.prefill(toks)
    slow = tcache.init_cache(tcfg, 2, 16, quant)
    for t in range(5):
        _, slow = ttransformer.decode_step(tparams, tcfg, slow,
                                           torch.as_tensor(toks[:, t:t + 1]))
    assert fast["pos"] == slow["pos"] == 5

    def values(c, name):
        a = c[name].to(torch.float32)
        return (a * c[name + "_scale"] if quant else a).numpy()

    jeng = jengine.Engine(jcfg, params, jengine.EngineConfig(
        max_len=16, kv_quant=quant))
    jfast = jax.tree_util.tree_map(np.asarray, jeng.prefill(
        jnp.asarray(toks)))
    for name in ("k", "v"):
        np.testing.assert_allclose(values(fast, name), values(slow, name),
                                   atol=5e-2, rtol=5e-2)
        want = jfast[name].astype(np.float32)
        if quant:
            want = want * jfast[name + "_scale"]
        np.testing.assert_allclose(values(fast, name), want, atol=5e-2,
                                   rtol=5e-2)
    last = np.full((2, 1), 3)
    got = eng.decode(fast, last, 4)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 4)
    np.testing.assert_array_equal(got.numpy(), eng.decode(slow, last,
                                                          4).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jeng.decode(
        jeng.prefill(jnp.asarray(toks)), jnp.asarray(last), 4)))


# --------------------- the engine end to end (dbrx) --------------------- #
@pytest.fixture(scope="module")
def dbrx():
    """Reduced dbrx with a gate/up/down pool of 4 rank-4 adapters (numpy
    draws at the reference's scales), 3 prompts of 6 tokens; the
    reference's coupled Engine tokens."""
    jcfg = dataclasses.replace(get_config("dbrx-132b").reduced(),
                               lora_targets=("gate", "up", "down"),
                               lora_rank=4)
    params, tcfg, tparams = both(jcfg)
    rng = np.random.default_rng(2)
    tensors = {}
    for tgt in jadapter.active_targets(jcfg):
        d_in, d_out, _ = jadapter.target_dims(jcfg, tgt)
        mid = (jcfg.n_layers, 4, jcfg.n_experts)
        tensors[tgt] = {
            "A": (rng.standard_normal(mid + (d_in, 4)) / 4)
            .astype(np.float32),
            "B": (rng.standard_normal(mid + (4, d_out)) * 0.01)
            .astype(np.float32)}
    pool = jadapter.AdapterPool(
        jcfg, 4, 4, 16.0 / 4,
        jax.tree_util.tree_map(jnp.asarray, tensors))
    tpool = bridge.adapter_pool(tcfg, tensors, 4, 16.0 / 4)
    prompts = rng.integers(0, jcfg.vocab_size, (3, 6))
    ids = np.array([0, 2, 3], np.int32)
    jeng = jengine.Engine(jcfg, params, jengine.EngineConfig(max_len=32),
                          pool=pool)
    want = np.asarray(jeng.decode(jeng.prefill(jnp.asarray(prompts)),
                                  jnp.asarray(prompts[:, -1:]), 5,
                                  adapter_ids=jnp.asarray(ids)))
    return dict(jcfg=jcfg, params=params, pool=pool, tcfg=tcfg,
                tparams=tparams, tpool=tpool, prompts=prompts, ids=ids,
                want=want)


def _server(kind, s):
    """The port's disaggregated plane over ``s["tpool"]``: one LoRAServer,
    or a ServerPool of 2 replicas (each adapter on its affinity home)."""
    tcfg, tpool = s["tcfg"], s["tpool"]
    if kind == "server":
        server = tls.LoRAServer(tcfg, tls.ServerConfig(
            m=1, x=1, y=1, cache_slots=4, rank=4), dtype=torch.float32,
            device="cpu")
        for aid in range(tpool.n):
            server.insert(aid, pool_tensors_from_adapter(tpool, aid))
        return server
    sp = ServerPool.build(tcfg, tpool, cache_slots=4, n_replicas=2,
                          dtype=torch.float32, device="cpu")
    every = LoRACache(tpool.n, adapter_bytes=0, n_layers=tcfg.n_layers,
                      layerwise=False, prefetch=False)
    for aid in range(tpool.n):
        every.admit(aid, 0.0)
    sp.sync(every, lambda a: pool_tensors_from_adapter(tpool, a),
            tpool.rank_of)
    return sp


@pytest.mark.parametrize("kind", ["server", "pool2"])
def test_engine_coupled_equals_disagg_and_reference(dbrx, kind):
    s = dbrx
    ecfg = tengine.EngineConfig(max_len=32)
    coupled = tengine.Engine(s["tcfg"], s["tparams"], ecfg, pool=s["tpool"],
                             device="cpu")
    disagg = tengine.Engine(s["tcfg"], s["tparams"], ecfg,
                            server=_server(kind, s), pool=s["tpool"],
                            device="cpu")
    toks = {}
    for name, eng in (("coupled", coupled), ("disagg", disagg)):
        cache = eng.prefill(s["prompts"])
        toks[name] = eng.decode(cache, s["prompts"][:, -1:], 5,
                                adapter_ids=s["ids"]).numpy()
    np.testing.assert_array_equal(toks["coupled"], toks["disagg"])
    np.testing.assert_array_equal(toks["disagg"], s["want"])
    assert toks["coupled"].shape == (3, 5)
    if kind == "pool2":      # routed a step, and forgotten after it
        assert disagg.server._engaged is None
        assert disagg.server.compute_calls == 5 * 2 * s["tcfg"].n_layers


# ------------------------------- refusals -------------------------------- #
def test_legacy_disagg_decode_refuses_int8(dbrx):
    """The reference runs ``disagg_decode_step`` over an int8 cache without
    its scales (unscaled truncation, garbage tokens); the port refuses.
    The coupled plane serves the same cache."""
    s = dbrx
    ecfg = tengine.EngineConfig(max_len=32, kv_quant=True)
    eng = tengine.Engine(s["tcfg"], s["tparams"], ecfg,
                         server=_server("server", s), pool=s["tpool"],
                         device="cpu")
    cache = eng.prefill(s["prompts"])
    assert cache["k"].dtype == torch.int8
    with pytest.raises(ValueError, match="int8 KV"):
        eng.decode(cache, s["prompts"][:, -1:], 2, adapter_ids=s["ids"])
    coupled = tengine.Engine(s["tcfg"], s["tparams"], ecfg, pool=s["tpool"],
                             device="cpu")
    out = coupled.decode(coupled.prefill(s["prompts"]), s["prompts"][:, -1:],
                         2, adapter_ids=s["ids"])
    assert tuple(out.shape) == (3, 2)


@pytest.mark.parametrize("case", ["family", "kv_quant"])
def test_slot_engine_refusals_carry_reference_messages(case):
    """The slot path's two refusals, at the first admission, with the
    reference's messages word for word."""
    jcfg = get_config("smollm-360m").reduced()
    params, tcfg, tparams = both(jcfg)
    kw = {}
    if case == "family":
        jcfg = get_config("rwkv6-3b").reduced()
        params, tcfg, tparams = both(jcfg)
    else:
        kw = dict(kv_quant=True)
    with pytest.raises(ValueError) as want:
        jengine.Engine(jcfg, params, jengine.EngineConfig(
            max_len=16, **kw)).add_request(0, [1, 2, 3], 0)
    eng = tengine.Engine(tcfg, tparams, tengine.EngineConfig(
        max_len=16, **kw), device="cpu")
    with pytest.raises(ValueError) as got:
        eng.add_request(0, [1, 2, 3], 0)
    assert str(got.value) == str(want.value)
    assert eng._k is None

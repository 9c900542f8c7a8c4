"""The port's ssm, hybrid and audio families against the JAX reference, on
the CPU in f32 at the reference's reduced configs:

  - ``models/ssm.py`` one layer at a time: ``rwkv6_time_mix`` and
    ``rwkv6_channel_mix`` from a non-zero state, ``mamba2_forward`` from
    no state and from a carried one, and ``mamba2_decode_step``, each
    against the reference's within TOL (outputs and states); the chunked
    forms at chunks 1, 4 and 16 against each other within TOL (the
    reference's chunk-invariance tests)
  - ``transformer.decode_step`` over 10 tokens against the reference's
    (jitted once a config) and against the port's own ``forward`` within
    TOL, for rwkv6-3b, zamba2-2.7b (its ring-buffer window) and
    seamless-m4t-large-v2 (decoding against cross caches); rwkv6-3b also
    at its published layer widths (one layer, a vocabulary of 512)
  - the audio encoder-decoder: ``forward(collect_kv=True)``, then decode
    against its cross caches within TOL of the forward's logits
    (tests/test_models.py:148-177); against the reference's forward
    within AUDIO_TOL (below); an empty cross cache attends to exactly 0
  - ``Engine.prefill`` / ``decode`` of each family (the prompt replayed
    through ``decode_step``, bf16 caches) gives the reference Engine's
    tokens

AUDIO_TOL: the encoder runs in bf16 whatever the weights, in both
packages (the reference casts the frames to bf16). The port rounds at
every operation; the reference's compiled scan keeps f32 between fused
bf16 operations (XLA's default ``xla_allow_excess_precision``; with it
off the two agree within 1e-6). Cross K/V then part by one bf16 ulp here
and there, and the logits by ~2e-3; AUDIO_TOL = 1e-2.

Weights are numpy draws at the reference initialisers' scales, the zero-
and one-initialised leaves (token-shift mixes, decays, bonuses, norms,
A_log, D) drawn around their value (``test_torch_static.draw_params``).
TOL = 1e-4 abs (f32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import cache as jcache
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.serving import engine as jengine
from repro_torch import bridge
from repro_torch.models import cache as tcache
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.serving import engine as tengine
from test_torch_static import STEPS, TOL, both, decode_both

AUDIO_TOL = 1e-2
# the reference's forward with its K/V stacks, jitted once
_ref_forward_kv = jax.jit(
    lambda params, tokens, frames, cfg: jtransformer.forward(
        params, cfg, tokens, frontend_emb=frames, kind="prefill",
        collect_kv=True), static_argnames=("cfg",))
NEW_FAMILIES = ["rwkv6-3b", "zamba2-2.7b", "seamless-m4t-large-v2"]
# the reduced configs, and rwkv6-3b at its published layer widths (d 2560,
# 40 heads of 64, d_ff 8960; one layer, a vocabulary of 512), where a
# head's group norm sees the f32 rounding of 64-term sums as on the card
DECODE_CONFIGS = {arch: get_config(arch).reduced() for arch in NEW_FAMILIES}
DECODE_CONFIGS["rwkv6-3b-full-width"] = dataclasses.replace(
    get_config("rwkv6-3b"), n_layers=1, vocab_size=512)
CHUNKS = [1, 4, 16]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _x(jcfg, S=16, seed=9):
    return np.random.default_rng(seed).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def rwkv():
    jcfg = get_config("rwkv6-3b").reduced()
    params, tcfg, tparams = both(jcfg)
    lp = {k: v[0] for k, v in params["layers"].items()}
    rng = np.random.default_rng(4)
    st = [rng.standard_normal((2, jcfg.d_model)).astype(np.float32) * 0.5,
          rng.standard_normal((2, jcfg.d_model)).astype(np.float32) * 0.5,
          rng.standard_normal((2, jcfg.n_heads, jcfg.head_dim,
                               jcfg.head_dim)).astype(np.float32) * 0.1]
    return (jcfg, lp, jssm.RWKV6State(*map(jnp.asarray, st)), tcfg,
            bridge.tree_to_tensors(lp),
            tssm.RWKV6State(*map(torch.as_tensor, st)))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_rwkv6_time_mix_matches_reference(rwkv, chunk):
    jcfg, lp, jst, tcfg, tlp, tst = rwkv
    x = _x(jcfg)
    want, wst = jssm.rwkv6_time_mix(jnp.asarray(x), lp, jcfg, jst,
                                    chunk=chunk)
    got, gst = tssm.rwkv6_time_mix(torch.as_tensor(x), tlp, tcfg, tst,
                                   chunk=chunk)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL)
    for a, b in zip(gst, wst):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=TOL)
    whole, _ = tssm.rwkv6_time_mix(torch.as_tensor(x), tlp, tcfg, tst,
                                   chunk=16)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=TOL)


def test_rwkv6_channel_mix_matches_reference(rwkv):
    jcfg, lp, jst, tcfg, tlp, tst = rwkv
    x = _x(jcfg)
    want, wst = jssm.rwkv6_channel_mix(jnp.asarray(x), lp, jcfg, jst)
    got, gst = tssm.rwkv6_channel_mix(torch.as_tensor(x), tlp, tcfg, tst)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL)
    np.testing.assert_allclose(gst.shift_cm.numpy(), _np(wst.shift_cm),
                               atol=0)


@pytest.fixture(scope="module")
def mamba():
    jcfg = get_config("zamba2-2.7b").reduced()
    params, tcfg, tparams = both(jcfg)
    lp = {k: v[0, 0] for k, v in params["layers"].items()}
    rng = np.random.default_rng(5)
    nh = jcfg.d_inner // jcfg.ssm_head_dim
    st = [rng.standard_normal((2, nh, jcfg.ssm_head_dim, jcfg.ssm_state))
          .astype(np.float32) * 0.1,
          rng.standard_normal((2, jcfg.ssm_conv - 1,
                               jcfg.d_inner + 2 * jcfg.ssm_state))
          .astype(np.float32) * 0.5]
    return (jcfg, lp, jssm.Mamba2State(*map(jnp.asarray, st)), tcfg,
            bridge.tree_to_tensors(lp),
            tssm.Mamba2State(*map(torch.as_tensor, st)))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_mamba2_forward_matches_reference(mamba, chunk):
    """From no state (the prefill) and from a carried state (h and the
    conv tail), each against the reference at the same chunk and against
    the port's one-chunk form."""
    jcfg, lp, jst, tcfg, tlp, tst = mamba
    x = _x(jcfg)
    for js, ts in ((None, None), (jst, tst)):
        want, wst = jssm.mamba2_forward(jnp.asarray(x), lp, jcfg, js,
                                        chunk=chunk)
        got, gst = tssm.mamba2_forward(torch.as_tensor(x), tlp, tcfg, ts,
                                       chunk=chunk)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL)
        for a, b in zip(gst, wst):
            np.testing.assert_allclose(a.numpy(), _np(b), atol=TOL)
        whole, _ = tssm.mamba2_forward(torch.as_tensor(x), tlp, tcfg, ts,
                                       chunk=16)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=TOL)


def test_mamba2_decode_step_matches_reference(mamba):
    """Four recurrent steps from a carried state, the state threaded."""
    jcfg, lp, jst, tcfg, tlp, tst = mamba
    x = _x(jcfg, S=4)
    for t in range(4):
        want, jst = jssm.mamba2_decode_step(jnp.asarray(x[:, t:t + 1]), lp,
                                            jcfg, jst)
        got, tst = tssm.mamba2_decode_step(torch.as_tensor(x[:, t:t + 1]),
                                           tlp, tcfg, tst)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL)
    np.testing.assert_allclose(tst.h.numpy(), _np(jst.h), atol=TOL)
    init = tssm.mamba2_init_state(tcfg, 3)
    want = jssm.mamba2_init_state(jcfg, 3)
    assert [tuple(a.shape) for a in init] == [a.shape for a in want]


def _audio_caches(jcfg, tcfg, ck, cv, frames, max_len):
    """Both packages' decode caches with the cross K/V ``ck``/``cv``
    (L, B, frames, KV, hd) f32 numpy, padded to cross_kv_len."""
    jc = jcache.init_cache(jcfg, 2, max_len, dtype=jnp.float32)
    pad = ((0, 0), (0, 0), (0, jcfg.cross_kv_len - frames), (0, 0), (0, 0))
    jc["ck"], jc["cv"] = (jnp.asarray(np.pad(a, pad)) for a in (ck, cv))
    jc["cross_len"] = jnp.int32(frames)
    return jc, bridge.cache_from(jax.tree_util.tree_map(np.asarray, jc))


@pytest.mark.parametrize("arch", list(DECODE_CONFIGS))
def test_decode_matches_reference_and_forward(arch):
    jcfg = DECODE_CONFIGS[arch]
    params, tcfg, tparams = both(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, STEPS))
    fe = None
    if jcfg.family == "audio":
        fe = (rng.standard_normal((2, 8, jcfg.d_model)) * 0.1) \
            .astype(np.float32)
    fwd, aux = ttransformer.forward(
        tparams, tcfg, torch.as_tensor(toks), collect_kv=fe is not None,
        frontend_emb=None if fe is None else torch.as_tensor(fe))
    if fe is None:
        jc = jcache.init_cache(jcfg, 2, STEPS + 2, dtype=jnp.float32)
        tc = tcache.init_cache(tcfg, 2, STEPS + 2, dtype=torch.float32)
    else:       # the port's own cross K/V, given to both packages
        jc, tc = _audio_caches(jcfg, tcfg, *(a.float().numpy()
                                             for a in aux[1]), 8, STEPS + 2)
    jl, tl, jc, tc = decode_both(jcfg, params, tcfg, tparams, toks, jc, tc)
    assert np.abs(jl - tl).max() < TOL
    assert np.abs(fwd.numpy() - tl).max() < TOL
    got, want = bridge.cache_to_numpy(tc), jax.tree_util.tree_map(
        np.asarray, jc)
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name], want[name].astype(
            got[name].dtype), atol=TOL, err_msg=name)


def test_audio_forward_collects_cross_kv_as_reference():
    """The encoder-decoder's forward with ``collect_kv``: its K/V stacks'
    shapes and dtypes, the first decoder layer's self K/V (no encoder
    input yet) within TOL of the reference's, every other K/V and the
    logits within AUDIO_TOL (the bf16 encoder; see above); decoding
    from the reference's own cross caches gives the reference's forward
    within TOL, from an empty cross cache exactly zero cross attention."""
    jcfg = get_config("seamless-m4t-large-v2").reduced()
    params, tcfg, tparams = both(jcfg)
    rng = np.random.default_rng(6)
    fe = (rng.standard_normal((2, 8, jcfg.d_model)) * 0.1).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (2, 6))
    want, (jkv, jck) = _ref_forward_kv(params, jnp.asarray(toks),
                                       jnp.asarray(fe), cfg=jcfg)
    got, (tkv, tck) = ttransformer.forward(
        tparams, tcfg, torch.as_tensor(toks),
        frontend_emb=torch.as_tensor(fe), collect_kv=True)
    L, KV, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    assert tuple(tkv[0].shape) == (L, 2, 6, KV, hd)
    assert tuple(tck[0].shape) == (L, 2, 8, KV, hd)
    assert tck[0].dtype == torch.bfloat16 and tkv[0].dtype == torch.float32
    for a, b in zip(tkv, jkv):
        np.testing.assert_allclose(a[0].numpy(), _np(b[0]), atol=TOL)
    for a, b in zip(tkv + tck, jkv + jck):
        np.testing.assert_allclose(a.float().numpy(), _np(b),
                                   atol=AUDIO_TOL)
    assert np.abs(got.numpy() - _np(want)).max() < AUDIO_TOL
    # the reference's own cross caches: its forward's logits within TOL
    jc, tc = _audio_caches(jcfg, tcfg, *(_np(a) for a in jck), 8, 8)
    outs = []
    for t in range(6):
        lg, tc = ttransformer.decode_step(tparams, tcfg, tc,
                                          torch.as_tensor(toks[:, t:t + 1]))
        outs.append(lg.numpy())
    assert np.abs(np.stack(outs, 1) - _np(want)).max() < TOL
    # no cross K/V (cross_len 0): every key masked at the finite NEG_INF
    # gives the mean of the zero rows, exactly 0
    q = torch.randn(2, jcfg.n_heads, hd)
    empty = torch.zeros(2, jcfg.cross_kv_len, KV, hd)
    out = tlayers.decode_attention(q, empty, empty, 0)
    assert torch.isfinite(out).all() and not out.any()


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_static_engine_serves_family_as_reference(arch):
    """``Engine.prefill`` (the prompt replayed through ``decode_step``) and
    ``decode`` on the family's bf16 caches: the reference Engine's
    tokens; the slot path refuses the family."""
    jcfg = get_config(arch).reduced()
    params, tcfg, tparams = both(jcfg, seed=3)
    prompts = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 5))
    jeng = jengine.Engine(jcfg, params, jengine.EngineConfig(max_len=16))
    want = np.asarray(jeng.decode(jeng.prefill(jnp.asarray(prompts)),
                                  jnp.asarray(prompts[:, -1:]), 4))
    eng = tengine.Engine(tcfg, tparams, tengine.EngineConfig(max_len=16),
                         device="cpu")
    cache = eng.prefill(prompts)
    assert cache["pos"] == 5 and isinstance(cache["pos"], int)
    got = eng.decode(cache, prompts[:, -1:], 4)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="legacy prefill/decode"):
        eng.add_request(0, [1, 2], 0)

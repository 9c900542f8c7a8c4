"""The grouped expert GEMM (``ops.gmm``) on both serving planes' base expert
GEMMs: the dispatch's group sizes, the port's expert FFN and disaggregated
hook layer against the JAX reference on the same bridged weights (reduced
qwen3-moe config, f32), and, on the card, the Hopper kernel against its
plain twin.

Tolerances: the expert FFN 1e-5 abs (f32, d = 128, one GEMM chain), the
hook layer 1e-4 abs (as the decode-step tests); on the card 1e-4 abs for
bf16 operands summed in f32 over d <= 512 in another order than the twin's
(outputs of order 1), 1e-5 for the small f32 cases. Tests marked ``gpu``
skip here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import adapter as jadapter
from repro.core import disagg as jdisagg
from repro.core import lora_server as jls
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.core import disagg as tdisagg
from repro_torch.core import lora_server as tls
from repro_torch.kernels import gmm as tgmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model import layer_params

FFN_TOL = 1e-5
LAYER_TOL = 1e-4
RANKS = [2, 8, 4]
FFN = ("gate", "up", "down")


@pytest.fixture(scope="module")
def setup():
    """The reference's config, params and mixed-rank FFN pool, their
    bridges, and a LoRA server of each side holding the pool."""
    jcfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                               lora_targets=FFN, lora_rank=8)
    key = jax.random.PRNGKey(0)
    params = jmodel.init_params(jcfg, key, dtype="float32")
    pool = jadapter.init_mixed_rank_pool(jcfg, RANKS,
                                         jax.random.fold_in(key, 1),
                                         dtype=jnp.float32)
    tcfg = bridge.config_from(jcfg)
    tparams = bridge.tree_to_tensors(
        jax.tree_util.tree_map(np.asarray, params))
    tpool = bridge.adapter_pool(
        tcfg, jax.tree_util.tree_map(np.asarray, pool.tensors), pool.rank,
        pool.scale, pool.ranks)
    scfg = dict(m=1, x=1, y=1, cache_slots=4, rank=8)
    jsrv = jls.LoRAServer(jcfg, jls.ServerConfig(**scfg), dtype=jnp.float32)
    tsrv = tls.LoRAServer(tcfg, tls.ServerConfig(**scfg),
                          dtype=torch.float32, device="cpu")
    for aid in range(len(RANKS)):
        jsrv.insert(aid, jls.pool_tensors_from_adapter(pool, aid),
                    rank=pool.rank_of(aid))
        tsrv.insert(aid, tls.pool_tensors_from_adapter(tpool, aid),
                    rank=tpool.rank_of(aid))
    return jcfg, params, pool, tcfg, tparams, tpool, jsrv, tsrv


def _moe_layer(params, l):
    return jax.tree_util.tree_map(lambda a: np.asarray(a[l]),
                                  params["layers"]["moe"])


def _routed(setup, rows, seed, ties=False):
    """Rows of activations and the reference's routing of them by layer
    0's router (a zero router ties every expert)."""
    jcfg, params = setup[:2]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, jcfg.d_model)).astype(np.float32)
    rw = np.asarray(params["layers"]["moe"]["router"][0])
    ids, _ = jmoe.route(jnp.asarray(x), jnp.asarray(
        np.zeros_like(rw) if ties else rw), jcfg.n_experts, jcfg.top_k)
    return x, np.array(ids)


# ----------------------------- group sizes ----------------------------- #
@pytest.mark.parametrize("C", [4, 8])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "all_tied"])
def test_dispatch_group_sizes_match_reference(setup, ties, C):
    """``moe.dispatch`` = ``local_dispatch`` plus group sizes min(counts,
    C): expert e's filled rows of the reference's dispatch are exactly its
    first group_sizes[e] rows (C = 4 drops pairs, 8 is dropless)."""
    jcfg = setup[0]
    E = jcfg.n_experts
    x, ids = _routed(setup, 6, seed=2, ties=ties)
    jxe, jst = jmoe.local_dispatch(jnp.asarray(x), jnp.asarray(ids), C, E)
    xe, st, pair, gs = tmoe.dispatch(torch.from_numpy(x),
                                     torch.from_numpy(ids), C, E)
    filled = np.asarray(jst).reshape(E, C) < x.shape[0]
    assert gs.dtype == torch.int32
    np.testing.assert_array_equal(gs.numpy(), filled.sum(1))
    np.testing.assert_array_equal(
        gs.numpy(), np.minimum(np.bincount(ids.reshape(-1), minlength=E), C))
    for e in range(E):
        assert filled[e, : int(gs[e])].all() and not filled[e, int(gs[e]):].any()
    np.testing.assert_array_equal(xe.numpy(), np.asarray(jxe))
    three = tmoe.local_dispatch(torch.from_numpy(x), torch.from_numpy(ids),
                                C, E)
    assert len(three) == 3
    for a, b in zip(three, (xe, st, pair)):
        assert torch.equal(a, b)


# --------------------------- planes vs reference -------------------------- #
@pytest.mark.parametrize("with_lora", [False, True], ids=["base", "lora"])
def test_expert_ffn_through_gmm_matches_reference(setup, with_lora):
    """The port's expert FFN (base GEMMs through ops.gmm with the dispatch's
    group sizes; with the coupled plane's expert deltas) against the
    reference's einsum expert FFN on the same dispatch."""
    jcfg, params, pool, tcfg, tparams, tpool, _, _ = setup
    E, C = jcfg.n_experts, 8
    x, ids = _routed(setup, 6, seed=3)
    jxe, jst = jmoe.local_dispatch(jnp.asarray(x), jnp.asarray(ids), C, E)
    mp = _moe_layer(params, 1)
    ads = np.array([0, 2, -1, 1, 0, 2], np.int32)
    st = np.asarray(jst)
    row_ad = np.where(st < 6, ads[np.minimum(st, 5)], -1).astype(np.int32)
    jl = tl = None
    if with_lora:
        jl = {t: {f: jnp.asarray(pool.tensors[t][f][1]) for f in ("A", "B")}
              for t in FFN}
        tl = {t: {f: tpool.tensors[t][f][1] for f in ("A", "B")} for t in FFN}
    want = np.asarray(jmoe.expert_ffn(
        jxe, *(jnp.asarray(mp[k]) for k in FFN), lora=jl,
        row_adapter=jnp.asarray(row_ad), lora_scale=pool.scale))
    txe, _, _, gs = tmoe.dispatch(torch.from_numpy(x), torch.from_numpy(ids),
                                  C, E)
    got = tmoe.expert_ffn(txe, *(torch.from_numpy(mp[k]) for k in FFN),
                          lora=tl, row_adapter=torch.from_numpy(row_ad),
                          lora_scale=tpool.scale, group_sizes=gs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FFN_TOL)
    rows = np.arange(C)[None, :] < gs.numpy()[:, None]
    assert np.all(got[~rows] == 0.0)          # pad rows: exact zeros


def test_moe_hooks_layer_through_gmm_matches_reference(setup):
    """One disaggregated MoE layer (base GEMMs through ops.gmm, both server
    hooks) against the reference's ``_moe_hooks_layer``."""
    jcfg, params, _, tcfg, tparams, _, jsrv, tsrv = setup
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 1, jcfg.d_model)).astype(np.float32)
    ads = np.array([1, -1, 0, 2], np.int32)
    for l in range(jcfg.n_layers):
        jlp = jax.tree_util.tree_map(lambda a, l=l: jnp.asarray(a[l]),
                                     params["layers"])
        want = np.asarray(jdisagg._moe_hooks_layer(
            jnp.asarray(x), jlp, jcfg, l, jsrv, jnp.asarray(ads), 0.5))
        got = tdisagg._moe_hooks_layer(torch.from_numpy(x),
                                       _layer(tparams, l), tcfg, l,
                                       tsrv, torch.from_numpy(ads), 0.5)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LAYER_TOL)


def _layer(tparams, l):
    return layer_params(tparams["layers"], l)


@pytest.mark.parametrize("path", ["coupled", "disagg", "prefill"])
def test_base_expert_gemms_run_through_gmm(setup, monkeypatch, path):
    """Each MoE layer's gate, up and down GEMMs go through ops.gmm, with the
    dispatch's group sizes: the coupled decode (moe_block with expert
    deltas), the disaggregated hook layer and the LoRA-free prefill."""
    jcfg, _, _, tcfg, tparams, tpool, _, tsrv = setup
    calls = []
    real = tops.gmm

    def counted(xe, w, group_sizes=None):
        calls.append(group_sizes)
        return real(xe, w, group_sizes)

    monkeypatch.setattr(tops, "gmm", counted)
    rng = np.random.default_rng(5)
    lp = _layer(tparams, 0)
    x = torch.from_numpy(rng.standard_normal(
        (3, 1, jcfg.d_model)).astype(np.float32))
    ads = torch.tensor([0, 2, 1], dtype=torch.int32)
    if path == "coupled":
        tl = {t: {f: tpool.tensors[t][f][0] for f in ("A", "B")} for t in FFN}
        tmoe.moe_block(x, lp["moe"], tcfg, lora=tl, ids_tok=ads,
                       lora_scale=tpool.scale)
        n_layers = 1
    elif path == "disagg":
        tdisagg._moe_hooks_layer(x, lp, tcfg, 0, tsrv, ads, 0.5)
        n_layers = 1
    else:
        toks = torch.from_numpy(rng.integers(0, jcfg.vocab_size, (1, 8)))
        shape = (tcfg.n_layers, 1, 0, tcfg.n_kv_heads, tcfg.head_dim)
        ttransformer.prefill_chunk(tparams, tcfg, toks, torch.zeros(shape),
                                   torch.zeros(shape))
        n_layers = tcfg.n_layers - 1      # the last layer's MoE is skipped
    assert len(calls) == 3 * n_layers
    E = tcfg.n_experts
    for gs in calls:
        assert gs is not None and gs.dtype == torch.int32
        assert tuple(gs.shape) == (E,) and int(gs.sum()) > 0


# ------------------------------ on the card ----------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card (CUDA kernel)")
    return torch.device("cuda")


def _gmm_inputs(device, E, C, d, f, sizes, x_dtype=torch.bfloat16,
                w_dtype=torch.bfloat16, seed=0):
    """xe (E, C, d) with zero rows past each group, w (E, d, f) scaled to
    outputs of order 1, group sizes (E,) int32."""
    rng = np.random.default_rng(seed)
    xe = rng.standard_normal((E, C, d)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    for e in range(E):
        xe[e, gs[e]:] = 0.0
    w = (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32)
    return (torch.from_numpy(xe).to(device, x_dtype),
            torch.from_numpy(w).to(device, w_dtype),
            torch.from_numpy(gs).to(device))


def _dispatch_sizes(E, tokens, top_k, seed):
    """Rows per expert of ``tokens`` tokens, each routed to top_k distinct
    experts (the decode and prefill dispatches' shape)."""
    rng = np.random.default_rng(seed)
    picks = np.argsort(rng.random((tokens, E)), axis=1)[:, :top_k]
    return np.bincount(picks.reshape(-1), minlength=E)


@pytest.mark.gpu
@pytest.mark.parametrize("tokens", [8, 64], ids=["decode", "prefill"])
def test_gmm_kernel_at_the_dispatches_on_card(cuda_device, tokens):
    """Decode (8 tokens top-8 over 32 experts, C = 64) and a 64-token
    prefill chunk (C = 512, groups over one 32-row tile) at d = 512, f =
    384, every GEMM of the gated FFN."""
    E, K = 32, 8
    sizes = _dispatch_sizes(E, tokens, K, seed=1)
    for d, f in ((512, 384), (384, 512)):
        xe, w, gs = _gmm_inputs(cuda_device, E, tokens * K, d, f, sizes)
        got = tgmm.gmm(xe, w, gs)
        torch.testing.assert_close(got, tref.gmm_ref(xe, w, gs), rtol=0,
                                   atol=1e-4)
        assert torch.equal(got, tgmm.gmm(xe, w, gs))      # same bits


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "empty", "ragged_c", "no_sizes", "k_tail", "d_not_vec", "big_group",
    "f32_f32", "f32_bf16", "bf16_f32"])
def test_gmm_kernel_edge_cases_on_card(cuda_device, case):
    """Every expert empty; C = 20 (not a multiple of 16); group_sizes None;
    d = 200 (a partial stage of d); d = 100 (not a multiple of 8: the
    CUDA-core kernel); a group of 70 rows (three 32-row tiles); and the
    f32 / bf16 mixes (the CUDA-core kernel, IEEE f32)."""
    E, C, d, f = 6, 40, 128, 96
    sizes = [0, 3, 17, 1, 40, 9]
    dt = {"x": torch.bfloat16, "w": torch.bfloat16}
    tol = 1e-4
    if case == "empty":
        sizes = [0] * E
    elif case == "ragged_c":
        C, sizes = 20, [0, 20, 16, 1, 5, 19]
    elif case == "k_tail":
        d = 200
    elif case == "d_not_vec":
        d = 100
    elif case == "big_group":
        C, sizes = 80, [70, 0, 33, 80, 2, 31]
    elif case.startswith(("f32", "bf16")):
        a, b = case.split("_")
        dt = {"x": torch.float32 if a == "f32" else torch.bfloat16,
              "w": torch.float32 if b == "f32" else torch.bfloat16}
        tol = 1e-5
    xe, w, gs = _gmm_inputs(cuda_device, E, C, d, f, sizes, dt["x"], dt["w"])
    if case == "no_sizes":
        xe = torch.randn(xe.shape, device=cuda_device).to(xe.dtype)
        got, want = tgmm.gmm(xe, w), tref.gmm_ref(xe, w)
    else:
        got, want = tgmm.gmm(xe, w, gs), tref.gmm_ref(xe, w, gs)
        rows = torch.arange(C, device=cuda_device)[None, :] < gs[:, None]
        assert torch.all(got[~rows] == 0) and not got[~rows].signbit().any()
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.gpu
def test_gmm_kernel_skips_pad_rows_whatever_they_hold(cuda_device):
    """Rows past group_sizes may hold anything (here NaN): the kernel never
    writes them from a product, only as exact zeros."""
    sizes = [2, 0, 5, 1]
    xe, w, gs = _gmm_inputs(cuda_device, 4, 16, 64, 64, sizes)
    for e, g in enumerate(sizes):
        xe[e, g:] = float("nan")
    got = tgmm.gmm(xe, w, gs)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, tref.gmm_ref(torch.nan_to_num(xe), w, gs),
                               rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_gmm_counts_one_launch_a_call(cuda_device):
    xe, w, gs = _gmm_inputs(cuda_device, 4, 16, 64, 64, [2, 0, 5, 1])
    before = tgmm.gmm.launches
    tops.gmm(xe, w, gs)
    tops.gmm(xe, w)
    assert tgmm.gmm.launches - before == 2

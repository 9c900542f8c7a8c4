"""Parity of the port's model path (``repro_torch``) with the JAX reference
on the reduced qwen3-moe config in f32: routing and dispatch, chunked
prefill, the LoRA Server's hooks, and one disaggregated decode step.

Weights come from the reference's initialisers and reach the port through
``repro_torch.bridge`` as numpy arrays; inputs are numpy arrays from fixed
seeds. Tolerances: logits and KV 1e-4 abs (f32, d=128), kernels and hooks
1e-6 abs (f32 rounding spread); integer outputs (routing ids, slots) exact.
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
from repro.models import transformer as jtransformer
from repro_torch import bridge
from repro_torch.core import adapter as tadapter
from repro_torch.core import disagg as tdisagg
from repro_torch.core import lora_server as tls
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer

HOOK_TOL = 1e-6
LOGIT_TOL = 1e-4
RANKS = [2, 8, 4]


@pytest.fixture(scope="module")
def setup():
    """Reference config, params and mixed-rank pool, and their bridges."""
    jcfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                               lora_targets=("gate", "up", "down"),
                               lora_rank=8)
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
    return jcfg, params, pool, tcfg, tparams, tpool


def _servers(setup, slots=4):
    """The reference's LoRAServer and the port's, with adapters 0..2
    resident at their true ranks (adapter 3 is never inserted)."""
    jcfg, _, pool, tcfg, _, tpool = setup
    jsrv = jls.LoRAServer(jcfg, jls.ServerConfig(m=1, x=1, y=1,
                                                 cache_slots=slots, rank=8),
                          dtype=jnp.float32)
    tsrv = tls.LoRAServer(tcfg, tls.ServerConfig(m=1, x=1, y=1,
                                                 cache_slots=slots, rank=8),
                          dtype=torch.float32, device="cpu")
    for aid in range(len(RANKS)):
        jsrv.insert(aid, jls.pool_tensors_from_adapter(pool, aid),
                    rank=pool.rank_of(aid))
        tsrv.insert(aid, tls.pool_tensors_from_adapter(tpool, aid),
                    rank=tpool.rank_of(aid))
    return jsrv, tsrv


@pytest.mark.parametrize("ties", [False, True], ids=["random", "all_tied"])
def test_route_and_local_dispatch_match(setup, ties):
    """Routing ids (top-k tie order), weights, and the stable-sort dispatch
    layout equal the reference's; with a zero router every expert ties and
    the lower ids must win."""
    jcfg, params, *_ = setup
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, jcfg.d_model)).astype(np.float32)
    rw = np.array(params["layers"]["moe"]["router"][0])
    if ties:
        rw = np.zeros_like(rw)
    E, K = jcfg.n_experts, jcfg.top_k
    jids, jw = jmoe.route(jnp.asarray(x), jnp.asarray(rw), E, K)
    tids, tw = tmoe.route(torch.from_numpy(x), torch.from_numpy(rw), E, K)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=HOOK_TOL)
    for C in (4, 8):  # 4 drops pairs when experts overflow; 8 is dropless
        jxe, jst = jmoe.local_dispatch(jnp.asarray(x), jids, C, E)
        txe, tst, _ = tmoe.local_dispatch(torch.from_numpy(x), tids, C, E)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        np.testing.assert_array_equal(txe.numpy(), np.asarray(jxe))


def test_capacity_matches():
    for args in [(1, 8, 128, 1.25, True), (3, 2, 4, 1.25, False),
                 (512, 8, 128, 1.25, True), (100, 2, 4, 1.25, False)]:
        assert tmoe.capacity(*args[:4], dropless=args[4]) == \
            jmoe.capacity(*args[:4], dropless=args[4])


def test_prefill_chunk_kv_matches(setup):
    """Two chunks (the second attending over the first's KV) cache the
    same K/V as the reference."""
    jcfg, params, _, tcfg, tparams, _ = setup
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (1, 16)).astype(np.int32)
    L, KV, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    empty = np.zeros((L, 1, 0, KV, hd), np.float32)
    jk0, jv0 = jtransformer.prefill_chunk(params, jcfg,
                                          jnp.asarray(toks[:, :8]),
                                          jnp.asarray(empty),
                                          jnp.asarray(empty))
    jk1, jv1 = jtransformer.prefill_chunk(params, jcfg,
                                          jnp.asarray(toks[:, 8:]), jk0, jv0)
    tk0, tv0 = ttransformer.prefill_chunk(
        tparams, tcfg, torch.from_numpy(toks[:, :8]).long(),
        torch.from_numpy(empty), torch.from_numpy(empty))
    tk1, tv1 = ttransformer.prefill_chunk(
        tparams, tcfg, torch.from_numpy(toks[:, 8:]).long(), tk0, tv0)
    for got, want in ((tk0, jk0), (tv0, jv0), (tk1, jk1), (tv1, jv1)):
        assert tuple(got.shape) == (L, 1, 8, KV, hd)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_TOL)


def test_pool_tensors_from_adapter_bitwise(setup):
    """The block-diagonal gate|up fusion is pure data movement."""
    _, _, pool, _, _, tpool = setup
    for aid in range(len(RANKS)):
        want = jls.pool_tensors_from_adapter(pool, aid)
        got = tls.pool_tensors_from_adapter(tpool, aid)
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))


def test_mixed_rank_pool_pads_with_positive_zero():
    cfg = dataclasses.replace(bridge.config_from(
        get_config("qwen3-moe-235b-a22b").reduced()),
        lora_targets=("gate", "up", "down"))
    pool = tadapter.init_mixed_rank_pool(cfg, [2, 8], seed=3,
                                         dtype=torch.float32, device="cpu")
    for t in pool.tensors.values():
        tail_a, tail_b = t["A"][:, 0, ..., 2:], t["B"][:, 0, ..., 2:, :]
        for tail in (tail_a, tail_b):
            assert torch.all(tail == 0) and not torch.any(tail.signbit())
        assert torch.any(t["A"][:, 1, ..., 7] != 0)


@pytest.mark.parametrize("hook", ["up", "down"])
def test_lora_server_compute_matches(setup, hook):
    """The port's hook (slot lookup, true-rank mask, shrink-expand) against
    the reference LoRAServer.compute, rows of resident, absent (3) and
    inactive (-1) adapters mixed."""
    jcfg = setup[0]
    jsrv, tsrv = _servers(setup)
    rng = np.random.default_rng(4)
    d_in = jcfg.d_model if hook == "up" else jcfg.d_ff
    R = 12
    rows = rng.standard_normal((R, d_in)).astype(np.float32)
    aids = np.array([0, 1, 2, -1, 3, 0, 2, 1, -1, 0, 2, 1], np.int32)
    eids = rng.integers(0, jcfg.n_experts, R).astype(np.int32)
    for layer in range(jcfg.n_layers):
        want = np.asarray(jsrv.compute(hook, layer, jnp.asarray(rows), aids,
                                       eids))
        got = tsrv.compute(hook, layer, torch.from_numpy(rows),
                           torch.from_numpy(aids), torch.from_numpy(eids))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=HOOK_TOL)
        assert np.all(got.numpy()[np.isin(aids, [-1, 3])] == 0.0)
    np.testing.assert_array_equal(
        tsrv.resolve_slots(torch.tensor([2, -1, 3, 99, 0])).numpy(),
        jsrv.resolve_slots(np.array([2, -1, 3, 99, 0])))


def test_lora_server_bridged_pool_matches(setup):
    """A reference server pool of random factors (uniform rank) bridged
    into the port's server computes the same hooks."""
    jcfg, _, _, tcfg, _, _ = setup
    jsrv = jls.LoRAServer(jcfg, jls.ServerConfig(m=1, x=1, y=1,
                                                 cache_slots=2, rank=8),
                          pool_init_key=jax.random.PRNGKey(7),
                          dtype=jnp.float32)
    tsrv = tls.LoRAServer(tcfg, tls.ServerConfig(m=1, x=1, y=1,
                                                 cache_slots=2, rank=8),
                          dtype=torch.float32, device="cpu")
    bridge.load_server_pool(tsrv, jax.tree_util.tree_map(np.asarray,
                                                         jsrv.pool))
    for srv in (jsrv, tsrv):
        srv.insert(5)
        srv.insert(9, rank=3)
    rows = np.random.default_rng(5).standard_normal(
        (4, jcfg.d_model)).astype(np.float32)
    aids = np.array([9, 5, -1, 9], np.int32)
    eids = np.array([0, 3, 1, 2], np.int32)
    want = np.asarray(jsrv.compute("up", 1, jnp.asarray(rows), aids, eids))
    got = tsrv.compute("up", 1, torch.from_numpy(rows),
                       torch.from_numpy(aids), torch.from_numpy(eids))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=HOOK_TOL)


def test_disagg_decode_step_logits_match(setup):
    """One disaggregated decode step over a paged pool: logits, and the KV
    written into the pages, against the reference (host transport path)."""
    jcfg, params, _, tcfg, tparams, tpool = setup
    jsrv, tsrv = _servers(setup)
    rng = np.random.default_rng(6)
    L, KV, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    P, ps, nb = 10, 4, 3
    k_pool = rng.standard_normal((L, P, ps, KV, hd)).astype(np.float32)
    v_pool = rng.standard_normal((L, P, ps, KV, hd)).astype(np.float32)
    bt = np.array([[3, 7, -1], [0, -1, -1], [5, 6, 1], [3, 7, -1]], np.int32)
    pos = np.array([5, 2, 9, -1], np.int32)       # row 3 is padding
    toks = rng.integers(0, jcfg.vocab_size, (4, 1)).astype(np.int32)
    aids = np.array([1, 2, 0, -1], np.int32)
    jl, jk, jv = jdisagg.disagg_decode_step_slots(
        params, jcfg, jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(toks), jnp.asarray(pos), jsrv, jnp.asarray(aids),
        0.5, block_table=jnp.asarray(bt))
    tk, tv = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    tl, tk, tv = tdisagg.disagg_decode_step_slots(
        tparams, tcfg, tk, tv, torch.from_numpy(toks).long(),
        torch.from_numpy(pos), tsrv, torch.from_numpy(aids), 0.5,
        block_table=torch.from_numpy(bt))
    assert tuple(tl.shape) == (4, jcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3], rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=LOGIT_TOL)

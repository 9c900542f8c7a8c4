"""The SPMD steps in the reference's parameter layout: every weight rests
sharded by its logical axes (the attention's qkv_out / kv_out, the vocab,
the fsdp dims), as ``repro.models.model.param_shardings`` lays it out.

  - ``steps.step_placements`` equals the reference's ``param_shardings``
    spec for spec, for every registered config, every step kind and the
    (2, 4) and (2, 2, 4) stub meshes of ``test_torch_spmd_rules.py``
    (the reference's read on a ``jax.sharding.AbstractMesh``)
  - in one 4-rank gloo world (``distributed.world.spawn``, a ``file://``
    rendezvous under the test's temporary directory, 30 s collective and
    300 s world timeouts) over the grids (2, 2), (1, 4) and (4, 1), on
    reduced qwen3-moe (MoE; also with 2 experts, whose weights the plan
    re-cuts at use on the (1, 4) grid), qwen2-1.5b (dense, q/k/v biases,
    tied embedding), starcoder2-15b (an untied lm head), zamba2-2.7b
    (the mamba2 hybrid, its shared block and sharded states) and rwkv6-3b
    (its sharded wkv state), in f32:
    ``jit_train_step``'s loss and updated parameters gathered whole,
    ``jit_prefill_step``'s logits and ``jit_serve_step``'s logits over 3
    decode steps (and its written cache) against the port's local step
    (no rules, one process); ``make_train_step`` under batch-only train
    rules ("seq" None: the tokens replicated over "model", which shards
    the weights) on the attention configs, held the same way; and each
    rank's allocated parameter and AdamW moment bytes (the decode cache's
    too) equal to ``analysis.memory_est``'s ``params``, ``opt_state`` and
    ``cache``

The tolerances are ``test_torch_spmd.py``'s: TOL 1e-5 of the largest
magnitude of the value held (the sharded step sums in other orders:
gathered rows in other GEMM shapes, gradients reduce-scattered), and
PARAM_TOL 1e-5 absolute on parameters after one AdamW step (lr 1e-3, eps
1e-3). The ranks run the port only (``tests/torch_spmd_layout_cases.py``);
this file draws the inputs with numpy, holds the results, joins no process
group and runs with one torch intra-op thread (restored after)."""
import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_spmd_layout_cases as cases
from repro.configs import REGISTRY, get_config
from repro.distributed import steps as jsteps
from repro.models import model as jmodel
from repro_torch import bridge
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import steps as tsteps
from repro_torch.distributed.world import spawn
from repro_torch.models import transformer as ttransformer
from repro_torch.models.cache import init_cache
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import make_train_step
from repro_torch.training.tree import flatten_with_keys
from test_torch_spmd_rules import MESHES, FakeMesh, _flat
from test_torch_static import draw_params

TOL = 1e-5
PARAM_TOL = 1e-5
B, S, S_CACHE = 4, 8, 16
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
# name -> (arch, fields replaced on its reduced()); "moe_e2": two experts,
# which the (1, 4) grid's "model" axis does not divide, so the plan
# computes with d_ff cut over "model" while it rests cut over "data"
# (the MoE body gathers and re-cuts it at use, ``model.use_layout``)
CONFIGS = {"moe": ("qwen3-moe-235b-a22b", {}),
           "moe_e2": ("qwen3-moe-235b-a22b", {"n_experts": 2}),
           "bias": ("qwen2-1.5b", {}), "untied": ("starcoder2-15b", {}),
           "hybrid": ("zamba2-2.7b", {}), "rwkv": ("rwkv6-3b", {})}
GRIDS = cases.GRIDS
# the attention configs, whose train rules shard the sequence over
# "model": under batch-only rules ("seq" None) the tokens are replicated
# there (the ssm configs' rules already shard the batch over it)
BATCH_ONLY = ["moe", "moe_e2", "bias", "untied"]
KINDS = ("train", "prefill", "decode")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------- the layout itself --------------------------- #
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_step_placements_equal_the_reference(arch):
    jcfg = get_config(arch)
    tcfg = bridge.config_from(jcfg)
    for shape, names in MESHES:
        for kind in KINDS:
            jr = jsteps.rules_for(FakeMesh(shape, names), kind, jcfg)
            jr.mesh = AbstractMesh(shape, names)
            tr = tsteps.rules_for(FakeMesh(shape, names), kind, tcfg)
            want = _flat(jmodel.param_shardings(jcfg, jr),
                         lambda s: tuple(s.spec))
            got = _flat(tsteps.step_placements(tcfg, tr), lambda p: p.spec)
            assert got == want, (shape, kind)
            # and the shapes the specs cut
            shapes = _flat(jmodel.abstract_params(jcfg),
                           lambda s: tuple(s.shape))
            assert _flat(tsteps.step_placements(tcfg, tr),
                         lambda p: p.shape) == shapes


# ------------------------------- the world ------------------------------- #
def _inputs():
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, (B, S), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[1, :2] = -1
    inp = {"configs": list(CONFIGS), "batch_only": BATCH_ONLY,
           "step_batch": {"tokens": tokens,
                                                    "labels": labels},
           "train_shape": ShapeConfig("t", seq_len=S, global_batch=B,
                                      kind="train"),
           "prefill_shape": ShapeConfig("p", seq_len=S, global_batch=B,
                                        kind="prefill"),
           "serve_shape": ShapeConfig("d", seq_len=S_CACHE, global_batch=B,
                                      kind="decode"),
           "serve_tokens": [rng.integers(0, 512, (B, 1), dtype=np.int32)
                            for _ in range(3)],
           "opt": OPT}
    for seed, (which, (arch, fields)) in enumerate(CONFIGS.items()):
        jcfg = dataclasses.replace(get_config(arch).reduced(), **fields)
        assert jcfg.vocab_size == 512
        inp[which + "_cfg"] = bridge.config_from(jcfg)
        inp[which + "_model"] = draw_params(jcfg, 10 + seed)
    return inp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inp = _inputs()
    results = spawn(cases.run, 4, inp, backend="gloo", timeout=30,
                    join_timeout=300, threads=1,
                    rendezvous_dir=str(tmp_path_factory.mktemp("gloo")))
    return inp, results


def _result(world, which, case, grid, rank=0):
    res = world[1][rank][(which, case, grid)]
    assert "error" not in res, res.get("error")
    return res


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), (what, err)


_LOCAL = {}


def _local(key, fn):
    if key not in _LOCAL:
        _LOCAL[key] = fn()
    return _LOCAL[key]


def _step_inputs(inp, which):
    return (inp[which + "_cfg"], bridge.tree_to_tensors(inp[which + "_model"]),
            {k: torch.tensor(v) for k, v in inp["step_batch"].items()})


def _train_local(inp, which, cfg_of=lambda c: c):
    cfg, params, batch = _step_inputs(inp, which)
    cfg = cfg_of(cfg)
    loss, new, _ = make_train_step(cfg, topt.AdamWConfig(**OPT))(
        params, topt.init(params), batch)
    return float(loss), {k: v.detach().numpy()
                         for k, v in flatten_with_keys(new).items()}


def _prefill_local(inp, which):
    cfg, params, batch = _step_inputs(inp, which)
    with torch.no_grad():
        return ttransformer.forward(params, cfg, batch["tokens"],
                                    kind="prefill")[0].numpy()


def _serve_local(inp, which):
    cfg, params, _ = _step_inputs(inp, which)
    cache = init_cache(cfg, B, S_CACHE, dtype=torch.float32)
    out = []
    with torch.no_grad():
        for t in inp["serve_tokens"]:
            lg, cache = ttransformer.decode_step(params, cfg, cache,
                                                 torch.tensor(t))
            out.append(lg.numpy())
    return np.stack(out), (cache["k"].numpy() if "k" in cache else None)


@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("which", list(CONFIGS))
def test_train_step_in_the_reference_layout(world, which, grid):
    res = _result(world, which, "train", grid)
    loss, params = _local(("train", which),
                          lambda: _train_local(world[0], which))
    assert abs(res["loss"] - loss) <= TOL * max(1.0, abs(loss))
    assert set(res["params"]) == set(params)
    for k, v in params.items():
        np.testing.assert_allclose(res["params"][k], v, atol=PARAM_TOL,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("which", BATCH_ONLY)
def test_train_step_under_batch_only_rules(world, which, grid):
    res = _result(world, which, "train_batch_only", grid)
    loss, params = _local(("train_dropless", which),
                          lambda: _train_local(world[0], which,
                                               cases.dropless))
    assert abs(res["loss"] - loss) <= TOL * max(1.0, abs(loss))
    assert set(res["params"]) == set(params)
    for k, v in params.items():
        np.testing.assert_allclose(res["params"][k], v, atol=PARAM_TOL,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("which", list(CONFIGS))
def test_prefill_step_in_the_reference_layout(world, which, grid):
    res = _result(world, which, "prefill", grid)
    _close(res["logits"], _local(("prefill", which),
                                 lambda: _prefill_local(world[0], which)))


@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("which", list(CONFIGS))
def test_serve_step_in_the_reference_layout(world, which, grid):
    res = _result(world, which, "serve", grid)
    logits, k = _local(("serve", which),
                       lambda: _serve_local(world[0], which))
    _close(res["logits"], logits, "logits")
    if k is not None:
        _close(res["cache_k"], k, "cache k")


@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("which", list(CONFIGS))
def test_allocated_bytes_equal_memory_est(world, which, grid):
    cfg = world[0][which + "_cfg"]
    whole = sum(np.asarray(v).nbytes for v in
                flatten_with_keys(world[0][which + "_model"]).values())
    for rank in range(4):
        res = _result(world, which, "bytes", grid, rank)
        for kind, (got, want) in res.items():
            assert got == want, (rank, kind)
        if grid != (4, 1):      # "model" shards the vocab and the heads
            assert res["train"][0]["params"] < whole, rank
    assert cfg.padded_vocab % 4 == 0

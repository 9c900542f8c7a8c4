"""The port's collective-bearing SPMD layer on the CPU: one gloo world of
4 processes, started once for the file (``distributed.world.spawn``, a
``file://`` rendezvous under the test's temporary directory, 30 s
collective and 300 s world timeouts), over the grids (2, 2), (1, 4) and
(4, 1) of a ``ProcessMesh``. Each case on each grid is its own test:

  - the sharded ``moe_block``: the train plan (expert all-to-all, FSDP
    gathers) with its gradients (x, router, gate/up/down), with and
    without the expert LoRA (``expert_offset``), and the decode plan (the
    all-gather MoE, the moe_ff psum), with and without LoRA
  - the head-sharded ``flash_attention`` (out, dq, dk, dv) and
    ``causal_attention`` under sequence parallelism
  - the sequence-parallel ``mlp`` with its gradients (x and the fsdp x
    mlp shards of gate/up/down)
  - the kv_seq flash-decode: ``decode_attention_update`` then
    ``decode_attention`` over bf16 and int8 caches, with and without a
    ring buffer's ``key_positions`` (and a window)
  - ``jit_train_step`` (loss, every updated parameter), ``jit_prefill_step``
    (logits) and ``jit_serve_step`` (3 decode steps' logits, the written
    cache) on reduced qwen3-moe and smollm in f32
  - ``make_lora_train_step(axis_name="data")`` on the (4, 1) grid, plain
    and compressed: each rank's loss, the adapter and the compression's
    residual after two steps (the compressed run one)
  - ``make_debug_mesh(2, 4)`` in the world of 4 raises a ValueError
    naming the world it needs

Every case is held against the port's local path (no rules, one
process) and the layer cases also against the reference's local path (a
JAX function on the same global inputs); the DP fine-tune against the
reference's step under ``jax.vmap(..., axis_name="data")`` over the
per-rank batches (its own pmean / int8 psum branch).

TOL = 1e-5 of the largest magnitude of the value held: f32 sums taken in
another order (the sharded paths reduce across ranks, gather rows into
other GEMM shapes, and reduce-scatter gradients). The caches a decode
writes are held bit for bit: a write moves values and quantizes one
token the same way. PARAM_TOL = 1e-5 absolute on parameters after one
AdamW step (lr 1e-3: each element moves by about lr, and its rounding by
~lr * 1e-4; the steps' AdamW takes eps 1e-3 so that an update moves
smoothly with its gradient). The DP adapters after two steps are held at
1e-4 absolute (AdamW divides each gradient by its own magnitude, as
``tests/test_torch_training.py`` explains). The compressed run (one step)
holds each residual within one int8 code step of the reference's: a code
on a rounding edge may fall the other way under f32 rounding of the
gradient, which moves that element's update by up to 2 lr; at most 0.1%
of a leaf's elements may do so, every other is held at 1e-4.

The ranks run the port only (``tests/torch_spmd_cases.py``); this file
draws the inputs with numpy and holds the results. The pytest process
joins no process group and keeps its torch settings (one intra-op thread
while this file runs, restored after)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_cases as cases
from repro.configs import get_config
from repro.core.adapter import init_adapter_pool as j_init_pool
from repro.models import layers as jll
from repro.models import moe as jmoe
from repro.training import optimizer as jopt
from repro.training.train_step import make_lora_train_step as j_make_step
from repro_torch import bridge
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.world import spawn
from repro_torch.models import layers as tll
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import make_train_step
from repro_torch.training.tree import flatten_with_keys
from test_torch_static import draw_params

TOL = 1e-5
PARAM_TOL = 1e-5
DP_ADAPTER_TOL = 1e-4
# 32 tokens: 8 a rank on every grid, where a rank's capacity (1.25 T_l K /
# E, rounded up to 4) is at least T_l, so the sharded train plan drops no
# pair, as the local plan's dropless capacity does not
B, S, D_MOE = 4, 8, 128
# eps 1e-3: AdamW's update lr * g / (|g| + eps) then moves smoothly with g
# (at eps 1e-8 an element of a near-zero gradient moves by up to lr for a
# rounding of its sign)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
GRIDS = cases.GRIDS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


# ------------------------------- inputs ---------------------------------- #
def _inputs():
    rng = np.random.default_rng(0)

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    jmoe_cfg = get_config("qwen3-moe-235b-a22b").reduced()
    jmlp_cfg = get_config("smollm-360m").reduced()
    moe_params = draw_params(jmoe_cfg, 0)
    mlp_params = draw_params(jmlp_cfg, 1)
    moe_layer = {k: np.asarray(v[0]) for k, v in
                 moe_params["layers"]["moe"].items()}
    # a router that separates the experts (the drawn one is near uniform)
    moe_layer["router"] = f32(D_MOE, jmoe_cfg.n_experts, scale=0.5)
    E, ff, N, r = jmoe_cfg.n_experts, jmoe_cfg.d_ff, 3, 4
    lora = {n: {"A": f32(N, E, din, r, scale=0.3),
                "B": f32(N, E, r, dout, scale=0.3)}
            for n, din, dout in (("gate", D_MOE, ff), ("up", D_MOE, ff),
                                 ("down", ff, D_MOE))}
    H, KV, hd = jmoe_cfg.n_heads, jmoe_cfg.n_kv_heads, jmoe_cfg.head_dim
    Sc = 16

    def bf16_values(*shape):
        return np.asarray(jnp.asarray(f32(*shape)).astype(jnp.bfloat16)
                          .astype(jnp.float32))

    key_positions = np.full((Sc,), -1, np.int32)
    for p in range(5, 20):          # a ring of 16 slots past position 15
        key_positions[p % Sc] = p
    dec = {"q": f32(B, H, hd), "k_new": f32(B, KV, hd),
           "v_new": f32(B, KV, hd), "k_bf16": bf16_values(B, Sc, KV, hd),
           "v_bf16": bf16_values(B, Sc, KV, hd),
           "k_q8": rng.integers(-127, 128, (B, Sc, KV, hd), dtype=np.int8),
           "v_q8": rng.integers(-127, 128, (B, Sc, KV, hd), dtype=np.int8),
           "k_scale": np.abs(f32(B, Sc, KV, 1, scale=0.01)),
           "v_scale": np.abs(f32(B, Sc, KV, 1, scale=0.01)),
           "key_positions": key_positions, "pos": 9, "ring_pos": 20, "window": 8}
    tokens = rng.integers(0, jmoe_cfg.vocab_size, (B, S), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :3] = -1
    # the DP fine-tune: smollm, a rank-8 adapter, 2 steps of 4 rows
    pool = j_init_pool(jmlp_cfg, 1, jax.random.PRNGKey(5), rank=8,
                       dtype=jnp.float32)
    dcfg = tdata.DataConfig(jmlp_cfg.vocab_size, 16, 4, tenant_id=1)
    lora_dp = {"params": mlp_params, "scale": pool.scale,
               "adapter": jax.tree_util.tree_map(np.asarray, pool.tensors),
               "opt": dict(lr=5e-3, warmup_steps=2, total_steps=25),
               "batches": [tdata.batch_at(dcfg, s) for s in range(2)]}
    return {
        "jmoe_cfg": jmoe_cfg, "jmlp_cfg": jmlp_cfg,
        "moe_cfg": bridge.config_from(jmoe_cfg),
        "mlp_cfg": bridge.config_from(jmlp_cfg),
        "moe_params": moe_layer, "moe_x": f32(B, S, D_MOE),
        "moe_dy": f32(B, S, D_MOE), "moe_x_dec": f32(B, 1, D_MOE),
        "moe_lora": lora,
        "moe_ids": np.array([0, 2, -1, 1], np.int32),
        "att_q": f32(B, S, H, hd), "att_k": f32(B, S, KV, hd),
        "att_v": f32(B, S, KV, hd), "att_do": f32(B, S, H, hd),
        "mlp_params": {k: np.asarray(v[0]) for k, v in
                       mlp_params["layers"]["mlp"].items()},
        "mlp_x": f32(B, S, D_MOE), "mlp_dy": f32(B, S, D_MOE),
        "dec": dec, "moe_model": moe_params, "mlp_model": mlp_params,
        "step_batch": {"tokens": tokens, "labels": labels},
        "train_shape": ShapeConfig("t", seq_len=S, global_batch=B,
                                   kind="train"),
        "prefill_shape": ShapeConfig("p", seq_len=S, global_batch=B,
                                     kind="prefill"),
        "serve_shape": ShapeConfig("d", seq_len=Sc, global_batch=B,
                                   kind="decode"),
        "serve_tokens": [rng.integers(0, jmoe_cfg.vocab_size, (B, 1),
                                      dtype=np.int32) for _ in range(3)],
        "opt": OPT, "lora_dp": lora_dp,
    }


def _rank_inputs(inp):
    """What the ranks take: the port's side of the inputs (not the
    reference's configs)."""
    return {k: v for k, v in inp.items() if not k.startswith("j")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inp = _inputs()
    rank_inp = _rank_inputs(inp)
    results = spawn(cases.run, 4, rank_inp, backend="gloo", timeout=30,
                    join_timeout=300, threads=1,
                    rendezvous_dir=str(tmp_path_factory.mktemp("gloo")))
    return inp, results


def _result(world, name, grid):
    _, results = world
    res = results[0][(name, grid)]
    assert "error" not in res, res.get("error")
    return res


def test_process_mesh_names_the_world_it_needs(world):
    assert world[1][0]["mesh_refusal"] == (
        "a process mesh of shape (2, 4) (('data', 'model')) needs a world "
        "of 8 processes, this one has 4")


# ------------------------------ the MoE ---------------------------------- #
def _moe_local(inp, kind, with_lora):
    """The port's and the reference's local moe_block: y and, for the
    train plan, the gradients of sum(y * dy)."""
    x = inp["moe_x"] if kind == "train" else inp["moe_x_dec"]
    p = inp["moe_params"]
    Sx = x.shape[1]
    ids = np.repeat(inp["moe_ids"], Sx) if with_lora else None
    lora = inp["moe_lora"] if with_lora else None
    # the port
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tl = None if lora is None else {n: {f: torch.tensor(a) for f, a in
                                        ab.items()} for n, ab in lora.items()}
    y = tmoe.moe_block(tx, tp, inp["moe_cfg"], kind=kind, lora=tl,
                       ids_tok=None if ids is None else torch.tensor(ids),
                       lora_scale=0.5)
    dy = torch.tensor(inp["moe_dy"][:, :Sx])
    g = torch.autograd.grad((y * dy).sum(),
                            [tx] + [tp[k] for k in ("router", "gate", "up",
                                                    "down")])
    port = {"y": y.detach().numpy(), "dx": g[0].numpy(),
            **{"d" + k: gk.numpy() for k, gk in
               zip(("router", "gate", "up", "down"), g[1:])}}
    # the reference
    jcfg = inp["jmoe_cfg"]
    jl = None if lora is None else jax.tree_util.tree_map(jnp.asarray, lora)
    jids = None if ids is None else jnp.asarray(ids)

    def f(x, p):
        return jmoe.moe_block(x, p, jcfg, kind=kind, lora=jl, ids_tok=jids,
                              lora_scale=0.5)

    jy, vjp = jax.vjp(f, jnp.asarray(x), {k: jnp.asarray(v)
                                          for k, v in p.items()})
    jdx, jdp = vjp(jnp.asarray(inp["moe_dy"][:, :Sx]))
    ref = {"y": np.asarray(jy), "dx": np.asarray(jdx),
           **{"d" + k: np.asarray(jdp[k]) for k in ("router", "gate", "up",
                                                     "down")}}
    return port, ref


_LOCAL = {}


def _local(key, fn):
    if key not in _LOCAL:
        _LOCAL[key] = fn()
    return _LOCAL[key]


@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("kind,with_lora", [("train", False),
                                            ("train", True),
                                            ("decode", False),
                                            ("decode", True)])
def test_sharded_moe(world, grid, kind, with_lora):
    inp = world[0]
    name = f"moe_{kind}" + ("_lora" if with_lora else "")
    res = _result(world, name, grid)
    port, ref = _local(name, lambda: _moe_local(inp, kind, with_lora))
    keys = ["y"] if kind == "decode" else list(port)
    for k in keys:
        _close(res[k], port[k], what=(k, "port"))
        _close(res[k], ref[k], what=(k, "reference"))
    plan = res["plan"]
    if kind == "train":
        # experts over model (the sequence's axis), ff at rest over data
        assert plan.ep_axis == "model" and plan.fsdp_axis == "data"
    else:
        assert plan.ep_axis == "data" and plan.ff_axis == "model"


# ---------------------------- attention ---------------------------------- #
def _attention_local(inp):
    q, k, v, do = (inp[n] for n in ("att_q", "att_k", "att_v", "att_do"))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = tll.flash_attention(tq, tk, tv, causal=True, q_chunk=4)
    g = torch.autograd.grad((o * torch.tensor(do)).sum(), [tq, tk, tv])
    port = {"out": o.detach().numpy(),
            **dict(zip(("dq", "dk", "dv"), (t.numpy() for t in g))),
            "causal": tll.causal_attention(torch.tensor(q), torch.tensor(k),
                                           torch.tensor(v)).numpy()}
    jo, vjp = jax.vjp(lambda q, k, v: jll.causal_attention(q, k, v,
                                                           q_chunk=4),
                      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = {"out": np.asarray(jo),
           **dict(zip(("dq", "dk", "dv"),
                      (np.asarray(t) for t in vjp(jnp.asarray(do))))),
           "causal": np.asarray(jo)}
    return port, ref


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_head_sharded_flash_attention(world, grid):
    res = _result(world, "flash_attention", grid)
    port, ref = _local("attention", lambda: _attention_local(world[0]))
    for k in ("out", "dq", "dk", "dv"):
        _close(res[k], port[k], what=(k, "port"))
        _close(res[k], ref[k], what=(k, "reference"))


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_head_sharded_causal_attention(world, grid):
    res = _result(world, "causal_attention", grid)
    port, ref = _local("attention", lambda: _attention_local(world[0]))
    _close(res["out"], port["causal"], what="port")
    _close(res["out"], ref["causal"], what="reference")


# ------------------------------ the MLP ---------------------------------- #
def _mlp_local(inp):
    p, x, dy = inp["mlp_params"], inp["mlp_x"], inp["mlp_dy"]
    keys = sorted(p)
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    y = tll.mlp(tx, tp, inp["mlp_cfg"])
    g = torch.autograd.grad((y * torch.tensor(dy)).sum(),
                            [tx] + [tp[k] for k in keys])
    port = {"y": y.detach().numpy(), "dx": g[0].numpy(),
            **{"d" + k: gk.numpy() for k, gk in zip(keys, g[1:])}}
    jy, vjp = jax.vjp(lambda x, p: jll.mlp(x, p, inp["jmlp_cfg"]),
                      jnp.asarray(x), {k: jnp.asarray(v)
                                       for k, v in p.items()})
    jdx, jdp = vjp(jnp.asarray(dy))
    ref = {"y": np.asarray(jy), "dx": np.asarray(jdx),
           **{"d" + k: np.asarray(jdp[k]) for k in keys}}
    return port, ref


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_sequence_parallel_mlp(world, grid):
    res = _result(world, "mlp", grid)
    assert res["sp"]            # the Megatron-SP body ran on every grid
    port, ref = _local("mlp", lambda: _mlp_local(world[0]))
    for k in port:
        _close(res[k], port[k], what=(k, "port"))
        _close(res[k], ref[k], what=(k, "reference"))


# ------------------------- kv_seq flash-decode --------------------------- #
def _decode_local(inp, quant, ring):
    d = inp["dec"]
    key = "q8" if quant else "bf16"
    pos = d["ring_pos"] if ring else d["pos"]
    window = d["window"] if ring else 0
    Sc = d["k_bf16"].shape[1]
    slot = pos % Sc if ring else None
    # the port, on copies (it writes in place)
    dt = torch.int8 if quant else torch.bfloat16
    kc, vc = (torch.tensor(d[n + "_" + key]).to(dt) for n in ("k", "v"))
    ks = torch.tensor(d["k_scale"]) if quant else None
    vs = torch.tensor(d["v_scale"]) if quant else None
    kp = torch.tensor(d["key_positions"]) if ring else None
    o, kc, vc, ks, vs, kp = tll.decode_attention_update(
        torch.tensor(d["q"]), torch.tensor(d["k_new"]),
        torch.tensor(d["v_new"]), kc, vc, pos, window=window, k_scale=ks,
        v_scale=vs, key_positions=kp, write_slot=slot)
    o2 = tll.decode_attention(torch.tensor(d["q"]), kc, vc, pos + 1,
                              window=window,
                              kv_scales=(ks, vs) if quant else None,
                              key_positions=kp)
    port = {"out": o.numpy(), "read": o2.numpy(), "k": kc.float().numpy(),
            "v": vc.float().numpy()}
    if quant:
        port.update(k_scale=ks.numpy(), v_scale=vs.numpy())
    if ring:
        port["key_positions"] = kp.numpy()
    # the reference
    jdt = jnp.int8 if quant else jnp.bfloat16
    jkc, jvc = (jnp.asarray(d[n + "_" + key]).astype(jdt) for n in ("k", "v"))
    jks = jnp.asarray(d["k_scale"]) if quant else None
    jvs = jnp.asarray(d["v_scale"]) if quant else None
    jkp = jnp.asarray(d["key_positions"]) if ring else None
    jo, jkc, jvc, jks, jvs, jkp = jll.decode_attention_update(
        jnp.asarray(d["q"]), jnp.asarray(d["k_new"]), jnp.asarray(d["v_new"]),
        jkc, jvc, jnp.int32(pos), window=window, k_scale=jks, v_scale=jvs,
        key_positions=jkp, write_slot=None if slot is None
        else jnp.int32(slot))
    jo2 = jll.decode_attention(jnp.asarray(d["q"]), jkc, jvc,
                               jnp.int32(pos + 1), window=window,
                               kv_scales=(jks, jvs) if quant else None,
                               key_positions=jkp)
    ref = {"out": np.asarray(jo), "read": np.asarray(jo2)}
    return port, ref


@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("ring", [False, True], ids=["dense", "ring"])
def test_kv_seq_flash_decode(world, grid, quant, ring):
    name = {(False, False): "decode_bf16", (True, False): "decode_int8",
            (False, True): "decode_ring",
            (True, True): "decode_ring_int8"}[quant, ring]
    res = _result(world, name, grid)
    port, ref = _local(name, lambda: _decode_local(world[0], quant, ring))
    for k in ("out", "read"):
        _close(res[k], port[k], what=(k, "port"))
        _close(res[k], ref[k], what=(k, "reference"))
    for k in port:
        if k not in ("out", "read"):    # what the write left: bit for bit
            np.testing.assert_array_equal(res[k], port[k], err_msg=k)


# ----------------------------- the steps --------------------------------- #
def _step_inputs(inp, which):
    cfg = inp[which + "_cfg"]
    params = bridge.tree_to_tensors(inp[which + "_model"])
    batch = {k: torch.tensor(v) for k, v in inp["step_batch"].items()}
    return cfg, params, batch


def _train_local(inp, which):
    cfg, params, batch = _step_inputs(inp, which)
    step = make_train_step(cfg, topt.AdamWConfig(**OPT))
    loss, new, _ = step(params, topt.init(params), batch)
    return float(loss), {k: v.detach().numpy()
                         for k, v in flatten_with_keys(new).items()}


@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("which", ["moe", "mlp"])
def test_sharded_train_step(world, grid, which):
    res = _result(world, f"train_step_{which}", grid)
    loss, params = _local(("train", which),
                          lambda: _train_local(world[0], which))
    assert abs(res["loss"] - loss) <= TOL * max(1.0, abs(loss))
    assert set(res["params"]) == set(params)
    for k, v in params.items():
        np.testing.assert_allclose(res["params"][k], v, atol=PARAM_TOL,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("which", ["moe", "mlp"])
def test_sharded_prefill_step(world, grid, which):
    res = _result(world, f"prefill_step_{which}", grid)

    def local():
        cfg, params, batch = _step_inputs(world[0], which)
        with torch.no_grad():
            return ttransformer.forward(params, cfg, batch["tokens"],
                                        kind="prefill")[0].numpy()

    _close(res["logits"], _local(("prefill", which), local))


@pytest.mark.parametrize("grid", GRIDS, ids=str)
@pytest.mark.parametrize("which", ["moe", "mlp"])
def test_sharded_serve_step(world, grid, which):
    res = _result(world, f"serve_step_{which}", grid)

    def local():
        from repro_torch.models.cache import init_cache
        inp = world[0]
        cfg, params, _ = _step_inputs(inp, which)
        shape = inp["serve_shape"]
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           dtype=torch.float32)
        out = []
        with torch.no_grad():
            for t in inp["serve_tokens"]:
                lg, cache = ttransformer.decode_step(params, cfg, cache,
                                                     torch.tensor(t))
                out.append(lg.numpy())
        return np.stack(out), cache["k"].numpy()

    logits, k = _local(("serve", which), local)
    _close(res["logits"], logits)
    _close(res["cache_k"], k)   # k of fewer rows a GEMM: rounded otherwise


# ---------------------------- the DP fine-tune --------------------------- #
def _lora_dp_reference(inp, compress):
    d = inp["lora_dp"]
    jcfg = inp["jmlp_cfg"]
    step = j_make_step(jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                    d["params"]),
                       d["scale"], jopt.AdamWConfig(**d["opt"]),
                       compress=compress, axis_name="data")
    W = 4

    def rep(t):
        return jnp.broadcast_to(jnp.asarray(t), (W,) + np.shape(t))

    adapter = jax.tree_util.tree_map(rep, d["adapter"])
    opt = jax.vmap(jopt.init)(adapter)
    err = jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, jnp.float32), adapter)
    vstep = jax.jit(jax.vmap(step, axis_name="data"))
    losses = []
    for toks, labels in d["batches"][:1 if compress else None]:
        b = {"tokens": jnp.asarray(toks)[:, None],
             "labels": jnp.asarray(labels)[:, None]}
        loss, adapter, opt, err = vstep(adapter, opt, err, b)
        losses.append(np.asarray(loss))
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(adapter)[0]}
    eflat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
             jax.tree_util.tree_flatten_with_path(err)[0]}
    return np.stack(losses, 1), flat, eflat


@pytest.mark.parametrize("compress", [False, True],
                         ids=["pmean", "compressed"])
def test_lora_train_step_data_parallel(world, compress):
    name = "lora_dp" + ("_compressed" if compress else "")
    _, results = world
    per_rank = [results[r][(name, (4, 1))] for r in range(4)]
    for r in per_rank:
        assert "error" not in r, r.get("error")
    losses, adapter, err = _local(name, lambda: _lora_dp_reference(
        world[0], compress))
    for r, res in enumerate(per_rank):
        np.testing.assert_allclose(res["losses"], losses[r], atol=1e-5,
                                   rtol=0)
    # an int8 code on a rounding edge may fall the other way (the port's
    # gradient and the reference's differ by f32 rounding): its residual
    # then differs by one code step, and that element's update by up to
    # 2 lr (AdamW's first step is lr * sign(g)); every other element is
    # held at DP_ADAPTER_TOL
    lr = world[0]["lora_dp"]["opt"]["lr"]
    for r, res in enumerate(per_rank):
        for k, v in err.items():
            # a residual is at most half a code step: a flip moves it by one
            step = 2.05 * np.abs(v[r]).max() if compress else 0.0
            np.testing.assert_allclose(res["err"][k], v[r],
                                       atol=max(step, 1e-7), rtol=0,
                                       err_msg=k)
    for k, v in adapter.items():
        flipped = np.zeros(v[0].shape, bool)
        for r, res in enumerate(per_rank):
            flipped |= np.abs(res["err"][k] - err[k][r]) > \
                np.abs(err[k][r]).max() if compress else False
        assert flipped.mean() <= 1e-3, (k, flipped.sum())
        for res in per_rank:
            diff = np.abs(res["adapter"][k] - v[0])
            assert diff[~flipped].max(initial=0) <= DP_ADAPTER_TOL, k
            assert diff.max() <= 2 * lr, k

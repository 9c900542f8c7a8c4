"""The port's training plane (``repro_torch.training``, ``launch/train.py``)
against the JAX reference, on the CPU in f32 at reduced sizes:

  - ``data.batch_at`` bit for bit; the four shapes
  - AdamW ``schedule`` and ``update`` (without and with a trainable mask,
    3 steps) within 1e-6 of the reference's
  - int8 compression: ``quantize``, ``dequantize`` and the tree forms
    equal to the reference's codes and within 1e-6 of its values; the
    error-feedback bound (the reference's hypothesis property)
  - checkpoints: a round trip (bf16 leaves included), ``CheckpointManager``
    gc and async save, a reference-written f32 checkpoint restored in the
    port and a port-written one restored in the reference
  - ``fault_tolerance``'s outputs equal the reference's; ``lm_loss`` with
    masked labels within 1e-6
  - ``make_lora_train_step``: 5 steps on reduced smollm and on reduced
    qwen3-moe from one state (``bridge.train_state_from``): the first
    step's adapter gradients and AdamW moments within 1e-5 of the
    reference's (relative to each leaf's largest), losses within 1e-5,
    adapters within ADAPTER_TOL and moments within MOMENT_TOL after 5
    steps, the step count equal; the data-parallel branch without a
    process group raises, naming the missing group
  - the ports of the reference's ``test_train_loss_decreases`` and
    ``test_lora_finetune_learns_tenant_structure``
  - ``launch/train.py`` in both modes (``--reduced --steps 6``) from the
    reference's initial weights: its printed losses are the reference
    CLI's (to the printed 4 decimals); a relaunch with ``--ckpt`` resumes
    at the saved step and prints the uninterrupted run's losses

ADAPTER_TOL = 1e-3 abs: AdamW divides each gradient by its own magnitude
plus eps = 1e-8. An element whose gradient is near eps and made of
terms that cancel (an expert's factor that few tokens reach) has a large
relative rounding error in either package's sum order, and its update
can then move by up to a quarter of lr a step: 6e-3 over these 5 steps
at lr <= 5e-3. The readings are up to 1.5e-4, one element in 16384; the
gradients themselves are held at 1e-5.

MOMENT_TOL = 1e-3 of each leaf's largest magnitude: after the first step
the moments are the gradients scaled and read 1.7e-6 of it (held at
GRAD_TOL); the later gradients are taken at adapters that moved apart as
above, and the moments after 5 steps read up to 3.4e-4 of it (an expert
down factor's first moment)."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config
from repro.configs import shapes as jshapes
from repro.core.adapter import init_adapter_pool as j_init_pool
from repro.distributed.steps import lm_loss as j_lm_loss
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro.training import checkpoint as jckpt
from repro.training import compression as jcomp
from repro.training import data as jdata
from repro.training import fault_tolerance as jft
from repro.training import optimizer as jopt
from repro.models import transformer as jtransformer
from repro.training.train_step import make_lora_train_step as j_make_step
from repro.training.train_step import single_adapter_ctx as j_single_ctx
from repro_torch import bridge
from repro_torch.configs import shapes as tshapes
from repro_torch.core.adapter import init_adapter_pool
from repro_torch.distributed.steps import lm_loss
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import compression as tcomp
from repro_torch.training import data as tdata
from repro_torch.training import fault_tolerance as tft
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import make_lora_loss, \
    make_lora_train_step, make_train_step, value_and_grad
from repro_torch.training.tree import flatten_with_keys, tree_map
from test_torch_static import draw_params

TOL = 1e-6
LOSS_TOL = 1e-5
ADAPTER_TOL = 1e-3
GRAD_TOL = 1e-5
MOMENT_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jflat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree):
    return {k: v.detach().numpy() for k, v in flatten_with_keys(tree).items()}


def _assert_trees_close(jtree, ttree, atol):
    want, got = _jflat(jtree), _tflat(ttree)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0,
                                   err_msg=k)


def _assert_leaves_rel_close(jtree, ttree, rtol):
    """Each leaf within ``rtol`` of its own largest magnitude (AdamW's
    moments are far below any absolute bound tied to lr)."""
    want, got = _jflat(jtree), _tflat(ttree)
    assert set(want) == set(got)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= \
            rtol * np.abs(want[k]).max(), k


# ------------------------------- data ----------------------------------- #
def test_batch_at_bit_for_bit_and_shapes():
    for kw in (dict(vocab_size=512, seq_len=16, global_batch=4),
               dict(vocab_size=49152, seq_len=64, global_batch=8, seed=3,
                    n_hosts=2, host_id=1, tenant_id=5)):
        for step in (0, 13):
            a = jdata.batch_at(jdata.DataConfig(**kw), step)
            b = tdata.batch_at(tdata.DataConfig(**kw), step)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y)
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert tshapes.TRAIN_4K.seq_len == 4096


# ----------------------------- optimizer -------------------------------- #
def test_adamw_schedule_and_update_match_reference():
    cfg_kw = dict(lr=2e-3, warmup_steps=3, total_steps=7)
    jc, tc = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    for step in range(0, 10):
        assert abs(float(jopt.schedule(jc, jnp.int32(step)))
                   - float(topt.schedule(tc, torch.tensor(step,
                                                          dtype=torch.int32)))
                   ) <= TOL * cfg_kw["lr"]
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 6)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    for mask in (None, {"a": False, "b": {"c": True}}):
        jp, tp = params, bridge.train_state_from(params)
        js, ts = jopt.init(jp, mask), topt.init(tp, mask)
        for s in range(3):
            g = {"a": rng.standard_normal((4, 6)).astype(np.float32),
                 "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
            jp, js = jopt.update(jp, g, js, jc, mask)
            tg = bridge.train_state_from(g)
            if mask is not None:
                tg["a"] = None      # a frozen leaf needs no gradient
            tp, ts = topt.update(tp, tg, ts, tc, mask)
        _assert_trees_close(jp, tp, TOL)
        _assert_trees_close(js, ts, TOL)
        assert int(ts["step"]) == 3 and ts["step"].dtype == torch.int32
        if mask is not None:
            assert np.array_equal(tp["a"].numpy(), params["a"])


# ---------------------------- compression ------------------------------- #
def test_compression_matches_reference():
    rng = np.random.default_rng(1)
    g = rng.standard_normal((6, 7)).astype(np.float32) * 3
    err = rng.standard_normal((6, 7)).astype(np.float32) * 1e-2
    jq, js, je = jcomp.quantize(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = tcomp.quantize(torch.tensor(g), torch.tensor(err))
    assert tq.dtype == torch.int8 and np.array_equal(np.asarray(jq),
                                                     tq.numpy())
    assert abs(float(js) - float(ts)) <= TOL * abs(float(js))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=TOL)
    np.testing.assert_allclose(tcomp.dequantize(tq, ts).numpy(),
                               np.asarray(jcomp.dequantize(jq, js)), atol=TOL)
    tree = {"a": np.ones((4, 4), np.float32),
            "b": {"c": np.arange(6, dtype=np.float32) * 0.1}}
    jqt, jet = jcomp.compress_tree(tree, jcomp.init_error(tree))
    ttree = bridge.train_state_from(tree)
    tqt, tet = tcomp.compress_tree(ttree, tcomp.init_error(ttree))
    assert np.array_equal(np.asarray(jqt["b"]["c"][0]),
                          tqt["b"]["c"][0].numpy())
    _assert_trees_close(jet, tet, TOL)
    _assert_trees_close(jcomp.decompress_tree(jqt),
                        tcomp.decompress_tree(tqt), TOL)


@settings(max_examples=25, deadline=None, database=None)
@given(st.lists(st.floats(-10, 10, allow_nan=False), min_size=4,
                max_size=64))
def test_compression_error_feedback_bounded(vals):
    g = torch.tensor(vals, dtype=torch.float32)
    err = torch.zeros_like(g)
    total_sent = torch.zeros_like(g)
    total_true = torch.zeros_like(g)
    for _ in range(8):
        q, scale, err = tcomp.quantize(g, err)
        total_sent = total_sent + tcomp.dequantize(q, scale)
        total_true = total_true + g
    amax = float(g.abs().max()) + 1e-30
    assert float((total_sent - total_true).abs().max()) <= amax / 127 + 1e-5


# ---------------------------- checkpoints ------------------------------- #
def _state_tree(rng):
    return {"p": {"w": torch.tensor(rng.standard_normal((3, 4)),
                                    dtype=torch.float32),
                  "h": torch.tensor(rng.standard_normal((2, 5)),
                                    dtype=torch.bfloat16)},
            "o": {"m": [torch.zeros(3), torch.ones(2)],
                  "step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip_gc_and_async(tmp_path):
    tree = _state_tree(np.random.default_rng(2))
    tckpt.save(tmp_path / "a", 7, tree)
    assert tckpt.latest_step(tmp_path / "a") == 7
    back = tckpt.restore(tmp_path / "a", 7, tree)
    for k, v in flatten_with_keys(tree).items():
        got = flatten_with_keys(back)[k]
        assert got.dtype == v.dtype and got.shape == v.shape
        assert torch.equal(got, v)
    mgr = tckpt.CheckpointManager(tmp_path / "b", every=1, keep=2)
    for s in (1, 2, 3, 4):
        mgr.maybe_save(s, {"x": torch.arange(8.0) * s})
    mgr.finalize()
    steps = sorted(p.name for p in (tmp_path / "b").glob("step_*"))
    assert steps == ["step_00000003", "step_00000004"]
    got = tckpt.restore(tmp_path / "b", 4, {"x": torch.zeros(8)})
    assert torch.equal(got["x"], torch.arange(8.0) * 4)


def test_checkpoint_crosses_packages(tmp_path):
    """An f32 checkpoint of the reference restores in the port and the
    reverse: the same layout, leaf names and manifest."""
    jcfg = get_config("smollm-360m").reduced()
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0), dtype="float32")
    jtree = {"p": params, "o": jopt.init(params)}
    jckpt.save(tmp_path / "ref", 5, jtree)
    ttree = bridge.train_state_from(jax.tree_util.tree_map(
        lambda a: np.zeros_like(np.asarray(a)), jtree))
    got = tckpt.restore(tmp_path / "ref", 5, ttree)
    _assert_trees_close(jtree, got, 0.0)
    assert got["o"]["step"].shape == () and \
        got["o"]["step"].dtype == torch.int32
    # the port writes; the reference reads
    got = tree_map(lambda t: t + 1 if t.is_floating_point() else t + 3, got)
    tckpt.save(tmp_path / "port", 9, got)
    assert (tmp_path / "port" / "step_00000009" / "MANIFEST.json").read_text(
    ) == (tmp_path / "ref" / "step_00000005" / "MANIFEST.json").read_text(
    ).replace('"step": 5', '"step": 9')
    back = jckpt.restore(tmp_path / "port", 9, jtree)
    _assert_trees_close(back, got, 0.0)


# ------------------------- fault tolerance, loss ------------------------ #
def test_fault_tolerance_and_lm_loss_match_reference():
    mons = (jft.HeartbeatMonitor(5, timeout=3.0),
            tft.HeartbeatMonitor(5, timeout=3.0))
    for m in mons:
        for w, (t, dt) in enumerate([(1, .5), (2, .4), (1, 2.5), (4, .6),
                                     (0, .5)]):
            m.heartbeat(w, float(t), dt)
            m.heartbeat(w, float(t) + .5, dt * 1.1)
    assert mons[0].check(4.2) == mons[1].check(4.2)
    for args in ((8, [1], [3], 4, 120), (16, [], [2, 5, 9], 16, 40, False),
                 (3, [0, 1, 2], [], 2, 0)):
        assert dataclasses.asdict(jft.plan_elastic_restart(*args)) == \
            dataclasses.asdict(tft.plan_elastic_restart(*args))

    class Report:
        def __init__(self, gpus):
            self.gpus = gpus

    probs = np.array([0.5, 0.3, 0.2])
    for need, cur in ((8, 10), (12, 10), (5, 10)):
        a = jft.reprovision_on_workload_shift(lambda p: Report(need), probs,
                                              cur)
        b = tft.reprovision_on_workload_shift(lambda p: Report(need), probs,
                                              cur)
        assert a[0] == b[0]
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 9, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (2, 9)).astype(np.int32)
    labels[0, :4] = -1
    labels[1, 7] = -5
    want = float(j_lm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(lm_loss(torch.tensor(logits), torch.tensor(labels)))
    assert abs(want - got) <= TOL * abs(want)
    assert float(lm_loss(torch.tensor(logits),
                         torch.full((2, 9), -1, dtype=torch.int32))) == 0.0


# ---------------------------- LoRA train step --------------------------- #
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-235b-a22b"])
def test_lora_train_step_matches_reference(arch):
    jcfg = get_config(arch).reduced()
    params = draw_params(jcfg, 0)
    pool = j_init_pool(jcfg, 1, jax.random.PRNGKey(5), rank=8,
                       dtype=jnp.float32)
    kw = dict(lr=5e-3, warmup_steps=2, total_steps=25)
    jstep = jax.jit(j_make_step(jcfg, params, pool.scale,
                                jopt.AdamWConfig(**kw)))
    tstep = make_lora_train_step(bridge.config_from(jcfg),
                                 bridge.tree_to_tensors(params), pool.scale,
                                 topt.AdamWConfig(**kw))
    ja, jo = pool.tensors, jopt.init(pool.tensors)
    ta, to = bridge.train_state_from(jax.tree_util.tree_map(np.asarray, ja)), \
        bridge.train_state_from(jax.tree_util.tree_map(np.asarray, jo))
    dcfg = tdata.DataConfig(jcfg.vocab_size, 32, 2, tenant_id=1)
    # the first step's gradients on one state
    toks, labels = tdata.batch_at(dcfg, 0)

    def jloss(adapter):
        ctx = j_single_ctx(adapter, toks.shape[0], pool.scale)
        logits, _ = jtransformer.forward(params, jcfg, jnp.asarray(toks),
                                         kind="train", lora_ctx=ctx)
        return j_lm_loss(logits, jnp.asarray(labels))

    _, tgrads = value_and_grad(
        make_lora_loss(bridge.config_from(jcfg),
                       bridge.tree_to_tensors(params), pool.scale), ta,
        {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)})
    want, got = _jflat(jax.grad(jloss)(ja)), _tflat(tgrads)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= \
            GRAD_TOL * np.abs(want[k]).max(), k
    for s in range(5):
        toks, labels = tdata.batch_at(dcfg, s)
        jl, ja, jo, _ = jstep(ja, jo, None, {"tokens": jnp.asarray(toks),
                                             "labels": jnp.asarray(labels)})
        tl, ta, to, _ = tstep(ta, to, None, {"tokens": torch.tensor(toks),
                                             "labels": torch.tensor(labels)})
        assert abs(float(jl) - float(tl)) <= LOSS_TOL
        if s == 0:
            _assert_leaves_rel_close(jo, to, GRAD_TOL)
    _assert_trees_close(ja, ta, ADAPTER_TOL)
    _assert_leaves_rel_close(jo, to, MOMENT_TOL)
    back = bridge.train_state_to_numpy(to)
    assert back["step"].dtype == np.int32 and int(back["step"]) == 5


def test_lora_train_step_refuses_the_collective_branch():
    cfg = get_config("smollm-360m").reduced()
    tcfg = bridge.config_from(cfg)
    with pytest.raises(RuntimeError, match="no process group for "
                                           "axis_name 'data'"):
        make_lora_train_step(tcfg, {}, 1.0, topt.AdamWConfig(),
                             axis_name="data")


# ------------------- the reference's training properties ---------------- #
def _tiny_setup():
    cfg = bridge.config_from(get_config("smollm-360m").reduced())
    params = tmodel.init_params(cfg, seed=0, dtype="float32", device="cpu")
    return cfg, params, tdata.DataConfig(cfg.vocab_size, seq_len=32,
                                         global_batch=4)


def _batch(dcfg, s):
    toks, labels = tdata.batch_at(dcfg, s)
    return {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)}


def test_train_loss_decreases():
    cfg, params, dcfg = _tiny_setup()
    step = make_train_step(cfg, topt.AdamWConfig(lr=2e-3, warmup_steps=2,
                                                 total_steps=30))
    opt_state = topt.init(params)
    losses = []
    for s in range(30):
        loss, params, opt_state = step(params, opt_state, _batch(dcfg, s))
        losses.append(float(loss))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def test_lora_finetune_learns_tenant_structure():
    """LoRA-only training (frozen base) reduces the tenant's loss."""
    cfg, params, _ = _tiny_setup()
    dcfg = tdata.DataConfig(cfg.vocab_size, 32, 4, tenant_id=3)
    pool = init_adapter_pool(cfg, 1, seed=5, rank=8, dtype=torch.float32,
                             device="cpu")
    step = make_lora_train_step(cfg, params, pool.scale, topt.AdamWConfig(
        lr=5e-3, warmup_steps=2, total_steps=25, weight_decay=0.0))
    adapter, opt_state = pool.tensors, topt.init(pool.tensors)
    snapshot = tree_map(lambda t: t.clone(), params)
    losses = []
    for s in range(25):
        loss, adapter, opt_state, _ = step(adapter, opt_state, None,
                                           _batch(dcfg, s))
        losses.append(float(loss))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.02
    for k, v in flatten_with_keys(params).items():
        assert torch.equal(v, flatten_with_keys(snapshot)[k]) and \
            not v.requires_grad, k


# ------------------------------ launcher -------------------------------- #
def _losses(text: str):
    return {int(s): float(v) for s, v in
            re.findall(r"step\s+(\d+) loss ([0-9.]+)", text)}


@pytest.fixture
def reference_init(monkeypatch):
    """The port's launcher built from the reference launcher's initial
    weights (its PRNGKey(0) params and fold_in(key, 1) adapter)."""
    def params_of(cfg, args):
        jcfg = get_config(args.arch).reduced()
        p = jmodel.init_params(jcfg, jax.random.PRNGKey(0), dtype="float32")
        return bridge.train_state_from(jax.tree_util.tree_map(np.asarray, p))

    def adapter_of(cfg, args):
        jcfg = get_config(args.arch).reduced()
        pool = j_init_pool(jcfg, 1, jax.random.fold_in(jax.random.PRNGKey(0),
                                                       1),
                           rank=8, dtype=jnp.float32)
        return bridge.train_state_from(jax.tree_util.tree_map(
            np.asarray, pool.tensors)), pool.scale

    monkeypatch.setattr(ttrain, "build_params", params_of)
    monkeypatch.setattr(ttrain, "build_adapter", adapter_of)


def test_launcher_matches_reference_cli(reference_init, capsys, tmp_path):
    argv = ["--reduced", "--steps", "6", "--batch", "4", "--seq", "32",
            "--log-every", "1"]
    for mode in ([], ["--lora"]):
        assert jtrain.main(argv + mode) == 0
        want = _losses(capsys.readouterr().out)
        assert ttrain.main(argv + mode + ["--device", "cpu"]) == 0
        got = _losses(capsys.readouterr().out)
        assert sorted(got) == sorted(want) == list(range(6))
        for s in want:
            assert abs(got[s] - want[s]) <= 1.01e-4, (mode, s)
    # checkpoint every 3 steps; drop the last one and relaunch: it resumes
    # at step 3 and prints the uninterrupted run's steps 3-5
    ck = tmp_path / "ck"
    full = ttrain.run(argv + ["--device", "cpu", "--ckpt", str(ck),
                              "--ckpt-every", "3"])
    capsys.readouterr()
    assert tckpt.latest_step(ck) == 6
    import shutil
    shutil.rmtree(ck / "step_00000006")
    again = ttrain.run(argv + ["--device", "cpu", "--ckpt", str(ck)])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and again["start"] == 3
    assert {s: again["losses"][s] for s in (3, 4, 5)} == \
        {s: full["losses"][s] for s in (3, 4, 5)}
    assert all(torch.equal(a, flatten_with_keys(full["params"])[k])
               for k, a in flatten_with_keys(again["params"]).items())
    assert "ms/step" in out


# --------------------------- into serving ------------------------------- #
@pytest.mark.parametrize("mode", ["disagg", "coupled"])
def test_trained_adapter_served_through_load_adapter(mode):
    """A LoRA fine-tune of reduced qwen3-moe (3 steps) loaded through
    ``ServeSystem.load_adapter`` (rank 8 in a rank-32 pool; disagg: its
    gate/up/down into the paged fused main path; coupled: all seven
    targets, appended to the static pool) serves the tokens of an engine
    given the same tensors directly, and other tokens than the untrained
    adapter's."""
    from repro_torch.launch import serve
    from repro_torch.serving.api import build_system
    from repro_torch.serving.engine import Engine
    from repro_torch.training.train_step import host_tensors
    cfg = dataclasses.replace(bridge.config_from(
        get_config("qwen3-moe-235b-a22b").reduced()), lora_rank=32)
    params = tmodel.init_params(cfg, seed=0, dtype="float32", device="cpu")
    pool0 = init_adapter_pool(cfg, 1, seed=1, rank=8, dtype=torch.float32,
                              device="cpu")
    step = make_lora_train_step(cfg, params, pool0.scale, topt.AdamWConfig(
        lr=1e-2, warmup_steps=1, total_steps=3))
    adapter, opt_state = pool0.tensors, topt.init(pool0.tensors)
    dcfg = tdata.DataConfig(cfg.vocab_size, 32, 2, tenant_id=2)
    for s in range(3):
        _, adapter, opt_state, _ = step(adapter, opt_state, None,
                                        _batch(dcfg, s))
    targets = ("gate", "up", "down") if mode == "disagg" else None
    trained, untrained = host_tensors(adapter, targets), \
        host_tensors(pool0.tensors, targets)
    ranks = (8, 16, 32, 32)
    traffic = dataclasses.replace(serve.Traffic(adapter_ranks=ranks),
                                  n_requests=4, prompt_len=(6, 20),
                                  new_tokens=6)
    pool = serve.adapter_pool(cfg, mode, ranks, seed=0, dtype=torch.float32,
                              device="cpu")
    new = len(ranks)
    requests = [(rid, p, new) for rid, p, _ in
                serve.make_requests(cfg, traffic, 0)]
    kw = dict(transport="fused") if mode == "disagg" else {}
    system = build_system(serve.serve_config(traffic, mode, **kw,
                                             adapter_cache_slots=6),
                          pool.cfg, params=params, pool=pool)
    try:
        assert system.load_adapter(new, trained, alpha=16.0) == 8
        assert system.load_adapter(new + 1, untrained, alpha=16.0) == 8
        got = serve.serve_system(system, requests, traffic)["tokens"]
        base = serve.serve_system(system, [(r, p, new + 1)
                                           for r, p, _ in requests],
                                  traffic)["tokens"]
    finally:
        system.close()
    assert pool.n == len(ranks)             # the caller's pool is untouched
    # the engine given the same tensors directly: the pool with the trained
    # adapter appended (B rescaled from its alpha / 8 to the pool's scale)
    direct = dataclasses.replace(pool, tensors={
        t: dict(ab) for t, ab in pool.tensors.items()})
    f = (16.0 / 8) / pool.scale
    direct.append({k: v * f if k.endswith(".B") else v
                   for k, v in trained.items()}, 8)
    ecfg = dataclasses.replace(serve.ENGINE, paged=True)
    if mode == "disagg":
        from repro_torch.core.lora_server import pool_tensors_from_adapter
        from repro_torch.serving.cache import LoRACache
        from repro_torch.serving.server_pool import ServerPool
        sp = ServerPool.build(direct.cfg, direct, cache_slots=direct.n,
                              device="cpu")
        every = LoRACache(direct.n, adapter_bytes=0, n_layers=cfg.n_layers,
                          layerwise=False, prefetch=False)
        for aid in range(direct.n):
            every.admit(aid, 0.0)
        sp.sync(every, lambda a: pool_tensors_from_adapter(direct, a),
                direct.rank_of)
        engine = Engine(cfg, params, ecfg, server=sp, pool=direct,
                        transport="fused", device="cpu")
    else:
        engine = Engine(cfg, params, ecfg, pool=direct, device="cpu")
    want = serve.serve(engine, requests, traffic)["tokens"]
    assert got == want
    assert sum(a != b for r in got for a, b in zip(got[r], base[r])) > 0

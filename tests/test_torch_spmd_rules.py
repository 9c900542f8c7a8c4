"""The SPMD layer's rules and specs in one process, with no process group
(``tests/test_torch_spmd.py`` runs the collectives):

  - the reference's ``test_moe_plan_invariants`` ported: over the same
    draws the port's ``resolve_moe_plan`` equals the reference's field for
    field, and keeps its invariants (``ep_axis`` shards tokens and divides
    E, ``ff_axis`` does not shard tokens, fsdp and ff exclusive)
  - ``batch_specs``, ``cache_specs`` and ``param_shardings`` give the
    reference's specs for every registered config and the four shapes,
    under each step kind's rules on a (2, 4) and a (2, 2, 4) mesh; the
    abstract params are meta tensors of the reference's shapes
  - ``ShardingRules.token_layout`` and ``Placement.local_shape``
  - ``make_lora_train_step(axis_name="data")`` without a process group
    raises a RuntimeError naming it; the process meshes refuse a world
    of the wrong size

The reference's specs are read on a ``jax.sharding.AbstractMesh`` (no
devices), the port's on a stub mesh of the same shape."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh

from repro.configs import REGISTRY, get_config
from repro.configs import shapes as jshapes
from repro.distributed import steps as jsteps
from repro.distributed.sharding import use_rules as j_use_rules
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.distributed import steps as tsteps
from repro_torch.distributed.sharding import use_rules
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import make_lora_train_step

MESHES = [((2, 4), ("data", "model")), ((2, 2, 4), ("pod", "data", "model"))]


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


def _both_rules(shape, names, kind, jcfg):
    """(the reference's rules over an abstract mesh, the port's over a
    stub mesh), both of ``kind`` for ``jcfg``."""
    jr = jsteps.rules_for(FakeMesh(shape, names), kind, jcfg)
    jr.mesh = AbstractMesh(shape, names)
    return jr, tsteps.rules_for(FakeMesh(shape, names), kind,
                                bridge.config_from(jcfg))


def _entries(spec):
    return tuple(spec)


# ------------------------------ the plans -------------------------------- #
@settings(max_examples=40, deadline=None, database=None)
@given(E=st.sampled_from([4, 8, 16, 64]), kind=st.sampled_from(
    ["train", "decode"]), model=st.sampled_from([2, 4, 8]),
    data=st.sampled_from([2, 4]))
def test_moe_plan_invariants(E, kind, model, data):
    jcfg = dataclasses.replace(get_config("dbrx-132b").reduced(),
                               n_experts=E)
    tcfg = bridge.config_from(jcfg)
    mesh = FakeMesh((data, model), ("data", "model"))
    args = dict(batch=data * 8, n_tokens_seq=model * 4, kind=kind)
    with j_use_rules(jsteps.rules_for(mesh, kind, jcfg)):
        want = jmoe.resolve_moe_plan(jcfg, **args)
    with use_rules(tsteps.rules_for(mesh, kind, tcfg)):
        plan = tmoe.resolve_moe_plan(tcfg, **args)
    assert dataclasses.asdict(plan) == dataclasses.asdict(want)
    token_axes = set(plan.token_batch_axes)
    if plan.token_seq_axis:
        token_axes.add(plan.token_seq_axis)
    if plan.ep_axis is not None:
        assert plan.ep_axis in token_axes          # a2a must move tokens
        assert E % (model if plan.ep_axis == "model" else data) == 0
    if plan.ff_axis is not None:
        assert plan.ff_axis not in token_axes      # psum must not mix tokens
    if plan.fsdp_axis is not None:
        assert plan.ff_axis is None                # gather and psum exclusive


def test_moe_plan_is_none_without_rules():
    assert tmoe.resolve_moe_plan(bridge.config_from(get_config(
        "qwen3-moe-235b-a22b").reduced()), 8, 8, "train") is None


# ------------------------------- the specs ------------------------------- #
SHAPE_KIND = {"train_4k": "train", "prefill_32k": "prefill",
              "decode_32k": "decode", "long_500k": "decode"}


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_specs_equal_the_reference(arch):
    jcfg = get_config(arch)
    tcfg = bridge.config_from(jcfg)
    for shape, names in MESHES:
        for sname, kind in SHAPE_KIND.items():
            jshape = jshapes.get_shape(sname)
            tshape = tsteps_shape(jshape)
            jr, tr = _both_rules(shape, names, kind, jcfg)
            # the step inputs
            want = jsteps.batch_specs(jcfg, jshape, jr)
            got = tsteps.batch_specs(tcfg, tshape, tr)
            assert set(got) == set(want)
            for k in want:
                assert tuple(got[k][0].shape) == want[k][0].shape, k
                assert got[k][0].device.type == "meta"
                assert got[k][1].spec == _entries(want[k][1].spec), k
            # the caches
            if kind == "decode":
                jc, jsh = jsteps.cache_specs(jcfg, jshape, jr)
                tc, tsh = tsteps.cache_specs(tcfg, tshape, tr)
                assert set(tsh) == set(jsh)
                for k in jsh:
                    assert tsh[k].spec == _entries(jsh[k].spec), k
                    assert tuple(getattr(tc[k], "shape", ())) == \
                        tuple(jc[k].shape), k
        # the parameters, under each kind's rules
        for kind in ("train", "decode"):
            jr, tr = _both_rules(shape, names, kind, jcfg)
            want = _flat(jmodel.param_shardings(jcfg, jr),
                         lambda s: _entries(s.spec))
            got = _flat(tmodel.param_shardings(tcfg, tr), lambda p: p.spec)
            assert got == want


def tsteps_shape(jshape):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(jshape.name, seq_len=jshape.seq_len,
                       global_batch=jshape.global_batch, kind=jshape.kind)


def _flat(tree, leaf, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, leaf, f"{prefix}/{k}"))
        return out
    return {prefix: leaf(tree)}


def test_abstract_params_are_meta_tensors_of_the_reference_shapes():
    for arch in ("qwen3-moe-235b-a22b", "smollm-360m", "zamba2-2.7b"):
        jcfg = get_config(arch)
        got = _flat(tmodel.abstract_params(bridge.config_from(jcfg)),
                    lambda t: (tuple(t.shape), t.device.type))
        want = _flat(jmodel.abstract_params(jcfg),
                     lambda s: (tuple(s.shape), "meta"))
        assert got == want


def test_token_layout_and_local_shapes():
    cfg = bridge.config_from(get_config("qwen3-moe-235b-a22b").reduced())
    mesh = FakeMesh((2, 4), ("data", "model"))
    train = tsteps.rules_for(mesh, "train", cfg)
    assert train.token_layout(3, 5) == (("data",), ("model",))
    dec = tsteps.rules_for(mesh, "decode", cfg)
    assert dec.token_layout(3, 16, seq_name="kv_seq") == (("data",),
                                                          ("model",))
    assert dec.token_layout(3, None) == (("data",), ())
    pl = train.sharding(("layers", "experts", None, "moe_ff"),
                        (2, 4, 128, 256))
    assert pl.spec == (None, "model", None, "data")
    assert pl.local_shape == (2, 1, 128, 128)


def test_steps_refuse_token_dims_that_do_not_divide():
    from repro_torch.configs.base import ShapeConfig
    cfg = bridge.config_from(get_config("qwen3-moe-235b-a22b").reduced())
    mesh = FakeMesh((2, 4), ("data", "model"))
    mesh.get_group = None           # never reached
    with pytest.raises(ValueError, match="must divide"):
        tsteps.jit_train_step(cfg, ShapeConfig("t", seq_len=6,
                                               global_batch=4, kind="train"),
                              mesh)


# ------------------------------ the refusals ----------------------------- #
def test_lora_train_step_needs_a_process_group():
    cfg = bridge.config_from(get_config("smollm-360m").reduced())
    with pytest.raises(RuntimeError, match="no process group for "
                                           "axis_name 'data'"):
        make_lora_train_step(cfg, {}, 1.0, topt.AdamWConfig(),
                             axis_name="data")


def test_process_meshes_need_a_world():
    with pytest.raises(RuntimeError, match="needs a torch.distributed "
                                           "process group of 8 ranks"):
        tmesh.make_debug_mesh(2, 4)
    with pytest.raises(RuntimeError, match="of 256 ranks"):
        tmesh.make_production_mesh()
    assert not torch.distributed.is_initialized()


# ------------------------------ the update ------------------------------- #
def test_in_place_adamw_equals_the_update(monkeypatch):
    """``steps.adamw_`` (in place, a few elements at a time) gives the
    functional ``optimizer.update``'s parameters, moments and step bit for
    bit, over two steps."""
    monkeypatch.setattr(tsteps, "ADAMW_CHUNK", 7)
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(5, 6, generator=g),
              "b": {"c": torch.randn(11, generator=g).to(torch.bfloat16)}}
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    want_p, want_s = params, topt.init(params)
    got_p = {"a": params["a"].clone(), "b": {"c": params["b"]["c"].clone()}}
    got_s = topt.init(got_p)
    for _ in range(2):
        grads = {"a": torch.randn(5, 6, generator=g),
                 "b": {"c": torch.randn(11, generator=g)}}
        want_p, want_s = topt.update(want_p, grads, want_s, cfg)
        got_p, got_s = tsteps.adamw_(got_p, grads, got_s, cfg)
    for k in ("a",):
        assert torch.equal(got_p[k], want_p[k])
        assert torch.equal(got_s["m"][k], want_s["m"][k])
        assert torch.equal(got_s["v"][k], want_s["v"][k])
    assert torch.equal(got_p["b"]["c"], want_p["b"]["c"])
    assert torch.equal(got_s["v"]["b"]["c"], want_s["v"]["b"]["c"])
    assert int(got_s["step"]) == int(want_s["step"]) == 2


def test_a_frontend_under_sequence_parallelism_is_refused():
    """The vlm's frontend rows lie ahead of the text's: with the sequence
    sharded, a rank's slice of the joined sequence is not its slices
    joined, so the forward refuses that layout (batch-only rules run)."""
    from repro_torch.models import transformer as ttransformer

    class RankMesh(FakeMesh):
        def coord(self, axes):
            return 0

    jcfg = get_config("internvl2-1b").reduced()
    cfg = bridge.config_from(jcfg)
    params = tmodel.init_params(cfg, seed=0, dtype="float32", device="cpu")
    toks = torch.zeros((2, 4), dtype=torch.long)
    front = torch.zeros((2, 4, cfg.d_model))
    rules = tsteps.rules_for(RankMesh((1, 2), ("data", "model")), "prefill",
                             cfg)
    with use_rules(rules), pytest.raises(NotImplementedError,
                                         match="sequence parallelism"):
        ttransformer.forward(params, cfg, toks, frontend_emb=front)


def test_a_recomputed_layer_sees_the_rules_of_its_forward():
    """A checkpointed layer body (``forward(kind="train")``) is run again
    by the backward, which for CUDA tensors runs on autograd's own
    thread: it must see the rules active at the forward, not that
    thread's (none). Here the backward runs on another thread."""
    import threading

    from repro_torch.models import transformer as ttransformer

    from repro_torch.distributed.sharding import active_rules

    seen = []

    def body(x):
        seen.append(active_rules())
        return x * x                    # keeps x: the backward recomputes

    rules = tsteps.rules_for(FakeMesh((1, 1), ("data", "model")), "train",
                             bridge.config_from(get_config(
                                 "smollm-360m").reduced()))
    x = torch.ones(3, requires_grad=True)
    with use_rules(rules):
        y = ttransformer._remat(True, body, x)
    t = threading.Thread(target=lambda: y.sum().backward())
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [rules, rules]       # the forward, then the recompute
    assert torch.equal(x.grad, torch.full((3,), 2.0))

"""The port's analysis plane (``repro_torch.analysis``) against the
reference's and against ``chip_smoke.py``'s bounds:

  - ``model_flops`` == the reference's for every assigned config x shape;
    the ``Roofline`` terms on the H100 peaks
  - ``kernel_work`` (data form) == the bound ``chip_smoke.call_bound``
    gives for paged attention, ``bgmv``, ``bgmv_expert`` (ranked and not)
    and ``gmm``, and == the LoRA-kernel path's own ``Work`` for every case
    it times (``bgmv``, ``bgmv_ranked``, the four sgmv forms, ``gmm``), on
    small CPU inputs; its shape form is an upper bound that needs no data
  - the counter's flops of a reduced dense (smollm-360m) and a reduced MoE
    (qwen3-moe-235b-a22b) prefill and decode step, one rank of a (1, 1)
    mesh, against ``analyze_hlo(...)["flops"]`` of the reference's jitted
    step on one CPU device. The kernels count in their shape form (every
    row of the dispatch's capacity), as the reference's einsums compute
    them: they agree exactly, so the test holds them at 1e-9, well inside
    the 10% a difference would need to be named here
  - the same step counted on the meta device and on the CPU reads the
    same work, but for the f32 casts ``layers.mm_f32`` makes on the CPU
    alone (a meta trace takes the card's branch), named there
  - ``analytic_device_bytes``' params and cache == the reference's on
    reduced configs over a (2, 4) mesh (the reference in one subprocess of
    8 host devices); the port's cache is 4 bytes short, the reference's
    ``pos`` being a device scalar and the port's a host int
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import roofline as jrl
from repro.analysis.hlo_parse import analyze_hlo
from repro.configs import ASSIGNED as J_ASSIGNED, SHAPES as J_SHAPES
from repro.configs import ShapeConfig as JShape, get_config as jget
from repro.distributed import steps as jsteps
from repro_torch.analysis import roofline as RL
from repro_torch.analysis.counter import count
from repro_torch.analysis.memory_est import analytic_device_bytes
from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.distributed.steps import rules_for
from repro_torch.launch import dryrun
from repro_torch.launch import kernels as lora_path
from repro_torch.launch.mesh import Mesh, make_process_mesh
from repro_torch.models import transformer
from repro_torch.models.cache import init_cache
from repro_torch.launch import serve

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_mod",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------ roofline -------------------------------- #
@pytest.mark.parametrize("arch", sorted(J_ASSIGNED))
def test_model_flops_equal_reference(arch):
    for name, jshape in J_SHAPES.items():
        assert RL.model_flops(get_config(arch), SHAPES[name]) == \
            jrl.model_flops(jget(arch), jshape)


def test_roofline_terms_on_h100_peaks():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)
    r = RL.Roofline("a", "s", "m", chips=256, flops_per_device=1e12,
                    bytes_per_device=1e12, coll_bytes_per_device=1e9,
                    coll_breakdown={}, peak_mem_per_device=0,
                    model_flops=2.56e14)
    assert r.t_compute == pytest.approx(1e12 / 989e12)
    assert r.t_memory == pytest.approx(1e12 / 3.35e12)
    assert r.t_collective == pytest.approx(1e9 / 450e9)
    assert r.bottleneck == "memory" and r.step_time == r.t_memory
    assert r.roofline_fraction == pytest.approx(
        2.56e14 / (256 * 989e12 * r.t_memory))
    assert r.useful_flops_ratio == pytest.approx(2.56e14 / (1e12 * 256))
    assert set(r.to_dict()) >= {"t_compute", "t_memory", "t_collective",
                                "bottleneck", "step_time",
                                "useful_flops_ratio", "roofline_fraction"}
    assert RL.bound_ms(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert RL.bound_ms(0, 989e9) == (pytest.approx(1.0), "operations")


# ---------------------------- kernel work ------------------------------- #
def _smoke_calls(g):
    """Small calls of the four kernels ``call_bound`` covers, with holes:
    inactive rows, unallocated pages, a window, empty experts."""
    bf = torch.bfloat16
    B, KV, G, hd, ps, nb = 3, 2, 2, 8, 4, 5
    P = B * nb + 2
    q = torch.randn(B, KV, G, hd, generator=g).to(bf)
    k = torch.randn(P, ps, KV, hd, generator=g).to(bf)
    bt = torch.randperm(P, generator=g)[:B * nb].reshape(B, nb).int()
    bt[1, 3:] = -1
    pos = torch.tensor([17, 6, -1], dtype=torch.int32)
    T, N, E, d_in, r, d_out = 12, 3, 4, 16, 8, 24
    ids = torch.tensor([0, 1, -1, 2, 0, 0, -1, 1, 2, 2, 0, -1],
                       dtype=torch.int32)
    eids = torch.randint(0, E, (T,), generator=g, dtype=torch.int32)
    ranks = torch.tensor([2, 8, 5, 8, 2, 2, 8, 8, 5, 5, 2, 8],
                         dtype=torch.int32)
    x = torch.randn(T, d_in, generator=g).to(bf)
    A4 = torch.randn(N, E, d_in, 2 * r, generator=g).to(bf)
    B4 = torch.randn(N, E, 2 * r, d_out, generator=g).to(bf)
    A3 = torch.randn(N, d_in, r, generator=g).to(bf)
    B3 = torch.randn(N, r, d_out, generator=g).to(bf)
    xe = torch.randn(E, 6, d_in, generator=g).to(bf)
    w = torch.randn(E, d_in, d_out, generator=g).to(bf)
    sizes = torch.tensor([3, 0, 6, 1], dtype=torch.int32)
    return [
        ("paged_attention", (q, k, k, bt, pos), {"window": 0}),
        ("paged_attention", (q, k, k, bt, pos), {"window": 5}),
        ("bgmv", (x, A3, B3, ids), {}),
        ("bgmv_expert", (x, A4, B4, ids, eids), {}),
        ("bgmv_expert", (x, A4, B4, ids, eids, ranks, r), {}),
        ("gmm", (xe, w, sizes), {}),
    ]


def test_kernel_work_equals_chip_smoke_call_bound():
    smoke = _chip_smoke()
    g = torch.Generator().manual_seed(0)
    for name, args, kw in _smoke_calls(g):
        want = smoke.call_bound(torch, name, args, kw)
        got = RL.kernel_bound(name, args, kw)
        assert got[1] == want[1], name
        assert got[0] == pytest.approx(want[0], rel=1e-12), name


def test_kernel_work_equals_the_lora_paths_work():
    res = lora_path.run(device="cpu", reduced=True, seed=0)
    seen = set()
    for case, (op, args, work) in res["cases"].items():
        if work is None:
            continue
        assert RL.kernel_work(op, args) == (work.bytes, work.operations), \
            case
        seen.add(op)
    assert seen == {"bgmv", "bgmv_ranked", "sgmv", "sgmv_ranked",
                    "sgmv_rank_grouped", "fused_sgmv", "fused_sgmv_ranked",
                    "gmm"}


def test_kernel_work_shape_form_bounds_the_data_form_on_meta_too():
    g = torch.Generator().manual_seed(1)
    res = lora_path.run(device="cpu", reduced=True, seed=1)
    calls = _smoke_calls(g) + [(op, args, {}) for op, args, _ in
                               res["cases"].values()]
    for name, args, kw in calls:
        data = RL.kernel_work(name, args, kw, "data")
        shape = RL.kernel_work(name, args, kw, "shape")
        assert shape[0] >= data[0] and shape[1] >= data[1], name
        meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                     for a in args)
        assert RL.kernel_work(name, meta, kw, "shape") == shape, name
    # every row active and every factor slice distinct: the forms agree
    xe = torch.ones(2, 3, 8, dtype=torch.bfloat16)
    w = torch.ones(2, 8, 16, dtype=torch.bfloat16)
    full = torch.tensor([3, 3], dtype=torch.int32)
    assert RL.kernel_work("gmm", (xe, w, full)) == \
        RL.kernel_work("gmm", (xe, w, full), form="shape")
    with pytest.raises(ValueError):
        RL.kernel_work("gmm", (xe, w, full), form="hlo")


# --------------------- the counter against the HLO ---------------------- #
def _reference_flops(arch, kind, S, B):
    import jax
    from jax.sharding import Mesh as JMesh
    mesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    f = jsteps.jit_prefill_step if kind == "prefill" else \
        jsteps.jit_serve_step
    jitted, abstract, _ = f(jget(arch).reduced(), JShape("x", S, B, kind),
                            mesh)
    return analyze_hlo(jitted.lower(*abstract).compile().as_text())["flops"]


def _port_count(arch, kind, S, B):
    with dryrun.fake_world(1):
        mesh = make_process_mesh((1, 1), ("data", "model"))
        counted, _, _ = dryrun.trace_cell(get_config(arch).reduced(),
                                          ShapeConfig("x", S, B, kind), mesh)
    return counted


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_counter_flops_equal_reference_hlo(arch, kind):
    S, B = 64, 2
    counted = _port_count(arch, kind, S, B)
    want = _reference_flops(arch, kind, S, B)
    assert counted["flops"] == pytest.approx(want, rel=1e-9)
    if arch.startswith("qwen3"):      # the base expert GEMMs through gmm
        assert counted["kernels"]["gmm"]["calls"] == 3 * 2


def test_counts_on_meta_equal_counts_on_cpu():
    """Flops and the kernels' work equal; so is every aten op's count and
    bytes, but for the one difference the layers make on purpose:
    ``layers.mm_f32`` casts bf16 operands to f32 on the CPU (``_to_copy``,
    then an f32 ``mm``), where the card, and a meta trace that stands for
    it, multiply bf16 into an f32 result."""
    cfg, params = serve.model("qwen3-moe-235b-a22b", reduced=True,
                              device="cpu")

    def on(t, dev):
        if isinstance(t, dict):
            return {k: on(v, dev) for k, v in t.items()}
        return t.to(dev) if isinstance(t, torch.Tensor) else t

    got, ops_of = {}, {}
    for dev in ("cpu", "meta"):
        cache = init_cache(cfg, 3, 32, device=dev)
        cache["pos"] = 9
        tok = torch.zeros(3, 1, dtype=torch.long, device=dev)
        p = on(params, dev)
        with torch.no_grad():       # builds the device's RoPE table once
            transformer.decode_step(p, cfg, dict(cache), tok)
            with count() as c:
                logits, _ = transformer.decode_step(p, cfg, cache, tok)
        assert logits.device.type == dev
        got[dev], ops_of[dev] = c.summary("shape"), dict(c.by_op)
    for key in ("flops", "aten_flops", "kernels", "coll_bytes"):
        assert got["cpu"][key] == got["meta"][key], key
    assert got["cpu"]["kernels"]["gmm"]["calls"] == 3 * cfg.n_layers
    cast = {"_to_copy", "mm"}
    assert {k: v for k, v in ops_of["cpu"].items() if k not in cast} == \
        {k: v for k, v in ops_of["meta"].items() if k not in cast}
    assert ops_of["cpu"]["mm"][0] == ops_of["meta"]["mm"][0]      # flops
    assert ops_of["cpu"]["mm"][2] == ops_of["meta"]["mm"][2]      # calls
    assert got["meta"]["hbm_bytes"] < got["cpu"]["hbm_bytes"]
    with pytest.raises(ValueError, match="meta"):
        c.summary("data")


# ------------------------------- memory --------------------------------- #
MEM_CASES = [("smollm-360m", "train", 64, 8), ("smollm-360m", "decode", 64, 8),
             ("qwen3-moe-235b-a22b", "train", 64, 8),
             ("qwen3-moe-235b-a22b", "prefill", 64, 8),
             ("qwen3-moe-235b-a22b", "decode", 64, 8)]

REFERENCE_MEMORY = textwrap.dedent("""
    import os, json, sys
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.analysis.memory_est import analytic_device_bytes
    from repro.configs import ShapeConfig, get_config
    from repro.distributed.steps import rules_for
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ('data', 'model'))
    out = []
    for arch, kind, S, B in json.loads(sys.argv[1]):
        cfg = get_config(arch).reduced()
        rules = rules_for(mesh, kind, cfg)
        m = analytic_device_bytes(cfg, ShapeConfig('x', S, B, kind), rules,
                                  kind)
        out.append({k: m[k] for k in ('params', 'cache', 'opt_state',
                                      'workspace')})
    print(json.dumps(out))
""")


def test_analytic_memory_equals_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_MEMORY, json.dumps(MEM_CASES)],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    mesh = Mesh(np.empty((2, 4), dtype=object), ("data", "model"))
    for (arch, kind, S, B), want in zip(MEM_CASES, ref):
        cfg = get_config(arch).reduced()
        got = analytic_device_bytes(cfg, ShapeConfig("x", S, B, kind),
                                    rules_for(mesh, kind, cfg), kind)
        assert got["params"] == want["params"], (arch, kind)
        # the reference's cache holds pos as a 4-byte device scalar
        assert got["cache"] == want["cache"] - (4 if kind == "decode"
                                                else 0), (arch, kind)
        assert got["opt_state"] == want["opt_state"]
        assert got["workspace"] == want["workspace"]
        # the steps hold the reference's layout; a layer's weights are
        # gathered whole at use
        assert got["params_as_run"] == got["params"]
        assert got["at_use_gather"] > 0
        assert got["fits_80g"] is True

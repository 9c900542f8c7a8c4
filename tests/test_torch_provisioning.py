"""The port's provisioning plane against the JAX reference's, host code on
the CPU:

  - ``configs/base.py``: ``param_count``, ``active_param_count`` and
    ``lora_adapter_bytes`` equal the reference's for every moe config
    and for the ssm, hybrid and audio ones
  - ``core/placement.py``: every strategy's ``owner``, groups, experts and
    layers per device equal the reference's
  - ``core/cost_model.py`` and ``core/protocol.py``: every function equals
    the reference's to 1e-12 relative on a port ``Hardware`` built here
    with the reference's default constants (the port itself prices with a
    nominal H100), and the reference's own invariants hold on the port's
    defaults
  - ``core/provisioning.py`` (float64): ``residency_q`` against
    ``scipy.special.gammainc`` (scipy on the test side only) to 1e-9,
    ``iar`` against ``iar_paper`` to 1e-10 and against the reference's
    float32 ``iar`` to 1e-5, IAR monotone in M where the reference's is
    not, ``min_cache_size`` and ``provision`` against the reference's with
    the float32 margin where they part, the paper's validation point
  - the port imports no scipy
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.special
from hypothesis import given, settings, strategies as st

from repro.configs import REGISTRY, get_config
from repro.core import cost_model as jcm
from repro.core import placement as jplacement
from repro.core import protocol as jprotocol
from repro.core import provisioning as JP
from repro_torch import bridge
from repro_torch.core import cost_model as cm
from repro_torch.core import protocol
from repro_torch.core import provisioning as P
from repro_torch.core.placement import Placement

ROOT = Path(__file__).resolve().parents[1]
MOE = sorted(n for n, c in REGISTRY.items() if c.family == "moe")
# a port Hardware with the reference's default constants: both packages
# price the same machine
REF_HW = cm.Hardware(**dataclasses.asdict(jcm.V5E))
REL = 1e-12
# the reference's gammainc runs in float32: IAR agrees to this
REF_IAR_TOL = 1e-5


def _port_cfg(name):
    return bridge.config_from(get_config(name))


def _close(a, b, rel=REL):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


# ------------------------------ accounting ------------------------------- #
@pytest.mark.parametrize("name", MOE)
def test_param_accounting_equals_reference(name):
    ref, cfg = get_config(name), _port_cfg(name)
    for c, j in ((cfg, ref), (cfg.reduced(), ref.reduced())):
        assert c.param_count() == j.param_count()
        assert c.active_param_count() == j.active_param_count()
        for rank in (None, 4, 16):
            assert c.lora_adapter_bytes(rank) == j.lora_adapter_bytes(rank)
        assert c.lora_adapter_bytes(8, "float32") == \
            j.lora_adapter_bytes(8, "float32")


def test_other_families_are_refused_naming_a7():
    """The ssm, hybrid and audio families are accounted as the reference
    does (they were refused before the static-batch API): rwkv's time and
    channel mix, the hybrid's mamba layers and one shared block, the
    audio decoder's cross attention and the encoder's layers in the
    adapter bytes; full and reduced, every rank."""
    for name, family in (("rwkv6-3b", "ssm"), ("zamba2-2.7b", "hybrid"),
                         ("seamless-m4t-large-v2", "audio")):
        ref, cfg = get_config(name), _port_cfg(name)
        assert cfg.family == family
        for c, j in ((cfg, ref), (cfg.reduced(), ref.reduced())):
            assert c.param_count() == j.param_count()
            assert c.active_param_count() == j.active_param_count()
            for rank in (None, 4, 16):
                assert c.lora_adapter_bytes(rank) == \
                    j.lora_adapter_bytes(rank)
            assert c.lora_adapter_bytes(8, "float32") == \
                j.lora_adapter_bytes(8, "float32")


# ------------------------------ placement -------------------------------- #
@pytest.mark.parametrize("strategy,m,x", [("dp", 4, None), ("pp", 4, None),
                                          ("ep", 4, None), ("hybrid", 8, 4),
                                          ("hybrid", 6, None),
                                          ("hybrid", 8, 1)])
def test_placement_equals_reference(strategy, m, x):
    got = Placement.make(strategy, m, 16, 12, 8, x=x)
    want = jplacement.Placement.make(strategy, m, 16, 12, 8, x=x)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.describe() == want.describe()
    assert got.sync_scope() == want.sync_scope()
    assert got.cells_per_device() == want.cells_per_device()
    for dev in range(m):
        np.testing.assert_array_equal(got.experts_on(dev),
                                      want.experts_on(dev))
        np.testing.assert_array_equal(got.layers_on(dev),
                                      want.layers_on(dev))
    for layer in range(12):
        np.testing.assert_array_equal(got.layer_group(layer),
                                      want.layer_group(layer))
        for a in (0, 5):
            for e in range(8):
                assert got.owner(a, layer, e) == want.owner(a, layer, e)


def test_hybrid_placement_rejects_a_bad_grid():
    with pytest.raises(ValueError, match="x \\* y"):
        Placement("hybrid", 8, 1, 1, 1, x=3, y=2)


# ------------------------------ cost model ------------------------------- #
def test_h100_is_nominal_and_the_default():
    h = cm.H100
    assert (h.flops, h.hbm_bw, h.hbm_gb, h.ici_bw, h.dcn_bw, h.host_bw,
            h.disk_bw) == (989e12, 3.35e12, 80.0, 450e9, 50e9, 64e9, 5e9)
    assert cm.Hardware() == h
    assert h.link(False) == (h.ici_bw, h.ici_lat)
    assert h.link(True) == (h.dcn_bw, h.dcn_lat)
    assert "nominal" in cm.Hardware.__doc__.lower()


@pytest.mark.parametrize("strategy", ["dp", "pp", "ep", "hybrid"])
def test_strategy_metrics_equal_reference(strategy):
    for b, k, p, m, x, y in [(128, 2, 2, 4, 2, 2), (256, 8, 4, 8, 4, 2),
                             (64, 4, 2, 16, 8, 2), (7, 1, 1, 1, 1, 1)]:
        assert cm.strategy_metrics(strategy, b, k, p, m, x, y) == \
            jcm.strategy_metrics(strategy, b, k, p, m, x, y)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "qwen3-moe-235b-a22b",
                                  "qwen3-30b-a3b"])
def test_cost_functions_equal_reference(name):
    ref, cfg = get_config(name), _port_cfg(name)
    for rows in (1.0, 48.0, 1024.0):
        assert cm.payload_bytes(cfg, rows) == jcm.payload_bytes(ref, rows)
        for distinct, rank, eff in ((1, 8, 0.7), (40, 32, 0.25),
                                    (300, 64, 0.7)):
            assert _close(
                cm.lora_compute_seconds(cfg, rows, distinct, rank, REF_HW,
                                        kernel_eff=eff),
                jcm.lora_compute_seconds(ref, rows, distinct, rank,
                                         kernel_eff=eff))
    for strategy, m, x in (("dp", 4, None), ("pp", 4, None), ("ep", 8, None),
                           ("hybrid", 8, 4), ("hybrid", 8, 2)):
        pl = Placement.make(strategy, m, 64, cfg.n_layers, cfg.n_experts, x=x)
        jpl = jplacement.Placement.make(strategy, m, 64, ref.n_layers,
                                        ref.n_experts, x=x)
        for b, p, distinct, rank, inter, proto in (
                (128, 2, 40.0, None, False, "push"),
                (6, 1, 4.0, 16, True, "pull"), (512, 8, 200.0, 4.5, False,
                                                "pull")):
            got = cm.latency_breakdown(cfg, pl, b, p, distinct, rank=rank,
                                       hw=REF_HW, inter_pod=inter,
                                       protocol=proto)
            want = jcm.latency_breakdown(ref, jpl, b, p, distinct,
                                         rank=rank, inter_pod=inter,
                                         protocol=proto)
            assert got.keys() == want.keys()
            assert all(_close(got[k], want[k]) for k in got), (got, want)
    for b, p in ((1, 1), (6, 1), (128, 2), (4096, 8)):
        assert _close(cm.base_moe_gemm_seconds(cfg, b, p, REF_HW),
                      jcm.base_moe_gemm_seconds(ref, b, p))
        assert _close(cm.base_moe_gemm_seconds(cfg, b, p, REF_HW, eff=0.8),
                      jcm.base_moe_gemm_seconds(ref, b, p, eff=0.8))


def test_transport_and_protocol_equal_reference():
    for args in ((94, 1, "host", 0.0), (94, 2, "host", 5.0),
                 (4, 2, "fused", 5.0), (4, 1, "fused", 0.0)):
        assert cm.transport_dispatch_seconds(*args) == \
            jcm.transport_dispatch_seconds(*args)
    for payload in (2**12, 4 * 2**20, 3e8):
        for inter in (False, True):
            for proto, peers, scope in (("push", 1, 1), ("push", 4, 2),
                                        ("pull", 1, 4), ("pull", 2, 8)):
                assert _close(
                    protocol.transfer_seconds(payload, REF_HW, inter, proto,
                                              peers, scope),
                    jprotocol.transfer_seconds(payload, jcm.V5E, inter,
                                               proto, peers, scope))
        assert _close(protocol.pull_push_ratio(payload, REF_HW),
                      jprotocol.pull_push_ratio(payload))
    with pytest.raises(ValueError):
        protocol.transfer_seconds(1.0, protocol="carrier-pigeon")


# the reference's invariants (tests/test_cost_model.py) on the port's
# defaults (the nominal H100)
def test_hybrid_specializations():
    for b, k, p, m in [(128, 2, 2, 4), (256, 8, 4, 8), (64, 4, 2, 16)]:
        ep = cm.strategy_metrics("ep", b, k, p, m)
        assert ep == cm.strategy_metrics("hybrid", b, k, p, m, x=m, y=1)
        pp = cm.strategy_metrics("pp", b, k, p, m)
        assert pp == cm.strategy_metrics("hybrid", b, k, p, m, x=1, y=m)


@settings(max_examples=30, deadline=None, database=None)
@given(b=st.integers(1, 512), k=st.integers(1, 8),
       p=st.sampled_from([1, 2, 4]), x=st.sampled_from([1, 2, 4]),
       y=st.sampled_from([1, 2, 4]))
def test_table1_invariants(b, k, p, x, y):
    m = x * y
    h = cm.strategy_metrics("hybrid", b, k, p, m, x=x, y=y)
    assert h["compute_volume"] * x == pytest.approx(b * k)
    assert h["sync_scope"] == x
    assert h["peer_count"] >= 1
    if x > 1:
        h1 = cm.strategy_metrics("hybrid", b, k, p, m, x=1, y=m)
        assert h["compute_volume"] <= h1["compute_volume"]


def test_push_pull_calibration():
    """Paper §5.1: pull/push ~= 2.63x at 4 MB, on the H100's link."""
    r = protocol.pull_push_ratio(4 * 2**20)
    assert 2.2 < r < 3.1, r
    for payload in (2**12, 2**16, 2**20, 2**24):
        push = protocol.transfer_seconds(payload, protocol="push")
        pull = protocol.transfer_seconds(payload, protocol="pull",
                                         sync_scope=4)
        assert pull > push


def test_table4_ordering_larger_ep_wins():
    """Paper A.2.1/Table 4 (Mixtral, 8 server GPUs): EP4-PP2 and EP8-PP1
    beat EP1-PP8; the best hybrid has x >= 4."""
    cfg = _port_cfg("mixtral-8x7b")
    totals = {}
    for x, y in ((1, 8), (2, 4), (4, 2), (8, 1)):
        pl = Placement.make("hybrid", 8, 256, cfg.n_layers, cfg.n_experts,
                            x=x)
        lat = cm.latency_breakdown(cfg, pl, b=128, p=2, distinct_adapters=40)
        totals[(x, y)] = lat["recv"] + lat["comp"] + lat["send"]
    assert totals[(4, 2)] <= totals[(1, 8)]
    assert totals[(8, 1)] <= totals[(1, 8)]
    assert min(totals, key=totals.get)[0] >= 4


def test_lora_compute_sublinear_and_base_gemm_roofline():
    cfg = _port_cfg("mixtral-8x7b")

    def t(b, distinct):
        return cm.lora_compute_seconds(cfg, rows=b * 2, distinct=distinct,
                                       rank=64)
    assert t(512, 60) < 4 * t(128, 40)
    t1, t2, t3 = (cm.base_moe_gemm_seconds(cfg, b, 2)
                  for b in (64, 256, 2048))
    assert t1 <= t2 < t3


# ----------------------------- provisioning ------------------------------ #
def test_residency_q_equals_scipy_in_float64():
    lams = np.concatenate([np.linspace(1e-6, 2.0, 40),
                           np.linspace(2.0, 1200.0, 80)])
    for tau in (0.0, 0.37, 3.3, 41.9, 100.7, 599.5, 1199.0):
        got = P.residency_q(lams, tau)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, scipy.special.gammainc(tau + 1.0,
                                                               lams),
                                   rtol=0, atol=1e-9)


@settings(max_examples=20, deadline=None, database=None)
@given(n=st.integers(8, 40), lb=st.integers(4, 400),
       s=st.floats(0.5, 2.0), m_frac=st.floats(0.1, 0.9))
def test_fast_iar_equals_paper_algorithm(n, lb, s, m_frac):
    probs = P.zipf_probs(n, s)
    M = max(1, int(n * m_frac))
    assert abs(P.iar(probs, lb, M) - P.iar_paper(probs, lb, M)) < 1e-10


@settings(max_examples=25, deadline=None, database=None)
@given(n=st.integers(8, 64), lb=st.integers(8, 600))
def test_iar_monotone_in_cache_size(n, lb):
    probs = P.zipf_probs(n, 1.2)
    vals = [P.iar(probs, lb, M) for M in range(1, n + 1)]
    assert all(b >= a - 1e-9 for a, b in zip(vals, vals[1:]))
    assert vals[-1] == pytest.approx(1.0)


def test_iar_monotone_where_the_reference_is_not():
    """n = 54, lb = 8: the reference's float32 IAR drops as M grows (its
    hypothesis run fails there); the port's float64 one does not, and the
    two agree within the reference's float32 error."""
    probs = P.zipf_probs(54, 1.2)
    got = [P.iar(probs, 8, M) for M in range(1, 55)]
    assert all(b >= a - 1e-12 for a, b in zip(got, got[1:]))
    want = [JP.iar(probs, 8, M) for M in range(1, 55)]
    assert any(b < a - 1e-9 for a, b in zip(want, want[1:]))
    np.testing.assert_allclose(got, want, rtol=0, atol=REF_IAR_TOL)


@pytest.mark.parametrize("n,lb,s,M", [(16, 64, 1.2, 4), (32, 128, 1.2, 9),
                                      (40, 400, 0.8, 30), (64, 600, 1.2, 20),
                                      (20, 4, 2.0, 3)])
def test_iar_equals_reference_within_float32(n, lb, s, M):
    probs = P.zipf_probs(n, s)
    np.testing.assert_allclose(P.zipf_probs(n, s), JP.zipf_probs(n, s),
                               rtol=0, atol=0)
    assert abs(P.iar(probs, lb, M) - JP.iar(probs, lb, M)) < REF_IAR_TOL
    lams = lb * probs
    assert abs(P.solve_tau(lams, M) - JP.solve_tau(lams, M)) < 1e-2


def test_poisson_binomial_and_deconvolution_equal_reference():
    rng = np.random.default_rng(0)
    qs = rng.uniform(0.01, 0.99, size=30)
    dp = P.poisson_binomial_pmf(qs)
    np.testing.assert_array_equal(dp, JP.poisson_binomial_pmf(qs))
    for i in (0, 7, 29):
        direct = P.poisson_binomial_pmf(np.delete(qs, i))
        dec = P._deconvolve(dp, qs[i])
        np.testing.assert_allclose(dec, direct, atol=1e-9)
        np.testing.assert_array_equal(dec, JP._deconvolve(dp, qs[i]))


def test_residency_threshold_solves_capacity():
    probs = P.zipf_probs(64, 1.2)
    lams = 256 * probs
    for M in (8, 16, 32):
        tau = P.solve_tau(lams, M)
        assert abs(P.residency_q(lams, tau).sum() - M) < 1e-6


def _margin(probs, lb, alpha, m_got, m_want):
    """Where the port's M* differs from the reference's, the reference's
    IAR at the boundary lies within its float32 error of ``alpha``."""
    if m_got == m_want:
        return
    lo = min(m_got, m_want)
    assert abs(JP.iar(probs, lb, lo) - alpha) < REF_IAR_TOL


@pytest.mark.parametrize("n,lb,alpha", [(48, 128, 0.9), (32, 64, 0.95),
                                        (64, 256, 0.8)])
def test_min_cache_size_equals_reference(n, lb, alpha):
    probs = P.zipf_probs(n, 1.2)
    m_star = P.min_cache_size(probs, lb, alpha)
    lin = next(M for M in range(1, n + 1) if P.iar(probs, lb, M) >= alpha)
    assert m_star == lin
    assert P.min_cache_size(probs, lb, alpha, exact=True) == m_star
    _margin(probs, lb, alpha, m_star, JP.min_cache_size(probs, lb, alpha))


def test_paper_validation_point():
    """Paper §6.3.2: 512 adapters, LB 1024; caches 128/192/256 ->
    predicted IAR 83.0/92.2/100.0%: the same cliff shape."""
    probs = P.zipf_probs(512, 1.2)
    v = [P.iar(probs, 1024, M) for M in (128, 192, 256)]
    assert v[0] < v[1] < v[2]
    assert v[2] > 0.98
    assert v[0] < 0.95


@pytest.mark.parametrize("name,n_adapters,n_instances,b,p,slo", [
    ("qwen3-30b-a3b", 96, 4, 128, 2, 0.1),
    ("mixtral-8x7b", 64, 4, 64, 8, 0.05),
    ("qwen3-moe-235b-a22b", 64, 2, 32, 8, 0.2)])
def test_provision_equals_reference(name, n_adapters, n_instances, b, p, slo):
    ref, cfg = get_config(name), _port_cfg(name)
    got = P.provision(cfg, n_adapters, n_instances, b, p, slo_tpot=slo,
                      hw=REF_HW)
    want = JP.provision(ref, n_adapters, n_instances, b, p, slo_tpot=slo)
    probs = P.zipf_probs(n_adapters, 1.2)
    _margin(probs, n_instances * b, 0.95, got.M_star, want.M_star)
    if got.M_star == want.M_star:
        assert got.cache_bytes == want.cache_bytes
        assert got.gpus_for_cache == want.gpus_for_cache
        assert got.gpus == want.gpus
        assert dataclasses.asdict(got.placement) == \
            dataclasses.asdict(want.placement)
        assert abs(got.iar - want.iar) < REF_IAR_TOL
    assert got.gpus_for_tpot == want.gpus_for_tpot
    assert got.latency.keys() == want.latency.keys()
    assert all(_close(got.latency[k], want.latency[k]) for k in got.latency)
    assert got.iar >= 0.95
    assert got.gpus == max(got.gpus_for_cache, got.gpus_for_tpot)
    assert got.placement.m == got.gpus


def test_provision_on_the_h100_and_tpot_search_monotone():
    """The reference's end-to-end case (512 adapters) on the port's
    default hardware: more instances need at least as much cache."""
    cfg = _port_cfg("qwen3-30b-a3b")
    rep = P.provision(cfg, n_adapters=512, n_instances=4, b=128, p=2)
    assert rep.M_star >= 1 and rep.iar >= 0.95
    assert rep.gpus == max(rep.gpus_for_cache, rep.gpus_for_tpot)
    rep2 = P.provision(cfg, n_adapters=512, n_instances=8, b=128, p=2)
    assert rep2.M_star >= rep.M_star
    mx = _port_cfg("mixtral-8x7b")
    tight, _, _ = P.min_gpus_for_tpot(mx, b=128, p=8, n_instances=4,
                                      slo_tpot=0.05, distinct_adapters=32)
    loose, _, _ = P.min_gpus_for_tpot(mx, b=128, p=8, n_instances=4,
                                      slo_tpot=0.4, distinct_adapters=32)
    assert tight >= loose
    # the faster card needs no more server GPUs than the reference's
    assert P.min_gpus_for_tpot(mx, 128, 8, 4, 0.05, 32)[0] <= \
        P.min_gpus_for_tpot(mx, 128, 8, 4, 0.05, 32, hw=REF_HW)[0]


def test_port_imports_without_scipy():
    """The provisioning plane (and every module that prices with it)
    imports with scipy made unimportable."""
    mods = ["repro_torch.core.provisioning", "repro_torch.core.cost_model",
            "repro_torch.serving.autoscaler", "repro_torch.serving.simulator",
            "repro_torch.serving.api", "repro_torch.baselines.slora",
            "repro_torch.launch.serve"]
    code = ("import sys, importlib; sys.modules['scipy'] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

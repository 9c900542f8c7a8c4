"""The port's config registry against the JAX reference's, on the CPU:

  - the registry holds every config of the reference (``ASSIGNED``,
    ``PAPER``, ``list_archs``), field for field
  - ``param_count``, ``active_param_count``, ``lora_adapter_bytes`` (ranks
    8, 32, 64, the config's own, float32, an attention-only target set, a
    GELU MLP) and ``reduced()`` equal the reference's
  - the ssm, hybrid and audio configs resolve, with the reference's
    accounting and ``reduced()``
  - ``launch/serve.py --cluster --arch mixtral-8x7b`` (``compare_planes``
    and the command line) and the front door's sim backend on every
    config (both planes on qwen2-72b) give the reference's numbers when
    priced on the reference's machine

Each property is one test over every config it concerns."""
import dataclasses
import math

import pytest

from repro import configs as jconfigs
from repro.baselines import slora as jslora
from repro.core import cost_model as jcm
from repro.serving import api as japi
from repro.serving import workload as jworkload
from repro_torch import bridge, configs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import Hardware
from repro_torch.launch import serve as tserve
from repro_torch.serving.api import ServeConfig, build_system
from repro_torch.serving.workload import Request

NAMES = sorted(configs.REGISTRY)
# the families only the legacy static-batch API serves
STATIC_ONLY = ("rwkv6-3b", "zamba2-2.7b", "seamless-m4t-large-v2")
# a port Hardware with the reference's default constants: both packages
# price the same machine
REF_HW = Hardware(**dataclasses.asdict(jcm.V5E))
PORT_FIELDS = [f.name for f in dataclasses.fields(ModelConfig)]


def _same(a, b) -> bool:
    """Equality that takes nan == nan (Summary's telemetry fields)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_registry_holds_the_reference_slot_families():
    """Since the static-batch API the registry is the reference's whole:
    the 11 slot-family configs and the three that only it serves."""
    ref = jconfigs.REGISTRY
    slot = {n for n, c in ref.items() if c.family in ("dense", "moe", "vlm")}
    assert len(slot) == 11 and set(ref) - slot == set(STATIC_ONLY)
    assert set(configs.REGISTRY) == set(ref) and len(ref) == 14
    assert not hasattr(configs, "UNPORTED")
    assert set(configs.ASSIGNED) == set(jconfigs.ASSIGNED)
    assert set(configs.PAPER) == set(jconfigs.PAPER)
    for assigned_only in (True, False):
        assert configs.list_archs(assigned_only) == \
            jconfigs.list_archs(assigned_only)


@pytest.mark.parametrize("name", NAMES)
def test_config_fields_equal_reference(name):
    """Every field of the port's config equals the reference's, and the
    port has every field the reference has."""
    got, want = configs.get_config(name), jconfigs.get_config(name)
    assert PORT_FIELDS == [f.name for f in dataclasses.fields(want)]
    assert {f: getattr(got, f) for f in PORT_FIELDS} == \
        {f: getattr(want, f) for f in PORT_FIELDS}
    assert bridge.config_from(want) == got


def _accounting(c):
    attn_only = dataclasses.replace(c, lora_targets=("q", "k", "v", "o"))
    return dict(
        params=c.param_count(), active=c.active_param_count(),
        bytes={r: c.lora_adapter_bytes(r) for r in (None, 8, 32, 64)},
        f32=c.lora_adapter_bytes(8, "float32"),
        attn_only=attn_only.lora_adapter_bytes(32),
        gelu=dataclasses.replace(c, gated_mlp=False).param_count())


@pytest.mark.parametrize("name", NAMES)
def test_accounting_equals_reference(name):
    got = configs.get_config(name)
    want = jconfigs.get_config(name)
    assert _accounting(got) == _accounting(want)
    assert _accounting(got.reduced()) == _accounting(want.reduced())


@pytest.mark.parametrize("name", NAMES)
def test_reduced_equals_reference(name):
    got, want = configs.get_config(name).reduced(), \
        jconfigs.get_config(name).reduced()
    assert {f: getattr(got, f) for f in PORT_FIELDS} == \
        {f: getattr(want, f) for f in PORT_FIELDS}
    assert got.frontend_tokens == (8 if got.frontend else 0)


@pytest.mark.parametrize("name", STATIC_ONLY)
def test_static_only_families_resolve_as_reference(name):
    """rwkv6-3b (ssm), zamba2-2.7b (hybrid) and seamless-m4t-large-v2
    (audio): ``get_config`` resolves each; ``param_count``,
    ``active_param_count``, ``lora_adapter_bytes`` and ``reduced()`` (its
    ssm, hybrid and encoder rules) equal the reference's; the properties
    the families read too."""
    got, want = configs.get_config(name), jconfigs.get_config(name)
    for c, j in ((got, want), (got.reduced(), want.reduced())):
        assert dataclasses.asdict(c) == dataclasses.asdict(j)
        assert c.param_count() == j.param_count()
        assert c.active_param_count() == j.active_param_count()
        for rank in (None, 8, 32):
            assert c.lora_adapter_bytes(rank) == j.lora_adapter_bytes(rank)
        for prop in ("is_ssm", "is_encdec", "attention_free",
                     "sub_quadratic", "d_inner"):
            assert getattr(c, prop) == getattr(j, prop), prop


def test_cluster_comparison_equals_reference():
    """``--cluster --arch mixtral-8x7b``: S-LoRA vs InfiniLoRA on the
    analytic plane, the reference's launcher's presets and workload,
    priced on the reference's machine."""
    cfg, ref = configs.get_config("mixtral-8x7b"), \
        jconfigs.get_config("mixtral-8x7b")
    n_adapters, rate, duration, gpus = 8, 10.0, 12.0, 8
    got = tserve.compare_planes(cfg, n_adapters, rate, duration, gpus,
                                hw=REF_HW)
    reqs = jworkload.generate(n_adapters, rate=rate, duration=duration,
                              seed=0)
    planes = {"s-lora": jslora.slora_config(ref, 4, gpus, n_adapters,
                                            duration),
              "infinilora": jslora.infinilora_config(
                  ref, 3, gpus, gpus, n_adapters, duration)}
    for name, sim in planes.items():
        system = japi.build_system(japi.ServeConfig.from_sim(sim), ref)
        system.submit_workload(reqs)
        system.drain()
        want = dataclasses.asdict(system.summary(duration=duration))
        assert _same(got[name], want), name
        assert want["n_finished"] > 0


def _sim_summaries(name, disagg, n_adapters, duration, seed):
    """The port's and the reference's front door on the analytic plane
    (the port on the reference's Hardware): each one's events and
    Summary."""
    cfg, ref = configs.get_config(name), jconfigs.get_config(name)
    kw = dict(backend="sim", disaggregated=disagg,
              n_instances=3 if disagg else 4, max_batch=64,
              adapter_cache_slots=16, n_adapters=n_adapters,
              duration=duration, server_gpus=8)
    reqs = jworkload.generate(n_adapters, rate=8, duration=duration,
                              seed=seed)
    out = []
    for system, rs in ((build_system(ServeConfig(hw=REF_HW, **kw), cfg),
                        [Request(**dataclasses.asdict(r)) for r in reqs]),
                       (japi.build_system(japi.ServeConfig(**kw), ref),
                        reqs)):
        handles = system.submit_workload(rs)
        system.drain()
        out.append(([[(e.time, e.rid, e.kind) for e in h.events]
                     for h in handles],
                    dataclasses.asdict(system.summary(duration=duration))))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_sim_backend_prices_every_config_as_reference(name):
    """Each registered config on the analytic plane, coupled: the events
    and Summary of the reference's."""
    (ev, got), (jev, want) = _sim_summaries(name, False, 16, 6.0, 4)
    assert ev == jev and _same(got, want) and got["n_finished"] > 0


def test_serve_cli_cluster_on_mixtral(capsys):
    """``launch/serve.py --cluster --arch mixtral-8x7b``, the reference's
    documented invocation, on the nominal H100."""
    assert tserve.main(["--cluster", "--arch", "mixtral-8x7b",
                        "--duration", "6", "--rate", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("s-lora") and out[1].startswith("infinilora")
    assert all("(analytic, H100 nominal)" in ln for ln in out[:2])


@pytest.mark.parametrize("disagg", [False, True], ids=["coupled", "disagg"])
def test_sim_backend_prices_qwen2_72b_as_reference(disagg):
    """The front door's analytic plane on a dense config, both planes: the
    same events and Summary as the reference's."""
    (ev, got), (jev, want) = _sim_summaries("qwen2-72b", disagg, 32, 20.0,
                                            3)
    assert ev == jev
    assert _same(got, want)
    assert got["n_finished"] > 0

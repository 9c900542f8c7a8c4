"""The port's config registry against the JAX reference's, on the CPU:

  - the registry holds every dense, moe and vlm config of the reference
    (``ASSIGNED``, ``PAPER``, ``list_archs``), field for field, and the
    fields the port leaves out sit at the reference's defaults
  - ``param_count``, ``active_param_count``, ``lora_adapter_bytes`` (ranks
    8, 32, 64, the config's own, float32, an attention-only target set, a
    GELU MLP) and ``reduced()`` equal the reference's
  - the ssm, hybrid and audio configs are refused naming ROADMAP A7d
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
UNPORTED = sorted(configs.UNPORTED)
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
    ref = jconfigs.REGISTRY
    slot = {n for n, c in ref.items() if c.family in ("dense", "moe", "vlm")}
    assert set(configs.REGISTRY) == slot and len(slot) == 11
    assert set(configs.UNPORTED) == set(ref) - slot
    assert {n: ref[n].family for n in configs.UNPORTED} == configs.UNPORTED
    assert set(configs.ASSIGNED) == set(jconfigs.ASSIGNED) & slot
    assert set(configs.PAPER) == set(jconfigs.PAPER)
    for assigned_only in (True, False):
        assert configs.list_archs(assigned_only) == [
            n for n in jconfigs.list_archs(assigned_only) if n in slot]


@pytest.mark.parametrize("name", NAMES)
def test_config_fields_equal_reference(name):
    """Every field of the port's config equals the reference's; every
    field the port leaves out (ssm, hybrid, encoder) is at the reference's
    default, so the port drops nothing the config sets."""
    got, want = configs.get_config(name), jconfigs.get_config(name)
    assert {f: getattr(got, f) for f in PORT_FIELDS} == \
        {f: getattr(want, f) for f in PORT_FIELDS}
    assert bridge.config_from(want) == got
    for f in dataclasses.fields(want):
        if f.name not in PORT_FIELDS:
            assert getattr(want, f.name) == f.default, f.name


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


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_families_raise_naming_a7d(name):
    with pytest.raises(KeyError, match="A7d"):
        configs.get_config(name)
    cfg = bridge.config_from(jconfigs.get_config(name))
    with pytest.raises(ValueError, match="A7d"):
        cfg.param_count()


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

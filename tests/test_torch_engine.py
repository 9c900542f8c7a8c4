"""End-to-end parity of the port's paged slot engine with the JAX
reference's ``Engine(paged=True)`` + LoRAServer on the host transport, and
the port's package hygiene: it imports no JAX and nothing of ``repro``, and
its entry points run on the card unless the caller names the CPU."""
import dataclasses
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import adapter as jadapter
from repro.core import lora_server as jls
from repro.models import model as jmodel
from repro.serving import engine as jengine
from repro_torch import bridge
from repro_torch.core import lora_server as tls
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.serving import engine as tengine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

# (rid, prompt length, adapter, admitted after this many decode steps)
REQUESTS = [(0, 7, 0, 0), (1, 5, 1, 0), (2, 9, 2, 0), (3, 6, 3, 2)]
NEW_TOKENS = 5
ENGINE = dict(max_len=32, n_slots=4, page_size=4, prefill_chunk=8)


def _drive(engine, prompts):
    """Admit REQUESTS in waves, decode NEW_TOKENS each, evict when done."""
    out = {rid: [] for rid, *_ in REQUESTS}
    step = 0
    while any(len(v) < NEW_TOKENS for v in out.values()):
        for rid, _, aid, at in REQUESTS:
            if at == step:
                engine.add_request(rid, prompts[rid], aid)
        for rid, t in engine.step().items():
            out[rid].append(int(t))
            if len(out[rid]) == NEW_TOKENS:
                engine.evict_request(rid)
        step += 1
    return out


@pytest.fixture(scope="module")
def reference_run():
    """One JAX reference run shared by the file (jit is the cost)."""
    jcfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                               lora_targets=("gate", "up", "down"),
                               lora_rank=8)
    key = jax.random.PRNGKey(0)
    params = jmodel.init_params(jcfg, key, dtype="float32")
    pool = jadapter.init_mixed_rank_pool(jcfg, [2, 8, 4, 8],
                                         jax.random.fold_in(key, 1),
                                         dtype=jnp.float32)
    rng = np.random.default_rng(0)
    prompts = {rid: rng.integers(0, jcfg.vocab_size, n).tolist()
               for rid, n, _, _ in REQUESTS}
    server = jls.LoRAServer(jcfg, jls.ServerConfig(m=1, x=1, y=1,
                                                   cache_slots=4, rank=8),
                            dtype=jnp.float32)
    for aid in range(pool.n):
        server.insert(aid, jls.pool_tensors_from_adapter(pool, aid),
                      rank=pool.rank_of(aid))
    engine = jengine.Engine(jcfg, params,
                            jengine.EngineConfig(paged=True, **ENGINE),
                            pool=pool, server=server, transport="host")
    tokens = _drive(engine, prompts)
    return jcfg, params, pool, prompts, tokens, engine.kv_stats()


def test_engine_tokens_match_reference(reference_run):
    """Greedy tokens of every request equal the reference's, with the last
    request admitted into a running batch, mixed adapter ranks, and pages
    allocated on demand and returned at eviction."""
    jcfg, params, pool, prompts, want, jstats = reference_run
    tcfg = bridge.config_from(jcfg)
    tparams = bridge.tree_to_tensors(jax.tree_util.tree_map(np.asarray,
                                                            params))
    tpool = bridge.adapter_pool(
        tcfg, jax.tree_util.tree_map(np.asarray, pool.tensors), pool.rank,
        pool.scale, pool.ranks)
    server = tls.LoRAServer(tcfg, tls.ServerConfig(m=1, x=1, y=1,
                                                   cache_slots=4, rank=8),
                            dtype=torch.float32, device="cpu")
    for aid in range(tpool.n):
        server.insert(aid, tls.pool_tensors_from_adapter(tpool, aid),
                      rank=tpool.rank_of(aid))
    engine = tengine.Engine(tcfg, tparams, tengine.EngineConfig(**ENGINE),
                            server, lora_scale=tpool.scale, device="cpu")
    got = _drive(engine, prompts)
    assert got == want
    stats = engine.kv_stats()
    for key in ("n_pages", "pages_in_use", "peak_pages", "pool_bytes",
                "slots_in_use", "dense_slab_bytes"):
        assert stats[key] == jstats[key], key
    assert stats["pages_in_use"] == 0 and stats["peak_pages"] > 0


def test_serve_entry_point_runs_on_cpu_when_asked(capsys):
    assert tserve.main(["--reduced", "--layers", "1", "--requests", "3",
                        "--device", "cpu"]) == 0
    assert "generated:" in capsys.readouterr().out


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    """Without a card, the default device raises a clear error; an
    explicit device="cpu" runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(bridge.config_from(
        get_config("qwen3-moe-235b-a22b").reduced()), n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmodel.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--reduced", "--layers", "1"])
    params = tmodel.init_params(cfg, device="cpu")
    server = tls.LoRAServer(cfg, tls.ServerConfig(1, 1, 1, 1, 8),
                            device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tls.LoRAServer(cfg, tls.ServerConfig(1, 1, 1, 1, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tengine.Engine(cfg, params, tengine.EngineConfig(), server)
    engine = tengine.Engine(cfg, params, tengine.EngineConfig(), server,
                            device="cpu")
    assert engine.device.type == "cpu"


def test_port_imports_without_jax():
    """Every module of the port imports with JAX, and ``ml_dtypes`` (which
    comes with JAX), made unimportable."""
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib; sys.modules['jax'] = None\n"
            "sys.modules['ml_dtypes'] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules), 'the port imported the JAX package'\n"
            "assert sys.modules['ml_dtypes'] is None\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(mods) >= 15


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro|ml_dtypes)\b"
    r"|from\s+(jax|repro|ml_dtypes)(\.|\s+import\b))",
    re.MULTILINE)


def test_port_sources_name_no_jax_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [str(f.relative_to(ROOT)) for f in files
           if _FORBIDDEN.search(f.read_text())]
    assert not bad, f"port files importing jax, ml_dtypes or repro.*: {bad}"

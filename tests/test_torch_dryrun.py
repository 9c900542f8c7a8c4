"""The port's dry run (``repro_torch.launch.dryrun``) and the kernels'
routing it rests on:

  - ``kernels.ops`` sends a CUDA operand to the hand-written kernel's
    wrapper and never to its plain twin (CUDA-typed fake tensors, the
    wrappers and twins replaced by recorders), a meta operand to the twin's
    shape arithmetic and never to a wrapper, and reports every call to an
    active counter
  - the CLI in a subprocess (a fake world of 8 ranks over the (2, 4) debug
    mesh, reduced configs, at the four shapes): OK records for train,
    prefill and decode with their roofline and analytic memory, SKIP from
    ``configs.applicable`` for long_500k on a full-attention config, the
    disaggregated split (``compile_disagg``), the report's table and
    ``reanalyze``; nothing is written outside ``--out`` (not under
    experiments/ of the checkout, whose ``dryrun/`` the reference's test
    reads)
  - ``fake_world`` leaves no process group behind
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis.counter import count
from repro_torch.configs import get_config, get_shape
from repro_torch.kernels import bgmv as kbgmv, fused as kfused, gmm as kgmm
from repro_torch.kernels import ops, paged as kpaged, ref, sgmv as ksgmv
from repro_torch.launch import dryrun

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-moe-235b-a22b"

WRAPPERS = [(kpaged, "paged_attention"), (kbgmv, "bgmv"),
            (kbgmv, "bgmv_ranked"), (kbgmv, "bgmv_expert"),
            (ksgmv, "sgmv"), (ksgmv, "sgmv_ranked"),
            (ksgmv, "sgmv_rank_grouped"), (kfused, "fused_sgmv"),
            (kfused, "fused_sgmv_ranked"), (kgmm, "gmm")]
TWINS = [n for n in dir(ref) if n.endswith("_ref")]


def _calls(dev):
    """One call of every op of ``kernels.ops`` on ``dev`` tensors."""
    bf, i32 = torch.bfloat16, torch.int32

    def t(*shape, dtype=bf):
        return torch.zeros(shape, dtype=dtype, device=dev)

    x, ids = t(6, 8), t(6, dtype=i32)
    seg = t(3, 2, 8)
    return {
        "paged_attention": lambda: ops.paged_attention(
            t(2, 2, 2, 8), t(5, 4, 2, 8), t(5, 4, 2, 8), t(2, 2, dtype=i32),
            t(2, dtype=i32)),
        "bgmv": lambda: ops.bgmv(x, t(2, 8, 4), t(2, 4, 8), ids),
        "bgmv_ranked": lambda: ops.bgmv_ranked(x, t(2, 8, 4), t(2, 4, 8),
                                               ids, t(2, dtype=i32)),
        "bgmv_expert": lambda: ops.bgmv_expert(
            x, t(2, 3, 8, 4), t(2, 3, 4, 8), ids, ids, ids, 4),
        "sgmv": lambda: ops.sgmv(seg, t(3, dtype=i32), t(2, 8, 4),
                                 t(2, 4, 8)),
        "sgmv_ranked": lambda: ops.sgmv_ranked(
            seg, t(3, dtype=i32), t(3, dtype=i32), t(2, 8, 4), t(2, 4, 8)),
        "sgmv_rank_grouped": lambda: ops.sgmv_rank_grouped(
            seg, t(3, dtype=i32), t(3, dtype=i32), t(2, 8, 4), t(2, 4, 8)),
        "fused_sgmv": lambda: ops.fused_sgmv(
            seg, t(3, dtype=i32), t(3, dtype=i32), t(2, 3, 8, 4),
            t(2, 3, 4, 8)),
        "fused_sgmv_ranked": lambda: ops.fused_sgmv_ranked(
            seg, t(3, dtype=i32), t(3, dtype=i32), t(3, dtype=i32),
            t(2, 3, 8, 4), t(2, 3, 4, 8)),
        "gmm": lambda: ops.gmm(t(3, 4, 8), t(3, 8, 16), t(3, dtype=i32)),
    }


def test_cuda_operands_never_reach_a_twin(monkeypatch):
    seen = []
    for mod, name in WRAPPERS:
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                            seen.append(_n) or "kernel")
    for name in TWINS:
        def twin(*a, _n=name, **k):
            raise AssertionError(f"{_n} reached with a CUDA operand")
        monkeypatch.setattr(ref, name, twin)
    with FakeTensorMode(allow_non_fake_inputs=True):
        calls = _calls("cuda")
        for name, call in calls.items():
            assert call() == "kernel", name
    assert seen == list(calls)


def test_meta_operands_take_the_twins_shapes_and_report(monkeypatch):
    for mod, name in WRAPPERS:
        def kernel(*a, _n=name, **k):
            raise AssertionError(f"{_n}: a meta operand reached the kernel")
        monkeypatch.setattr(mod, name, kernel)
    want = {"paged_attention": (2, 2, 2, 8), "bgmv": (6, 8),
            "bgmv_ranked": (6, 8), "bgmv_expert": (6, 8),
            "sgmv": (3, 2, 8), "sgmv_ranked": (3, 2, 8),
            "sgmv_rank_grouped": (3, 2, 8), "fused_sgmv": (3, 2, 8),
            "fused_sgmv_ranked": (3, 2, 8), "gmm": (3, 4, 16)}
    with count() as c:
        for name, call in _calls("meta").items():
            out = call()
            assert out.device.type == "meta" and out.dtype == torch.float32
            assert tuple(out.shape) == want[name], name
    assert {n: r["calls"] for n, r in c.kernels.items()} == \
        {n: 1 for n in want}
    assert c.summary()["form"] == "shape"
    assert not ops.COUNTERS


def test_fake_world_leaves_no_group():
    with dryrun.fake_world(8, rank=3):
        assert dist.get_world_size() == 8 and dist.get_rank() == 3
        mesh = dryrun.mesh_of("debug")
        assert mesh.shape == {"data": 2, "model": 4} and mesh.rank == 3
    assert not dist.is_initialized()


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=240)


def test_dryrun_cli_debug_mesh(tmp_path):
    out = tmp_path / "records"
    before = sorted((ROOT / "experiments").glob("**/*")) \
        if (ROOT / "experiments").exists() else []
    p = _run(["repro_torch.launch.dryrun", "--arch", ARCH, "--mesh",
              "debug", "--reduced", "--out", str(out)], tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    recs = {f.name.split("__")[1]: json.loads(f.read_text())
            for f in out.glob("*.json")}
    assert sorted(recs) == ["decode_32k", "long_500k", "prefill_32k",
                            "train_4k"]
    assert recs["long_500k"]["status"] == "SKIP"
    assert "full-attention" in recs["long_500k"]["reason"]
    cfg = get_config(ARCH).reduced()
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        rec = recs[name]
        assert rec["status"] == "OK", rec
        r, m = rec["roofline"], rec["memory"]
        assert r["chips"] == 8 and r["mesh"] == "debug"
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert r["bottleneck"] in ("compute", "memory", "collective")
        assert 0 < r["roofline_fraction"] <= 1
        assert m["fits_80g"] is True
        assert m["analytic"]["params"] > 0
        assert rec["counted"]["kernels"]["gmm"]["calls"] >= cfg.n_layers
        shape = get_shape(name)
        if shape.kind == "decode":     # this rank's rows, the padded vocab
            assert rec["output_shape"] == [shape.global_batch // 2,
                                           cfg.padded_vocab]
    # the train step's collectives: the MoE's all-to-alls over the ranks
    assert recs["train_4k"]["roofline"]["coll_breakdown"]["all-to-all"] > 0
    # a second run keeps the cached records
    p = _run(["repro_torch.launch.dryrun", "--arch", ARCH, "--mesh",
              "debug", "--reduced", "--shape", "decode_32k", "--out",
              str(out)], tmp_path)
    assert "cached OK" in p.stdout

    p = _run(["repro_torch.launch.dryrun", "--disagg", "--arch", ARCH,
              "--mesh", "debug", "--reduced", "--out", str(out)], tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    split = json.loads((out / f"{ARCH}__decode_32k__debug__disagg.json")
                       .read_text())
    assert split["status"] == "OK"
    assert split["instance_mesh"] == "1x4" and split["server_mesh"] == "2x1"
    for part in ("instance", "server_up", "server_down"):
        assert split[part]["flops_per_device"] > 0
    assert split["transfer_bytes_per_layer"] == 1024 * (cfg.d_model
                                                        + cfg.d_ff) * 2

    p = _run(["repro_torch.analysis.report", "--mesh", "debug", "--out",
              str(out)], tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [ln for ln in p.stdout.splitlines() if ln.startswith(f"| {ARCH}")]
    assert any("| train_4k |" in ln and "| Y |" in ln for ln in rows)
    assert any("| long_500k |" in ln and "SKIP" in ln for ln in rows)
    assert any("| server_up |" in ln for ln in rows)
    p = _run(["repro_torch.analysis.reanalyze", "--out", str(out)], tmp_path)
    assert p.returncode == 0 and p.stdout.count("frac=") == 3

    after = sorted((ROOT / "experiments").glob("**/*")) \
        if (ROOT / "experiments").exists() else []
    assert after == before
    assert sorted(f.name for f in tmp_path.iterdir()) == ["records"]

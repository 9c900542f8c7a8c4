"""The port's examples (``repro_torch.examples``) on the CPU at the
reduced size, each through its command line, with its invariant lines:

  - ``serve_disaggregated``: the coupled and the disaggregated plane
    (a 2-replica LoRA-Server pool) serve the same tokens under mid-decode
    admission ("tokens identical across architectures: True"), a
    cancellation gives back its slots, and the analytic plane's S-LoRA vs
    InfiniLoRA table is printed;
  - ``train_lora``: each tenant's loss is printed a step and adapter 1
    improves tenant 1's loss over the base model;
  - ``provision_capacity``: the re-provisioner grows for the larger pool
    and shrinks for the hot one.
"""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
    return p.stdout


def test_serve_disaggregated():
    out = _run("repro_torch.examples.serve_disaggregated", "--device", "cpu")
    lines = out.splitlines()
    assert "tokens identical across architectures: True" in lines
    assert re.search(r"rid=0 cancelled after 2/7 tokens \[cancelled\]", out)
    assert "slots in use after drain: [0, 0]" in out
    rows = [ln for ln in lines if ln.startswith("rate=")]
    assert len(rows) == 3 and all("s-lora:" in r and "infinilora:" in r
                                  for r in rows)
    assert "modelled, not measured" in out
    assert len(re.findall(r"rid=\d adapter=\d arrival=\d: \[", out)) == 5


def test_train_lora():
    out = _run("repro_torch.examples.train_lora", "--device", "cpu",
               "--steps", "12")
    losses = {t: [float(x) for x in re.findall(
        rf"tenant {t} step +\d+ loss ([\d.]+)", out)] for t in (1, 2)}
    assert all(len(v) == 3 for v in losses.values())
    assert all(v[-1] < v[0] for v in losses.values())
    assert "adapter 1 improves tenant 1: True" in out.splitlines()


def test_provision_capacity():
    out = _run("repro_torch.examples.provision_capacity")
    assert len(re.findall(r"zipf s=[\d.]+: M\* = +\d+ adapters", out)) == 3
    assert "grows for the larger pool: True; shrinks for the hot one: True" \
        in out

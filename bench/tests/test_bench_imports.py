"""Nothing the benchmark loads is the JAX stack or the JAX package
(compared by whole top-level names: ``repro_torch`` is not ``repro``),
and the plain reference loads nothing of the program. Each check runs in
a fresh interpreter, since the test process may hold JAX itself."""
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_modules(code: str):
    prog = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=240, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_program():
    mods = _top_modules("from bench import correct, reference, flops, "
                        "workload")
    assert not mods & FORBIDDEN
    assert "repro_torch" not in mods


def test_a_whole_run_loads_no_jax():
    """A small run through the program on the CPU, then the harness's own
    look at ``sys.modules``."""
    code = """
import time, torch
torch.set_num_threads(2)
from bench import harness
over = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
            d_ff=16, vocab_size=256, n_experts=4, top_k=2, dtype="float32")
sp = {"count": 16, "prompt": {"median": 12, "sigma": 0.5, "min": 4,
      "max": 24}, "output": {"median": 8, "sigma": 0.5, "min": 4, "max": 16},
      "serve": {"slots": 4, "max_len": 64, "page_size": 8,
                "prefill_chunk": 8, "warm_buckets": [4], "warm_prompt": 5}}
out = harness.run("mixtral.decode.backlog", 3, 0.5, False, time.perf_counter(),
                  device="cpu", override=over, spec_override=sp)
assert out["run"].rounds
assert harness.forbidden_modules() == [], harness.forbidden_modules()
"""
    mods = _top_modules(code)
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN

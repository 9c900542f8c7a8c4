"""The port's static checker (``repro_torch.staticcheck``): each of the
seven rules flags a seeded fault and passes its blessed pattern (small
trees written under a temporary root with the port's layout), inline
suppressions and the baseline round trip, the CLI's exit codes, the
shipped port tree (``src/repro_torch`` and ``chip_smoke.py``) is clean,
and the package imports with neither torch nor jax importable."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch.staticcheck import ALL_RULES, get_rules, run_paths
from repro_torch.staticcheck.engine import load_baseline, load_modules, \
    run_modules, split_suppressed, write_baseline

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tree(root: pathlib.Path, files: dict) -> None:
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))


def _check(root, files, rule, paths=("src",)):
    _tree(root, files)
    rep = run_paths([str(root / p) for p in paths], root=root,
                    rules=get_rules({rule}))
    return [f for f in rep.findings if f.rule == rule]


# ------------------------------ SC001 ------------------------------------ #
def test_sc001_flags_a_collective_on_the_serving_plane(tmp_path):
    got = _check(tmp_path, {"src/repro_torch/models/moe.py": """
        import torch.distributed as dist
        from repro_torch.distributed import collectives as col

        def expert_gmm(x, blocks):
            return _blocks(x, blocks)

        def _blocks(x, blocks):
            y = x @ blocks
            dist.all_reduce(y)
            return y

        def _moe_sharded(x, group):
            return col.all_to_all(x, group, 0, 1)
        """, "src/repro_torch/transport/host.py": """
        from repro_torch.distributed import collectives as col
        def step(x, g):
            return col.psum(x, g)
        """}, "SC001")
    assert sorted((f.path, f.line) for f in got) == [
        ("src/repro_torch/models/moe.py", 10),
        ("src/repro_torch/transport/host.py", 4)]


def test_sc001_passes_the_pure_map_and_the_spmd_bodies(tmp_path):
    assert not _check(tmp_path, {"src/repro_torch/models/moe.py": """
        from repro_torch.distributed import collectives as col

        def expert_gmm(x, blocks):
            return [b(x.to(b.device)) for b in blocks]

        def _moe_sharded(x, group):
            return col.all_to_all(x, group, 0, 1)
        """, "src/repro_torch/distributed/steps.py": """
        import torch.distributed as dist
        def sum_grads(g):
            dist.all_reduce(g)
        """}, "SC001")


# ------------------------- SC002 and SC006 -------------------------------- #
CAPTURE = {
    "src/repro_torch/transport/fused.py": """
        import torch
        from repro_torch.transport.base import decode_tokens

        class View:
            def compute(self, rows, ids):
                return rows * ids.max()

        def capture(graph, args):
            def run():
                return decode_tokens(**args)
            with torch.cuda.graph(graph):
                out = run()
            return out
        """,
    "src/repro_torch/transport/base.py": """
        import torch
        from repro_torch.models import layers

        def decode_tokens(x, pos):
            return layers.attend(x, pos)
        """,
}


def test_sc002_flags_host_syncs_a_capture_reaches(tmp_path):
    files = dict(CAPTURE)
    files["src/repro_torch/models/layers.py"] = """
        import numpy as np

        def attend(x, pos):
            n = int(pos.max())
            return _write(x, pos) + n

        def _write(x, pos):
            return x[pos.tolist()]

        def eager_only(x):
            return x.item()
        """
    got = _check(tmp_path, files, "SC002")
    assert sorted((f.path.split("/")[-1], f.line) for f in got) == [
        ("layers.py", 5), ("layers.py", 9)]
    assert all("capture" in f.message for f in got)


def test_sc002_passes_device_only_code(tmp_path):
    files = dict(CAPTURE)
    files["src/repro_torch/models/layers.py"] = """
        import math
        import torch

        def attend(x, pos):
            scale = int(math.prod((2, 3)))
            return torch.where(pos[:, None] >= 0, x * scale, 0.0)
        """
    assert not _check(tmp_path, files, "SC002")


def test_sc006_flags_host_tensors_a_capture_reaches(tmp_path):
    files = dict(CAPTURE)
    files["src/repro_torch/models/layers.py"] = """
        import torch

        def attend(x, pos):
            table = torch.as_tensor([1.0, 2.0], device=x.device)
            return x * table + torch.tensor(3.0).cuda()

        def host_side(a):
            return torch.as_tensor(a)
        """
    got = _check(tmp_path, files, "SC006")
    assert sorted((f.line, f.message.split("'")[1]) for f in got) == [
        (5, "torch.as_tensor"), (6, ".cuda()"), (6, "torch.tensor")]


def test_sc006_passes_inputs_loaded_before_the_replay(tmp_path):
    files = dict(CAPTURE)
    files["src/repro_torch/models/layers.py"] = """
        def attend(x, pos):
            return x[pos.clamp(min=0)]
        """
    files["src/repro_torch/transport/load.py"] = """
        import torch
        def load(buf, host):
            buf.copy_(torch.as_tensor(host), non_blocking=True)
        """
    assert not _check(tmp_path, files, "SC006")


# ------------------------------ SC003 ------------------------------------ #
def test_sc003_flags_captures_in_a_loop_and_unhashable_keys(tmp_path):
    got = _check(tmp_path, {"src/repro_torch/serving/eng.py": """
        import torch

        def serve(steps, fn):
            for s in steps:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    fn(s)
                g.replay()

        class T:
            def store(self, shape, g):
                self._graphs[[shape, 1]] = g
        """}, "SC003")
    assert sorted(f.line for f in got) == [6, 7, 13]


def test_sc003_passes_a_keyed_cache(tmp_path):
    assert not _check(tmp_path, {"src/repro_torch/serving/eng.py": """
        import torch

        class T:
            def serve(self, steps, fn):
                for s in steps:
                    key = (s.shape, s.layout)
                    g = self._graphs.get(key)
                    if g is None:
                        g = torch.cuda.CUDAGraph()
                        self._graphs[key] = g
                    g.replay()
        """}, "SC003")


# ------------------------------ SC004 ------------------------------------ #
KERNEL = """
    from repro_torch.kernels import build

    def _lib():
        return build.load("foo")

    def foo(x):
        return _lib().foo_launch(x)

    def plan(n):
        return n // 2
    """


def test_sc004_flags_a_kernel_without_twin_test_or_source(tmp_path):
    got = _check(tmp_path, {
        "src/repro_torch/kernels/foo.py": KERNEL,
        "src/repro_torch/kernels/ref.py": "def bar_ref(x):\n    return x\n",
        "src/repro_torch/kernels/ops.py": """
            from repro_torch.kernels import ref
            def foo(x):
                return ref.baz_ref(x)
            """,
        "tests/test_torch_other.py": "def test_x():\n    pass\n"}, "SC004")
    msgs = sorted(f.message for f in got)
    assert len(msgs) == 4
    assert any("csrc/foo.cu" in m for m in msgs)
    assert any("'foo_ref'" in m for m in msgs)
    assert any("no parity test" in m for m in msgs)
    assert any("'ref.baz_ref'" in m for m in msgs)


def test_sc004_passes_a_twinned_tested_kernel(tmp_path):
    assert not _check(tmp_path, {
        "src/repro_torch/kernels/foo.py": KERNEL,
        "src/repro_torch/csrc/foo.cu": "// kernel\n",
        "src/repro_torch/kernels/ref.py": "def foo_ref(x):\n    return x\n",
        "src/repro_torch/kernels/ops.py": """
            from repro_torch.kernels import ref
            def foo(x):
                return ref.foo_ref(x)
            """,
        "tests/test_torch_foo.py": "def test_foo():\n    foo = 1\n"},
        "SC004")


# ------------------------------ SC005 ------------------------------------ #
def test_sc005_flags_reads_of_retired_aliases(tmp_path):
    got = _check(tmp_path, {"src/repro_torch/training/loop.py": """
        from repro_torch.distributed import steps

        def step(params, grads, opt, cfg):
            wq = params["layers"]["wq"]
            steps.adamw_(params, grads, opt, cfg)
            return wq.sum()

        def decode(st):
            toks = st.tokens
            st.graph.replay()
            return toks
        """}, "SC005")
    assert sorted(f.line for f in got) == [7, 12]


def test_sc005_passes_a_copy_or_a_fresh_read(tmp_path):
    assert not _check(tmp_path, {"src/repro_torch/training/loop.py": """
        from repro_torch.distributed import steps

        def step(params, grads, opt, cfg):
            before = params["layers"]["wq"].clone()
            steps.adamw_(params, grads, opt, cfg)
            return before - params["layers"]["wq"]

        def decode(st):
            st.graph.replay()
            toks = st.tokens
            st.graph.replay()
            toks = st.tokens
            return toks
        """}, "SC005")


# ------------------------------ SC007 ------------------------------------ #
def test_sc007_flags_raw_timing_outside_obs(tmp_path):
    got = _check(tmp_path, {
        "src/repro_torch/serving/x.py": """
            import time
            def f():
                return time.perf_counter()
            """,
        "src/repro_torch/obs/clock.py": """
            import time
            def wall_time():
                return time.perf_counter()
            """}, "SC007")
    assert [(f.path, f.line) for f in got] == [
        ("src/repro_torch/serving/x.py", 4)]


# --------------------- suppressions, baseline, CLI ----------------------- #
SEEDED = {"src/repro_torch/serving/x.py": """
    import time
    def f():
        a = time.perf_counter()
        # staticcheck: disable=SC007 (the seed's blessed line)
        b = time.perf_counter()
        return a, b, time.time()  # staticcheck: disable=SC007 (inline)
    """}


def test_suppressions_and_baseline_round_trip(tmp_path):
    _tree(tmp_path, SEEDED)
    ctx = load_modules([str(tmp_path / "src")], root=tmp_path)
    kept, n_sup = split_suppressed(ctx, run_modules(ctx))
    assert n_sup == 2 and [f.line for f in kept] == [4]
    base = tmp_path / "base.json"
    write_baseline(base, kept)
    assert load_baseline(base) == {f.fingerprint(): 1 for f in kept}
    rep = run_paths([str(tmp_path / "src")], root=tmp_path, baseline=base)
    assert rep.ok and len(rep.baselined) == 1 and rep.suppressed_count == 2
    # one more of the same finding is new
    p = tmp_path / "src/repro_torch/serving/x.py"
    p.write_text(p.read_text() + "\ndef g():\n    return time.time()\n")
    rep = run_paths([str(tmp_path / "src")], root=tmp_path, baseline=base)
    assert not rep.ok and len(rep.findings) == 1


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.staticcheck",
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_cli_exit_codes(tmp_path):
    _tree(tmp_path, SEEDED)
    p = _cli("src", cwd=tmp_path)
    assert p.returncode == 1 and "SC007" in p.stdout
    p = _cli("src", "--json", cwd=tmp_path)
    rep = json.loads(p.stdout)
    assert p.returncode == 1 and not rep["ok"]
    assert len(rep["new_findings"]) == 1
    p = _cli("src", "--write-baseline", "staticcheck.baseline.json",
             cwd=tmp_path)
    assert p.returncode == 0
    assert _cli("src", cwd=tmp_path).returncode == 0   # auto-loaded
    assert _cli("no/such/path", cwd=tmp_path).returncode == 2
    assert _cli("src", "--select", "SC999", cwd=tmp_path).returncode == 2
    assert _cli("src", "--select", "SC001", cwd=tmp_path).returncode == 0
    p = _cli("--list-rules", cwd=tmp_path)
    assert p.returncode == 0 and len(p.stdout.splitlines()) == 7


def test_shipped_port_tree_is_clean():
    p = _cli("src/repro_torch", "chip_smoke.py", cwd=ROOT)
    assert p.returncode == 0, p.stdout[-3000:]
    assert "0 new finding(s)" in p.stdout


def test_rules_are_the_seven_with_their_docs():
    assert [r.rule_id for r in ALL_RULES] == [f"SC00{i}"
                                             for i in range(1, 8)]
    for cls in ALL_RULES:
        doc = sys.modules[cls.__module__].__doc__
        assert doc.startswith(cls.rule_id) and "test" in doc


def test_imports_without_torch_or_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules['torch'] = None
        sys.modules['jax'] = None
        import repro_torch.staticcheck as sc
        rep = sc.run_paths(['src/repro_torch/staticcheck'])
        assert rep.checked_files > 10, rep
        print('ok', len(sc.ALL_RULES))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.split() == ["ok", "7"], p.stderr

"""SC004 kernel-twin-discipline (the counterpart of the reference's
Pallas kernel discipline).

Invariant guarded: every hand-written kernel of the port has a plain
PyTorch twin and a parity test (``tests/test_torch_kernels.py``,
``test_torch_lora_kernels.py``, ``test_torch_gmm.py`` hold the twins to
the JAX package's Pallas kernels on the CPU; their ``gpu`` tests and
``chip_smoke.py`` phase 2 hold each kernel to its twin on the card). A
kernel without them ships untested wherever no card is.

For every public function of ``kernels/`` that reaches ``build.load("x")``
(directly or through same-module helpers), a kernel wrapper:

  - ``csrc/x.cu`` exists beside the package;
  - ``kernels/ref.py`` defines ``<wrapper>_ref``;
  - some ``tests/test_torch_*.py`` names the wrapper.

And every ``ref.<name>_ref`` reference in the checked files resolves to a
function of ``kernels/ref.py``.

The files looked up: ``kernels/ref.py`` among the checked modules (else
``src/repro_torch/kernels/ref.py`` under the root), ``csrc/`` beside the
wrapper's package, and ``tests/`` under the root.
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import List, Optional, Set

from repro_torch.staticcheck.astutil import call_name, iter_calls
from repro_torch.staticcheck.engine import Finding, ModuleInfo, \
    ProjectContext

_SKIP = ("ref.py", "ops.py", "build.py", "autograd.py", "__init__.py")


def _ref_names(ctx: ProjectContext) -> Optional[Set[str]]:
    mod = ctx.module_by_relpath("kernels/ref.py")
    if mod is not None and mod.tree is not None:
        tree = mod.tree
    else:
        path = ctx.root / "src/repro_torch/kernels/ref.py"
        if not path.exists():
            return None
        tree = ast.parse(path.read_text())
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}


def _tests_text(ctx: ProjectContext) -> str:
    cached = getattr(ctx, "_torch_tests_text", None)
    if cached is None:
        cached = "\n".join(p.read_text() for p in sorted(
            (ctx.root / "tests").glob("test_torch_*.py")))
        ctx._torch_tests_text = cached
    return cached


def _loads(fn) -> List[str]:
    out = []
    for call in iter_calls(fn):
        name = call_name(call) or ""
        if name.endswith("build.load") and call.args and \
                isinstance(call.args[0], ast.Constant) and \
                isinstance(call.args[0].value, str):
            out.append(call.args[0].value)
    return out


class KernelTwinDiscipline:
    rule_id = "SC004"
    name = "kernel-twin-discipline"

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Finding]:
        findings: List[Finding] = []
        refs = _ref_names(ctx)
        if refs is not None:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Attribute) and \
                        node.attr.endswith("_ref") and \
                        isinstance(node.value, ast.Name) and \
                        node.value.id in ("ref", "_ref") and \
                        node.attr not in refs:
                    findings.append(Finding(
                        self.rule_id, mod.relpath, node.lineno,
                        node.col_offset,
                        f"'{node.value.id}.{node.attr}' names no function "
                        f"of kernels/ref.py"))
        parts = mod.relpath.split("/")
        if len(parts) < 2 or parts[-2] != "kernels" or parts[-1] in _SKIP:
            return findings
        index = mod.index
        csrc = (ctx.root / mod.relpath).parent.parent / "csrc"
        for fn in mod.tree.body:
            if not isinstance(fn, ast.FunctionDef) or \
                    fn.name.startswith("_"):
                continue
            names = sorted({n for body in index.reachable([fn])
                            for n in _loads(body)})
            if not names:
                continue
            for src in names:
                if not (csrc / f"{src}.cu").exists():
                    findings.append(Finding(
                        self.rule_id, mod.relpath, fn.lineno, fn.col_offset,
                        f"kernel wrapper '{fn.name}' loads csrc/{src}.cu, "
                        f"which does not exist"))
            if refs is not None and f"{fn.name}_ref" not in refs:
                findings.append(Finding(
                    self.rule_id, mod.relpath, fn.lineno, fn.col_offset,
                    f"kernel wrapper '{fn.name}' has no plain twin "
                    f"'{fn.name}_ref' in kernels/ref.py"))
            if not re.search(rf"\b{re.escape(fn.name)}\b", _tests_text(ctx)):
                findings.append(Finding(
                    self.rule_id, mod.relpath, fn.lineno, fn.col_offset,
                    f"kernel wrapper '{fn.name}' is named in no "
                    f"tests/test_torch_*.py: it has no parity test"))
        return findings

"""SC003 recapture-hazard.

Invariant guarded: the fused transport captures one CUDA graph a (bucket,
layout) and replays it for every later step of that shape
(``tests/test_torch_transport.py`` and ``chip_smoke.py`` phases 6-8: the
captures counted, no new capture in a churn run or across an autoscaler's
second add/drain cycle, the graph pool not growing). The port's
counterpart of the reference's recompile hazard is a capture (or a
``torch.compile``) made again and again:

  - ``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)`` or
    ``torch.compile(...)`` inside a ``for`` / ``while`` loop of a function,
    with no cache around it: a capture a step costs the capture's time and
    a pool segment every step. Blessed: building into a dict keyed by the
    step's shape (``self._graphs[key] = ...`` or a ``.get(key)`` probe in
    the same function);
  - a graph cache keyed by something unhashable (a list, dict or set
    display, or a comprehension, in a subscript of a name that mentions
    ``graph``, ``capture`` or ``compiled``): it raises at the first store.

Heuristic bounds: the cache check is by shape of code in one function,
not by data flow; a loop that runs once per engine is flagged and takes an
inline suppression with its reason.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.staticcheck.astutil import call_name, dotted_name
from repro_torch.staticcheck.engine import Finding, ModuleInfo, \
    ProjectContext

BUILDERS = frozenset({"torch.cuda.CUDAGraph", "torch.cuda.graph",
                      "torch.compile", "cuda.CUDAGraph"})
_CACHE_WORDS = ("graph", "capture", "compiled")
_UNHASHABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
               ast.SetComp)


def _loops_of(index, node):
    for anc in index.parent_chain(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return
        if isinstance(anc, (ast.For, ast.While, ast.AsyncFor)):
            yield anc


def _cached(fn) -> bool:
    """Whether ``fn`` stores into, or probes, a subscripted cache."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Store):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in ("get", "setdefault"):
            return True
    return False


class RecaptureHazard:
    rule_id = "SC003"
    name = "recapture-hazard"

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Finding]:
        index = mod.index
        findings: List[Finding] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and \
                    (call_name(node) or "") in BUILDERS:
                if not any(True for _ in _loops_of(index, node)):
                    continue
                fn = index.enclosing_function(node)
                if fn is not None and _cached(fn):
                    continue
                findings.append(Finding(
                    self.rule_id, mod.relpath, node.lineno,
                    node.col_offset,
                    f"'{call_name(node)}' built inside a loop with no "
                    f"cache: a capture (or compile) every iteration; key "
                    f"one by the step's shape and replay it"))
            elif isinstance(node, ast.Subscript):
                base = (dotted_name(node.value) or "").lower()
                if not any(w in base for w in _CACHE_WORDS):
                    continue
                key = node.slice
                elts = key.elts if isinstance(key, ast.Tuple) else [key]
                if any(isinstance(e, _UNHASHABLE) for e in elts):
                    findings.append(Finding(
                        self.rule_id, mod.relpath, node.lineno,
                        node.col_offset,
                        f"graph cache '{dotted_name(node.value)}' keyed by "
                        f"an unhashable value: key it by a tuple of ints "
                        f"and hashables"))
        return findings

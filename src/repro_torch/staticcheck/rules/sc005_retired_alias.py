"""SC005 retired-alias-read (the counterpart of the reference's
donation-after-use).

Invariant guarded: a buffer that an in-place update overwrites is not
read afterwards through a name bound before the update, expecting the old
value. The port updates in place where the reference donates:
``distributed.steps.adamw_`` overwrites every parameter and moment
(``tests/test_torch_spmd.py``, ``chip_smoke.py`` phase 13(iii) read the
gradients from the moments after the step, not the parameters), and a
captured graph's replay overwrites its static output buffers
(``FusedTransport.decode_step`` reads ``step.tokens`` after its own
replay; ``tests/test_torch_transport.py``).

Flagged, within one function, in line order: a name bound to a view of
root ``R`` (``a = R[...]`` or ``a = R.attr``, a subscript or attribute
chain with no call in it), then a retiring call (``adamw_(R, ...)`` in
any spelling, or ``R....replay()``), then a read of ``a`` with no
rebinding of it between.

Heuristic bounds: names only, one function, line order (a loop's next
iteration is not modelled), and a view made through a call
(``R.view(-1)``) or held in a container escapes it.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from repro_torch.staticcheck.astutil import FunctionNode, call_name, \
    name_tail
from repro_torch.staticcheck.engine import Finding, ModuleInfo, \
    ProjectContext

RETIRING = frozenset({"adamw_"})


def _root(node: ast.AST):
    """The name a subscript/attribute chain with no call starts from."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _retired_root(call: ast.Call):
    if name_tail(call_name(call)) in RETIRING and call.args and \
            isinstance(call.args[0], ast.Name):
        return call.args[0].id
    if isinstance(call.func, ast.Attribute) and call.func.attr == "replay":
        return _root(call.func.value)
    return None


class RetiredAliasRead:
    rule_id = "SC005"
    name = "retired-alias-read"

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Finding]:
        findings: List[Finding] = []
        for fn in ast.walk(mod.tree):
            if isinstance(fn, FunctionNode):
                findings.extend(self._check_fn(mod, fn))
        return findings

    def _own_nodes(self, fn):
        """Nodes of ``fn`` outside its nested defs."""
        work = list(ast.iter_child_nodes(fn))
        while work:
            node = work.pop()
            if isinstance(node, FunctionNode + (ast.Lambda, ast.ClassDef)):
                continue
            yield node
            work.extend(ast.iter_child_nodes(node))

    def _check_fn(self, mod, fn) -> List[Finding]:
        aliases: List[Tuple[int, str, str]] = []    # (line, alias, root)
        binds: Dict[str, List[int]] = {}
        retires: List[Tuple[int, str]] = []
        loads: List[ast.Name] = []
        for node in self._own_nodes(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    isinstance(node.value, (ast.Subscript, ast.Attribute)):
                root = _root(node.value)
                if root and not any(isinstance(s, ast.Call)
                                    for s in ast.walk(node.value)):
                    aliases.append((node.lineno, node.targets[0].id, root))
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Store):
                    binds.setdefault(node.id, []).append(node.lineno)
                elif isinstance(node.ctx, ast.Load):
                    loads.append(node)
            if isinstance(node, ast.Call):
                root = _retired_root(node)
                if root:
                    retires.append((node.lineno, root))
        findings = []
        for line, alias, root in aliases:
            hit = None
            for r_line, r_root in sorted(retires):
                if r_root != root or r_line <= line:
                    continue
                for ld in sorted(loads, key=lambda n: n.lineno):
                    rebound = any(r_line < b <= ld.lineno
                                  for b in binds.get(alias, []))
                    if ld.id == alias and ld.lineno > r_line and \
                            not rebound:
                        hit = (r_line, ld)
                        break
                if hit:
                    break
            if hit:
                r_line, ld = hit
                findings.append(Finding(
                    self.rule_id, mod.relpath, ld.lineno, ld.col_offset,
                    f"'{alias}' (a view of '{root}', line {line}) read "
                    f"after the in-place update at line {r_line} retired "
                    f"it: it holds the new values; copy before the update "
                    f"or read it again after"))
        return findings

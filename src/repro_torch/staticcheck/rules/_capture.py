"""The code a CUDA-graph capture runs, shared by SC002 and SC006.

Roots: the body of every ``with torch.cuda.graph(...)`` block (what it
calls, followed through same-module defs and the port's own imports,
``astutil.reach``), and ``EXTRA_ROOTS``: bodies the captured step reaches
through an object, which a static pass cannot follow (the fused
transport's ``DeviceLoraView.compute``, called as ``server.compute``).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from repro_torch.staticcheck.astutil import dotted_name, reach

# (relpath suffix, function name)
EXTRA_ROOTS = (
    ("transport/fused.py", "compute"),
)
_GRAPH_CTX = ("torch.cuda.graph", "cuda.graph")


def _capture_blocks(tree: ast.Module) -> List[ast.With]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.With):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call) and \
                        dotted_name(ctx.func) in _GRAPH_CTX:
                    out.append(node)
    return out


def captured(ctx) -> Dict[str, List[ast.AST]]:
    """relpath -> the bodies (defs, and the capture blocks themselves) a
    capture reaches in that module; computed once a project."""
    cached = getattr(ctx, "_captured", None)
    if cached is not None:
        return cached
    roots: List[Tuple[object, ast.AST]] = []
    for mod in ctx.modules:
        if mod.tree is None:
            continue
        for block in _capture_blocks(mod.tree):
            roots.append((mod, block))
        for suffix, name in EXTRA_ROOTS:
            if mod.relpath.endswith(suffix) and \
                    name in mod.index.functions:
                roots.append((mod, mod.index.functions[name]))
    out: Dict[str, List[ast.AST]] = {}
    for mod, fn in reach(ctx.modules, roots):
        out.setdefault(mod.relpath, []).append(fn)
    ctx._captured = out
    return out


def calls_in(bodies) -> List[ast.Call]:
    """Every call lexically inside ``bodies``, once each."""
    seen, out = set(), []
    for body in bodies:
        for node in ast.walk(body):
            if isinstance(node, ast.Call) and id(node) not in seen:
                seen.add(id(node))
                out.append(node)
    return out

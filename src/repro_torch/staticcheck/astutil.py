"""Shared AST helpers for the staticcheck rules (stdlib ``ast`` only): a
copy of ``repro.staticcheck.astutil``, plus the port's cross-module
reachability (``import_map``, ``reach``), which follows calls through the
port's own imports.

The rules all need the same three capabilities:

  - name resolution: turn a ``Call``'s func into a dotted string
    ("jax.lax.psum", "pl.pallas_call") so matching is prefix/tail based
    and survives import aliasing;
  - module indexing: every function def (top-level AND nested) by name,
    so "the function passed to shard_map / jax.jit" resolves to a body;
  - bounded reachability: from a root def, the set of same-module defs
    reachable through plain ``Name`` calls — the static analogue of "code
    reachable under this trace". Cross-module attribute calls are NOT
    followed (each module is checked with its own roots instead), which
    keeps the pass O(repo) and the findings local to the file that must
    change.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``Name``/``Attribute`` chain -> "a.b.c" (None for anything else,
    e.g. a subscript or call in the chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted_name(call.func)


def name_tail(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def iter_calls(node: ast.AST) -> Iterator[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub


def first_pos_arg(call: ast.Call) -> Optional[ast.AST]:
    return call.args[0] if call.args else None


def unwrap_partial(node: ast.AST) -> ast.AST:
    """``functools.partial(f, ...)`` -> ``f`` (else the node itself)."""
    if isinstance(node, ast.Call) and name_tail(call_name(node)) == "partial":
        inner = first_pos_arg(node)
        if inner is not None:
            return inner
    return node


class ModuleIndex:
    """Function defs of one module, by (scope-flattened) name.

    Nested defs are indexed under their bare name too: the repo's idiom is
    inner ``def body(...)`` closures handed to shard_map/jit, and bare
    names are what ``Name`` calls carry. On a duplicate bare name the
    first definition wins — good enough for reachability, which is a
    may-analysis here.
    """

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.functions: Dict[str, ast.AST] = {}
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        for node in ast.walk(tree):
            if isinstance(node, FunctionNode):
                self.functions.setdefault(node.name, node)

    def parent_chain(self, node: ast.AST) -> Iterator[ast.AST]:
        while node in self.parents:
            node = self.parents[node]
            yield node

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        for anc in self.parent_chain(node):
            if isinstance(anc, FunctionNode):
                return anc
        return None

    def resolve_callable(self, node: ast.AST) -> Optional[ast.AST]:
        """A node in callable position (``f`` of ``jit(f)``) -> its def:
        a ``Name`` bound to a def in this module, an inline ``Lambda``, or
        ``partial(f, ...)``/``shard_map(f, ...)``-style wrappers peeled
        one level."""
        node = unwrap_partial(node)
        if isinstance(node, ast.Lambda):
            return node
        if isinstance(node, ast.Call):
            # e.g. jax.jit(shard_map(body, ...)): peel the wrapper call
            inner = first_pos_arg(node)
            if inner is not None and inner is not node:
                return self.resolve_callable(inner)
            return None
        if isinstance(node, ast.Name):
            return self.functions.get(node.id)
        return None

    def reachable(self, roots: Iterable[ast.AST]) -> List[ast.AST]:
        """Defs reachable from ``roots`` via plain ``Name`` calls (and the
        roots themselves). Lambdas count as bodies but have no callees
        resolved beyond Name calls inside them."""
        seen: List[ast.AST] = []
        seen_ids: Set[int] = set()
        work = list(roots)
        while work:
            fn = work.pop()
            if id(fn) in seen_ids:
                continue
            seen_ids.add(id(fn))
            seen.append(fn)
            for call in iter_calls(fn):
                if isinstance(call.func, ast.Name):
                    target = self.functions.get(call.func.id)
                    if target is not None and id(target) not in seen_ids:
                        work.append(target)
        return seen


def func_params(fn: ast.AST) -> List[str]:
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args]
    if args.vararg:
        names.append(args.vararg.arg)
    names += [a.arg for a in args.kwonlyargs]
    if args.kwarg:
        names.append(args.kwarg.arg)
    return names


def positional_params(fn: ast.AST) -> List[str]:
    args = fn.args
    return [a.arg for a in args.posonlyargs + args.args]


def kwonly_params(fn: ast.AST) -> List[str]:
    return [a.arg for a in fn.args.kwonlyargs]


def taint_set(fn: ast.AST, seeds: Iterable[str],
              seed_calls: Tuple[str, ...] = ()) -> Set[str]:
    """Forward-propagate ``seeds`` through simple assignments in ``fn``:
    a name assigned from an expression mentioning a tainted name (or a
    call whose dotted name is in ``seed_calls``) becomes tainted. One
    fixed-point loop; flow-insensitive, which over-approximates — the
    right direction for a guard."""
    tainted = set(seeds)
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                value = node.value
                if value is None:
                    continue
                hit = False
                for sub in ast.walk(value):
                    if isinstance(sub, ast.Name) and sub.id in tainted:
                        hit = True
                    elif isinstance(sub, ast.Call) and \
                            call_name(sub) in seed_calls:
                        hit = True
                if not hit:
                    continue
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name) and \
                                sub.id not in tainted:
                            tainted.add(sub.id)
                            changed = True
    return tainted


def mentions_tainted(node: ast.AST, tainted: Set[str]) -> bool:
    return any(isinstance(sub, ast.Name) and sub.id in tainted
               for sub in ast.walk(node))


def mentions_tainted_direct(node: ast.AST, tainted: Set[str]) -> bool:
    """Like ``mentions_tainted`` but a name used only as an attribute base
    (``cfg.sliding_window``) does not count: attribute reads off a static
    config object are the repo's standard way to thread compile-time
    constants through jitted functions, while a *direct* use of a traced
    array is the hazard."""
    hit = False

    def visit(n: ast.AST, parent: Optional[ast.AST]) -> None:
        nonlocal hit
        if isinstance(n, ast.Name) and n.id in tainted:
            if not (isinstance(parent, ast.Attribute)
                    and parent.value is n):
                hit = True
        for child in ast.iter_child_nodes(n):
            visit(child, n)

    visit(node, None)
    return hit


def int_tuple_literal(node: ast.AST) -> Optional[Tuple[int, ...]]:
    """``(0, 1)`` / ``0`` literals -> tuple of ints (else None)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for el in node.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, int) \
                    and not isinstance(el.value, bool):
                out.append(el.value)
            else:
                return None
        return tuple(out)
    return None


def ref_chain(node: ast.AST) -> Optional[str]:
    """Stringify a Name/Attribute chain used as a buffer reference
    ("self._k", "k") so later loads of the SAME chain can be matched."""
    return dotted_name(node)


# --------------------- cross-module reachability ------------------------ #
PACKAGE = "repro_torch"


def import_map(tree: ast.Module, package: str = PACKAGE
               ) -> Dict[str, Tuple[str, Optional[str]]]:
    """alias -> (dotted module under ``package``, attribute or None) for
    the module's imports of ``package``: ``import p.a.b as m`` gives
    m -> ("p.a.b", None), ``from p.a import b`` gives b -> ("p.a", "b")
    (``b`` may be a module or a name of p.a: ``reach`` tries both)."""
    out: Dict[str, Tuple[str, Optional[str]]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == package and a.asname:
                    out[a.asname] = (a.name, None)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[0] == package and not node.level:
            for a in node.names:
                out[a.asname or a.name] = (node.module, a.name)
    return out


def _module_suffix(dotted: str) -> str:
    return dotted.replace(".", "/") + ".py"


def reach(modules, roots) -> List[Tuple[object, ast.AST]]:
    """(module, def) pairs reachable from ``roots`` ((module, def) pairs)
    through calls by bare name within a module, and through the port's
    imports across modules (``alias.f(...)`` of an imported module, ``f``
    imported by name). ``modules``: the checked ``ModuleInfo`` list.
    Calls on objects (``self.x.f()``) are not followed: a rule names such
    bodies as roots of their own."""
    by_suffix = {}
    for m in modules:
        if m.tree is not None:
            by_suffix[m.relpath] = m

    def find(dotted: str):
        suffix = _module_suffix(dotted)
        for rel, m in by_suffix.items():
            if rel == suffix or rel.endswith("/" + suffix):
                return m
        return None

    def resolve(mod, call: ast.Call):
        imports = getattr(mod, "_imports", None)
        if imports is None:
            imports = mod._imports = import_map(mod.tree)
        func = call.func
        if isinstance(func, ast.Name):
            local = mod.index.functions.get(func.id)
            if local is not None:
                return mod, local
            if func.id in imports:
                dotted, attr = imports[func.id]
                target = find(dotted)
                if target is not None and attr:
                    fn = target.index.functions.get(attr)
                    if fn is not None:
                        return target, fn
            return None
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name) and \
                func.value.id in imports:
            dotted, attr = imports[func.value.id]
            target = find(dotted + "." + attr if attr else dotted) or (
                find(dotted) if attr is None else None)
            if target is not None:
                fn = target.index.functions.get(func.attr)
                if fn is not None:
                    return target, fn
        return None

    seen: List[Tuple[object, ast.AST]] = []
    seen_ids: Set[int] = set()
    work = list(roots)
    while work:
        mod, fn = work.pop()
        if id(fn) in seen_ids:
            continue
        seen_ids.add(id(fn))
        seen.append((mod, fn))
        for call in iter_calls(fn):
            hit = resolve(mod, call)
            if hit is not None and id(hit[1]) not in seen_ids:
                work.append(hit)
    return seen

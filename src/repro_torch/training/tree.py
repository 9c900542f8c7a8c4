"""Nested containers of tensors (the training plane's trees): dicts, lists
and tuples, with ``None`` an empty subtree, as JAX's pytrees treat them.
Dict keys are visited in sorted order and a leaf's key path reads as
``jax.tree_util.keystr`` writes it (``['p']['embed']``, ``['o'][0]``), so
a checkpoint's leaf names are the reference's."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


def _children(tree):
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); ``None`` stays ``None``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def flatten_with_keys(tree) -> Dict[str, Any]:
    """{key path: leaf} in the reference's flatten order."""
    out: Dict[str, Any] = {}

    def walk(prefix, t):
        if t is None:
            return
        kids = _children(t)
        if kids is None:
            out[prefix] = t
            return
        for k, v in kids:
            walk(prefix + k, v)

    walk("", tree)
    return out


def leaves(tree) -> List[Any]:
    return list(flatten_with_keys(tree).values())


def unflatten_like(tree, flat: Dict[str, Any]):
    """``tree``'s structure with each leaf replaced by ``flat[key path]``."""
    def walk(prefix, t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(prefix + f"[{k!r}]", v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(prefix + f"[{i}]", v)
                           for i, v in enumerate(t))
        return flat[prefix]

    return walk("", tree)

"""Parameter trees in JAX's flatten order.

``torch.utils._pytree`` flattens a dict in insertion order; JAX sorts its
keys.  The port's checkpoints, its optimizer's leaf list and
:func:`cpprob_tpu_torch.interop.csis_params_from_numpy` use one order, JAX's,
so a leaf list written by either package means the same tree in the other:
dicts by sorted key, lists and tuples in order, ``None`` an empty node,
anything else a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map", "treedef_str"]

_LEAF = "*"


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` in JAX's order; ``treedef`` is a nest of
    ``("dict", keys, children)`` / ``("list", children)`` / ``("tuple",
    children)`` / ``None`` / ``"*"``."""
    leaves: List[Any] = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, tuple(walk(c) for c in node))
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves) -> Any:
    """The tree of ``treedef`` with ``leaves`` in order."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == _LEAF:
            return next(it)
        if d[0] == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        children = [build(c) for c in d[1]]
        return children if d[0] == "list" else tuple(children)

    return build(treedef)


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(l) for l in leaves])


def treedef_str(treedef: Any) -> str:
    """``treedef`` written as JAX prints a ``PyTreeDef``."""

    def fmt(d):
        if d is None:
            return "None"
        if d == _LEAF:
            return "*"
        if d[0] == "dict":
            return "{" + ", ".join(f"{k!r}: {fmt(c)}" for k, c in zip(d[1], d[2])) + "}"
        inner = ", ".join(fmt(c) for c in d[1])
        if d[0] == "list":
            return f"[{inner}]"
        return f"({inner},)" if len(d[1]) == 1 else f"({inner})"

    return f"PyTreeDef({fmt(treedef)})"

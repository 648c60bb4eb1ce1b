"""The few tree operations the port needs over dicts, tuples and lists.

Parameters, optimizer states and batches are nested ``dict`` / ``tuple`` /
``list`` containers of tensors (the reference's pytrees); ``None`` is an
empty subtree, as a plain-DFL state's missing CHOCO estimates are.
"""
from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over ``tree`` and the trees of the same
    structure in ``rest``; dict keys keep ``tree``'s order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, *parts) for parts in zip(tree, *rest)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out

"""The few tree operations the port needs over dicts, tuples and lists.

Parameters, optimizer states and batches are nested ``dict`` / ``tuple`` /
``list`` containers of tensors (the reference's pytrees); ``None`` is an
empty subtree, as a plain-DFL state's missing CHOCO estimates are. The
parameters of a model are one flat dict keyed by the reference's joined
tree path (``"blocks/0/mixer/wq"``); ``leaf_order`` gives the order in
which the reference flattens the tree those paths came from.
"""
from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["tree_map", "tree_leaves", "leaf_order"]


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


def _path_key(name: str):
    return tuple((0, int(part), "") if part.isdigit() else (1, 0, part)
                 for part in name.split("/"))


def leaf_order(names) -> List[str]:
    """Path-keyed leaf names in the reference's ``tree_leaves`` order: the
    path's parts compared one by one, dict keys as strings (JAX sorts a
    dict's keys) and list indices (the all-digit parts) as numbers, so
    ``blocks/2`` comes before ``blocks/10``. For names without a ``/``,
    the flat dicts of the CNN, this is the sorted order."""
    return sorted(names, key=_path_key)

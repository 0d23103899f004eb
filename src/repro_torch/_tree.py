"""A small pytree flattener for dicts, lists and tuples of tensors.

Leaves come out in JAX's order: dict keys sorted, lists and tuples in
position order, ``None`` an empty subtree.  Key paths are written the way
``jax.tree_util.keystr`` writes them (``['a']['b']``, ``[0]``).  The runtime
records per-leaf byte spans in this order, so registering the same tree in
the JAX package and here gives the same spans and the same plans.
(``torch.utils._pytree`` keeps dict insertion order, which is why it is not
used.)
"""

from __future__ import annotations

from typing import Any, Iterator, List, Tuple


class TreeDef:
    """The structure of a flattened tree, enough to rebuild it."""

    __slots__ = ("kind", "keys", "children")

    def __init__(self, kind: Any, keys: Tuple = (), children: Tuple = ()):
        self.kind = kind            # dict | list | tuple | None | "leaf"
        self.keys = keys
        self.children = children


def _flatten(node: Any, path: str, out: List[Tuple[str, Any]]) -> TreeDef:
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return TreeDef(dict, keys, tuple(
            _flatten(node[k], f"{path}[{k!r}]", out) for k in keys))
    if isinstance(node, (list, tuple)):
        return TreeDef(type(node), (), tuple(
            _flatten(c, f"{path}[{i}]", out) for i, c in enumerate(node)))
    if node is None:
        return TreeDef(None)
    out.append((path, node))
    return TreeDef("leaf")


def flatten_with_path(tree: Any) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """``([(keystr, leaf), ...], treedef)`` in JAX's flatten order."""
    out: List[Tuple[str, Any]] = []
    return out, _flatten(tree, "", out)


def flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    pairs, treedef = flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def _build(td: TreeDef, it: Iterator[Any]) -> Any:
    if td.kind == "leaf":
        return next(it)
    if td.kind is None:
        return None
    if td.kind is dict:
        return {k: _build(c, it) for k, c in zip(td.keys, td.children)}
    return td.kind(_build(c, it) for c in td.children)


def unflatten(treedef: TreeDef, new_leaves: List[Any]) -> Any:
    it = iter(new_leaves)
    tree = _build(treedef, it)
    if next(it, _END) is not _END:
        raise ValueError("unflatten: more leaves than the tree holds")
    return tree


_END = object()

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

from typing import Any, Callable, Iterator, List, Optional, Tuple


class TreeDef:
    """The structure of a flattened tree, enough to rebuild it."""

    __slots__ = ("kind", "keys", "children")

    def __init__(self, kind: Any, keys: Tuple = (), children: Tuple = ()):
        self.kind = kind            # dict | list | tuple | None | "leaf"
        self.keys = keys
        self.children = children


def _flatten(node: Any, keys: Tuple, out: List[Tuple[Tuple, Any]],
             is_leaf: Optional[Callable[[Any], bool]]) -> TreeDef:
    if is_leaf is not None and is_leaf(node):
        out.append((keys, node))
        return TreeDef("leaf")
    if isinstance(node, dict):
        ks = tuple(sorted(node))
        return TreeDef(dict, ks, tuple(
            _flatten(node[k], keys + (k,), out, is_leaf) for k in ks))
    if isinstance(node, (list, tuple)):
        return TreeDef(type(node), (), tuple(
            _flatten(c, keys + (i,), out, is_leaf)
            for i, c in enumerate(node)))
    if node is None:
        return TreeDef(None)
    out.append((keys, node))
    return TreeDef("leaf")


def flatten_with_keys(tree: Any, is_leaf: Optional[Callable[[Any], bool]]
                      = None) -> Tuple[List[Tuple[Tuple, Any]], TreeDef]:
    """``([(keys, leaf), ...], treedef)`` in JAX's flatten order: ``keys``
    the dict keys and sequence indices from the root.  ``is_leaf(node)``
    true makes a node a leaf (as JAX's ``is_leaf``)."""
    out: List[Tuple[Tuple, Any]] = []
    return out, _flatten(tree, (), out, is_leaf)


def flatten_with_path(tree: Any) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """``([(keystr, leaf), ...], treedef)`` in JAX's flatten order."""
    pairs, treedef = flatten_with_keys(tree)
    return [("".join(f"[{k!r}]" for k in keys), leaf)
            for keys, leaf in pairs], treedef


def flatten(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
            ) -> Tuple[List[Any], TreeDef]:
    pairs, treedef = flatten_with_keys(tree, is_leaf)
    return [leaf for _, leaf in pairs], treedef


def leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
           ) -> List[Any]:
    return flatten(tree, is_leaf)[0]


def _up_to(td: TreeDef, node: Any, out: List[Any]) -> None:
    if td.kind == "leaf":
        out.append(node)
    elif td.kind is dict:
        for k, c in zip(td.keys, td.children):
            _up_to(c, node[k], out)
    elif td.kind is not None:
        for i, c in enumerate(td.children):
            _up_to(c, node[i], out)


def flatten_up_to(treedef: TreeDef, tree: Any) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``treedef`` (as
    ``treedef.flatten_up_to`` in JAX): e.g. a quantized moment's
    ``{"q", "s"}`` dict where the parameters have a tensor."""
    out: List[Any] = []
    _up_to(treedef, tree, out)
    return out


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

"""Nested containers of tensors: the port's stand-in for ``jax.tree_util``.

A tree is a dict, list, tuple or NamedTuple of trees, or a leaf
(anything else, usually a tensor). Traversal follows JAX's order —
dict keys sorted, sequences and NamedTuple fields in order — and
:func:`flatten_with_path` names each leaf with the string
``jax.tree_util.keystr`` gives it (``[0]['embed']['table']``,
``[1].m['stack']['wq']``), so a checkpoint's keys are the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Iterator[Tuple[str, Any]]:
    """(path piece, child) pairs of a container, in JAX's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield f"[{k!r}]", tree[k]
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield f".{f}", getattr(tree, f)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield f"[{i}]", v


def is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple))


def flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr path, leaf)] in JAX's leaf order."""
    if is_leaf(tree):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for piece, child in _children(tree):
        out.extend(flatten_with_path(child, prefix + piece))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def _rebuild(like, children: List[Any]):
    if isinstance(like, dict):
        keys = sorted(like)
        return {k: children[keys.index(k)] for k in like}
    if _is_namedtuple(like):
        return type(like)(*children)
    return type(like)(children)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    if is_leaf(tree):
        return fn(tree, *rest)
    kids = [tree_map(fn, child, *(_child(r, piece) for r in rest))
            for piece, child in _children(tree)]
    return _rebuild(tree, kids)


def _child(tree, piece: str):
    for p, child in _children(tree):
        if p == piece:
            return child
    raise ValueError(f"tree structures differ at {piece}")


def unflatten_like(like, flat: List[Any]):
    """The leaves ``flat`` (in :func:`leaves` order) in ``like``'s
    structure."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("unflatten_like: more leaves than the structure")
    return out

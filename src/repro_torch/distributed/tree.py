"""Trees of tensors, as the reference's ``jax.tree_util`` walks its pytrees.

A tree is nested dicts, lists, tuples and ``NamedTuple``s; ``None`` is an
empty subtree (no leaf); anything else is a leaf (a tensor, a numpy array,
a scalar).  The walk order is the reference's: dict keys sorted, list and
tuple entries by index, a ``NamedTuple``'s fields in declaration order.

A path is a tuple of entries, each the dict key, the list or tuple index,
or ``".field"`` for a ``NamedTuple`` field: ``str`` of each entry is
``str`` of the reference's key object (``DictKey.key``,
``SequenceKey.idx``, ``GetAttrKey``), so ``leaf_name`` gives the
reference's checkpoint leaf names (``.params/w``, ``.opt/.m/w``).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Optional


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> list[tuple[Any, Any]] | None:
    """(path entry, child) pairs of an inner node in walk order; None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _rebuild(node, values: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), values))
    if _is_namedtuple(node):
        return type(node)(*values)
    return type(node)(values)


def map_with_path(fn: Callable[[tuple, Any], Any], tree: Any, path: tuple = (), *,
                  is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``tree`` with each leaf replaced by ``fn(path, leaf)``; ``None``
    subtrees stay ``None``; a node for which ``is_leaf`` holds is a leaf."""
    if tree is None:
        return None
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return fn(path, tree)
    return _rebuild(tree, [map_with_path(fn, child, path + (key,), is_leaf=is_leaf)
                           for key, child in kids])


def tree_map(fn: Callable[[Any], Any], tree: Any, *,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``tree`` with each leaf replaced by ``fn(leaf)``."""
    return map_with_path(lambda _path, leaf: fn(leaf), tree, is_leaf=is_leaf)


def _walk(tree: Any, path: tuple) -> Iterator[tuple[tuple, Any]]:
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for key, child in kids:
        yield from _walk(child, path + (key,))


def leaves_with_path(tree: Any) -> list[tuple[tuple, Any]]:
    """Every (path, leaf) of ``tree`` in walk order."""
    return list(_walk(tree, ()))


def leaves(tree: Any) -> list:
    """Every leaf of ``tree`` in walk order."""
    return [leaf for _, leaf in _walk(tree, ())]


def unflatten(template: Any, values) -> Any:
    """``template``'s structure with its leaves replaced, in walk order, by
    ``values``."""
    it = iter(values)
    out = tree_map(lambda _leaf: next(it), template)
    if next(it, it) is not it:
        raise ValueError("more values than the template has leaves")
    return out


def leaf_name(path: tuple) -> str:
    """The reference's checkpoint name of the leaf at ``path``."""
    return "/".join(str(p) for p in path)

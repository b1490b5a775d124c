"""Parameter trees: nested dicts, lists and named tuples with tensor (or
array) leaves.

The port keeps the JAX package's tree layout (same keys, same per-segment
stacks), so flattened '/'-joined paths name the same leaves on both sides.
"""
from __future__ import annotations

from typing import Callable, Iterator


def is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf, rebuilding the dict/list/named-tuple
    structure (a plain tuple comes back as a list)."""
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """Apply ``fn(path, leaf)`` to every leaf, the path as
    ``tree_leaves_with_path`` gives it, rebuilding the structure as
    ``tree_map`` does (dicts keep their key order)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f".{name}",))
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_leaves_with_path(tree, path: tuple = ()) -> Iterator[tuple[tuple, object]]:
    """(path, leaf) pairs in the JAX package's flattening order: dict keys
    sorted, list items by index, named-tuple fields in declaration order.
    A path holds dict keys, list indices and ``'.field'`` names, as JAX's
    key paths print."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (k,))
    elif is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from tree_leaves_with_path(v, path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def slice_stack(tree, start: int, end: int):
    """Rows [start, end) of every stacked leaf (leading axis = layers)."""
    return tree_map(lambda a: a[start:end], tree)

"""Parameter trees: nested dicts and lists with tensor (or array) leaves.

The port keeps the JAX package's tree layout (same keys, same per-segment
stacks), so flattened '/'-joined paths name the same leaves on both sides.
"""
from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf, rebuilding the dict/list structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def slice_stack(tree, start: int, end: int):
    """Rows [start, end) of every stacked leaf (leading axis = layers)."""
    return tree_map(lambda a: a[start:end], tree)

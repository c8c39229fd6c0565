"""Nested dicts of tensors (the training state) walked in the reference's
leaf order: ``jax.tree`` sorts a dict's keys at every level, and the
global norm, the optimizer and the checkpoint names follow that order."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Path = Tuple[str, ...]


def flatten(tree: Any, prefix: Path = ()) -> Tuple[List[Path], List[Any]]:
    """(paths, leaves) in sorted-key order; anything but a dict is a
    leaf."""
    if not isinstance(tree, dict):
        return [prefix], [tree]
    paths: List[Path] = []
    leaves: List[Any] = []
    for key in sorted(tree):
        p, l = flatten(tree[key], prefix + (str(key),))
        paths += p
        leaves += l
    return paths, leaves


def unflatten(paths: List[Path], leaves: List[Any]) -> Any:
    """The nested dicts ``flatten`` walked (a lone leaf at the root stays
    a leaf)."""
    if paths == [()]:
        return leaves[0]
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[1]


def map_tree(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    paths, ls = flatten(tree)
    others = [flatten(t)[1] for t in rest]
    return unflatten(paths, [fn(*args) for args in zip(ls, *others)])

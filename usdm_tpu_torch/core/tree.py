"""Parameter trees: the port's params are nested dicts and lists of tensors."""

from __future__ import annotations

from typing import Callable, List

import torch


def tree_map(fn: Callable, tree):
    """`fn` applied to every leaf, keeping the dict/list structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in a fixed order (dict insertion order, then list order)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map2(fn: Callable, tree, other):
    """`fn(leaf, other_leaf)` over `tree`, `other` matched to it by dict key
    and list index (the result has `tree`'s structure and order)."""
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map2(fn, v, o) for v, o in zip(tree, other, strict=True)]
    return fn(tree, other)

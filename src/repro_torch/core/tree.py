"""Walking the port's param trees: nested dicts and lists of tensors (the
reference uses ``jax.tree_util``)."""

from __future__ import annotations

from typing import List

import torch


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def map_tree(fn, tree):
    """The same tree with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)

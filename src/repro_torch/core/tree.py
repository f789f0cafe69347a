"""Walking the port's param trees: nested dicts and lists of tensors (the
reference uses ``jax.tree_util``)."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

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


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) as ``jax.tree_util`` flattens the reference's tree: dict
    keys sorted, NamedTuple fields in order, names joined by ``/``. A leaf is
    a tensor, a Python or numpy scalar, or, for a list of per-layer dicts, the
    list of its layers' tensors at one path: the reference stacks those on a
    leading L dim (``stacked_shape``)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, list):
        per_layer = [named_leaves(lp) for lp in tree]
        names = [n for n, _ in per_layer[0]]
        if any([n for n, _ in pl] != names for pl in per_layer):
            raise ValueError(f"the layers under {prefix!r} differ in structure")
        return [(prefix + n, [pl[j][1] for pl in per_layer]) for j, n in enumerate(names)]
    else:
        return [(prefix[:-1], tree)]
    return [nl for k, v in items for nl in named_leaves(v, f"{prefix}{k}/")]


def stacked_shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape as the reference holds it: a layer list as (L, ...)."""
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(int(d) for d in leaf[0].shape)
    return tuple(int(d) for d in getattr(leaf, "shape", ()))


def from_names(named: Dict[str, Any]) -> Dict[str, Any]:
    """The nested dict whose ``named_leaves`` are ``named`` (names split on
    ``/``), so a tree of stacked tensors flattens to the names of the
    per-layer tree it mirrors."""
    out: Dict[str, Any] = {}
    for name, leaf in named.items():
        *path, last = name.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out

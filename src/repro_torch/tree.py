"""Nested containers of tensors, walked in the JAX package's order.

The parameter tree, the optimizer's moments and the gradients are
nested dicts and lists of tensors (a ``ParamTree`` module reads as the
dict of its parameters and child modules). ``tree_leaves`` lists the
leaves as ``jax.tree.leaves`` lists a pytree: dict keys sorted, lists in
order; so a checkpoint's ``a{i}`` arrays and an optimizer's updates line
up with the JAX package's leaf for leaf. Tuples are leaves here.
"""
from __future__ import annotations

from typing import Any, Callable

from torch import nn


def as_tree(tree) -> Any:
    """A module as the nested dict of its parameters and child modules
    (a ModuleList as a list); dicts and lists rebuilt with their leaves
    as they are."""
    if isinstance(tree, nn.ModuleList):
        return [as_tree(m) for m in tree]
    if isinstance(tree, nn.Module):
        out = dict(tree._parameters)
        out.update({k: as_tree(m) for k, m in tree._modules.items()})
        return out
    if isinstance(tree, dict):
        return {k: as_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_tree(v) for v in tree]
    return tree


def tree_leaves(tree) -> list:
    """The leaves in JAX's flatten order."""
    tree = as_tree(tree)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has the structure
    of ``tree`` as nested dicts and lists."""
    tree = as_tree(tree)
    rest = [as_tree(r) for r in rest]
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)

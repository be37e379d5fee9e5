"""Nested-dict trees of tensors (params, LoRA adapters, optimizer
moments): the helpers the port needs in place of ``jax.tree``."""
from __future__ import annotations

from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (parallel trees in rest)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_finite(tree: Any) -> bool:
    """True iff every leaf of a (possibly nested) tensor tree is fully
    finite: the publish gate's predicate, so a NaN/Inf-poisoned tree is
    never swapped into serving (one host read per leaf)."""
    if tree is None:
        return True
    return all(bool(torch.isfinite(leaf).all())  # lint: host-sync-ok publish gate, off the decode path
               for leaf in tree_leaves(tree))

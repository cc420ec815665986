"""Minimal functional optimizer substrate, PyTorch port of ``repro.optim.base``.

An ``Optimizer`` is an (init, update) pair over parameter trees (nested
dicts, lists and tuples of tensors)::

    state   = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params  = apply_updates(params, updates)

Updates are *deltas* (already scaled by the learning rate, sign included).
Dict keys are walked in sorted order, as ``jax.tree`` walks them, so a
leaf's index (``tree_leaves``) is the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (updates, state)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree``; each tree of ``rest`` is taken
    up to ``tree``'s structure, so its subtree at a leaf of ``tree`` goes
    to ``fn`` whole (JAX's ``flatten_up_to``). ``None`` is an empty
    subtree, as in JAX."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order (``None`` has none)."""
    out = []
    tree_map(out.append, tree)
    return out


def flatten_up_to(structure, tree) -> list:
    """The subtrees of ``tree`` at the leaves of ``structure``, in order."""
    out = []
    tree_map(lambda _, sub: out.append(sub), structure, tree)
    return out


def unflatten(structure, leaves):
    """A tree of ``structure``'s shape holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), structure)


def donated(donate: bool, olds, news):
    """``news``, or with ``donate`` each written into its old tensor and
    the olds returned: the JAX package's buffer donation (``jit``'s
    ``donate_argnums``), which lets a step reuse its state's memory. The
    caller gives up the state it passed; the values are the same."""
    if not donate:
        return tuple(news)
    with torch.no_grad():
        for old, new in zip(olds, news):
            old.copy_(new)
    return tuple(olds)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p if u is None else p + u.to(p.dtype),
                    params, updates)


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def cast_tree(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)

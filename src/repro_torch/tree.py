"""Nested containers of tensors (the port's pytrees): dicts, NamedTuples,
lists and tuples around leaves.

Leaves are visited in the reference's ``jax.tree`` order: dict keys
sorted, NamedTuple fields and sequence items in order.  That order
matters where a reduction adds the leaves one after another
(:func:`repro_torch.optim.adamw.global_norm`) and where a checkpoint
names them (:mod:`repro_torch.train.checkpoint`).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, path: Tuple = (),
                      is_leaf: Optional[Callable] = None
                      ) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in the reference's order; a path is a tuple of dict
    keys, NamedTuple field names and sequence indices.  ``is_leaf(x)``
    true stops the descent at ``x`` (a spec tuple in a tree of specs)."""
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [lp for k in sorted(tree)
                for lp in leaves_with_paths(tree[k], path + (k,), is_leaf)]
    if _is_namedtuple(tree):
        return [lp for k in tree._fields
                for lp in leaves_with_paths(getattr(tree, k), path + (k,),
                                            is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [lp for i, v in enumerate(tree)
                for lp in leaves_with_paths(v, path + (i,), is_leaf)]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, k),
                                     *(getattr(r, k) for r in rest))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree, values: dict, path: Tuple = ()):
    """``tree``'s structure with each leaf replaced by ``values[path]``."""
    if isinstance(tree, dict):
        return {k: unflatten_like(v, values, path + (k,))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(unflatten_like(getattr(tree, k), values,
                                           path + (k,))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(unflatten_like(v, values, path + (i,))
                          for i, v in enumerate(tree))
    return values[path]

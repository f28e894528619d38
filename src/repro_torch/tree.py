"""Trees of tensors: nested lists, tuples and dicts with tensor leaves.

The port's counterpart of the parts of ``jax.tree_util`` the JAX package
uses.  Parameters keep the JAX layouts (an MLP's list of ``{"w", "b"}``
dicts, a recurrent baseline's nested dicts, an LM's tree), and the
adjoint carries ``(y, a, grad_params)`` tuples, so a structural map over
those containers is all that is needed.  Dict keys are visited
in sorted order, as ``jax.tree_util`` flattens them.
"""
from __future__ import annotations

from typing import Any, Callable

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, x, *[r[i] for r in rest])
                               for i, x in enumerate(tree)])
    return fn(tree, *rest)


def _rebuild(seq, items: list):
    """A list or tuple of ``seq``'s type holding ``items`` (a NamedTuple,
    such as an optimizer state, takes them as its fields)."""
    if isinstance(seq, tuple) and hasattr(seq, "_fields"):
        return type(seq)(*items)
    return type(seq)(items)


def tree_leaves(tree: Tree) -> list:
    """The leaves in flattening order (dict keys sorted, sequences by
    index)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template: Tree, leaves) -> Tree:
    """Rebuild ``template``'s structure from ``leaves`` given in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return _rebuild(t, [build(v) for v in t])
        return next(it)

    return build(template)


def tree_map_with_path(fn: Callable, tree: Tree) -> Tree:
    """``fn(path, leaf)`` leaf by leaf; ``path`` is the tuple of keys from
    the root: a dict's key, a NamedTuple's field name, a list's or tuple's
    index (the JAX package's ``DictKey``, ``GetAttrKey`` and
    ``SequenceKey``)."""
    def walk(path, t):
        if isinstance(t, dict):
            return {k: walk((*path, k), v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return _rebuild(t, [walk((*path, f), v)
                                for f, v in zip(t._fields, t)])
        if isinstance(t, (list, tuple)):
            return _rebuild(t, [walk((*path, i), v)
                                for i, v in enumerate(t)])
        return fn(path, t)

    return walk((), tree)

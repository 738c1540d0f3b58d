"""Tree utilities over the port's nested containers: dicts (walked in
sorted key order, as ``jax.tree`` walks them), lists, tuples and
NamedTuples, with tensors (or any other object) as leaves."""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over matching leaves of ``tree`` and ``rest``, which share
    its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        if hasattr(tree, "_fields"):             # NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` with ``leaves`` (in ``tree_leaves``
    order) in place of its leaves."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            out = [build(x) for x in t]
            return type(t)(*out) if hasattr(t, "_fields") else type(t)(out)
        return next(it)

    return build(like)

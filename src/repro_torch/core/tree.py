"""Nested state trees: the port's counterpart of the ``jax.tree`` calls
the training stack makes.

A tree is made of dicts (children in sorted key order, as ``jax.tree``
orders them), lists and tuples (by index), ``None`` (no leaves), and the
sparse formats ``EllMatrix``/``BsrMatrix`` (their tensors by index, the
logical shape kept from the tree itself); anything else is a leaf. A
leaf's path joins the keys with "/", as ``repro.runtime.checkpoint.
_flatten`` joins them, so the port's checkpoint keys are the reference's
for the same state.
"""
from __future__ import annotations

from repro_torch.core.sparse import BsrMatrix, EllMatrix


def _node(x):
    """(keys, children, rebuild) for an inner node, None for a leaf."""
    if x is None:
        return [], [], lambda kids: None
    if isinstance(x, dict):
        keys = sorted(x)
        return keys, [x[k] for k in keys], lambda kids: dict(zip(keys, kids))
    if isinstance(x, (list, tuple)):
        return list(range(len(x))), list(x), lambda kids: type(x)(kids)
    if isinstance(x, EllMatrix):
        return [0, 1], [x.values, x.cols], lambda kids: EllMatrix(*kids, x.shape)
    if isinstance(x, BsrMatrix):
        return ([0, 1, 2], [x.tile_values, x.tile_rows, x.tile_cols],
                lambda kids: BsrMatrix(*kids, x.shape))
    return None


def flatten_with_paths(tree) -> tuple[list[str], list]:
    """(paths, leaves) in the tree's order."""
    paths, leaves = [], []

    def walk(x, prefix):
        node = _node(x)
        if node is None:
            paths.append("/".join(prefix))
            leaves.append(x)
            return
        for key, kid in zip(node[0], node[1]):
            walk(kid, prefix + [str(key)])

    walk(tree, [])
    return paths, leaves


def leaves(tree) -> list:
    return flatten_with_paths(tree)[1]


def unflatten(like, new_leaves):
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def build(x):
        node = _node(x)
        if node is None:
            return next(it)
        return node[2]([build(kid) for kid in node[1]])

    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and, leaf for leaf, of ``rest``
    (trees of the same structure)."""
    columns = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*columns)])

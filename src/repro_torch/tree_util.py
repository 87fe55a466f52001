"""Trees of tensors in `jax.tree_util`'s order: the port's counterpart of
the flattening the JAX package's optimizer and checkpoints rely on.

A tree is nested dicts, lists, tuples and NamedTuples with tensors (or
numpy arrays) at the leaves.  The order is jax's for the same tree:
NamedTuple and tuple fields and list items in order, dict keys sorted,
`None` no leaf.  So the i-th leaf of a port tree is the i-th leaf of the
JAX package's, and a checkpoint written by either package restores leaf
for leaf in the other.
"""
from __future__ import annotations

__all__ = ["tree_map", "leaves_with_paths", "leaves", "unflatten", "keystr"]


def tree_map(fn, tree):
    """`fn` of every leaf, in a tree of the same structure (dicts keep
    their key order; `None` stays `None`)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def leaves_with_paths(tree, path: tuple = ()) -> list:
    """[(path, leaf)] in jax's flatten order; a path is the tuple of dict
    keys and sequence indices from the root."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_paths(v, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> list:
    """The leaves of `tree` in jax's flatten order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, values):
    """A tree shaped like `like` holding `values` (a sequence in jax's
    flatten order, one value a leaf) at its leaves; each dict keeps
    `like`'s key order."""
    values = list(values)
    if len(values) != len(leaves(like)):
        raise ValueError(f"{len(values)} values for a tree of "
                         f"{len(leaves(like))} leaves")
    it = iter(values)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            done = {k: build(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def keystr(path: tuple) -> str:
    """`jax.tree_util.keystr` of a path of dict keys and sequence indices,
    e.g. "['segments'][0][0]['attn']['wq']"."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)

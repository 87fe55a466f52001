"""Paths and leaves of a nested dict/list of tensors, in sorted-key order
(the order in which the port's optimizer walks its state)."""
from __future__ import annotations


def flatten(tree, prefix: str = "") -> list:
    """[(path, leaf)]: dict keys sorted, list items in order; a path joins
    the keys and indices with "/" (e.g. "segments/0/0/attn/wq")."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flatten(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]

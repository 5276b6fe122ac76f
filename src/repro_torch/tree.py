"""Nested dicts of tensors as the reference's pytrees.

The port keeps parameters, optimizer state and checkpoints as nested dicts
with the reference's key paths.  ``jax.tree`` flattens a dict in sorted key
order; :func:`flatten` does the same, so a sum over leaves (the global
gradient norm) adds them in the reference's order and a checkpoint's keys
are the reference's ``/``-joined paths.
"""

from __future__ import annotations


def flatten(tree, prefix: str = "") -> dict:
    """{``/``-joined key path: leaf}, depth first in sorted key order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat: dict) -> dict:
    """The nested dict of a :func:`flatten` mapping."""
    out: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def leaves(tree) -> list:
    """The leaves in :func:`flatten` order (``jax.tree.leaves``)."""
    return list(flatten(tree).values())


def tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict, structure kept."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}

"""Path names of the leaves of the port's state trees.

The port's copy of what ``repro/utils/tree.py`` gives the checkpoints:
``flatten_path`` and ``named_leaves``.  A tree is a dataclass (fields in
declaration order), a dict (keys sorted, as JAX flattens them) or a leaf
(a tensor or a number); ``None`` has no leaves.
The names are the JAX package's (``.local/ii``, ``.comm/acc``), so a
checkpoint written by either package reads in the other.
"""
from __future__ import annotations

import dataclasses


def flatten_path(path) -> str:
    """``/``-joined path parts: ``.field`` for a dataclass field, the key
    for a dict."""
    return "/".join(str(p) for p in path)


def named_leaves(tree, path=()):
    """Yield ``(path_string, leaf)`` pairs in the JAX package's order."""
    if tree is None:
        return
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from named_leaves(getattr(tree, f.name),
                                    path + (f".{f.name}",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], path + (k,))
    else:
        yield flatten_path(path), tree

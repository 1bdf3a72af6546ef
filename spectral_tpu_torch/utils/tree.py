"""Nested containers of tensors in the JAX package's pytree order.

``jax.tree_util`` flattens a dict in sorted key order and a tuple or list in
its own order, and takes ``None`` for an empty node; ``torch.utils._pytree``
keeps a dict's insertion order.  Checkpoints, finite-value checks and the
Jacobi PC walk states through these functions, so a ``{"v", "p"}`` state
has its leaves as ``p`` then ``v`` in both packages, and the paths and
structure strings read as ``jax.tree_util.keystr`` and ``str(treedef)``
print them.
"""

from __future__ import annotations

from typing import Any, Callable


def _children(node):
    """(keys, children) of a container, or None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return [f"[{k!r}]" for k in keys], [node[k] for k in keys]
    if isinstance(node, (tuple, list)):
        return [f"[{i}]" for i in range(len(node))], list(node)
    if node is None:
        return [], []
    return None


def leaves_with_path(tree) -> list[tuple[str, Any]]:
    """[(keystr path, leaf), ...] in the JAX package's order."""
    kids = _children(tree)
    if kids is None:
        return [("", tree)]
    return [(key + path, leaf) for key, child in zip(*kids)
            for path, leaf in leaves_with_path(child)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def structure(tree) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))`` prints it."""

    def node(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            inner = ", ".join(node(c) for c in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(node(c) for c in t) + "]"
        return "None" if t is None else "*"

    return f"PyTreeDef({node(tree)})"


def unflatten(like, new_leaves: list):
    """A tree of ``like``'s structure holding ``new_leaves`` (JAX order)."""
    new_leaves = list(new_leaves)
    if len(new_leaves) != len(leaves(like)):
        raise ValueError(f"{len(new_leaves)} leaves for the structure {structure(like)}")
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}   # the caller's key order
        if isinstance(node, (tuple, list)):
            return type(node)(build(c) for c in node)
        if node is None:
            return None
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to trees of one structure."""
    return unflatten(tree, [fn(*ls) for ls in zip(leaves(tree), *map(leaves, rest))])

"""Trees of tensors: nested dicts, lists and tuples, with anything else a
leaf.  One walk order for the whole port, the reference's pytrees': a
dict's keys sorted, a sequence in order.
"""

from __future__ import annotations

from typing import Any


def tree_leaves(tree, up_to=None) -> list:
    """The leaves of ``tree`` in order.  With ``up_to``, a tree that
    ``tree`` extends: each of its leaves names the whole subtree of
    ``tree`` in its place (Adafactor's ``{vr, vc}`` per parameter)."""
    node = tree if up_to is None else up_to
    if isinstance(node, dict):
        keys = sorted(node)
    elif isinstance(node, (list, tuple)):
        keys = range(len(node))
    else:
        return [tree]
    return [x for k in keys for x in tree_leaves(
        tree[k], None if up_to is None else up_to[k])]


def tree_unflatten(like, leaves) -> Any:
    """``like``'s structure (its dicts' key order kept) holding ``leaves``
    in ``tree_leaves`` order; a leaf may itself be a tree."""
    return _build(like, iter(leaves))


def _build(node, it):
    # a module function, not a closure: a closure that calls itself is a
    # reference cycle, which would keep ``leaves`` alive until the
    # collector runs (on the card, a whole parameter tree)
    if isinstance(node, dict):
        out = {k: _build(node[k], it) for k in sorted(node)}
        return {k: out[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def tree_map(fn, tree, *rest):
    """``fn`` of each leaf of ``tree`` and the leaves in its place in
    ``rest`` (trees of the same structure)."""
    leaves = [tree_leaves(t) for t in (tree,) + rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])


def path_to_str(path) -> str:
    """A leaf's key path as the reference names it: keys joined by ``/``."""
    return "/".join(str(p) for p in path)


def tree_paths(tree, prefix=()) -> list:
    """The path string of every leaf, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
    elif isinstance(tree, (list, tuple)):
        keys = range(len(tree))
    else:
        return [path_to_str(prefix)]
    return [p for k in keys for p in tree_paths(tree[k], prefix + (k,))]


def flatten_with_paths(tree, prefix=()) -> dict:
    """``{path string: leaf}``, a sequence's keys its indices."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path_to_str(prefix): tree}
    out = {}
    for key, sub in items:
        out.update(flatten_with_paths(sub, prefix + (key,)))
    return out


__all__ = ["tree_leaves", "tree_unflatten", "tree_map", "path_to_str",
           "tree_paths", "flatten_with_paths"]

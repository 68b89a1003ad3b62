"""Minimal pytree helpers over nested dicts and lists.

The flatten order is ``jax.tree.flatten``'s: dict keys sorted, lists in
order.  Only dicts and lists are nodes; a tuple is a leaf (a partition
spec is one).  The bucket plan identifies leaves by their flat index, so this
order is part of the contract with the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


# The walkers are module-level functions, not closures: a closure that
# calls itself is a reference cycle, and would keep every leaf it saw (a
# train step's parameters and optimizer state) alive until the next
# garbage collection.

def _walk(node, path, out) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (k,), out)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _walk(v, path + (i,), out)
    else:
        out.append((path, node))


def flatten_with_path(tree) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in flatten order; a path holds dict keys and list
    indices from the root."""
    out: List[Tuple[Tuple, Any]] = []
    _walk(tree, (), out)
    return out


def keystr(path: Tuple) -> str:
    """``("params", "segments", 0)`` -> ``['params']['segments'][0]``,
    ``jax.tree_util.keystr``'s form of the same path."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def flatten(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def _walk_up_to(node, sub, out) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _walk_up_to(node[k], sub[k], out)
    elif isinstance(node, list):
        for v, s in zip(node, sub):
            _walk_up_to(v, s, out)
    else:
        out.append(sub)


def flatten_up_to(like, tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``like`` (e.g. the
    per-leaf ``{"master", "m", "v"}`` dicts of an optimizer state)."""
    out: List[Any] = []
    _walk_up_to(like, tree, out)
    return out


def _build(node, it) -> Any:
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, list):
        return [_build(v, it) for v in node]
    return next(it)


def unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in flatten order."""
    it = iter(leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    flats = [flatten(t) for t in (tree,) + rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*flats)])


def map_with_path(fn: Callable, tree) -> Any:
    return unflatten(tree, [fn(p, x) for p, x in flatten_with_path(tree)])

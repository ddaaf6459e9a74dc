"""Nested containers of tensors walked in the JAX package's order.

`jax.tree.leaves` visits a dict's keys sorted, a NamedTuple's fields and
a tuple's or list's items in order; `tree_flatten_with_path` names each
leaf by its keys, "['params']/['layers']/['attn']/['wq']" for dicts and
".m" for a NamedTuple field. The port's optimizer sums its global norm
over the leaves in that order (ROADMAP hazard 61), and its checkpoints
name their arrays by those paths, so a directory written by either
package restores in the other. None is an empty subtree, as in JAX.
The walks are module-level functions, not closures that call
themselves: such a closure is a reference cycle that keeps its leaves
(a training step's parameters, moments, gradients) alive until Python's
cycle collector runs, tens of GB on the card at mamba2-1.3B's step.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(node, parts, out) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for key in sorted(node):
            _walk(node[key], parts + [f"[{key!r}]"], out)
    elif _is_namedtuple(node):
        for name in node._fields:
            _walk(getattr(node, name), parts + [f".{name}"], out)
    elif isinstance(node, (tuple, list)):
        for i, item in enumerate(node):
            _walk(item, parts + [f"[{i}]"], out)
    else:
        out.append(("/".join(parts), node))


def flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's leaf order, each path as
    `tree_flatten_with_path` prints it, parts joined by "/"."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, [], out)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def _build(node, it):
    if node is None:
        return None
    if isinstance(node, dict):
        built = {key: _build(node[key], it) for key in sorted(node)}
        return {key: built[key] for key in node}  # the caller's key order
    if _is_namedtuple(node):
        return type(node)(*(_build(getattr(node, name), it) for name in node._fields))
    if isinstance(node, (tuple, list)):
        return type(node)(_build(item, it) for item in node)
    return next(it)


def tree_unflatten(like, leaves) -> Any:
    """A tree of `like`'s structure holding `leaves`, given in JAX's order."""
    it = iter(leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree) -> Any:
    """fn over the leaves of `tree`, in a tree of the same structure."""
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])

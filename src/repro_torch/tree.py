"""Trees of tensors: the port's counterpart of JAX pytrees.

A tree is a nested dict, tuple, list or NamedTuple with tensor (or
array) leaves; None is an empty subtree. Leaves go in the reference's
order (dict keys sorted, sequences in order), which the optimizer, the
train step and the checkpoint format all rely on, so that a checkpoint
of either package restores into the other.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

Tree = Any


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(dotted path, leaf) pairs in leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), t) for i, t in enumerate(tree)]
    else:
        return [(prefix or "leaf", tree)]
    return [x for k, t in items
            for x in leaves_with_paths(t, f"{prefix}.{k}" if prefix else k)]


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def _build(template: Tree, it) -> Tree:
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _build(template[k], it) for k in sorted(template)}
    if _is_namedtuple(template):
        return type(template)(*(_build(x, it) for x in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_build(x, it) for x in template)
    return next(it)


def unflatten(template: Tree, new_leaves: Iterable) -> Tree:
    """A tree shaped like ``template`` holding ``new_leaves`` in leaf
    order. The recursion is a module-level function: a nested closure
    that calls itself is a reference cycle, which would hold
    ``new_leaves`` (a step's gradients) until a pass of the garbage
    collector."""
    return _build(template, iter(new_leaves))


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over corresponding leaves of trees shaped like ``tree``."""
    flat = [leaves(t) for t in (tree,) + rest]
    return unflatten(tree, (fn(*xs) for xs in zip(*flat)))

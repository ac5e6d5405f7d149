"""Trees of tensors: the reference's pytrees as nested dicts, lists and
tuples.

Leaves come in the reference's order (``jax.tree_util``): dict keys
sorted, sequences by index.  ``None`` is an empty subtree, not a leaf.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Tuple


def _walk(node, prefix, paths: List[str], leaves: List[Any]):
    """The tree's template: its structure with each leaf replaced by its
    index in ``leaves``."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _walk(node[k], prefix + (str(k),), paths, leaves)
                for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        seq = [_walk(v, prefix + (str(i),), paths, leaves) for i, v in enumerate(node)]
        return tuple(seq) if isinstance(node, tuple) else seq
    paths.append("/".join(prefix))
    leaves.append(node)
    return len(leaves) - 1


def _build(template, new_leaves: List[Any]):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _build(v, new_leaves) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        seq = [_build(v, new_leaves) for v in template]
        return tuple(seq) if isinstance(template, tuple) else seq
    return new_leaves[template]


def tree_flatten_with_paths(tree) -> Tuple[List[str], List[Any],
                                           Callable[[List[Any]], Any]]:
    """(paths, leaves, unflatten) of a dict/list/tuple tree.  The paths are
    the reference's (``jax.tree_util.tree_flatten_with_path``): dict keys in
    sorted order, a sequence index as its number, joined by ``/``; ``None``
    is an empty subtree, not a leaf.

    The walkers are module functions, not closures over themselves: a
    recursive closure is a reference cycle, and one that held the leaves
    would keep a train step's old params and moments alive until the
    cycle collector ran."""
    paths: List[str] = []
    leaves: List[Any] = []
    template = _walk(tree, (), paths, leaves)
    return paths, leaves, functools.partial(_build, template)


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten_with_paths(tree)[1]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in
    ``tree_leaves`` order)."""
    return tree_flatten_with_paths(like)[2](leaves)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of ``rest`` (trees of the same
    structure), in one tree of that structure."""
    _, leaves, unflatten = tree_flatten_with_paths(tree)
    others = [tree_leaves(r) for r in rest]
    return unflatten([fn(*xs) for xs in zip(leaves, *others)])

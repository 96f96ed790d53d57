"""Trees: nested dicts, lists and tuples, as the port keeps its parameters,
optimizer state, batches and collective payloads.  Leaves are taken in
insertion order (JAX sorts dict keys; nothing here depends on the order
beyond :func:`leaves` and :func:`unflatten` agreeing)."""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree: Any) -> List[Any]:
    """The leaves in order: everything that is not a dict, list or tuple."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(tree: Any, new_leaves: List[Any]) -> Any:
    """``tree``'s structure with ``new_leaves`` in :func:`leaves`' order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``, leaf by leaf."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others)])

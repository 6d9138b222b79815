"""Trees of tensors: nested dicts and lists, as the port keeps its
parameters and optimizer state (the JAX package's pytrees).

Dict keys are visited in sorted order, as ``jax.tree_util`` visits a
dict's, and a path joins dict keys and list indices, so a tree of the same
structure flattens to the same leaves, in the same order, under the same
keys in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Mapping, Tuple


def leaves_with_paths(tree: Any, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) for every leaf; ``None`` is an empty subtree."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from leaves_with_paths(tree[key], prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from leaves_with_paths(sub, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def path_key(path: Tuple) -> str:
    """The checkpoint key of a path: dict keys and list indices joined by '/'."""
    return "/".join(str(p) for p in path)


def map_with_paths(fn: Callable, tree: Any, prefix: Tuple = ()) -> Any:
    """A tree of ``tree``'s structure whose leaf at each path is fn(path, leaf)."""
    if isinstance(tree, Mapping):
        return {k: map_with_paths(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, prefix + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to trees of one structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)

"""Helpers over trees of tensors (nested dicts), as `repro.utils.tree`:
its counts, maps and arithmetic (`tree_param_count`, `tree_size_bytes`,
`tree_map_with_path_str`, `tree_cast`, `tree_zeros_like`, `tree_add`,
`tree_scale`, `tree_norm`), and the port's own stack helpers for JAX's
stacked-layer layout. A leaf is anything that is not a dict; the counts
read any leaf with a `shape` (and `dtype`), as JAX's read arrays and
shape structs."""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

# where a per-layer leaf lies in a stacked tree: (its stacked key, its
# index on the leading axis), or None for a leaf that is not per layer
Where = Callable[[str], Optional[Tuple[str, int]]]


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        for value in tree.values():
            yield from tree_leaves(value)
    else:
        yield tree


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of `tree` (and the matching leaves of `rest`),
    keeping the dicts' keys and order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_param_count(tree: Any) -> int:
    """Total number of scalar parameters in a tree (a leaf without a
    shape counts 1)."""
    return int(sum(math.prod(t.shape) if hasattr(t, "shape") else 1
                   for t in tree_leaves(tree)))


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return dtype.itemsize          # a numpy dtype


def tree_size_bytes(tree: Any) -> int:
    """Bytes of every leaf with a shape and a dtype (torch or numpy)."""
    return int(sum(math.prod(t.shape) * _itemsize(t.dtype)
                   for t in tree_leaves(tree)
                   if hasattr(t, "shape") and hasattr(t, "dtype")))


def tree_map_with_path_str(fn: Callable, tree: Any, *rest: Any,
                           _path: str = "") -> Any:
    """`tree_map` with fn(path, leaf, *rest_leaves), the path the
    "/"-joined keys down to the leaf (JAX's `_path_str` of dict keys)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path_str(
            fn, v, *(r[k] for r in rest),
            _path=f"{_path}/{k}" if _path else str(k))
            for k, v in tree.items()}
    return fn(_path, tree, *rest)


def tree_cast(tree: Any, dtype: torch.dtype) -> Any:
    """Floating leaves cast to `dtype`; others as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def tree_zeros_like(tree: Any, dtype: Optional[torch.dtype] = None) -> Any:
    """Zeros of each leaf's shape, in `dtype` or the leaf's, on its
    device."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype or x.dtype,
                                          device=x.device), tree)


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(torch.add, a, b)


def tree_scale(tree: Any, s) -> Any:
    return tree_map(lambda x: x * s, tree)


def tree_norm(tree: Any) -> torch.Tensor:
    """Global L2 norm of a tree of tensors, in fp32 (0-d tensor on the
    leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree_leaves(tree)))


def stack_leaves(flat: Dict[str, torch.Tensor], where: Where
                 ) -> Dict[str, torch.Tensor]:
    """Flat leaves -> stacked ones: the per-layer leaves of each stacked
    key (`where`) stacked along a new leading axis, in index order, at
    the place of the first of them; other keys pass unchanged, in
    order. The layout of JAX trees whose layers are a `vmap`ped init."""
    out: Dict[str, Any] = {}
    parts: Dict[str, Dict[int, torch.Tensor]] = {}
    for key, leaf in flat.items():
        at = where(key)
        if at is None:
            out[key] = leaf
            continue
        if at[0] not in parts:
            parts[at[0]] = {}
            out[at[0]] = None                    # keeps the key's place
        parts[at[0]][at[1]] = leaf
    for key, by_index in parts.items():
        out[key] = torch.stack([by_index[n] for n in range(len(by_index))])
    return out


def unstack_leaves(flat: Dict[str, Any], like, where: Where
                   ) -> Dict[str, Any]:
    """The inverse of `stack_leaves`: the keys of `like` (per-layer),
    each read from `flat` (stacked) at its index."""
    out = {}
    for key in like:
        at = where(key)
        out[key] = flat[key] if at is None else flat[at[0]][at[1]]
    return out


def prefixed(prefix: str, flat: Dict[str, Any]) -> Dict[str, Any]:
    """{f"{prefix}/{key}": value} of a flat "/"-keyed dict."""
    return {f"{prefix}/{k}": v for k, v in flat.items()}

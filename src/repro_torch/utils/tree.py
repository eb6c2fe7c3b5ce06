"""Helpers over trees of tensors (nested dicts), as `repro.utils.tree`."""
from __future__ import annotations

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

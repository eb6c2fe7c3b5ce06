"""Helpers over trees of tensors (nested dicts), as `repro.utils.tree`."""
from __future__ import annotations

from typing import Any, Iterator

import torch


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

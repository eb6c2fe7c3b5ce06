"""JAX parameter trees (as numpy) -> the port's modules.

A tree is what `jax.tree_util.tree_map(np.asarray, params)` gives for the
parameters of `repro.core.bbe.bbe_init` or `repro.core.signature.
signature_init`: nested dicts and lists of numpy arrays. The port's
modules name their parameters after the tree's keys and keep the JAX
layout of dense weights ((d_in, d_out), applied as x @ w), so the tree
maps onto `state_dict` keys by path, with two layout changes:

  * `blocks` of the Stage-1 encoder carries a leading `num_layers` axis
    (`bbe_init` builds it with `jax.vmap`); it is unstacked into the
    `blocks` ModuleList, one layer per index;
  * lists (`embeds`, the Stage-2 `sabs`) become numbered entries.

Loading is strict: a missing or extra leaf, or a shape that differs,
raises. Nothing here imports jax.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.bbe import BBEConfig, BBEEncoder
from repro_torch.core.signature import SignatureConfig, SignatureModel


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flatten(value, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _flatten(value, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _load(module: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    state = module.state_dict()
    missing = sorted(set(state) - set(flat))
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise KeyError(f"parameter tree does not match the module: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    for key, value in flat.items():
        if tuple(value.shape) != tuple(state[key].shape):
            raise ValueError(f"{key}: tree shape {value.shape} vs module "
                             f"shape {tuple(state[key].shape)}")
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v, np.float32)) for k, v in flat.items()},
        strict=True)
    return module


def bbe_params_from_jax(tree: Dict[str, Any], cfg: BBEConfig) -> BBEEncoder:
    """Stage-1 encoder with the weights of a `bbe_init` tree (CPU)."""
    flat = dict(_flatten({k: v for k, v in tree.items() if k != "blocks"}))
    for key, stacked in _flatten(tree["blocks"]):
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(f"blocks.{key}: leading axis {stacked.shape[0]}"
                             f" != num_layers {cfg.num_layers}")
        for layer in range(cfg.num_layers):
            flat[f"blocks.{layer}.{key}"] = stacked[layer]
    return _load(BBEEncoder(cfg), flat)


def signature_params_from_jax(tree: Dict[str, Any], cfg: SignatureConfig
                              ) -> SignatureModel:
    """Stage-2 model with the weights of a `signature_init` tree (CPU)."""
    return _load(SignatureModel(cfg), dict(_flatten(tree)))

"""Weights drawn from the seed on the device, in a few large calls.

One generator on the device draws every leaf's normals as a single
tensor; each leaf takes its slice, scaled by its kind, and is cast to the
dtype the model stores it in. The same tensors go to the system (through
`load_state_dict`) and to the reference.

Kinds, by the leaf's last name: norm scales and `ln_x` 1 + 0.1 n;
biases 0.02 n; token-shift mixes `mu` 0.5 + 0.1 n; the decay bias
`w_bias` -2 + 0.5 n; embedding tables, `ww` and `wbeta` 0.02 n; the
pool's `ua` 0.1 n; Set Transformer seeds 0.5 n; every other matrix n
over the square root of its fan-in.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _scaled(name: str, n: torch.Tensor, shape: Tuple[int, ...]):
    leaf = name.rsplit(".", 1)[-1]
    parent = name.split(".")[-2] if "." in name else ""
    if leaf in ("scale", "ln_x"):
        return 1.0 + 0.1 * n
    if leaf in ("bias", "b", "ba", "b1", "b2"):
        return 0.02 * n
    if leaf == "mu":
        return 0.5 + 0.1 * n
    if leaf == "w_bias":
        return -2.0 + 0.5 * n
    if parent == "embeds" or leaf in ("ww", "wbeta"):
        return 0.02 * n
    if leaf == "ua":
        return 0.1 * n
    if leaf == "seeds":
        return 0.5 * n
    return n / math.sqrt(shape[0] if len(shape) > 1 else shape[-1])


def draw(like: Dict[str, torch.Tensor], seed: int, device
         ) -> Dict[str, torch.Tensor]:
    """{name: tensor} with the names, shapes and dtypes of `like` (a
    state dict, on any device), drawn from `seed` on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [t.numel() for t in like.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, t), part in zip(like.items(), flat.split(sizes)):
        out[name] = _scaled(name, part.view(t.shape), tuple(t.shape)
                            ).to(t.dtype)
    return out

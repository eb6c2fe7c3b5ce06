"""Core layers as `nn.Module`s, fp32.

Weights keep the JAX package's layout: a dense weight is stored
(d_in, d_out) and applied as `x @ w`, and parameter names follow the keys
of the JAX parameter trees, so `repro_torch.bridge` maps a tree onto a
module by name alone. Initial values are drawn from a CPU
`torch.Generator`, so one seed gives the same weights on every device.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def init_array(gen: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None) -> torch.Tensor:
    """Fan-in scaled normal (scale 1/sqrt(shape[0]) unless given), drawn
    on the CPU from `gen`."""
    if scale is None:
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
        scale = 1.0 / math.sqrt(max(1, fan_in))
    return torch.randn(tuple(shape), generator=gen) * scale


def param(value: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(value.float())


class Dense(nn.Module):
    """x @ w (+ b); w is (d_in, d_out)."""

    def __init__(self, gen: torch.Generator, d_in: int, d_out: int,
                 bias: bool = False, scale: Optional[float] = None):
        super().__init__()
        self.w = param(init_array(gen, (d_in, d_out), scale))
        self.b = param(torch.zeros(d_out)) if bias else None

    def forward(self, x):
        y = x @ self.w
        return y if self.b is None else y + self.b


def rmsnorm(x, scale, eps: float = 1e-6):
    """fp32 math, as `repro.models.layers.rmsnorm_apply`."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-6):
    """fp32 math, as `repro.models.layers.layernorm_apply`."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = param(torch.ones(d))

    def forward(self, x):
        return rmsnorm(x, self.scale)


class LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = param(torch.ones(d))
        self.bias = param(torch.zeros(d))

    def forward(self, x):
        return layernorm(x, self.scale, self.bias)

"""Core layers as `nn.Module`s.

The Stage-1/2 modules (`Dense`, `RMSNorm`, `LayerNorm` by default) hold
fp32 parameters; the LM zoo's (`Embed`, `MLP`, `RMSNorm(dtype=...)`) hold
them in the config's `param_dtype` (bf16 for the real configs) and
follow the JAX code's dtype promotions. Weights keep the JAX package's layout: a dense weight is stored
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
    return torch.randn(tuple(shape), generator=gen).mul_(scale)


def require_float32(field: str, dtype: str) -> None:
    """Raises NotImplementedError unless `dtype` is "float32". The Stage-1
    and Stage-2 modules hold fp32 parameters and their CUDA kernels take
    fp32 only: bf16 Stage 1 / Stage 2 is not ported yet."""
    if dtype != "float32":
        raise NotImplementedError(
            f"{field} = {dtype!r}: bf16 Stage 1 / Stage 2 is not ported "
            f"yet; only \"float32\" is")


def param(value: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> nn.Parameter:
    return nn.Parameter(value.to(dtype))


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
    def __init__(self, d: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-6):
        super().__init__()
        self.scale = param(torch.ones(d), dtype)
        self.eps = eps

    def forward(self, x):
        return rmsnorm(x, self.scale, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = param(torch.ones(d))
        self.bias = param(torch.zeros(d))

    def forward(self, x):
        return layernorm(x, self.scale, self.bias)


# ----------------------------------------------------------------------------
# LM zoo: embeddings, rotary positions, MLP (params in the config's dtype)
# ----------------------------------------------------------------------------

class Embed(nn.Module):
    """(vocab, d) table, N(0, 0.02^2) as `repro.models.layers.embed_init`;
    the input embedding and (tied or not) the LM head."""

    def __init__(self, gen: torch.Generator, vocab: int, d: int,
                 dtype: torch.dtype):
        super().__init__()
        self.table = param(init_array(gen, (vocab, d), scale=0.02), dtype)


def embed(table, ids):
    """Rows of `table` for `ids`, clamped into range as
    `jnp.take(..., mode="clip")` does."""
    return table[ids.clamp(0, table.shape[0] - 1)]


def unembed(table, x):
    """Logits projection x @ table^T, in x's dtype."""
    return x @ table.to(x.dtype).T


def rope(x, positions, theta: float = 10000.0):
    """x: (..., seq, heads, head_dim), positions: broadcastable to
    (..., seq). Angles in fp32; x1 * cos etc. promote to fp32 as in JAX,
    and the result is cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    angles = positions[..., None].float() * freqs   # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]            # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class MLP(nn.Module):
    """SwiGLU (gated) or GELU MLP, as `repro.models.layers.mlp_apply`;
    weights (d_in, d_out) cast to x's dtype."""

    def __init__(self, gen: torch.Generator, d_model: int, d_ff: int,
                 dtype: torch.dtype, gated: bool = True):
        super().__init__()
        self.gated = gated
        self.wi = param(init_array(gen, (d_model, d_ff)), dtype)
        if gated:
            self.wg = param(init_array(gen, (d_model, d_ff)), dtype)
        self.wo = param(init_array(gen, (d_ff, d_model)), dtype)
        if not gated:
            self.bi = param(torch.zeros(d_ff), dtype)
            self.bo = param(torch.zeros(d_model), dtype)

    def forward(self, x):
        dt = x.dtype
        if self.gated:
            g = x @ self.wg.to(dt)
            h = (g * torch.sigmoid(g)) * (x @ self.wi.to(dt))  # silu(g) * up
            return h @ self.wo.to(dt)
        h = torch.nn.functional.gelu(x @ self.wi.to(dt) + self.bi.to(dt),
                                     approximate="tanh")
        return h @ self.wo.to(dt) + self.bo.to(dt)

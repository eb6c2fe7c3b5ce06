"""Core layers as `nn.Module`s.

Every module holds its parameters in a dtype it is given: fp32 or bf16
(`BBEConfig.dtype` / `SignatureConfig.dtype` for Stage 1 and Stage 2, the
config's `param_dtype` for the LM zoo), fp32 by default, and follows the
JAX code's dtype casts and promotions (`matmul`). Weights keep the JAX package's layout: a dense weight is stored
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


def torch_dtype(name: str) -> torch.dtype:
    """"bfloat16" / "float32" (a config's dtype field) -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def param(value: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> nn.Parameter:
    return nn.Parameter(value.to(dtype))


def matmul(x, w):
    """x @ w as JAX computes it for operands of two dtypes: both promoted
    to `torch.promote_types` of theirs (fp32 activations on bf16 weights
    give fp32; torch's `@` would refuse the pair)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def gelu(x):
    """`jax.nn.gelu` (its tanh form). In fp32 torch's fused kernel; in bf16
    (`_LowPrecisionGelu`) JAX's steps, each rounded to bf16, both ways."""
    if x.dtype == torch.float32:
        return torch.nn.functional.gelu(x, approximate="tanh")
    return _LowPrecisionGelu.apply(x)


def _gelu_steps(x):
    """The forward steps of `jax.nn.gelu` in x's dtype, its constants
    rounded to it: (y, x^2, tanh(.), 0.5 (1 + tanh(.)))."""
    const = lambda c: torch.tensor(c, dtype=x.dtype)  # noqa: E731
    x2 = x * x
    t = torch.tanh(const(math.sqrt(2 / math.pi))
                   * (x + const(0.044715) * (x2 * x)))
    half = (t + const(1.0)) * const(0.5)
    return x * half, x2, t, half


class _LowPrecisionGelu(torch.autograd.Function):
    """`jax.nn.gelu` in bf16 as JAX's compiled code computes it: the
    forward's steps and the backward's (the transpose JAX derives from
    them), each rounded to x's dtype in the order of XLA's fusion, so the
    gradient too is JAX's and not autograd's own order of roundings."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_steps(x)[0]

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        const = lambda c: torch.tensor(c, dtype=x.dtype)  # noqa: E731
        _, x2, t, half = _gelu_steps(x)
        go = (x * g) * const(0.5)
        q = go * (const(1.0) - t)
        gs = (q + q * t) * const(math.sqrt(2 / math.pi))   # tanh's transpose
        gp = gs * const(0.044715)
        return (g * half + gs) + gp * (x2 * const(3.0))


class Dense(nn.Module):
    """x @ w (+ b); w is (d_in, d_out). As `repro.models.layers.
    dense_apply`: the product promoted (`matmul`), the bias added in the
    product's dtype."""

    def __init__(self, gen: torch.Generator, d_in: int, d_out: int,
                 bias: bool = False, scale: Optional[float] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w = param(init_array(gen, (d_in, d_out), scale), dtype)
        self.b = param(torch.zeros(d_out), dtype) if bias else None

    def forward(self, x):
        y = matmul(x, self.w)
        return y if self.b is None else y + self.b.to(y.dtype)


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
    def __init__(self, d: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = param(torch.ones(d), dtype)
        self.bias = param(torch.zeros(d), dtype)

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


# ---------------------------------------------------------------------------
# logical-axis specs (`repro_torch.distributed.sharding`): flat {"/"-joined
# parameter name: tuple of logical axes}, from the JAX init functions'
# spec dicts
# ---------------------------------------------------------------------------

def dense_specs(bias: bool = False, in_axis: Optional[str] = "embed",
                out_axis: Optional[str] = "ff") -> dict:
    specs = {"w": (in_axis, out_axis)}
    if bias:
        specs["b"] = (out_axis,)
    return specs


def rmsnorm_specs(axis: str = "embed_act") -> dict:
    return {"scale": (axis,)}


def layernorm_specs(axis: str = "embed_act") -> dict:
    return {"scale": (axis,), "bias": (axis,)}


def embed_specs() -> dict:
    return {"table": ("vocab", "embed")}


def mlp_specs(gated: bool = True) -> dict:
    if gated:
        return {"wi": ("embed", "ff"), "wg": ("embed", "ff"),
                "wo": ("ff", "embed")}
    return {"wi": ("embed", "ff"), "wo": ("ff", "embed"),
            "bi": ("ff",), "bo": ("embed",)}

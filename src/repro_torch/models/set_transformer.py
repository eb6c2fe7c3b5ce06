"""Set Transformer (Lee et al. 2019) for Stage-2 aggregation (paper §III-B).

Encoder = stacked SABs, decoder = PMA with learned seed vectors; no
positional information, masks handle padding. The per-element
log-frequency is (a) concatenated to the input features and (b) added as
an attention-logit bias on keys. Port of `repro.models.set_transformer`;
every attention goes through the set-attention wrapper
(`repro_torch.kernels.set_attention`).

Parameters are in the dtype given (`SignatureConfig.dtype`); the dtypes of
the activations follow JAX's: the attention's weights are cast to the
queries' dtype, a `Dense` promotes (so fp32 inputs on bf16 weights run
in fp32, and bf16 inputs in bf16).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.set_attention.ops import masked_set_attention
from repro_torch.models.layers import (
    Dense, LayerNorm, dense_specs, gelu, init_array, layernorm_specs, param,
)
from repro_torch.utils.tree import prefixed


class MHA(nn.Module):
    def __init__(self, gen: torch.Generator, d: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.wq = param(init_array(gen, (d, d)), dtype)
        self.wk = param(init_array(gen, (d, d)), dtype)
        self.wv = param(init_array(gen, (d, d)), dtype)
        self.wo = param(init_array(gen, (d, d)), dtype)

    def forward(self, xq, xk, key_bias=None, key_mask=None):
        """xq: (B,N,d), xk: (B,M,d); key_bias: (B,M) additive logit bias;
        key_mask: (B,M) valid flags. The weights take xq's dtype, as
        `_mha_apply` casts them."""
        B, N, d = xq.shape
        M = xk.shape[1]
        H = self.num_heads
        dh = d // H
        dt = xq.dtype
        heads = lambda t, n: t.reshape(B, n, H, dh).transpose(1, 2).contiguous()  # noqa: E731
        q = heads(xq @ self.wq.to(dt), N)
        k = heads(xk @ self.wk.to(dt), M)
        v = heads(xk @ self.wv.to(dt), M)
        o = masked_set_attention(q, k, v, key_bias, key_mask)
        return o.transpose(1, 2).reshape(B, N, d) @ self.wo.to(dt)


class MAB(nn.Module):
    def __init__(self, gen: torch.Generator, d: int, num_heads: int,
                 d_ff: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mha = MHA(gen, d, num_heads, dtype)
        self.ff1 = Dense(gen, d, d_ff, bias=True, dtype=dtype)
        self.ff2 = Dense(gen, d_ff, d, bias=True, dtype=dtype)
        self.norm1 = LayerNorm(d, dtype)
        self.norm2 = LayerNorm(d, dtype)

    def forward(self, xq, xk, key_bias=None, key_mask=None):
        h = self.norm1(xq + self.mha(xq, xk, key_bias, key_mask))
        # jax.nn.gelu defaults to the tanh approximation
        ff = self.ff2(gelu(self.ff1(h)))
        return self.norm2(h + ff)


class SetTransformer(nn.Module):
    def __init__(self, gen: torch.Generator, d_in: int, d_model: int,
                 d_out: int, num_heads: int = 4, num_sabs: int = 2,
                 num_seeds: int = 1, d_ff: int = 0,
                 dtype: torch.dtype = torch.float32):
        """d_in includes any frequency feature channels."""
        super().__init__()
        d_ff = d_ff or 2 * d_model
        self.in_proj = Dense(gen, d_in, d_model, bias=True, dtype=dtype)
        self.sabs = nn.ModuleList([MAB(gen, d_model, num_heads, d_ff, dtype)
                                   for _ in range(num_sabs)])
        self.pma = MAB(gen, d_model, num_heads, d_ff, dtype)
        self.seeds = param(init_array(gen, (num_seeds, d_model), 0.5), dtype)
        self.out_proj = Dense(gen, d_model * num_seeds, d_out, bias=True,
                              dtype=dtype)

    def forward(self, x, weights: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None):
        """x: (B, N, d_in) set elements; weights: (B, N) nonneg
        frequencies; mask: (B, N) valid flags. Returns (B, d_out)."""
        B = x.shape[0]
        key_bias = None
        if weights is not None:
            logw = torch.log1p(weights.float())
            # normalize so the bias is scale-free across interval lengths
            denom = torch.clamp(logw.amax(dim=-1, keepdim=True), min=1e-6)
            key_bias = logw / denom
            x = torch.cat([x, key_bias[..., None].to(x.dtype)], dim=-1)
        h = self.in_proj(x)
        for sab in self.sabs:
            h = sab(h, h, key_bias, mask)
        seeds = self.seeds[None].expand(B, -1, -1).to(h.dtype)
        pooled = self.pma(seeds, h, key_bias, mask)
        return self.out_proj(pooled.reshape(B, -1))


# logical-axis specs (`_mha_init`, `_mab_init`, `set_transformer_init`)

def mha_specs() -> dict:
    specs = {k: ("embed", "heads") for k in ("wq", "wk", "wv")}
    specs["wo"] = ("heads", "embed")
    return specs


def mab_specs() -> dict:
    return {**prefixed("mha", mha_specs()),
            **prefixed("ff1", dense_specs(True, "embed", "ff")),
            **prefixed("ff2", dense_specs(True, "ff", "embed")),
            **prefixed("norm1", layernorm_specs()),
            **prefixed("norm2", layernorm_specs())}


def set_transformer_specs(num_sabs: int = 2) -> dict:
    specs = prefixed("in_proj", dense_specs(True, None, "embed"))
    for i in range(num_sabs):
        specs.update(prefixed(f"sabs/{i}", mab_specs()))
    specs.update(prefixed("pma", mab_specs()))
    specs["seeds"] = ("pool", "embed")
    specs.update(prefixed("out_proj", dense_specs(True, "embed", None)))
    return specs

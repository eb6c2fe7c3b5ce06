"""RWKV backbone for the Stage-1 basic-block encoder (paper §III-A-2).

Time-mix: token-shift interpolation feeding r/k/v/decay/β projections,
then the gated delta-rule state update run by the wkv kernel
(`repro_torch.kernels.wkv`):
    S_t = (diag(w_t) S_{t-1}) (I − β_t k̂_t k̂_tᵀ) + β_t v_t k̂_tᵀ
    y_t = S_tᵀ r_t
Channel-mix: token-shifted squared-ReLU FFN.

Port of `repro.models.rwkv` (forward over whole sequences; the one-token
decode path is for a later slice). Unlike the JAX encoder, whose Stage-1
path always takes the `lax.scan` oracle, the time-mix here always goes
through the wkv wrapper: the plain version on the CPU, the kernel on CUDA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.wkv.ops import wkv
from repro_torch.models.layers import RMSNorm, init_array, param, rmsnorm


def token_shift(x):
    """x_{t-1} stream: (B,S,d) -> previous token (zeros at t=0)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


class TimeMix(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        dh = d_model // num_heads
        self.mu = param(torch.full((5, d_model), 0.5))  # lerp for r,k,v,w,β
        self.wr = param(init_array(gen, (d_model, d_model)))
        self.wk = param(init_array(gen, (d_model, d_model)))
        self.wv = param(init_array(gen, (d_model, d_model)))
        self.ww = param(init_array(gen, (d_model, num_heads * dh), 0.02))
        self.w_bias = param(torch.full((d_model,), -2.0))  # decay ~ sigmoid
        self.wbeta = param(init_array(gen, (d_model, num_heads), 0.02))
        self.wo = param(init_array(gen, (d_model, d_model)))
        self.ln_x = param(torch.ones(d_model))

    def project(self, x, x_prev):
        """r, k (unit-normalised per head), v, w (decay), β."""
        B, S, d = x.shape
        H = self.num_heads
        dh = d // H
        mu = self.mu
        lerp = [x * mu[i] + x_prev * (1 - mu[i]) for i in range(5)]
        r = (lerp[0] @ self.wr).reshape(B, S, H, dh)
        k = (lerp[1] @ self.wk).reshape(B, S, H, dh)
        v = (lerp[2] @ self.wv).reshape(B, S, H, dh)
        w = torch.sigmoid((lerp[3] @ self.ww).float()
                          + self.w_bias).reshape(B, S, H, dh)
        beta = torch.sigmoid((lerp[4] @ self.wbeta).float())     # (B,S,H)
        k = k / torch.clamp(torch.linalg.vector_norm(k.float(), dim=-1,
                                                     keepdim=True), min=1e-6)
        return r, k, v, w, beta

    def forward(self, x):
        B, S, d = x.shape
        r, k, v, w, beta = self.project(x, token_shift(x))
        y, _ = wkv(r, k, v, w, beta)
        y = rmsnorm(y.to(x.dtype).reshape(B, S, d), self.ln_x)
        return y @ self.wo


class ChannelMix(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, expand: int = 4):
        super().__init__()
        self.mu = param(torch.full((d_model,), 0.5))
        self.wk = param(init_array(gen, (d_model, expand * d_model)))
        self.wv = param(init_array(gen, (expand * d_model, d_model)))

    def forward(self, x):
        xk = x * self.mu + token_shift(x) * (1 - self.mu)
        return torch.square(torch.relu(xk @ self.wk)) @ self.wv


class RWKVBlock(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, num_heads: int):
        super().__init__()
        self.time_mix = TimeMix(gen, d_model, num_heads)
        self.channel_mix = ChannelMix(gen, d_model)
        self.norm1 = RMSNorm(d_model)
        self.norm2 = RMSNorm(d_model)

    def forward(self, x):
        x = x + self.time_mix(self.norm1(x))
        return x + self.channel_mix(self.norm2(x))

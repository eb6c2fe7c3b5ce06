"""RWKV backbone for the Stage-1 basic-block encoder (paper §III-A-2), and
the zoo's RWKV blocks (`configs/semanticbbv_encoder.py`).

Time-mix: token-shift interpolation feeding r/k/v/decay/β projections,
then the gated delta-rule state update run by the wkv kernel
(`repro_torch.kernels.wkv`):
    S_t = (diag(w_t) S_{t-1}) (I − β_t k̂_t k̂_tᵀ) + β_t v_t k̂_tᵀ
    y_t = S_tᵀ r_t
Channel-mix: token-shifted squared-ReLU FFN.

Port of `repro.models.rwkv`: the forward over whole sequences, and the
one-token decode step over a state {tm_shift, cm_shift, S}
(`rwkv_init_state`, `timemix_decode`, `channelmix_decode`). Unlike the
JAX package, whose Stage-1 path and zoo blocks always take the `lax.scan`
oracle, the time-mix here always goes through the wkv wrapper: the plain
version on the CPU, the kernel on CUDA, forward and (when a gradient is
wanted) backward; the decode step is the kernel at S = 1 with the state
passed in. Parameters are in `BBEConfig.dtype` (Stage 1) or the zoo
config's dtype, but for `w_bias`, which JAX keeps in fp32 in every model.
r, k and v go to wkv in that dtype (the kernel's bf16 instance reads
them as they are), w and β in fp32; y comes back fp32 and is cast to
the activations' dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.wkv.ops import wkv
from repro_torch.models.layers import (
    RMSNorm, init_array, param, rmsnorm, rmsnorm_specs,
)
from repro_torch.utils.tree import prefixed


def token_shift(x, shift=None):
    """x_{t-1} stream: (B,S,d) -> previous token; at t=0 the token before
    x, `shift` (B,d) (a decode state, fp32), or zeros."""
    if shift is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([shift[:, None].to(x.dtype), x], dim=1)[:, :-1]


class TimeMix(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        dh = d_model // num_heads
        # lerp for r,k,v,w,β
        self.mu = param(torch.full((5, d_model), 0.5), dtype)
        self.wr = param(init_array(gen, (d_model, d_model)), dtype)
        self.wk = param(init_array(gen, (d_model, d_model)), dtype)
        self.wv = param(init_array(gen, (d_model, d_model)), dtype)
        self.ww = param(init_array(gen, (d_model, num_heads * dh), 0.02),
                        dtype)
        self.w_bias = param(torch.full((d_model,), -2.0))  # decay ~ sigmoid
        self.wbeta = param(init_array(gen, (d_model, num_heads), 0.02),
                           dtype)
        self.wo = param(init_array(gen, (d_model, d_model)), dtype)
        self.ln_x = param(torch.ones(d_model), dtype)

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
        norm = torch.linalg.vector_norm(k.float(), dim=-1, keepdim=True)
        k = k / torch.clamp(norm, min=1e-6).to(k.dtype)
        return r, k, v, w, beta

    def mix(self, x, shift=None, state=None):
        """(out (B,S,d), wkv state after x (B,H,dh,dh) fp32) for x
        (B,S,d) following the token `shift` and the wkv `state` (both
        zeros when None)."""
        B, S, d = x.shape
        r, k, v, w, beta = self.project(x, token_shift(x, shift))
        y, sf = wkv(r, k, v, w, beta, state)
        y = rmsnorm(y.to(x.dtype).reshape(B, S, d), self.ln_x)
        return y @ self.wo, sf

    def forward(self, x):
        return self.mix(x)[0]


class ChannelMix(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int,
                 dtype: torch.dtype = torch.float32, expand: int = 4):
        super().__init__()
        self.mu = param(torch.full((d_model,), 0.5), dtype)
        self.wk = param(init_array(gen, (d_model, expand * d_model)), dtype)
        self.wv = param(init_array(gen, (expand * d_model, d_model)), dtype)

    def forward(self, x, shift=None):
        xk = x * self.mu + token_shift(x, shift) * (1 - self.mu)
        return torch.square(torch.relu(xk @ self.wk)) @ self.wv


class RWKVBlock(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.time_mix = TimeMix(gen, d_model, num_heads, dtype)
        self.channel_mix = ChannelMix(gen, d_model, dtype)
        self.norm1 = RMSNorm(d_model, dtype)
        self.norm2 = RMSNorm(d_model, dtype)

    def forward(self, x):
        """x + time-mix, then + channel-mix. norm2 reads the first sum in
        fp32, unrounded, as JAX's compiled Stage-1 scan computes it (XLA
        keeps that fp32 sum, its excess precision; the residual takes it
        rounded): the same thing in fp32, one rounding fewer in bf16."""
        h = x.float() + self.time_mix(self.norm1(x)).float()
        x = h.to(x.dtype)
        n2 = rmsnorm(h, self.norm2.scale, self.norm2.eps)
        return x + self.channel_mix(n2.to(x.dtype))


# ---------------------------------------------------------------------------
# decode: one token against a state
# ---------------------------------------------------------------------------


def rwkv_init_state(batch: int, d_model: int, num_heads: int,
                    device=None) -> dict:
    """Zero decode state of one RWKV block, all fp32: the normed inputs of
    the last token to the time-mix and the channel-mix, and the wkv
    state."""
    dh = d_model // num_heads
    zeros = lambda *shape: torch.zeros(shape, device=device)  # noqa: E731
    return {"tm_shift": zeros(batch, d_model),
            "cm_shift": zeros(batch, d_model),
            "S": zeros(batch, num_heads, dh, dh)}


def timemix_decode(params: TimeMix, x, shift, S):
    """x: (B,1,d). Returns (out, new shift (fp32), new S): the wkv kernel
    at S = 1 with the state passed in (the plain version on the CPU)."""
    out, sf = params.mix(x, shift, S)
    return out, x[:, 0].float(), sf


def channelmix_decode(params: ChannelMix, x, shift):
    """x: (B,1,d). Returns (out, new shift (fp32))."""
    return params(x, shift), x[:, 0].float()


# logical-axis specs (`timemix_init`, `channelmix_init`, `rwkv_block_init`)

def timemix_specs() -> dict:
    return {"mu": (None, "embed_act"), "wr": ("embed", "heads"),
            "wk": ("embed", "heads"), "wv": ("embed", "heads"),
            "ww": ("embed", "heads"), "w_bias": (None,),
            "wbeta": ("embed", None), "wo": ("heads", "embed"),
            "ln_x": ("embed_act",)}


def channelmix_specs() -> dict:
    return {"mu": ("embed_act",), "wk": ("embed", "ff"), "wv": ("ff", "embed")}


def rwkv_block_specs() -> dict:
    return {**prefixed("norm1", rmsnorm_specs()),
            **prefixed("time_mix", timemix_specs()),
            **prefixed("norm2", rmsnorm_specs()),
            **prefixed("channel_mix", channelmix_specs())}

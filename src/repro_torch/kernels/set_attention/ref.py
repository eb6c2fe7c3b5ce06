"""Plain PyTorch version of fused masked, frequency-weighted set attention.

    softmax_M( q·kᵀ/√dh + key_bias + NEG_INF·(1 − key_mask) ) · v

as `repro.kernels.set_attention.ref.set_attention_reference` computes it:
the mask is ADDITIVE (NEG_INF = -2^30 on top of the bias), so a fully
masked row collapses to a uniform softmax over its M keys, never NaN.
All math in fp32, output cast back to q.dtype.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def set_attention_reference(q, k, v, key_bias=None, key_mask=None):
    """q: (B,H,N,dh); k,v: (B,H,M,dh); key_bias: (B,M) additive logit
    bias; key_mask: (B,M) valid flags. Returns (B,H,N,dh) in q.dtype."""
    dh = q.shape[-1]
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * (dh ** -0.5)
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    if key_mask is not None:
        s = s + torch.where(key_mask.bool(), 0.0, NEG_INF).to(
            torch.float32)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p, v.float()).to(q.dtype)

"""Plain PyTorch version of fused masked, frequency-weighted set attention
and of its backward.

    softmax_M( q·kᵀ/√dh + key_bias + NEG_INF·(1 − key_mask) ) · v

as `repro.kernels.set_attention.ref.set_attention_reference` computes it:
the mask is ADDITIVE (NEG_INF = -2^30 on top of the bias), so a fully
masked row collapses to a uniform softmax over its M keys, never NaN.
All math in fp32, output cast back to q.dtype.

The backward is written out with the formulas of the JAX package's
backward kernel (`set_attn.py::_set_attn_bwd_kernel`), not with autograd:
it recomputes P, then dV = Pᵀ·dO, dP = dO·Vᵀ, δ = rowsum(dP ⊙ P),
dS = P ⊙ (dP − δ), dQ = scale·dS·K, dK = scale·dSᵀ·Q and the per-head
key-bias gradient Σ_n dS.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def set_attention_reference(q, k, v, key_bias=None, key_mask=None):
    """q: (B,H,N,dh); k,v: (B,H,M,dh); key_bias: (B,M) additive logit
    bias; key_mask: (B,M) valid flags. Returns (B,H,N,dh) in q.dtype."""
    p = _probabilities(q, k, key_bias, key_mask)
    return torch.einsum("bhnm,bhmd->bhnd", p, v.float()).to(q.dtype)


def _probabilities(q, k, key_bias, key_mask):
    """(B,H,N,M) fp32 softmax of the biased, masked scores."""
    dh = q.shape[-1]
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * (dh ** -0.5)
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    if key_mask is not None:
        s = s + torch.where(key_mask.bool(), 0.0, NEG_INF).to(
            torch.float32)[:, None, None, :]
    return torch.softmax(s, dim=-1)


def set_attention_backward_reference(q, k, v, key_bias, key_mask, do):
    """Cotangents of `set_attention_reference` for the output cotangent
    do: (B,H,N,dh). Returns (dq, dk, dv) in the dtypes of q, k, v and
    db (B,H,M) fp32, the key-bias gradient of each head (the caller sums
    it over heads). Masked keys of a row with any valid key have P == 0,
    so their dk, dv and db are exactly 0."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = _probabilities(q, k, key_bias, key_mask)
    dv = torch.einsum("bhnm,bhnd->bhmd", p, dof)
    dp = torch.einsum("bhnd,bhmd->bhnm", dof, vf)
    delta = torch.sum(dp * p, dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhnm,bhmd->bhnd", ds, kf) * scale
    dk = torch.einsum("bhnm,bhnd->bhmd", ds, qf) * scale
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            torch.sum(ds, dim=2))

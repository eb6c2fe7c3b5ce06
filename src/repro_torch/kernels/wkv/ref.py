"""Plain PyTorch version of the gated delta-rule recurrence (RWKV-7 core),
forward and backward.

    S_t = (diag(w_t) S_{t-1}) + β_t k_t (v_t − (diag(w_t) S_{t-1})ᵀ k_t)ᵀ
    y_t = S_tᵀ r_t

State layout S: (k_dim, v_dim). All math in fp32, one token at a time,
as `repro.kernels.wkv.ref.wkv_reference` computes it, whatever the
inputs' dtype (fp32 or bf16): y, the state and the gradients of w, beta
and the state are fp32, those of r, k, v come back in their dtypes. The backward has no
twin in the JAX package, which differentiates the `lax.scan` of
`repro.models.rwkv.wkv_scan_ref`; it is held to that `jax.grad` and to
autograd of `wkv_reference` in the tests.
"""
from __future__ import annotations

from typing import Optional

import torch


def wkv_reference(r, k, v, w, beta, state: Optional[torch.Tensor] = None):
    """r,k,v,w: (B,S,H,dh); beta: (B,S,H); state: (B,H,dh,dh) or None.

    Returns (y (B,S,H,dh) fp32, final_state (B,H,dh,dh) fp32)."""
    B, S, H, dh = r.shape
    r, k, v, w, beta = (a.float() for a in (r, k, v, w, beta))
    Sm = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
          if state is None else state.float())
    ys = []
    for t in range(S):
        kt = k[:, t]
        Sm = Sm * w[:, t, :, :, None]                      # decay rows (k dim)
        sk = torch.einsum("bhkv,bhk->bhv", Sm, kt)
        delta = v[:, t] - sk
        Sm = Sm + beta[:, t, :, None, None] * (kt[..., :, None]
                                               * delta[..., None, :])
        ys.append(torch.einsum("bhkv,bhk->bhv", Sm, r[:, t]))
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((B, 0, H, dh), dtype=torch.float32, device=r.device))
    return y, Sm


def wkv_backward_reference(r, k, v, w, beta, state, dy,
                           dstate_final: Optional[torch.Tensor] = None):
    """Cotangents of `wkv_reference(r, k, v, w, beta, state)` for the
    output cotangents dy (B,S,H,dh) and dstate_final (B,H,dh,dh) or None
    (zeros). Returns (dr, dk, dv, dw, dbeta, dstate), dstate the gradient
    of the initial state (of zeros when `state` is None): dr, dk, dv in
    the dtypes of r, k, v, each rounded once from fp32; the rest fp32.

    An explicit reverse loop over the tokens. Per (b, h), with the
    forward step A = diag(w_t) S_{t-1}, δ = v_t − Aᵀk_t, S_t = A + β_t k_t
    δᵀ, y_t = S_tᵀ r_t, and G = dL/dS_t, token t back to 1:
        G += r_t dy_tᵀ;  dr_t = S_t dy_t
        dδ = β_t Gᵀk_t;  dβ_t = k_tᵀ G δ;  dv_t = dδ
        dk_t = β_t G δ − A dδ
        dA = G − k_t dδᵀ;  dw_t[i] = Σ_j dA[i,j] S_{t-1}[i,j]
        G ← diag(w_t) dA
    S_{t-1} is kept from a forward pass; A, δ and S_t are recomputed."""
    B, S, H, dh = r.shape
    dtypes = (r.dtype, k.dtype, v.dtype)
    r, k, v, w, beta, dy = (a.float() for a in (r, k, v, w, beta, dy))
    Sm = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
          if state is None else state.float())
    prev = []                                          # S_{t-1} of token t
    for t in range(S):
        prev.append(Sm)
        A = Sm * w[:, t, :, :, None]
        delta = v[:, t] - torch.einsum("bhkv,bhk->bhv", A, k[:, t])
        Sm = A + beta[:, t, :, None, None] * (k[:, t, ..., :, None]
                                              * delta[..., None, :])
    G = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
         if dstate_final is None else dstate_final.float().clone())
    dr, dk, dv, dw = (torch.zeros_like(a) for a in (r, k, v, w))
    dbeta = torch.zeros_like(beta)
    for t in reversed(range(S)):
        kt, wt, bt = k[:, t], w[:, t], beta[:, t]
        A = prev[t] * wt[..., :, None]
        delta = v[:, t] - torch.einsum("bhkv,bhk->bhv", A, kt)
        St = A + bt[..., None, None] * (kt[..., :, None] * delta[..., None, :])
        G = G + r[:, t, ..., :, None] * dy[:, t, ..., None, :]
        dr[:, t] = torch.einsum("bhkv,bhv->bhk", St, dy[:, t])
        gk = torch.einsum("bhkv,bhk->bhv", G, kt)                  # Gᵀk
        ddelta = bt[..., None] * gk
        dbeta[:, t] = torch.einsum("bhv,bhv->bh", gk, delta)
        dv[:, t] = ddelta
        dk[:, t] = (bt[..., None] * torch.einsum("bhkv,bhv->bhk", G, delta)
                    - torch.einsum("bhkv,bhv->bhk", A, ddelta))
        dA = G - kt[..., :, None] * ddelta[..., None, :]
        dw[:, t] = torch.einsum("bhkv,bhkv->bhk", dA, prev[t])
        G = dA * wt[..., :, None]
    dr, dk, dv = (g.to(dt) for g, dt in zip((dr, dk, dv), dtypes))
    return dr, dk, dv, dw, dbeta, G

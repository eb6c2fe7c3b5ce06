"""Plain PyTorch version of the gated delta-rule recurrence (RWKV-7 core).

    S_t = (diag(w_t) S_{t-1}) + β_t k_t (v_t − (diag(w_t) S_{t-1})ᵀ k_t)ᵀ
    y_t = S_tᵀ r_t

State layout S: (k_dim, v_dim). All math in fp32, one token at a time,
as `repro.kernels.wkv.ref.wkv_reference` computes it.
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

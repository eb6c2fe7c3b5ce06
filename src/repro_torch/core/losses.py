"""Training objectives for both stages (paper §III-A-4, §III-B-3),
forward only: the port's training slice adds their gradients.

L_total = L_triplet + w_r · L_CPI_Huber + w_c · L_consistency
"""
from __future__ import annotations

import torch


def l2_normalize(x, eps: float = 1e-8):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def triplet_loss(anchor, positive, negative, margin: float = 0.5):
    """Euclidean triplet loss on L2-normalized embeddings."""
    a, p, n = (l2_normalize(x.float()) for x in (anchor, positive, negative))
    d_ap = torch.sum(torch.square(a - p), dim=-1)
    d_an = torch.sum(torch.square(a - n), dim=-1)
    return torch.mean(torch.clamp(d_ap - d_an + margin, min=0.0))


def huber_loss(pred, target, delta: float = 1.0):
    """Robust CPI regression loss."""
    err = pred.float() - target.float()
    abs_err = torch.abs(err)
    quad = torch.clamp(abs_err, max=delta)
    return torch.mean(0.5 * quad ** 2 + delta * (abs_err - quad))


def cpi_consistency_loss(signatures, cpis, tau: float = 1.0):
    """mean_{i≠j} exp(-||s_i - s_j||² / τ) · |log1p CPI_i − log1p CPI_j|."""
    s = l2_normalize(signatures.float())
    d2 = torch.sum(torch.square(s[:, None] - s[None, :]), dim=-1)
    sim = torch.exp(-d2 / tau)
    lc = torch.log1p(cpis.float())
    dc = torch.abs(lc[:, None] - lc[None, :])
    n = s.shape[0]
    mask = 1.0 - torch.eye(n, device=s.device)
    return torch.sum(sim * dc * mask) / torch.clamp(mask.sum(), min=1.0)


def combined_stage2_loss(anchor_sig, pos_sig, neg_sig, cpi_pred, cpi_true,
                         w_r: float = 1.0, w_c: float = 0.5,
                         margin: float = 0.5, tau: float = 1.0):
    """Eq. (3): weighted sum of the three Stage-2 terms (CPI regression
    on log1p(CPI))."""
    l_tri = triplet_loss(anchor_sig, pos_sig, neg_sig, margin)
    l_reg = huber_loss(cpi_pred, torch.log1p(cpi_true.float()))
    l_con = cpi_consistency_loss(anchor_sig, cpi_true, tau)
    total = l_tri + w_r * l_reg + w_c * l_con
    return total, {"triplet": l_tri, "cpi_reg": l_reg, "consistency": l_con}

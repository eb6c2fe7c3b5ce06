"""Plain PyTorch versions of nearest-centroid assignment and the fused
k-means step, as `repro.kernels.kmeans_assign.ref` computes them."""
from __future__ import annotations

import torch


def kmeans_assign_reference(x, centroids):
    """x: (N,d); centroids: (K,d). Returns (assign (N,) int32, dist2 (N,)
    f32); ties go to the lowest centroid index."""
    x = x.float()
    c = centroids.float()
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    d2 = x2 - 2.0 * (x @ c.T) + c2[None, :]
    return torch.argmin(d2, dim=-1).to(torch.int32), d2.min(dim=-1).values


def kmeans_update_reference(x, centroids, valid):
    """One k-means step: assignment + valid-weighted segment reduction.

    x: (N,d); centroids: (K,d); valid: (N,) weights. Returns (sums (K,d),
    counts (K,), inertia (1,)), all fp32."""
    x = x.float()
    a, d2 = kmeans_assign_reference(x, centroids)
    v = valid.float()
    onehot = torch.nn.functional.one_hot(
        a.long(), centroids.shape[0]).float() * v[:, None]
    sums = onehot.T @ x
    counts = onehot.sum(dim=0)
    inertia = torch.sum(d2 * v)[None]
    return sums, counts, inertia

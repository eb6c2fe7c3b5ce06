"""Wrappers of the two k-means kernels: dispatch by device, checks,
launch counts.

Replace `repro.kernels.kmeans_assign.ops.kmeans_assign` and
`kmeans_update`. No block padding: the CUDA kernels take any row count."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.kmeans_assign.ref import (
    kmeans_assign_reference, kmeans_update_reference,
)

MAX_DIM = 256
ROWS_PER_BLOCK = 256   # rows one block of the update kernel reduces


def _check_inputs(x, centroids):
    N, d = x.shape
    K = centroids.shape[0]
    _lib.require(x, "x", (N, d))
    _lib.require(centroids, "centroids", (K, d))
    if not 0 < d <= MAX_DIM or K == 0:
        raise ValueError(f"k-means kernels take 1 <= d <= {MAX_DIM} and "
                         f"K >= 1, got d={d}, K={K}")
    return N, d, K


def kmeans_assign(x, centroids):
    """x: (N,d); centroids: (K,d) -> (assign (N,) int32, dist2 (N,) f32),
    in the x²−2xc+c² form, ties to the lowest index."""
    if _lib.device_kind(x, centroids) == "cpu":
        return kmeans_assign_reference(x, centroids)
    N, d, K = _check_inputs(x, centroids)
    assign = torch.empty((N,), dtype=torch.int32, device=x.device)
    dist2 = torch.empty((N,), dtype=torch.float32, device=x.device)
    lib = _lib.load_library()
    rc = lib.rt_kmeans_assign(_lib.ptr(x), _lib.ptr(centroids), N, d, K,
                              _lib.ptr(assign), _lib.ptr(dist2),
                              _lib.stream())
    _lib.check(rc, "kmeans_assign")
    kmeans_assign.launches += 1
    return assign, dist2


kmeans_assign.launches = 0


def kmeans_update(x, centroids, valid: Optional[torch.Tensor] = None):
    """One fused k-means step: assignment + per-cluster segment reduce.

    x: (N,d); centroids: (K,d); valid: optional (N,) weights (None = all
    rows count). Returns (sums (K,d), counts (K,), inertia scalar), fp32.
    The CUDA path is deterministic: partials per row block, then a sum in
    block order, with no float atomics."""
    if valid is None:
        valid = torch.ones((x.shape[0],), dtype=torch.float32,
                           device=x.device)
    if _lib.device_kind(x, centroids, valid) == "cpu":
        sums, counts, inertia = kmeans_update_reference(x, centroids, valid)
        return sums, counts, inertia[0]
    N, d, K = _check_inputs(x, centroids)
    _lib.require(valid, "valid", (N,))
    if N == 0:
        raise ValueError("kmeans_update: needs at least one row")
    nblocks = -(-N // ROWS_PER_BLOCK)
    dev = x.device
    part_sums = torch.empty((nblocks, K, d), dtype=torch.float32, device=dev)
    part_counts = torch.empty((nblocks, K), dtype=torch.float32, device=dev)
    part_inertia = torch.empty((nblocks,), dtype=torch.float32, device=dev)
    sums = torch.empty((K, d), dtype=torch.float32, device=dev)
    counts = torch.empty((K,), dtype=torch.float32, device=dev)
    inertia = torch.empty((1,), dtype=torch.float32, device=dev)
    lib = _lib.load_library()
    rc = lib.rt_kmeans_update(
        _lib.ptr(x), _lib.ptr(centroids), _lib.ptr(valid), N, d, K,
        _lib.ptr(part_sums), _lib.ptr(part_counts), _lib.ptr(part_inertia),
        _lib.ptr(sums), _lib.ptr(counts), _lib.ptr(inertia), ROWS_PER_BLOCK,
        _lib.stream())
    _lib.check(rc, "kmeans_update")
    kmeans_update.launches += 1
    return sums, counts, inertia[0]


kmeans_update.launches = 0

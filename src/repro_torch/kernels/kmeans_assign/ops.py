"""Wrappers of the two k-means kernels: dispatch by device, checks,
launch counts.

Replace `repro.kernels.kmeans_assign.ops.kmeans_assign` and
`kmeans_update`. No block padding: the CUDA kernels take any row count.
x is fp32 or bf16, as JAX's kernels take it: a bf16 x on CUDA launches
the kernels' bf16 instances, which read it as it is (bitwise the fp32
instances on the upcast rows); the centroids are fp32 or bf16, a bf16
centroid matrix widened to fp32 first (exactly)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.kmeans_assign.ref import (
    kmeans_assign_reference, kmeans_update_reference,
)

MAX_DIM = 256
ROWS_PER_BLOCK = 64    # rows a block of both kernels (128 threads)
JOIN_WARPS = 32        # warps a block of the update's join kernel


def kmeans_plan(N: int, d: int, K: int,
                dtype: torch.dtype = torch.float32) -> dict:
    """The launch `csrc/kmeans.cu` makes for N rows of width d (of
    `dtype`, fp32 or bf16) and K centroids: rows a block and blocks; the
    K tile (the centroids a block holds at once, split in quarters over
    the four lanes of a pair of rows; K > 16 loops over tiles of 16); the
    fp32 centroid stride and the centroid quarters' stride in float4s
    (odd, and 1 mod 8: no bank conflicts); the row tile's stride in
    16-byte units (`row16`, odd: ceil(d / 4) in fp32, ceil(d / 8) in
    bf16); the dynamic shared bytes a block of either kernel takes; and
    the update's `outputs` = K d + K + 1 partials a block, joined in
    chains over blocks by the `join_warps` warps of a join block. Raises
    for a shape the kernels do not take."""
    if N < 1 or K < 1 or not 0 < d <= MAX_DIM:
        raise ValueError(f"k-means kernels take N >= 1, K >= 1 and "
                         f"1 <= d <= {MAX_DIM}, got N={N}, d={d}, K={K}")
    k_tile = 4 if K <= 4 else 8 if K <= 8 else 16
    stride4 = -(-d // 4) | 1
    row16 = stride4 if dtype == torch.float32 else -(-d // 8) | 1
    quarter4 = k_tile // 4 * stride4
    quarter4 += (9 - quarter4 % 8) % 8
    floats = (4 * row16 * ROWS_PER_BLOCK + 16 * quarter4 + k_tile
              + 3 * ROWS_PER_BLOCK + 2 * (k_tile + 1) + 4 * ROWS_PER_BLOCK)
    return dict(rows_per_block=ROWS_PER_BLOCK,
                blocks=-(-N // ROWS_PER_BLOCK), k_tile=k_tile,
                stride4=stride4, quarter4=quarter4, row16=row16,
                shared_bytes=4 * floats, outputs=K * d + K + 1,
                join_warps=JOIN_WARPS)


def _check_inputs(x, centroids):
    """(N, d, K, bf16, the centroids in fp32) of a CUDA launch."""
    N, d = x.shape
    K = centroids.shape[0]
    bf16 = _lib.float_or_bf16(x, "x")
    _lib.float_or_bf16(centroids, "centroids")
    _lib.require(x, "x", (N, d), x.dtype)
    centroids = centroids.float()
    _lib.require(centroids, "centroids", (K, d))
    if not 0 < d <= MAX_DIM or K == 0:
        raise ValueError(f"k-means kernels take 1 <= d <= {MAX_DIM} and "
                         f"K >= 1, got d={d}, K={K}")
    return N, d, K, bf16, centroids


def _vec(x, centroids) -> int:
    """The kernels' copy routes: bit 0 when x's rows are whole 16-byte
    vectors (d % 4 == 0 in fp32, d % 8 == 0 in bf16) from a 16-byte
    aligned start, bit 1 when the fp32 centroids' are; each is then
    copied by 16-byte cp.async, else by element."""
    per16 = 16 // x.element_size()
    rows = x.shape[1] % per16 == 0 and x.data_ptr() % 16 == 0
    cents = centroids.shape[1] % 4 == 0 and centroids.data_ptr() % 16 == 0
    return int(rows) | 2 * int(cents)


def kmeans_assign(x, centroids):
    """x: (N,d); centroids: (K,d) -> (assign (N,) int32, dist2 (N,) f32),
    in the x²−2xc+c² form, ties to the lowest index."""
    if _lib.device_kind(x, centroids) == "cpu":
        return kmeans_assign_reference(x, centroids)
    N, d, K, bf16, centroids = _check_inputs(x, centroids)
    assign = torch.empty((N,), dtype=torch.int32, device=x.device)
    dist2 = torch.empty((N,), dtype=torch.float32, device=x.device)
    lib = _lib.load_library()
    rc = lib.rt_kmeans_assign(_lib.ptr(x), _lib.ptr(centroids), N, d, K,
                              _vec(x, centroids), bf16, _lib.ptr(assign),
                              _lib.ptr(dist2), _lib.stream())
    _lib.check(rc, "kmeans_assign")
    kmeans_assign.launches += 1
    kmeans_assign.launches_bf16 += bf16
    return assign, dist2


# launches of the kernel, and of its bf16 instances among them
kmeans_assign.launches = kmeans_assign.launches_bf16 = 0


def kmeans_update(x, centroids, valid: Optional[torch.Tensor] = None):
    """One fused k-means step: assignment + per-cluster segment reduce.

    x: (N,d); centroids: (K,d); valid: optional (N,) weights (None = all
    rows count). Returns (sums (K,d), counts (K,), inertia scalar), fp32.
    The CUDA path (`kmeans_plan`) reads only rows with valid != 0 and is
    deterministic: partials per block of 64 rows, joined in a fixed order,
    no float atomics; its results depend only on the live rows and their
    row indices. It makes one allocation a call (and one more for bf16
    centroids, widened first): the outputs are views of it, in front of
    the partials' scratch."""
    if _lib.device_kind(x, centroids, valid) == "cpu":
        if valid is None:
            valid = torch.ones((x.shape[0],), dtype=torch.float32)
        sums, counts, inertia = kmeans_update_reference(x, centroids, valid)
        return sums, counts, inertia[0]
    N, d, K, bf16, centroids = _check_inputs(x, centroids)
    if valid is not None:
        _lib.require(valid, "valid", (N,))
    if N == 0:
        raise ValueError("kmeans_update: needs at least one row")
    plan = kmeans_plan(N, d, K, x.dtype)
    O, nb = plan["outputs"], plan["blocks"]
    buf = torch.empty((O + nb * O + nb,), dtype=torch.float32,
                      device=x.device)
    lib = _lib.load_library()
    rc = lib.rt_kmeans_update(
        _lib.ptr(x), _lib.ptr(centroids), _lib.ptr(valid), N, d, K,
        _vec(x, centroids), bf16, buf.data_ptr() + 4 * O,
        buf.data_ptr() + 4 * (O + nb * O), buf.data_ptr(), _lib.stream())
    _lib.check(rc, "kmeans_update")
    kmeans_update.launches += 1
    kmeans_update.launches_bf16 += bf16
    return buf[:K * d].view(K, d), buf[K * d:K * d + K], buf[K * d + K]


kmeans_update.launches = kmeans_update.launches_bf16 = 0

"""k-means with kmeans++ seeding (port of `repro.core.clustering`).

Two build paths share the per-iteration math (the `kmeans_update` kernel
for each Lloyd step, `kmeans_assign` for the labels):

  `kmeans`          host-facing: each restart's inertia read back and
                    the best picked on the host with a strict `<` (the
                    intra-program SimPoint clustering).
  `kmeans_device`   every restart over a padded device-resident matrix
                    (the store's `device_matrix`), the best-of-inertia
                    pick an argmin on the device; only the winning
                    centroids and labels come back (the 14-archetype
                    universal build of `KnowledgeBase`). Validity is a
                    prefix (`n_valid`, the padded tail) or an arbitrary
                    0/1 mask (`valid_mask`, tombstoned rows).

Seeding draws from `torch.Generator`s seeded `seed * 1000 + r` per
restart, which cannot reproduce `jax.random`; `init_centroids`
((restarts, k, d)) replaces the seeding, so tests can hand in the JAX
package's seeds. The `mesh` sharding of the JAX package is not ported.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import Device, resolve_device
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign, kmeans_update


def _choice(gen: torch.Generator, probs: torch.Tensor) -> torch.Tensor:
    """One index drawn with probability `probs` (stays on the device)."""
    return torch.multinomial(probs, 1, generator=gen)[0]


def kmeans_pp_init(gen: torch.Generator, x, k: int):
    """kmeans++ seeding over every row of x."""
    n, d = x.shape
    first = torch.randint(n, (), generator=gen, device=x.device)
    cents = torch.zeros((k, d), dtype=x.dtype, device=x.device)
    cents[0] = x[first]
    cols = torch.arange(k, device=x.device)
    for i in range(1, k):
        d2 = torch.sum(torch.square(x[:, None, :] - cents[None, :, :]), -1)
        d2 = torch.amin(d2 + torch.where(cols < i, 0.0, torch.inf)[None, :],
                        dim=1)
        probs = d2 / torch.clamp(d2.sum(), min=1e-12)
        cents[i] = x[_choice(gen, probs)]
    return cents


def _pp_rest(gen, x, k, cents, valid_bool, fallback):
    """Shared kmeans++ loop of the masked and weighted seedings: the
    x²−2xc+c² distances, zero mass on invalid rows, and `fallback`
    probabilities when every valid row sits on a centroid."""
    x2 = torch.sum(x * x, dim=-1)
    cols = torch.arange(k, device=x.device)
    for i in range(1, k):
        c2 = torch.sum(cents * cents, dim=-1)
        d2 = x2[:, None] - 2.0 * (x @ cents.T) + c2[None, :]
        d2 = torch.amin(d2 + torch.where(cols < i, 0.0, torch.inf)[None, :],
                        dim=1)
        d2 = torch.where(valid_bool, torch.clamp(d2, min=0.0), 0.0)
        total = d2.sum()
        probs = torch.where(total > 0, d2 / torch.clamp(total, min=1e-30),
                            fallback)
        cents[i] = x[_choice(gen, probs)]
    return cents


def kmeans_pp_init_masked(gen: torch.Generator, x, k: int, n_valid: int):
    """kmeans++ over the first `n_valid` rows of a padded matrix; padded
    rows get zero sampling mass."""
    n, d = x.shape
    valid = torch.arange(n, device=x.device) < n_valid
    first = torch.randint(max(n_valid, 1), (), generator=gen, device=x.device)
    cents = torch.zeros((k, d), dtype=x.dtype, device=x.device)
    cents[0] = x[first]
    uniform = valid.to(x.dtype) / max(n_valid, 1)
    return _pp_rest(gen, x, k, cents, valid, uniform)


def kmeans_pp_init_weighted(gen: torch.Generator, x, k: int, valid):
    """kmeans++ over an arbitrary 0/1 validity mask (tombstoned rows get
    zero mass); the first centroid is a weighted draw over the mask."""
    n, d = x.shape
    v = valid.to(x.dtype)
    cents = torch.zeros((k, d), dtype=x.dtype, device=x.device)
    cents[0] = x[_choice(gen, v / torch.clamp(v.sum(), min=1e-30))]
    fallback = v / torch.clamp(v.sum(), min=1.0)
    return _pp_rest(gen, x, k, cents, v > 0, fallback)


def _fit_one(gen: Optional[torch.Generator], x, k: int, iters: int,
             valid, n_valid: Optional[int],
             init_centroids: Optional[torch.Tensor] = None):
    """One seeded restart: ++init (or `init_centroids`), `iters` fused
    steps, final assignment. n_valid set => prefix mask; n_valid None but
    valid set => arbitrary mask; both None => every row is real.
    Returns (centroids, assign, inertia)."""
    if init_centroids is not None:
        cents = init_centroids.to(x.device, torch.float32).clone()
    elif n_valid is not None:
        cents = kmeans_pp_init_masked(gen, x, k, n_valid)
    elif valid is not None:
        cents = kmeans_pp_init_weighted(gen, x, k, valid)
    else:
        cents = kmeans_pp_init(gen, x, k)
    for _ in range(iters):
        sums, counts, _ = kmeans_update(x, cents, valid)
        cents = torch.where(counts[:, None] > 0,
                            sums / torch.clamp(counts[:, None], min=1.0),
                            cents)
    a, d2 = kmeans_assign(x, cents)
    if valid is not None:
        d2 = d2 * valid
    return cents, a, d2.sum()


def _each_restart(seeds: Sequence[int], x, k: int, iters: int, valid,
                  n_valid: Optional[int],
                  init_centroids: Optional[torch.Tensor]):
    """(centroids, assign, inertia) of each restart in turn, as `_fit_one`
    gives them: restart r seeded from a generator seeded seeds[r], or by
    init_centroids[r] ((R, k, d); then there are R restarts)."""
    restarts = (len(seeds) if init_centroids is None
                else init_centroids.shape[0])
    for r in range(restarts):
        gen = (None if init_centroids is not None else
               torch.Generator(device=x.device).manual_seed(seeds[r]))
        init = None if init_centroids is None else init_centroids[r]
        yield _fit_one(gen, x, k, iters, valid, n_valid, init)


def kmeans_fit(seed: int, x, k: int, iters: int = 25,
               init_centroids: Optional[torch.Tensor] = None):
    """One restart over every row of x ((N, d), on its device): kmeans++
    seeding from a generator seeded `seed` (or `init_centroids` (k, d)),
    `iters` Lloyd steps, the restart's own final assignment. Returns
    device (centroids (k,d), assign (N,), inertia)."""
    init = None if init_centroids is None else init_centroids[None]
    return next(_each_restart([seed], x.float().contiguous(), k, iters,
                              None, None, init))


@torch.inference_mode()
def kmeans(x: np.ndarray, k: int, iters: int = 25, seed: int = 0,
           restarts: int = 3, device: Device = "cuda",
           init_centroids=None) -> Tuple[np.ndarray, np.ndarray, float]:
    """Host-facing k-means of x ((N, d)) on `device`: restart r is a
    `kmeans_fit` seeded `seed * 1000 + r` (or by `init_centroids[r]`),
    its inertia comes back as a Python float, and the first restart with
    the strictly least inertia wins. Returns host (centroids (k,d),
    assign (N,) int32, inertia)."""
    dev = resolve_device(device)
    xd = torch.tensor(np.asarray(x, np.float32), device=dev)
    if init_centroids is not None:
        init_centroids = torch.as_tensor(init_centroids, dtype=torch.float32)
    seeds = [seed * 1000 + r for r in range(restarts)]
    best = None
    for c, a, inertia in _each_restart(seeds, xd, k, iters, None, None,
                                       init_centroids):
        inertia = float(inertia)
        if best is None or inertia < best[2]:
            best = (c, a, inertia)
    return best[0].cpu().numpy(), best[1].cpu().numpy(), best[2]


def kmeans_fit_restarts(seeds: Sequence[int], x, k: int, iters: int = 25,
                        n_valid: Optional[int] = None, valid_mask=None,
                        init_centroids: Optional[torch.Tensor] = None):
    """Every restart on the device; best-of-inertia picked there too.

    seeds: one generator seed per restart. `valid_mask` ((N,) 0/1)
    supersedes `n_valid`. `init_centroids` ((R, k, d)) replaces the
    seeding of restart r by init_centroids[r]. Returns (centroids,
    assign, inertia, best_restart) as device tensors."""
    x = x.float().contiguous()
    n = x.shape[0]
    if valid_mask is not None:
        nv = None
        valid = valid_mask.to(x.device, torch.float32).contiguous()
    else:
        nv = n if n_valid is None else int(n_valid)
        valid = (torch.arange(n, device=x.device) < nv).float()
    cents_all, inertia_all = [], []
    for cents, _, inertia in _each_restart(seeds, x, k, iters, valid, nv,
                                           init_centroids):
        cents_all.append(cents)
        inertia_all.append(inertia)
    best = torch.argmin(torch.stack(inertia_all))
    cents = torch.stack(cents_all)[best].contiguous()
    a, d2 = kmeans_assign(x, cents)
    return cents, a, (d2 * valid).sum(), best


@torch.inference_mode()
def kmeans_device(x, k: int, iters: int = 25, seed: int = 0,
                  restarts: int = 3, n_valid: Optional[int] = None,
                  valid_mask=None, init_centroids=None
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """On-device build over a (possibly padded) matrix: restart seeds
    `seed * 1000 + r`. Returns host (centroids (k,d), assign (n_valid,),
    inertia). Entries of the assignment at dead rows of `valid_mask` are
    meaningless; the caller masks them."""
    x = torch.as_tensor(x)
    n = int(x.shape[0] if n_valid is None else n_valid)
    if init_centroids is not None:
        init_centroids = torch.as_tensor(init_centroids, dtype=torch.float32)
    seeds = [seed * 1000 + r for r in range(restarts)]
    if valid_mask is None:
        c, a, inertia, _ = kmeans_fit_restarts(
            seeds, x, k, iters, n_valid=n, init_centroids=init_centroids)
    else:
        c, a, inertia, _ = kmeans_fit_restarts(
            seeds, x, k, iters, valid_mask=torch.as_tensor(valid_mask),
            init_centroids=init_centroids)
    return (c.cpu().numpy(), a[:n].cpu().numpy(), float(inertia))


def representatives(x: np.ndarray, centroids: np.ndarray,
                    assign: np.ndarray) -> np.ndarray:
    """Index of the member closest to each centroid (SimPoint rep points).
    Empty clusters get the globally closest point.

    One segment-reduce instead of a per-cluster Python loop: rows sort by
    (cluster, distance-to-own-centroid, row) and the first row of each
    cluster segment wins — same member and tie-breaking (lowest row index
    among equal distances) as the loop, without materializing (N,k,d).
    """
    n = x.shape[0]
    k = centroids.shape[0]
    if n == 0:
        return np.zeros(k, dtype=np.int64)
    xf = np.asarray(x, np.float64)
    cf = np.asarray(centroids, np.float64)
    d2_all = (np.sum(xf * xf, -1, keepdims=True) - 2.0 * (xf @ cf.T)
              + np.sum(cf * cf, -1)[None, :])              # (N, k)
    # empty-cluster fallback: global argmin per centroid column
    reps = d2_all.argmin(axis=0).astype(np.int64)
    assign = np.asarray(assign, np.int64)
    rows = np.arange(n)
    order = np.lexsort((rows, d2_all[rows, assign], assign))
    seg = assign[order]
    first = np.ones(n, bool)
    first[1:] = seg[1:] != seg[:-1]
    reps[seg[first]] = order[first]
    return reps

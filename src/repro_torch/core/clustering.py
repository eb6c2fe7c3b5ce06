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
package's seeds.

With a `mesh` (a DeviceMesh on the matrix's device type; every rank
calls with the whole matrix), the device build shards the rows over the
mesh's data axes ("pod" and/or "data"; model axes never split rows):
each rank runs the kernels on its rows, and the sums, counts and inertia
of every Lloyd step are summed over the ranks, as JAX's `psum`. kmeans++
gathers every row's distance in row order and every rank draws the same
row from the same generator, so a sharded build draws the unsharded
build's seeds. Rows that do not divide the data axes warn and run
unsharded, as in JAX. Unlike JAX, a 1-way data axis still takes the
sharded path (its collectives are copies), so one card drives it.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import Device, resolve_device
from repro_torch.distributed.collectives import DataShard
from repro_torch.distributed.sharding import axis_sizes
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign, kmeans_update


def _data_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the (N, d) rows shard over ("pod" and/or "data")."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _data_axis_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    size = 1
    for a in _data_axes(mesh):
        size *= sizes[a]
    return size


def _row_shard_axes(mesh, n_rows: int) -> Optional[Tuple[str, ...]]:
    """The one place of the row-sharding rule: the data axes to split
    `n_rows` over, or None when sharding is off (no mesh, no data axis,
    or rows that do not divide)."""
    if mesh is None:
        return None
    axes = _data_axes(mesh)
    if not axes or n_rows % _data_axis_size(mesh):
        return None
    return axes


def shard_rows(x, mesh) -> Tuple[torch.Tensor, Optional[DataShard]]:
    """(this rank's rows of x, its DataShard), or (x, None) when
    `_row_shard_axes` says sharding is off. Raises when the mesh's device
    type is not x's."""
    axes = _row_shard_axes(mesh, x.shape[0])
    if axes is None:
        return x, None
    if mesh.device_type != x.device.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the rows "
                         f"on {x.device.type!r}")
    shard = DataShard(mesh, axes)
    return x[shard.rows(x.shape[0])], shard


def _gather(t: torch.Tensor, shard: Optional[DataShard]) -> torch.Tensor:
    return t if shard is None else shard.all_gather(t)


def _row(x: torch.Tensor, i, shard: Optional[DataShard]) -> torch.Tensor:
    """Global row i of the row-sharded matrix (x: this rank's rows), on
    every rank: its owner's copy, gathered whole."""
    if shard is None:
        return x[i]
    n = x.shape[0]
    owner = int(i) // n
    buf = (x[int(i) - owner * n] if owner == shard.index
           else torch.zeros_like(x[0]))
    return shard.all_gather(buf[None].contiguous())[owner]


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


def _pp_rest(gen, x, k, cents, valid_bool, fallback, shard=None):
    """Shared kmeans++ loop of the masked and weighted seedings: the
    x²−2xc+c² distances, zero mass on invalid rows, and `fallback`
    probabilities when every valid row sits on a centroid. Sharded: x
    and valid_bool are this rank's rows; the distances are gathered in
    row order, so every rank draws the same row."""
    x2 = torch.sum(x * x, dim=-1)
    cols = torch.arange(k, device=x.device)
    for i in range(1, k):
        c2 = torch.sum(cents * cents, dim=-1)
        d2 = x2[:, None] - 2.0 * (x @ cents.T) + c2[None, :]
        d2 = torch.amin(d2 + torch.where(cols < i, 0.0, torch.inf)[None, :],
                        dim=1)
        d2 = _gather(torch.where(valid_bool, torch.clamp(d2, min=0.0), 0.0),
                     shard)
        total = d2.sum()
        probs = torch.where(total > 0, d2 / torch.clamp(total, min=1e-30),
                            fallback)
        cents[i] = _row(x, _choice(gen, probs), shard)
    return cents


def kmeans_pp_init_masked(gen: torch.Generator, x, k: int, n_valid: int,
                          shard: Optional[DataShard] = None):
    """kmeans++ over the first `n_valid` rows of a padded matrix (x: this
    rank's rows when sharded); padded rows get zero sampling mass."""
    n, d = x.shape
    size, lo = (1, 0) if shard is None else (shard.size, shard.index * n)
    rows = torch.arange(n * size, device=x.device) < n_valid
    first = torch.randint(max(n_valid, 1), (), generator=gen, device=x.device)
    cents = torch.zeros((k, d), dtype=x.dtype, device=x.device)
    cents[0] = _row(x, first, shard)
    uniform = rows.to(x.dtype) / max(n_valid, 1)
    return _pp_rest(gen, x, k, cents, rows[lo:lo + n], uniform, shard)


def kmeans_pp_init_weighted(gen: torch.Generator, x, k: int, valid,
                            shard: Optional[DataShard] = None):
    """kmeans++ over an arbitrary 0/1 validity mask (tombstoned rows get
    zero mass); the first centroid is a weighted draw over the mask.
    Sharded: x is this rank's rows, `valid` the whole mask."""
    n, d = x.shape
    lo = 0 if shard is None else shard.index * n
    v = valid.to(x.dtype)
    cents = torch.zeros((k, d), dtype=x.dtype, device=x.device)
    cents[0] = _row(x, _choice(gen, v / torch.clamp(v.sum(), min=1e-30)),
                    shard)
    fallback = v / torch.clamp(v.sum(), min=1.0)
    return _pp_rest(gen, x, k, cents, v[lo:lo + n] > 0, fallback, shard)


def _fit_one(gen: Optional[torch.Generator], x, k: int, iters: int,
             valid, n_valid: Optional[int],
             init_centroids: Optional[torch.Tensor] = None,
             shard: Optional[DataShard] = None):
    """One seeded restart: ++init (or `init_centroids`), `iters` fused
    steps, final assignment. n_valid set => prefix mask; n_valid None but
    valid set => arbitrary mask; both None => every row is real.
    Sharded (`shard`): x is this rank's rows, `valid` the whole mask; each
    step's sums, counts and inertia are summed over the ranks. Returns
    (centroids, this rank's assign, inertia)."""
    mine = valid
    if shard is not None and valid is not None:
        mine = valid[shard.rows(valid.shape[0])]
    if init_centroids is not None:
        cents = init_centroids.to(x.device, torch.float32).clone()
    elif n_valid is not None:
        cents = kmeans_pp_init_masked(gen, x, k, n_valid, shard)
    elif valid is not None:
        cents = kmeans_pp_init_weighted(gen, x, k, valid, shard)
    else:
        cents = kmeans_pp_init(gen, x, k)
    for _ in range(iters):
        sums, counts, _ = _update(x, cents, mine, shard)
        cents = torch.where(counts[:, None] > 0,
                            sums / torch.clamp(counts[:, None], min=1.0),
                            cents)
    a, d2 = kmeans_assign(x, cents)
    if mine is not None:
        d2 = d2 * mine
    d2 = d2.sum()
    return cents, a, d2 if shard is None else shard.all_reduce(d2)


def _update(x, cents, valid, shard: Optional[DataShard]):
    """`kmeans_update` on this rank's rows, its (sums, counts, inertia)
    summed over the ranks."""
    sums, counts, inertia = kmeans_update(x, cents, valid)
    if shard is None:
        return sums, counts, inertia
    K, d = sums.shape
    flat = shard.all_reduce(torch.cat([sums.reshape(-1), counts,
                                       inertia.reshape(1)]))
    return flat[:K * d].view(K, d), flat[K * d:K * d + K], flat[K * d + K]


def _each_restart(seeds: Sequence[int], x, k: int, iters: int, valid,
                  n_valid: Optional[int],
                  init_centroids: Optional[torch.Tensor],
                  shard: Optional[DataShard] = None):
    """(centroids, assign, inertia) of each restart in turn, as `_fit_one`
    gives them: restart r seeded from a generator seeded seeds[r], or by
    init_centroids[r] ((R, k, d); then there are R restarts)."""
    restarts = (len(seeds) if init_centroids is None
                else init_centroids.shape[0])
    for r in range(restarts):
        gen = (None if init_centroids is not None else
               torch.Generator(device=x.device).manual_seed(seeds[r]))
        init = None if init_centroids is None else init_centroids[r]
        yield _fit_one(gen, x, k, iters, valid, n_valid, init, shard)


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
                        init_centroids: Optional[torch.Tensor] = None,
                        mesh=None):
    """Every restart on the device; best-of-inertia picked there too.

    seeds: one generator seed per restart. `valid_mask` ((N,) 0/1)
    supersedes `n_valid`. `init_centroids` ((R, k, d)) replaces the
    seeding of restart r by init_centroids[r]. `mesh`: the rows sharded
    over its data axes (`shard_rows`; every rank passes the whole x).
    Returns (centroids, assign, inertia, best_restart) as device tensors,
    the same on every rank."""
    x = x.float().contiguous()
    n = x.shape[0]
    if valid_mask is not None:
        nv = None
        valid = valid_mask.to(x.device, torch.float32).contiguous()
    else:
        nv = n if n_valid is None else int(n_valid)
        valid = (torch.arange(n, device=x.device) < nv).float()
    xs, shard = shard_rows(x, mesh)
    cents_all, inertia_all = [], []
    for cents, _, inertia in _each_restart(seeds, xs, k, iters, valid, nv,
                                           init_centroids, shard):
        cents_all.append(cents)
        inertia_all.append(inertia)
    best = torch.argmin(torch.stack(inertia_all))
    cents = torch.stack(cents_all)[best].contiguous()
    a, d2 = kmeans_assign(xs, cents)
    a, d2 = _gather(a, shard), _gather(d2, shard)
    return cents, a, (d2 * valid).sum(), best


@torch.inference_mode()
def kmeans_device(x, k: int, iters: int = 25, seed: int = 0,
                  restarts: int = 3, n_valid: Optional[int] = None,
                  valid_mask=None, init_centroids=None, mesh=None
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """On-device build over a (possibly padded) matrix: restart seeds
    `seed * 1000 + r`. Returns host (centroids (k,d), assign (n_valid,),
    inertia). Entries of the assignment at dead rows of `valid_mask` are
    meaningless; the caller masks them. `mesh`: the rows sharded over its
    data axes (every rank calls with the whole x); rows that do not
    divide them warn and run unsharded."""
    x = torch.as_tensor(x)
    if (mesh is not None and _row_shard_axes(mesh, x.shape[0]) is None
            and _data_axis_size(mesh) > 1):
        warnings.warn(
            f"kmeans_device: rows ({x.shape[0]}) do not divide the "
            f"mesh's {_data_axis_size(mesh)}-way data axis: running "
            "unsharded; pad rows to a multiple of the data-axis size to "
            "shard", stacklevel=2)
        mesh = None
    n = int(x.shape[0] if n_valid is None else n_valid)
    if init_centroids is not None:
        init_centroids = torch.as_tensor(init_centroids, dtype=torch.float32)
    seeds = [seed * 1000 + r for r in range(restarts)]
    if valid_mask is None:
        c, a, inertia, _ = kmeans_fit_restarts(
            seeds, x, k, iters, n_valid=n, init_centroids=init_centroids,
            mesh=mesh)
    else:
        c, a, inertia, _ = kmeans_fit_restarts(
            seeds, x, k, iters, valid_mask=torch.as_tensor(valid_mask),
            init_centroids=init_centroids, mesh=mesh)
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

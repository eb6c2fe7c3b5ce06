"""The data-parallel collectives of a sharded step.

A `DataShard` is this rank's place along the data-parallel axes of a
DeviceMesh: the process group of each axis (major first), this rank's
index along them (row-major over the axes, as a global batch's rows are
laid out) and their product `size`. Rows of a global batch are split in
`size` equal consecutive shares; share `index` is this rank's.

While a shard is active (`active_shard`, entered by the Trainer around
its loss calls and by k-means), the losses that couple rows read global
quantities through these functions, which are the identity when no shard
is active, so the unsharded code runs exactly as before:

  share(x)        a mean over this rank's rows -> its share of the global
                  mean (x / size): summed over ranks, the global mean
  total(x)        a count summed over the ranks (no gradient)
  all_sum(x)      a sum over the ranks that autograd differentiates (the
                  gradient is summed over the ranks too)
  gather_rows(x)  every rank's rows, in row order, differentiable: the
                  gradient of each rank's rows is summed over the ranks

Every rank must enter every collective, in the same order. At one rank
each is a copy, so a sharded run on one rank is bitwise an unsharded one.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import axis_sizes


class DataShard:
    """This rank's place along `axes` of `mesh` (see the module doc)."""

    def __init__(self, mesh, axes: Sequence[str]):
        sizes = axis_sizes(mesh)
        self.mesh = mesh
        self.axes = tuple(axes)
        self.groups: List = [mesh.get_group(a) for a in self.axes]
        self.size = 1
        self.index = 0
        for a in self.axes:
            self.index = self.index * sizes[a] + mesh.get_local_rank(a)
            self.size *= sizes[a]

    def rows(self, n: int) -> slice:
        """This rank's share of n rows; raises when size does not divide
        n (a share of unequal size would change the global means)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide the {self.size}-way "
                             f"data axes {self.axes}")
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks, in place."""
        for g in self.groups:
            dist.all_reduce(t, group=g)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t concatenated along dim 0 in row order (the
        minor axis gathered first)."""
        for g in reversed(self.groups):
            parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
            dist.all_gather(parts, t.contiguous(), group=g)
            t = torch.cat(parts)
        return t


_ACTIVE: List[Optional[DataShard]] = [None]


@contextlib.contextmanager
def active_shard(shard: Optional[DataShard]) -> Iterator[None]:
    """Makes `shard` the active one inside the block (None: unsharded)."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = shard
    try:
        yield
    finally:
        _ACTIVE[0] = prev


def active() -> Optional[DataShard]:
    return _ACTIVE[0]


def share(x: torch.Tensor) -> torch.Tensor:
    s = _ACTIVE[0]
    return x if s is None else x / s.size


def total(x: torch.Tensor) -> torch.Tensor:
    s = _ACTIVE[0]
    return x if s is None else s.all_reduce(x.detach().clone())


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return shard.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.all_reduce(g.contiguous().clone()), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard, ctx.n = shard, x.shape[0]
        return shard.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        g = ctx.shard.all_reduce(g.contiguous().clone())
        lo = ctx.shard.index * ctx.n
        return g[lo:lo + ctx.n], None


def all_sum(x: torch.Tensor) -> torch.Tensor:
    s = _ACTIVE[0]
    return x if s is None else _AllSum.apply(x, s)


def gather_rows(x: torch.Tensor):
    """(every rank's rows of x in row order, the row offset of this
    rank's); (x, 0) when no shard is active."""
    s = _ACTIVE[0]
    if s is None:
        return x, 0
    return _GatherRows.apply(x, s), s.index * x.shape[0]

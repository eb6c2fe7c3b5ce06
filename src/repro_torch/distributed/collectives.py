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

Tensor-parallel compute (the attention LMs of the zoo, `models/`) runs
its collectives through a `MeshComm`: collectives over named mesh axes
in one of three modes, "group" (a DeviceMesh's process groups),
"count" (no process group, the dry-run: each collective is a record of
the active `analysis.counting.StepCount` and returns an empty tensor of
its output's shape) and "local" (one rank's share computed alone, the
per-rank checks: sums and maxima return this rank's part, for the
caller to combine; each part it summed is kept, in order, in `parts`). A
`ModelShard` is a rank's place for that compute:
its comm, the arch's `sharding.ComputeSplit`, and the autograd
functions the layers call:

  copy_in(x)        the identity; backward all-reduces the gradient over
                    "model" (a replicated input to rank-local compute)
  reduce_out(x)     all-reduce over "model"; backward the identity (the
                    partial outputs of rank-local compute, summed)
  gather(x, axes, dim, grad)
                    all-gather along dim over axes; backward the sum of
                    the gradients, scattered ("sum": every rank used the
                    whole for its own share of the work) or this rank's
                    block of it ("split": every rank did the same work)
  weight(p)         a parameter block with its dims split over the data
                    axes (FSDP) gathered just before use ("sum" backward:
                    the gradient arrives reduce-scattered)
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (
    ComputeSplit, axes_of, axis_sizes, pruned_spec,
)


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


# ---------------------------------------------------------------------------
# collectives over named mesh axes (tensor-parallel compute)
# ---------------------------------------------------------------------------

MODEL = ("model",)


class MeshComm:
    """Collectives over named axes of a mesh of `sizes` ({axis: size}, in
    mesh order) for the rank at `coords` ({axis: index}), in `mode`
    "group" (`groups`: {axis: process group}), "count" or "local" (see
    the module doc; `peers` {data_ptr: [each rank's block]} serves a
    local rank's gathers). Axes of size 1 are skipped: a collective over
    them is the identity and moves nothing."""

    def __init__(self, sizes: Dict[str, int], coords: Dict[str, int],
                 mode: str = "group", groups: Optional[Dict] = None,
                 peers: Optional[Dict[int, list]] = None):
        if mode not in ("group", "count", "local"):
            raise ValueError(f"MeshComm mode {mode!r}: group, count or "
                             f"local")
        self.sizes, self.coords = dict(sizes), dict(coords)
        self.mode, self.groups = mode, groups or {}
        self.peers = peers if peers is not None else {}
        self.parts: List[torch.Tensor] = []

    @classmethod
    def of_mesh(cls, mesh) -> "MeshComm":
        names = list(axis_sizes(mesh))
        return cls(axis_sizes(mesh),
                   {a: mesh.get_local_rank(a) for a in names}, "group",
                   {a: mesh.get_group(a) for a in names})

    def live(self, axes: Sequence[str]) -> Tuple[str, ...]:
        return tuple(a for a in axes if self.sizes.get(a, 1) > 1)

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.sizes.get(a, 1) for a in axes)

    def index(self, axes: Sequence[str]) -> int:
        """This rank's index along `axes`, row-major (the first major)."""
        i = 0
        for a in axes:
            i = i * self.sizes.get(a, 1) + self.coords.get(a, 0)
        return i

    def _record(self, kind: str, axes, t: torch.Tensor) -> None:
        from repro_torch.analysis import counting
        if counting.ACTIVE is not None:
            name = f"model {kind}" if tuple(axes) == MODEL else kind
            counting.ACTIVE.add_collective(name, t.numel() * t.element_size())

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str],
                   op: str = "sum") -> torch.Tensor:
        """t summed (op "sum") or maximised ("max") over the ranks along
        axes, in place in mode "group"; this rank's t in mode "local"."""
        axes = self.live(axes)
        if not axes:
            return t
        if self.mode == "local":
            if op == "sum":
                self.parts.append(t)
            return t
        if self.mode == "count":
            self._record("all-reduce", axes, t)
            return t
        rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        for a in axes:
            dist.all_reduce(t, op=rop, group=self.groups[a])
        return t

    def all_gather(self, t: torch.Tensor, axes: Sequence[str], dim: int
                   ) -> torch.Tensor:
        """Every rank's t along axes, concatenated along dim in rank order
        (the dim split major first, as `sharding.local_block` splits it)."""
        axes = self.live(axes)
        if not axes:
            return t
        dim = dim % t.dim()
        shape = list(t.shape)
        shape[dim] *= self.size(axes)
        if self.mode == "count":
            out = t.new_empty(shape)
            self._record("all-gather", axes, out)
            return out
        if self.mode == "local":
            blocks = self.peers.get(t.data_ptr())
            if blocks is None:
                raise ValueError("a rank computed alone gathers only the "
                                 "blocks its caller put in `peers`")
            return torch.cat(blocks, dim)
        for a in reversed(axes):
            g = self.groups[a]
            parts = [torch.empty_like(t)
                     for _ in range(dist.get_world_size(g))]
            dist.all_gather(parts, t.contiguous(), group=g)
            t = torch.cat(parts, dim)
        return t

    def block(self, t: torch.Tensor, axes: Sequence[str], dim: int
              ) -> torch.Tensor:
        """This rank's block of t along dim (split over axes)."""
        axes = self.live(axes)
        if not axes:
            return t
        n = t.shape[dim] // self.size(axes)
        return t.narrow(dim, self.index(axes) * n, n)

    def reduce_scatter(self, t: torch.Tensor, axes: Sequence[str], dim: int
                       ) -> torch.Tensor:
        """This rank's block along dim of t summed over the ranks along
        axes (an all-reduce, then the block: every backend has both)."""
        axes = self.live(axes)
        if not axes:
            return t
        if self.mode == "count":
            self._record("reduce-scatter", axes, t)
            shape = list(t.shape)
            shape[dim] //= self.size(axes)
            return t.new_empty(shape)
        return self.block(self.all_reduce(t.contiguous().clone(), axes),
                          axes, dim).contiguous()


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous().clone(), ctx.axes), None, \
            None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        return comm.all_reduce(x.contiguous().clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, dim, grad):
        ctx.comm, ctx.axes, ctx.dim, ctx.grad = comm, axes, dim, grad
        return comm.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        comm, axes, dim = ctx.comm, ctx.axes, ctx.dim
        if ctx.grad == "sum":
            out = comm.reduce_scatter(g, axes, dim)
        else:
            out = comm.block(g, axes, dim).contiguous()
        return out, None, None, None, None


def gather(x: torch.Tensor, comm: MeshComm, axes: Sequence[str], dim: int,
           grad: str = "sum") -> torch.Tensor:
    """x gathered along dim over axes (`_Gather`; see the module doc)."""
    axes = comm.live(axes)
    if not axes:
        return x
    return _Gather.apply(x, comm, axes, dim, grad)


class ModelShard:
    """A rank's place for the tensor-parallel compute of a zoo LM: `comm`
    (a `MeshComm`), `split` (the arch's `sharding.ComputeSplit` on this
    mesh), `rules`, and this rank's index along "model" (`rank`). Every
    parameter of a module sharded by it carries its pruned spec as
    `tp_spec`; every submodule carries the shard as `tp`."""

    def __init__(self, comm: MeshComm, split: ComputeSplit, rules: Dict):
        self.comm, self.split, self.rules = comm, split, rules
        self.M = comm.size(MODEL)
        self.rank = comm.index(MODEL)

    def data_shard(self, n_rows: int) -> Optional["CommShard"]:
        """The rows' shard of a batch of n_rows over the rules' "batch"
        axes, as the pruned spec splits it (None: every rank all rows)."""
        axes = axes_of(pruned_spec(("batch",), (n_rows,), self.comm.sizes,
                                   self.rules)[0])
        return CommShard(self.comm, axes) if self.comm.live(axes) else None

    def copy_in(self, x):
        if not self.comm.live(MODEL):
            return x
        return _CopyIn.apply(x, self.comm, MODEL)

    def reduce_out(self, x):
        if not self.comm.live(MODEL):
            return x
        return _ReduceOut.apply(x, self.comm, MODEL)

    def gather_model(self, x, dim: int, grad: str = "sum"):
        return gather(x, self.comm, MODEL, dim, grad)

    def max_model(self, x: torch.Tensor) -> torch.Tensor:
        """x maximised over "model" (no gradient)."""
        return self.comm.all_reduce(x.detach().clone(), MODEL, op="max")

    def weight(self, p: torch.Tensor, local: bool = False,
               whole: Optional[bool] = None) -> torch.Tensor:
        """Parameter block p as the compute uses it: the dims split over
        data axes gathered ("sum" backward: FSDP's reduce-scatter). For
        compute every model rank repeats (`local` False) also the dims
        split over "model" ("split" backward). For a rank's share of the
        compute (`local`) its block of those dims, or with `whole` the
        dims gathered ("sum": each rank used its part of the whole); a
        parameter "model" does not split enters such a share by copy-in,
        so that its gradient is summed over the shares."""
        whole = (not local) if whole is None else whole
        w, on_model = p, False
        for d, entry in enumerate(getattr(p, "tp_spec", ())):
            axes = axes_of(entry)
            data = tuple(a for a in axes if a != "model")
            if data and len(data) < len(axes):
                raise ValueError(f"dim {d} of a weight is split over "
                                 f"{axes}: the compute splits a dim over "
                                 f"\"model\" or over data axes, not both")
            if data:
                w = gather(w, self.comm, data, d, "sum")
            elif axes and self.comm.live(MODEL):
                on_model = True
                if whole:
                    w = gather(w, self.comm, MODEL, d,
                               "sum" if local else "split")
        return self.copy_in(w) if local and not on_model else w


class CommShard(DataShard):
    """A `DataShard` along `axes` whose collectives go through a
    `MeshComm` (any of its modes)."""

    def __init__(self, comm: MeshComm, axes: Sequence[str]):
        self.mesh, self.comm = None, comm
        self.axes = tuple(axes)
        self.groups = []
        self.size = comm.size(self.axes)
        self.index = comm.index(self.axes)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return self.comm.all_reduce(t, self.axes)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return self.comm.all_gather(t, self.axes, 0)

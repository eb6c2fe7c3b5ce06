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

Tensor-parallel compute (every LM of the zoo, the Stage-1 encoder and
the Stage-2 model, `models/`, `core/`) runs its collectives through a
`MeshComm`: collectives over named mesh axes in one of four modes,
"group" (a DeviceMesh's process groups), "count" (no process group, the
dry-run: each collective is a record of the active
`analysis.counting.StepCount` and returns an empty tensor of its
output's shape), "local" (one rank's share computed alone, the per-rank
checks of compute whose sums all feed replicated compute: sums and
maxima return this rank's part, for the caller to combine; each part it
summed is kept, in order, in `parts`) and "thread" (the ranks of a mesh
run as threads of one process, `run_threads`, each collective meeting
every rank's tensor in a `Room`: the per-rank checks of compute that
consumes a sum itself, forward and backward, with no process group). A
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
  all_sum(x)        all-reduce over "model" both ways: a sum of partials
                    that rank-local compute consumes (its gradient is
                    partial on each rank too)
  exchange_halves(p)
                    a rank's block of a projection stored split over its
                    whole output but used as two halves -> this rank's
                    channels of each half (one all-to-all; backward the
                    inverse all-to-all)
  splits(p, dim, units)
                    whether the rank computes its share along dim of p:
                    the stored spec splits dim over "model" and M divides
                    the units (heads) it holds
"""
from __future__ import annotations

import contextlib
import copy
import math
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.distributed import sharding
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


class Room:
    """Where the `n` ranks of a mesh, run as threads of one process (a
    MeshComm in mode "thread"), meet: `exchange` hands every rank the
    values all of them brought. A rank that waits longer than `timeout`
    seconds for the others fails (threading.BrokenBarrierError) instead of
    hanging."""

    def __init__(self, n: int, timeout: float = 300.0):
        self.n = n
        self.slots: List = [None] * n
        self.barrier = threading.Barrier(n, timeout=timeout)

    def exchange(self, rank: int, value) -> list:
        self.slots[rank] = value
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


def run_threads(fn, n: int, room: Optional[Room] = None) -> list:
    """[fn(0), ..., fn(n - 1)], each call in a thread of its own (the ranks
    of a MeshComm in mode "thread"); the first exception of a rank is
    raised here, after it broke `room` (the ranks' Room), so that the
    others stop waiting for it. Each thread runs its backward passes
    itself (`set_multithreading_enabled(False)`), so that a collective in
    a backward on the card meets the other ranks' instead of waiting on
    the autograd engine's one device thread."""
    out: List = [None] * n
    errors: List = []

    def main(r):
        try:
            with torch.autograd.set_multithreading_enabled(False):
                out[r] = fn(r)
        except BaseException as e:      # noqa: BLE001 (re-raised below)
            errors.append(e)
            if room is not None:
                room.barrier.abort()

    threads = [threading.Thread(target=main, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        real = [e for e in errors
                if not isinstance(e, threading.BrokenBarrierError)]
        raise (real or errors)[0]
    return out


class MeshComm:
    """Collectives over named axes of a mesh of `sizes` ({axis: size}, in
    mesh order) for the rank at `coords` ({axis: index}), in `mode`
    "group" (`groups`: {axis: process group}), "count", "local" or
    "thread" (`room`: the `Room` every rank of the mesh meets in; see
    the module doc; `peers` {data_ptr: [each rank's block]} serves a
    local rank's gathers). Axes of size 1 are skipped: a collective over
    them is the identity and moves nothing."""

    def __init__(self, sizes: Dict[str, int], coords: Dict[str, int],
                 mode: str = "group", groups: Optional[Dict] = None,
                 peers: Optional[Dict[int, list]] = None,
                 room: Optional[Room] = None):
        if mode not in ("group", "count", "local", "thread"):
            raise ValueError(f"MeshComm mode {mode!r}: group, count, local "
                             f"or thread")
        if (mode == "thread") != (room is not None):
            raise ValueError("a Room serves the ranks of mode thread only")
        self.sizes, self.coords = dict(sizes), dict(coords)
        self.mode, self.groups = mode, groups or {}
        self.peers = peers if peers is not None else {}
        self.room = room
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

    def index(self, axes: Sequence[str], coords: Optional[Dict] = None
              ) -> int:
        """This rank's (or the rank at `coords`) index along `axes`,
        row-major (the first major)."""
        coords = self.coords if coords is None else coords
        i = 0
        for a in axes:
            i = i * self.sizes.get(a, 1) + coords.get(a, 0)
        return i

    def _record(self, kind: str, axes, t: torch.Tensor) -> None:
        from repro_torch.analysis import counting
        if counting.ACTIVE is not None:
            name = f"model {kind}" if tuple(axes) == MODEL else kind
            counting.ACTIVE.add_collective(name, t.numel() * t.element_size())

    def _met(self, axes: Sequence[str], value) -> list:
        """Mode "thread": the values the ranks of this rank's group along
        axes (the ranks that share its coordinates on the other axes)
        brought to the same collective, in their index order along
        axes."""
        everyone = self.room.exchange(self.index(tuple(self.sizes)),
                                      (dict(self.coords), value))
        others = [a for a in self.sizes if a not in axes]
        group = [(c, v) for c, v in everyone
                 if all(c.get(a, 0) == self.coords.get(a, 0)
                        for a in others)]
        group.sort(key=lambda cv: self.index(axes, cv[0]))
        return [v for _, v in group]

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
        if self.mode == "thread":
            parts = self._met(axes, t.detach().clone())
            out = parts[0]
            for p in parts[1:]:     # in rank order, the same on every rank
                out = out + p if op == "sum" else torch.maximum(out, p)
            with torch.no_grad():
                t.copy_(out)
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
        if self.mode == "thread":
            return torch.cat(self._met(axes, t.detach().clone()), dim)
        for a in reversed(axes):
            g = self.groups[a]
            parts = [torch.empty_like(t)
                     for _ in range(dist.get_world_size(g))]
            dist.all_gather(parts, t.contiguous(), group=g)
            t = torch.cat(parts, dim)
        return t

    def all_to_all(self, pieces: Sequence[torch.Tensor], dests: Sequence[int],
                   srcs: Sequence[int], axes: Sequence[str] = MODEL
                   ) -> List[torch.Tensor]:
        """pieces[i] sent to the rank at index dests[i] along axes (one
        axis); returns the pieces from the ranks at srcs, in that order.
        Every piece has one shape, and a pair of ranks carries at most
        one of them."""
        axes = self.live(axes)
        if not axes:
            return [pieces[dests.index(s)] for s in srcs]
        if len(axes) != 1 or len(set(dests)) != len(dests) or \
                len(set(srcs)) != len(srcs):
            raise ValueError("an all-to-all over one axis, at most one "
                             "piece a pair of ranks")
        shape, like = pieces[0].shape, pieces[0]
        if self.mode == "count":
            for p in pieces:
                self._record("all-to-all", axes, p)
            return [like.new_empty(shape) for _ in srcs]
        if self.mode == "local":
            raise ValueError("a rank computed alone cannot receive another "
                             "rank's piece: run the ranks as threads")
        me = self.index(axes)
        if self.mode == "thread":
            sent = self._met(axes, [(d, p.detach().clone())
                                    for d, p in zip(dests, pieces)])
            return [next(p for d, p in sent[s] if d == me) for s in srcs]
        n = self.size(axes)
        order = sorted(range(len(dests)), key=lambda i: dests[i])
        send = torch.cat([pieces[i].reshape(-1) for i in order])
        numel = pieces[0].numel()
        recv = send.new_empty(len(srcs) * numel)
        dist.all_to_all_single(
            recv, send, [numel * (s in srcs) for s in range(n)],
            [numel * (d in dests) for d in range(n)],
            group=self.groups[axes[0]])
        got = dict(zip(sorted(srcs), recv.split(numel)))
        return [got[s].reshape(shape) for s in srcs]

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


class _ModelAllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return comm.all_reduce(x.contiguous().clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous().clone(), ctx.axes), None, \
            None


def _halves_routes(M: int, r: int):
    """The all-to-all of `exchange_halves` on rank r of M: where this
    rank's two chunks go (chunk 2r + j of the 2M along the whole output is
    channel block (2r + j) mod M of half (2r + j) // M) and where its two
    blocks come from (block r of the first half from rank r // 2, of the
    second from rank (M + r) // 2)."""
    return [(2 * r) % M, (2 * r + 1) % M], [r // 2, (M + r) // 2]


class _ExchangeHalves(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        n = p.shape[-1] // 2
        dests, srcs = _halves_routes(comm.size(axes), comm.index(axes))
        ctx.routes = dests, srcs
        a, b = comm.all_to_all([p[..., :n].contiguous(),
                                p[..., n:].contiguous()], dests, srcs, axes)
        return a, b

    @staticmethod
    def backward(ctx, ga, gb):
        dests, srcs = ctx.routes
        back = ctx.comm.all_to_all([ga.contiguous(), gb.contiguous()], srcs,
                                   dests, ctx.axes)
        return torch.cat(back, -1), None, None


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

    def __deepcopy__(self, memo):
        # a handle on the rank's place (process groups, a Room), shared by
        # copies of a module
        return self

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

    def all_sum(self, x):
        if not self.comm.live(MODEL):
            return x
        return _ModelAllSum.apply(x, self.comm, MODEL)

    def exchange_halves(self, p):
        """p (..., 2n): this rank's block of the output of a projection
        whose whole output (..., 2 M n) the code cuts into two halves (a
        gate and its input, Mamba's xi and z) -> (a, b), each (..., n):
        this rank's block of channels of each half, as the halves'
        consumers are stored (their "ff" split). One all-to-all (B S 2n
        elements out and in), against gathering the projection's weight."""
        if not self.comm.live(MODEL):
            return p.chunk(2, dim=-1)
        return _ExchangeHalves.apply(p, self.comm, MODEL)

    def splits(self, p: torch.Tensor, dim: int, units: int = 0) -> bool:
        """Whether the rank computes only its share along dim of the
        parameter block p: its stored spec (`tp_spec`) splits dim over
        "model", and M divides `units`, the whole units (heads) along it
        (0: any column is a unit)."""
        spec = getattr(p, "tp_spec", ())
        return (bool(self.comm.live(MODEL)) and dim < len(spec)
                and "model" in axes_of(spec[dim])
                and (units == 0 or units % self.M == 0))

    def head_block(self, x, dim: int):
        """This rank's block along dim of a tensor every rank holds whole
        (a replicated leaf's columns, the gates of every head)."""
        return self.comm.block(x, MODEL, dim)

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


def shard_module(module: nn.Module, comm, rules=None,
                 specs: Optional[Dict[str, tuple]] = None, cfg=None
                 ) -> nn.Module:
    """Makes `module` (whole, any device) hold, in place, the blocks of its
    parameters that the rank of `comm` (a `MeshComm`, or a DeviceMesh)
    holds when each is stored by its pruned spec (`specs`, keyed by the
    "/"-joined parameter names, default `module.param_specs()`, under
    `rules` (default `sharding.LOGICAL_RULES`) and the overrides of
    `cfg`, the zoo arch's `ModelConfig`; None for a model that is no LM
    of the zoo, such as the Stage-1 encoder or the Stage-2 model),
    keeping each spec as the parameter's `tp_spec`, and gives every
    submodule the rank's ModelShard as `tp`: the tensor-parallel route
    of the `Trainer` and `Stage2Engine`. Returns it."""
    if not isinstance(comm, MeshComm):
        comm = MeshComm.of_mesh(comm)
    specs = module.param_specs() if specs is None else specs
    rules = (sharding.arch_rules(cfg, rules) if cfg is not None
             else dict(rules or sharding.LOGICAL_RULES))
    sizes = comm.sizes
    tp = ModelShard(comm, sharding.compute_split(cfg, sizes, rules), rules)
    with torch.no_grad():
        for name, p in module.named_parameters():
            spec = sharding.pruned_spec(specs[name.replace(".", "/")],
                                        p.shape, sizes, rules)
            block = sharding.local_block(p.data, spec, sizes, comm.coords)
            if block.shape != p.shape:
                p.data = block.clone(memory_format=torch.contiguous_format)
            p.tp_spec = spec
    for m in module.modules():
        m.tp = tp
    return module


def rank_shares(module: nn.Module, specs: Dict[str, tuple], cfg, M: int,
                rules=None, ranks=None, mode: str = "local") -> list:
    """Copies of `module` as ranks `ranks` (default 0..M-1) of a "model"
    axis of M hold it. In mode "local" each is over its own `MeshComm`:
    one rank computed alone, its reductions returning its own part for
    the caller to combine in rank order; with every rank made, a gather
    of a parameter's block over "model" finds the blocks of all of them
    (`peers`). In mode "thread" the copies' comms meet in one `Room`: run
    them with `collectives.run_threads`, every rank's collectives (both
    ways) meeting the others'."""
    peers: Dict[int, list] = {}
    room = Room(M) if mode == "thread" else None
    copies = [shard_module(copy.deepcopy(module), MeshComm(
        {"model": M}, {"model": r}, mode, peers=peers, room=room), rules,
        specs, cfg)
        for r in (range(M) if ranks is None else ranks)]
    if ranks is None and mode == "local":
        for blocks in zip(*(list(c.parameters()) for c in copies)):
            for b in blocks:
                peers[b.data_ptr()] = [x.data for x in blocks]
    return copies

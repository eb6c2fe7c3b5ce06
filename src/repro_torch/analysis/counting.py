"""Counting one step's work while it runs: the port's counterpart of
`repro.analysis.hlo_parse`.

XLA's analysis reads a compiled program; torch has none, so the count is
taken while the step runs, by a `TorchDispatchMode` that sees every aten
op. It runs the same on meta tensors (the dry-run, where nothing is
allocated), on the CPU and on the card, and gives the same count on all
three for the same shapes:

  * products: FLOPs of every matmul-like op by `torch.utils.flop_counter`'s
    formulas, by operand dtype (bf16 / fp16 for the tensor cores' peak,
    fp32 for the fp32 peak);
  * bytes: the input plus output bytes of each aten op; views and bare
    allocations move none, as `hlo_parse` counts a fusion at its call
    site and skips bitcasts;
  * collective bytes by kind (all-reduce, all-gather, ...) of any c10d
    op, and what a caller adds by `add_collective` (the tensor-parallel
    compute's collectives with no process group, `distributed.
    collectives.MeshComm` in mode "count": over the "model" axis under
    "model all-reduce", "model all-gather", "model all-to-all" (the
    exchange of a projection's halves, `ModelShard.exchange_halves`),
    ...; the sums both ways of `ModelShard.all_sum` are a "model
    all-reduce" in each direction);
  * the peak of live tensor bytes: every storage an op makes is live
    from its making until it is freed (tensors made before the count are
    its baseline, not counted);
  * one `Record` per counted region.

A counted region is either

  * a kernel wrapper (`kernels/*/ops.py`): under an active count each
    wrapper adds its kernel's `costs` work as one record and the aten
    ops inside it are not counted, so the plain version on the CPU, the
    shape propagation on meta and the kernel on the card count the same;
  * a recurrent token loop (`models/ssm.py`, through `token_loop`): on
    the CPU and the card its ops are counted as they run. On meta the
    loop is not run: it is run at 2, 3 and 4 tokens, forward (and, in
    the backward, backward) under sub-counts, and each count is
    extrapolated to S tokens by the quadratic through those three points
    (the bytes live at once by the line through the last two). That is
    `hlo_parse`'s trip-count rule (`_trip_count`), made exact for loops
    whose backward grows with S per token (a token's `select_backward`
    writes a zeroed tensor of the whole sequence, and the S of them are
    summed).

The wrappers and loops read one module-level variable, `ACTIVE`, the
count in force (None outside `with StepCount():`); with none, that is
all they cost.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, \
    Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.costs import Work

# the count in force, read by every kernel wrapper and token loop
ACTIVE: Optional["StepCount"] = None

_aten = torch.ops.aten
# ops that move no bytes though they are no views: bare allocations, and
# ops that hand back (a view of) their input
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten.new_empty.default,
             _aten.new_empty_strided.default, _aten._unsafe_view.default,
             _aten._local_scalar_dense.default, _aten.detach_.default}
# outputs that share their input's storage without saying so in the schema
_ALIASING = {_aten._unsafe_view.default}
_COLLECTIVES = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                ("all_gather", "all-gather"), ("allgather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                ("broadcast", "broadcast"), ("send", "collective-permute"),
                ("recv", "collective-permute"))


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            if isinstance(y, torch.Tensor):
                yield y


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class Tally:
    """What a stretch of a step did: FLOPs of products by dtype name,
    bytes, collective bytes and calls by kind; and the peak of live
    bytes above `base`, the live bytes when it began."""
    flops: Dict[str, float] = field(default_factory=dict)
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    base: int = 0
    peak: int = 0

    @property
    def flops_bf16(self) -> float:
        return sum(v for k, v in self.flops.items()
                   if k in ("bfloat16", "float16"))

    @property
    def flops_fp32(self) -> float:
        return sum(v for k, v in self.flops.items()
                   if k not in ("bfloat16", "float16"))

    def add_flops(self, dtype: torch.dtype, n: float) -> None:
        key = str(dtype).replace("torch.", "")
        self.flops[key] = self.flops.get(key, 0.0) + n

    def add_collective(self, kind: str, nbytes: float, calls: int = 1
                       ) -> None:
        self.collective_bytes[kind] = (self.collective_bytes.get(kind, 0.0)
                                       + nbytes)
        self.collective_counts[kind] = (self.collective_counts.get(kind, 0)
                                        + calls)

    def add(self, other: "Tally") -> None:
        for k, v in other.flops.items():
            self.flops[k] = self.flops.get(k, 0.0) + v
        self.bytes += other.bytes
        for k, v in other.collective_bytes.items():
            self.add_collective(k, v, other.collective_counts.get(k, 0))


class Record(NamedTuple):
    """One counted region: a kernel call ("kernel", trips 1) or a token
    loop's forward ("loop", trips = its tokens)."""
    name: str
    kind: str
    flops_fp32: float
    flops_bf16: float
    bytes: float
    trips: int = 1


class _Mode(TorchDispatchMode):
    def __init__(self, count: "StepCount"):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # reached whole only where autograd is off (inference mode):
            # counted as its parts, as everywhere else
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        count = self.count
        sink = count._sinks[-1]
        if sink is not None:
            _count_op(sink, func, args, kwargs, out)
        count._track(func, out)
        return out


_COMPOSITE: Dict = {}


_BACKEND_KEYS = ("CPU", "CUDA", "Meta", "CompositeExplicitAutograd",
                 "CompositeExplicitAutogradNonFunctional")


def _composite(func) -> bool:
    """True for an op made only of other ops (a CompositeImplicitAutograd
    kernel and no kernel of its own), which autograd decomposes before it
    reaches a mode; an op with a kernel of its own runs as it is."""
    hit = _COMPOSITE.get(func)
    if hit is None:
        has = torch._C._dispatch_has_kernel_for_dispatch_key
        keys = torch._C.DispatchKey
        name = func.name()
        hit = has(name, keys.CompositeImplicitAutograd) and not any(
            has(name, getattr(keys, k)) for k in _BACKEND_KEYS)
        _COMPOSITE[func] = hit
    return hit


_ALIASES: Dict = {}


def _aliases(func) -> bool:
    """True for an op whose outputs share an input's storage (a view, an
    in-place op): they make no new storage."""
    hit = _ALIASES.get(func)
    if hit is None:
        hit = func in _ALIASING or any(
            r.alias_info is not None for r in func._schema.returns)
        _ALIASES[func] = hit
    return hit


def _count_op(sink: Tally, func, args, kwargs, out) -> None:
    formula = flop_registry.get(func._overloadpacket)
    if formula is not None:
        operand = next(_tensors(args), None)
        sink.add_flops(operand.dtype if operand is not None else
                       torch.float32, formula(*args, **kwargs, out_val=out))
    if func.namespace in ("c10d", "_c10d_functional"):
        name = func._overloadpacket.__name__
        for key, kind in _COLLECTIVES:
            if key in name:
                sink.add_collective(kind, sum(map(_nbytes, _tensors(out))))
                break
    if func.is_view or func in _NO_BYTES:
        return
    n = 0
    for a in args:
        for t in _tensors(a):
            n += _nbytes(t)
    for a in kwargs.values():
        for t in _tensors(a):
            n += _nbytes(t)
    for t in _tensors(out):
        n += _nbytes(t)
    sink.bytes += n


class StepCount:
    """`with StepCount() as count:` counts what the block does (see the
    module doc): `flops_fp32`, `flops_bf16`, `bytes`, `collective_bytes`,
    `peak_bytes`, `records`. Counts nest: the inner one is in force
    inside it, and the outer one counts nothing meanwhile."""

    def __init__(self):
        self.total = Tally()
        self.records: List[Record] = []
        self.live = 0
        self.allocations = 0          # storages made during the count
        # where ops are counted: the innermost entry (None inside a kernel
        # region: not counted)
        self._sinks: List[Optional[Tally]] = [self.total]
        # tallies whose peak follows the live bytes
        self._watch: List[Tally] = [self.total]
        self._storages: Dict[int, int] = {}

    def __enter__(self) -> "StepCount":
        global ACTIVE
        self._outer = ACTIVE
        if self._outer is not None:
            self._outer._sinks.append(None)
        ACTIVE = self
        self._mode = _Mode(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        global ACTIVE
        self._mode.__exit__(*exc)
        ACTIVE = self._outer
        if self._outer is not None:
            self._outer._sinks.pop()

    # ------------------------------------------------------------ results
    @property
    def flops_fp32(self) -> float:
        return self.total.flops_fp32

    @property
    def flops_bf16(self) -> float:
        return self.total.flops_bf16

    @property
    def flops(self) -> float:
        return self.flops_fp32 + self.flops_bf16

    @property
    def bytes(self) -> float:
        return self.total.bytes

    @property
    def collective_bytes(self) -> Dict[str, float]:
        return dict(self.total.collective_bytes)

    @property
    def peak_bytes(self) -> int:
        """The most bytes of tensors made during the count that were live
        at once."""
        return self.total.peak

    def kernels(self) -> Dict[str, dict]:
        """The kernel records summed by name: calls, flops_fp32,
        flops_bf16, bytes."""
        out: Dict[str, dict] = {}
        for r in self.records:
            if r.kind != "kernel":
                continue
            d = out.setdefault(r.name, dict(calls=0, flops_fp32=0.0,
                                            flops_bf16=0.0, bytes=0.0))
            d["calls"] += 1
            d["flops_fp32"] += r.flops_fp32
            d["flops_bf16"] += r.flops_bf16
            d["bytes"] += r.bytes
        return out

    def summary(self) -> dict:
        """Everything counted, as plain numbers (JSON)."""
        return dict(flops=dict(self.total.flops), flops_fp32=self.flops_fp32,
                    flops_bf16=self.flops_bf16, bytes=self.bytes,
                    collective_bytes=self.collective_bytes,
                    collective_counts=dict(self.total.collective_counts),
                    peak_bytes=self.peak_bytes, kernels=self.kernels(),
                    loops=[r._asdict() for r in self.records
                           if r.kind == "loop"])

    # ------------------------------------------------------------ regions
    @property
    def open(self) -> bool:
        """False inside a kernel region (its ops are not counted)."""
        return self._sinks[-1] is not None

    @contextlib.contextmanager
    def kernel(self, name: str, work: Work) -> Iterator[None]:
        """A kernel wrapper's call: its ops are not counted, `work` is."""
        self._sinks.append(None)
        try:
            yield
        finally:
            self._sinks.pop()
        self._add_work(work)
        self.records.append(Record(name, "kernel", *work))

    def _add_work(self, work: Work) -> None:
        sink = self._sinks[-1]
        if sink is None:
            return
        if work.flops_fp32:
            sink.add_flops(torch.float32, work.flops_fp32)
        if work.flops_bf16:
            sink.add_flops(torch.bfloat16, work.flops_bf16)
        sink.bytes += work.bytes

    @contextlib.contextmanager
    def loop(self, name: str, trips: int) -> Iterator[None]:
        """A token loop run in full: its ops are counted as they run, and
        its forward is recorded."""
        t = Tally()
        self._sinks.append(t)
        try:
            yield
        finally:
            self._sinks.pop()
        self._merge(t)
        self.records.append(Record(name, "loop", t.flops_fp32, t.flops_bf16,
                                   t.bytes, trips))

    def _merge(self, t: Tally) -> None:
        if self._sinks[-1] is not None:
            self._sinks[-1].add(t)

    def add_collective(self, kind: str, nbytes: float, calls: int = 1
                       ) -> None:
        """Collective bytes moved by communication that did not run as
        an op here (the dry-run's reckoning of a sharded step)."""
        sink = self._sinks[-1]
        if sink is not None:
            sink.add_collective(kind, nbytes, calls)

    def _probe(self, fn: Callable, counted: bool = True):
        """(tally, fn()): fn's ops in a fresh tally (or counted nowhere)
        whose peak follows the live bytes above those before it."""
        t = Tally(base=self.live)
        self._sinks.append(t if counted else None)
        self._watch.append(t)
        try:
            out = fn()
        finally:
            self._sinks.pop()
            self._watch.pop()
        return t, out

    # -------------------------------------------------------- live bytes
    def _track(self, func, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages or _aliases(func):
                continue
            n = st.nbytes()
            self.allocations += 1
            self._storages[key] = n
            weakref.finalize(st, self._free, key)
            self._grow(n)

    def _grow(self, n: int) -> None:
        self.live += n
        self._reach(self.live)

    def _reach(self, live: int) -> None:
        for t in self._watch:
            if live - t.base > t.peak:
                t.peak = live - t.base

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)


# ---------------------------------------------------------------------------
# token loops
# ---------------------------------------------------------------------------

# the sequence lengths a loop is probed at on meta
PROBE_TOKENS = (2, 3, 4)


def _quadratic(values: Sequence[float], S: int) -> float:
    """The value at S of the quadratic through (2, v2), (3, v3), (4, v4)
    (Lagrange; exact in integers: (S-3)(S-4) and (S-2)(S-3) are even)."""
    v2, v3, v4 = values
    return (v2 * ((S - 3) * (S - 4) // 2) - v3 * ((S - 2) * (S - 4))
            + v4 * ((S - 2) * (S - 3) // 2))


def _linear(values: Sequence[float], S: int) -> float:
    """The value at S of the line through the last two probes (3, v3),
    (4, v4): bytes live at once grow by a token's worth a token once the
    loop is under way, but the first tokens' are not yet steady."""
    return values[-1] + (values[-1] - values[-2]) * (S - PROBE_TOKENS[-1])


def _fit(tallies: Sequence[Tally], S: int) -> Tally:
    out = Tally()
    keys = {k for t in tallies for k in t.flops}
    for k in keys:
        out.flops[k] = _quadratic([t.flops.get(k, 0.0) for t in tallies], S)
    out.bytes = _quadratic([t.bytes for t in tallies], S)
    for k in {k for t in tallies for k in t.collective_bytes}:
        out.collective_bytes[k] = _quadratic(
            [t.collective_bytes.get(k, 0.0) for t in tallies], S)
        out.collective_counts[k] = int(_quadratic(
            [t.collective_counts.get(k, 0) for t in tallies], S))
    out.peak = max(0, int(_linear([t.peak for t in tallies], S)))
    return out


def _own_graph():
    """A probe's graph keeps what it saves, whatever saved-tensor hooks the
    step has set (a checkpoint's drop them in its forward and keep them
    in its recompute, and the probes must measure the same both times)."""
    return torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                    lambda t: t)


class _Loop:
    """A token loop `fn(*args)` over dim 1 of `args[i]` for i in
    `seq_args`, returning one tensor with its tokens on dim 1, counted on
    meta from its probes. It keeps the tensor args' shapes, dtypes and
    grad flags, not the tensors (which the step frees as it goes)."""

    def __init__(self, count: StepCount, name: str, fn: Callable,
                 args: tuple, seq_args: Sequence[int], S: int):
        self.count, self.name, self.fn = count, name, fn
        self.seq_args, self.S = tuple(seq_args), S
        self.args = [(tuple(a.shape), a.dtype, a.requires_grad)
                     if isinstance(a, torch.Tensor) else a for a in args]
        self.tensor = [isinstance(a, torch.Tensor) for a in args]

    def _inputs(self, n: int, grad: bool) -> list:
        """Fresh meta tensors of the args' shapes, the sequences at n
        tokens; leaves requiring grad as the args do when `grad`."""
        out = list(self.args)
        for i, a in enumerate(self.args):
            if self.tensor[i]:
                shape, dtype, req = a
                if i in self.seq_args:
                    shape = (shape[0], n) + shape[2:]
                out[i] = torch.empty(shape, dtype=dtype, device="meta")
                out[i].requires_grad_(grad and req)
        return out

    def forward(self, grad: bool):
        """(y, a meta tensor as big as what the whole loop's graph would
        hold for the backward, or None): saved for the backward, it is
        live exactly as long as that graph (freed at once under a
        checkpoint, as the graph is)."""
        count = self.count
        base = count.live
        tallies, kept = [], []
        for n in PROBE_TOKENS:
            inputs = self._inputs(n, grad)
            start = count.live
            with torch.set_grad_enabled(grad), _own_graph():
                t, out = count._probe(lambda: self.fn(*inputs))
            kept.append(count.live - start)      # the output and its graph
            tallies.append(t)
            shape, dtype = list(out.shape), out.dtype
            del out, inputs
        fit = _fit(tallies, self.S)
        count._merge(fit)
        count.records.append(Record(self.name, "loop", fit.flops_fp32,
                                    fit.flops_bf16, fit.bytes, self.S))
        count._reach(base + fit.peak)
        shape[1] = self.S
        y = torch.empty(shape, dtype=dtype, device="meta")
        held = None
        if grad:
            n = max(0, int(_linear(kept, self.S)) - _nbytes(y))
            held = torch.empty((n,), dtype=torch.uint8, device="meta")
        return y, held

    def backward(self, dy: torch.Tensor, needs: Sequence[bool]) -> list:
        count = self.count
        base = count.live
        tallies = []
        for n in PROBE_TOKENS:
            inputs = self._inputs(n, True)
            with torch.enable_grad(), _own_graph():
                _, out = count._probe(lambda: self.fn(*inputs), counted=False)
            leaves = [a for a, need in zip(inputs, needs)
                      if need and isinstance(a, torch.Tensor)]
            g = torch.empty(out.shape, dtype=dy.dtype, device="meta")
            t, _ = count._probe(lambda: torch.autograd.grad(
                out, leaves, g, allow_unused=True))
            tallies.append(t)
            del out, inputs, leaves, g
        fit = _fit(tallies, self.S)
        count._merge(fit)
        count._reach(base + fit.peak)
        return [torch.empty(a[0], dtype=a[1], device="meta")
                if need and tensor else None
                for a, need, tensor in zip(self.args, needs, self.tensor)]


class _MetaLoop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, loop: _Loop, *args):
        ctx.loop = loop
        y, held = loop.forward(grad=True)
        ctx.save_for_backward(held)
        return y

    @staticmethod
    def backward(ctx, dy):
        _ = ctx.saved_tensors         # the graph's bytes live until now
        return (None, *ctx.loop.backward(dy, ctx.needs_input_grad[1:]))


def token_loop(name: str, fn: Callable, args: Sequence,
               seq_args: Sequence[int]) -> torch.Tensor:
    """fn(*args): a loop over the tokens on dim 1 of `args[i]` for i in
    `seq_args`, returning (B, S, ...). Without an active count it is
    fn(*args); under one it is a counted region (see the module doc): run
    and recorded on the CPU and the card, probed and extrapolated on
    meta for S past the probes' lengths."""
    count = ACTIVE
    if count is None or not count.open:
        return fn(*args)
    seq = args[seq_args[0]]
    S = seq.shape[1]
    if seq.device.type != "meta" or S <= PROBE_TOKENS[-1]:
        with count.loop(name, S):
            return fn(*args)
    loop = _Loop(count, name, fn, tuple(args), seq_args, S)
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return _MetaLoop.apply(loop, *args)
    return loop.forward(grad=False)[0]

"""Trainer, port of `repro.train.trainer`: microbatch accumulation,
global-norm clipping, the warmup + cosine schedule, the optimizer update,
checkpoint/restart with exact resume, preemption handling, a straggler
watchdog, and data-parallel training with sharded state over a mesh.

The model's parameters are updated in place (`copy_` of the optimizer's
new values into the `nn.Parameter`s), so the module stays the one
source of the weights; the optimizer functions themselves are pure.

Under a mesh there are two routes, chosen by the module:

Tensor-parallel (a module built as one rank's blocks, so that it
carries its `ModelShard` as `tp`: a zoo LM by `Model.init(mesh=,
rules=)` or `transformer.shard_lm`, the Stage-1 encoder and the
Stage-2 model by `collectives.shard_module(module, mesh)`): the module
holds only this rank's blocks of the parameters, placed by the rules'
pruned specs, and so does the optimizer state. A step on the
GLOBAL batch:

  * gives this rank its share of each microbatch along the rules'
    "batch" axes (its rows; the ranks of one "model" group hold the same
    rows);
  * runs forward and backward on it computing only this rank's share of
    the work (its heads, ff columns, recurrent channels, experts or
    expert columns and vocab rows on "model", see `models/` and
    `core/`), each weight split over the data
    axes (FSDP) gathered just before its use, so that its gradient
    arrives reduce-scattered over them;
  * all-reduces the other gradients over the "batch" axes that do not
    split them (a leaf replicated over "model" already has the same
    gradient on every model rank: its uses in a rank's share, whole or
    by a slice as RWKV's w_bias and the sLSTM's b_zifo, entered by
    copy-in), sums the loss and the metrics over the "batch" axes, takes
    the global norm from the blocks (each leaf's sum of squares summed
    over the axes that split it, once) and updates the blocks in place
    (Adafactor's means summed over the axes that split each dim).

Replicated (any other module, e.g. a whole LM, Stage-1 encoder or
Stage-2 model, with `mesh` (a DeviceMesh on the parameters' device
type), `rules` and the parameters' logical specs, `param_specs`, by
default the model's own): every rank holds its shard of each parameter
and of its optimizer state as DTensors placed by the rules
(`state.param_shards`, `state.opt_state`), as JAX's `device_put` places
them; a step splits the batch as above, runs forward and backward on
the share with the FULL parameters (the losses reading global counts
and gathered rows through `repro_torch.distributed.collectives`), sums
the gradients, the loss and the metrics over the data axes, clips by the
global norm, updates this rank's shards and gathers the full parameters
into the model; ranks along "model" compute the same rows.

Every rank must call `step`, `maybe_checkpoint` and `restore` alike:
each enters collectives. Checkpoints hold full tensors in the unsharded
layout on either route: every rank gathers, global rank 0 writes, and a
restore re-shards onto the current mesh, whatever mesh wrote it.
"""
from __future__ import annotations

import collections
import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.config import TrainConfig
from repro_torch.distributed.collectives import (
    CommShard, DataShard, active_shard,
)
from repro_torch.distributed.sharding import (
    axes_of, distribute, logical_to_pspec, make_shardings, set_logical_mesh,
)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import (
    Shards, global_norm_clip, lr_schedule, make_optimizer,
)
from repro_torch.utils import spans
from repro_torch.utils.log import get_logger
from repro_torch.utils.tree import tree_map

log = get_logger("repro_torch.train")

# steps whose median the straggler watchdog compares each step with
_STRAGGLER_WINDOW = 20


@dataclasses.dataclass
class TrainState:
    params: Dict[str, nn.Parameter]   # "/"-joined names, the JAX tree keys
    opt_state: Any                    # DTensor leaves under a mesh
    step: int
    # under a mesh: {name: DTensor}, this rank's shard of each parameter
    param_shards: Optional[Dict[str, Any]] = None


def _split(batch: Any, mb: int, i: int) -> Any:
    """The i-th of mb equal leading-dim slices of every tensor in batch."""
    if isinstance(batch, dict):
        return {k: _split(v, mb, i) for k, v in batch.items()}
    n = batch.shape[0] // mb
    return batch[i * n:(i + 1) * n]


def _share(batch: Any, shard: Optional[DataShard]) -> Any:
    """This rank's share of the rows of every tensor in batch."""
    if shard is None:
        return batch
    if isinstance(batch, dict):
        return {k: _share(v, shard) for k, v in batch.items()}
    return batch[shard.rows(batch.shape[0])]


def _slot_placement(place: tuple, leaf: str, ndim: int) -> tuple:
    """An Adafactor slot's placements from its parameter's: vr drops the
    last dim, vc the one before it; the rest is laid out as the
    parameter."""
    from torch.distributed.tensor import Replicate, Shard
    if leaf not in ("vr", "vc"):
        return place
    gone = ndim - 1 if leaf == "vr" else ndim - 2
    out = []
    for p in place:
        d = getattr(p, "dim", None)
        if d is None or d < gone:
            out.append(p)
        elif d == gone:
            out.append(Replicate())
        else:
            out.append(Shard(d - 1))
    return tuple(out)


def _split_dims(spec, comm) -> dict:
    """{dim: the live mesh axes that split it} of a pruned spec."""
    dims = {d: comm.live(axes_of(entry)) for d, entry in enumerate(spec)}
    return {d: axes for d, axes in dims.items() if axes}


def _full_shape(shape, dims: dict, comm) -> tuple:
    return tuple(n * comm.size(dims.get(d, ())) for d, n in enumerate(shape))


class _CommMeans(Shards):
    """`Shards` whose sums go through a `MeshComm` over the named axes
    that split each dim (`groups` {dim: axes})."""

    def __init__(self, shape, groups: dict, comm):
        super().__init__(shape, {d: list(ax) for d, ax in groups.items()})
        self.comm = comm

    def reduce(self, s: torch.Tensor, group) -> None:
        self.comm.all_reduce(s, (group,))


class Trainer:
    """loss_fn(model, batch) -> (loss, {name: scalar tensor}). With `mesh`
    (and `rules`, `param_specs`), data-parallel with sharded state: see
    the module doc."""

    def __init__(self, loss_fn: Callable, model: nn.Module,
                 cfg: TrainConfig, mesh=None, rules: Optional[Dict] = None,
                 param_specs: Optional[Dict[str, tuple]] = None):
        self.loss_fn = loss_fn
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        self.rules = rules
        opt_init, self._opt_update, opt_specs_fn = make_optimizer(
            cfg.optimizer)
        params = {name.replace(".", "/"): p
                  for name, p in model.named_parameters()}
        if param_specs is None and hasattr(model, "param_specs"):
            param_specs = model.param_specs()
        self.param_specs = param_specs
        self.opt_specs = (None if param_specs is None
                          else opt_specs_fn(param_specs))
        self._preempted = False
        self._step_times: collections.deque = collections.deque(
            maxlen=_STRAGGLER_WINDOW)
        self._data: Optional[DataShard] = None
        self._tp = getattr(model, "tp", None)
        if self._tp is not None:
            self._init_tensor_parallel(params, opt_init)
            return
        if mesh is None:
            self.state = TrainState(params=params,
                                    opt_state=opt_init(params), step=0)
            return
        self._init_sharded(params, opt_init)

    def _init_sharded(self, params, opt_init) -> None:
        mesh = self.mesh
        if self.param_specs is None:
            raise ValueError("a Trainer with a mesh needs param_specs")
        kinds = {p.device.type for p in params.values()}
        if kinds != {mesh.device_type}:
            raise ValueError(f"the mesh is on {mesh.device_type!r}, the "
                             f"parameters on {sorted(kinds)}")
        set_logical_mesh(mesh, self.rules)
        batch_axes = logical_to_pspec(("batch",), mesh, self.rules)[0]
        batch_axes = ((batch_axes,) if isinstance(batch_axes, str)
                      else tuple(batch_axes or ()))
        self._data = DataShard(mesh, batch_axes)
        self._place = make_shardings(
            {k: self.param_specs[k] for k in params}, mesh, self.rules,
            shapes=params)
        with torch.no_grad():
            shards = {k: distribute(p.detach(), mesh, self._place[k])
                      for k, p in params.items()}
        local = {k: v.to_local() for k, v in shards.items()}
        opt_local = opt_init(local)
        self._opt_place = self._state_placements(opt_local, params)
        # each parameter's dims split over mesh axes of size > 1 (the
        # sums of Adafactor's means)
        self._means = {}
        for k, p in params.items():
            groups: Dict[int, list] = {}
            for i, pl in enumerate(self._place[k]):
                d = getattr(pl, "dim", None)
                if d is not None and mesh.size(i) > 1:
                    groups.setdefault(d, []).append(mesh.get_group(i))
            self._means[k] = Shards(p.shape, groups)
        self.state = TrainState(params=params,
                                opt_state=self._wrap(opt_local), step=0,
                                param_shards=shards)

    def _init_tensor_parallel(self, params, opt_init) -> None:
        """The tensor-parallel route: `params` are this rank's blocks,
        each with its pruned spec (`tp_spec`)."""
        tp = self._tp
        comm = tp.comm
        kinds = {p.device.type for p in params.values()}
        if self.mesh is not None and kinds != {self.mesh.device_type}:
            raise ValueError(f"the mesh is on {self.mesh.device_type!r}, the "
                             f"parameters on {sorted(kinds)}")
        batch = axes_of(logical_to_pspec(("batch",), comm.sizes,
                                         tp.rules)[0])
        self._data = CommShard(comm, batch)
        # {name: {dim: the live mesh axes that split it}}
        self._split = {k: _split_dims(p.tp_spec, comm)
                       for k, p in params.items()}
        self._grad_axes = {
            k: tuple(a for a in comm.live(batch)
                     if all(a not in ax for ax in dims.values()))
            for k, dims in self._split.items()}
        self._means = {k: _CommMeans(_full_shape(p.shape, self._split[k],
                                                 comm),
                                     self._split[k], comm)
                       for k, p in params.items()}
        self.state = TrainState(params=params, opt_state=opt_init(params),
                                step=0)

    def _reduce_squares(self, sq: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """Each leaf's sum of squares summed over the axes that split it
        (one all-reduce a set of axes)."""
        by_axes: Dict[tuple, list] = {}
        for k in sq:
            axes = tuple(a for ax in self._split[k].values() for a in ax)
            if axes:
                by_axes.setdefault(axes, []).append(k)
        out = dict(sq)
        for axes, names in by_axes.items():
            stacked = self._tp.comm.all_reduce(
                torch.stack([sq[k] for k in names]), axes)
            out.update(zip(names, stacked.unbind()))
        return out

    def _slot_dims(self, name: str, leaf: str, ndim: int) -> dict:
        """The split dims of an optimizer-state leaf of parameter `name`
        (Adafactor's vr drops the last dim, vc the one before it)."""
        dims = self._split[name]
        if leaf not in ("vr", "vc"):
            return dims
        gone = ndim - 1 if leaf == "vr" else ndim - 2
        return {(d if d < gone else d - 1): ax for d, ax in dims.items()
                if d != gone}

    def _opt_dims(self) -> dict:
        """A tree like the optimizer state of each leaf's split dims."""
        out = {}
        for key, sub in self.state.opt_state.items():
            if key == "count":
                out[key] = {}
            elif key == "slots":
                out[key] = {n: {leaf: self._slot_dims(
                    n, leaf, self.state.params[n].ndim) for leaf in slot}
                    for n, slot in sub.items()}
            else:
                out[key] = {n: self._split[n] for n in sub}
        return out

    def _state_placements(self, state: dict, params) -> dict:
        from torch.distributed.tensor import Replicate
        rep = (Replicate(),) * self.mesh.ndim
        out = {}
        for key, sub in state.items():
            if key == "count":
                out[key] = rep
            elif key == "slots":
                out[key] = {n: {leaf: _slot_placement(
                    self._place[n], leaf, params[n].ndim) for leaf in slot}
                    for n, slot in sub.items()}
            else:
                out[key] = {n: self._place[n] for n in sub}
        return out

    def _wrap(self, local_state: dict) -> dict:
        """Local blocks of the optimizer state -> DTensors."""
        from torch.distributed.tensor import DTensor
        return tree_map(lambda t, pl: DTensor.from_local(
            t, self.mesh, pl, run_check=False), local_state, self._opt_place)

    def _full_opt_state(self) -> dict:
        """The optimizer state gathered whole (every rank enters)."""
        if self._tp is not None:
            return tree_map(self._gather, self.state.opt_state,
                            self._opt_dims())
        if self.mesh is None:
            return self.state.opt_state
        return tree_map(lambda t: t.full_tensor(), self.state.opt_state)

    # ------------------------------------------------------------------ step
    def _grads(self, batch: Any) -> Tuple[torch.Tensor, Dict, Dict]:
        """(loss, metrics, grads) of one batch; with cfg.microbatch > 1
        the grads of its leading-dim splits are summed, then scaled by
        1/mb (loss and metrics alike), as the JAX Trainer's scan does.
        Under a mesh: of this rank's share of each split, the losses and
        metrics being this rank's shares of the global ones."""
        names = list(self.state.params)
        leaves = list(self.state.params.values())
        mb = self.cfg.microbatch if self.cfg.microbatch > 1 else 1
        loss = metrics = grads = None
        for i in range(mb):
            part = _split(batch, mb, i) if mb > 1 else batch
            with active_shard(self._data):
                l_i, m_i = self.loss_fn(self.model, _share(part, self._data))
                # a parameter the loss does not reach (the pooling head in
                # pre-training) gets zeros, as under jax.grad
                g_i = torch.autograd.grad(l_i, leaves, allow_unused=True,
                                          materialize_grads=True)
            l_i, m_i = l_i.detach(), {k: v.detach() for k, v in m_i.items()}
            if grads is None:
                loss, metrics, grads = l_i, m_i, list(g_i)
            else:
                loss = loss + l_i
                metrics = {k: metrics[k] + m_i[k] for k in metrics}
                grads = [a + b for a, b in zip(grads, g_i)]
        if mb > 1:
            scale = 1.0 / mb
            loss = loss * scale
            metrics = {k: v * scale for k, v in metrics.items()}
            grads = [g * scale for g in grads]
        return loss, metrics, dict(zip(names, grads))

    def advance(self, batch: Any) -> Dict[str, torch.Tensor]:
        """One step on the global batch; its metrics stay tensors (no
        host read, so it runs on meta tensors too)."""
        cfg = self.cfg
        with spans.span("train.grads"):
            loss, metrics, grads = self._grads(batch)
            if self._tp is not None:
                # over the "batch" axes that do not split the leaf (FSDP's
                # gather reduce-scattered the others in the backward)
                for k, g in grads.items():
                    self._tp.comm.all_reduce(g, self._grad_axes[k])
            elif self._data is not None:
                # sums over the data axes of the ranks' shares
                for g in grads.values():
                    self._data.all_reduce(g)
            if self._data is not None:
                keys = list(metrics)
                tot = self._data.all_reduce(torch.stack(
                    [loss] + [metrics[k] for k in keys]).float())
                loss, metrics = tot[0], dict(zip(keys, tot[1:]))
        with spans.span("train.clip"):
            grads, gnorm = global_norm_clip(
                grads, cfg.grad_clip,
                None if self._tp is None else self._reduce_squares)
        with spans.span("train.optimizer"):
            lr = lr_schedule(self.state.step, base_lr=cfg.learning_rate,
                             warmup_steps=cfg.warmup_steps,
                             total_steps=cfg.total_steps)
            new_params = self._update(grads, float(lr))
            with torch.no_grad():
                for name, p in self.state.params.items():
                    p.copy_(new_params[name])
        self.state.step += 1
        return dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    def step(self, batch: Any) -> Dict[str, float]:
        """One step on the global batch (`advance`), its metrics read to
        the host."""
        with spans.span("train.step"):
            t0 = time.monotonic()
            out = self.advance(batch)
            with spans.span("train.read"):
                metrics = {k: float(v) for k, v in out.items()}
            dt = time.monotonic() - t0
            self._step_times.append(dt)
            self._watchdog(dt)
            return metrics

    def _update(self, grads: Dict[str, torch.Tensor], lr: float
                ) -> Dict[str, torch.Tensor]:
        """The optimizer on the clipped gradients; returns the new
        parameters (this rank's blocks on the tensor-parallel route, else
        full)."""
        if self.mesh is not None and self._tp is None:
            return self._sharded_update(grads, lr)
        if self._tp is not None and self.cfg.optimizer == "adafactor":
            new_params, self.state.opt_state = self._opt_update(
                grads, self.state.opt_state, self.state.params, lr=lr,
                weight_decay=self.cfg.weight_decay, shards=self._means)
            return new_params
        new_params, self.state.opt_state = self._opt_update(
            grads, self.state.opt_state, self.state.params, lr=lr,
            weight_decay=self.cfg.weight_decay)
        return new_params

    def _sharded_update(self, grads: Dict[str, torch.Tensor], lr: float
                        ) -> Dict[str, torch.Tensor]:
        """The optimizer on this rank's shards of the (reduced, clipped)
        gradients, parameters and state; returns the full new parameters,
        gathered."""
        from torch.distributed.tensor import DTensor
        mesh = self.mesh
        g_loc = {k: distribute(g, mesh, self._place[k]).to_local()
                 for k, g in grads.items()}
        p_loc = {k: v.to_local() for k, v in self.state.param_shards.items()}
        o_loc = tree_map(lambda t: t.to_local(), self.state.opt_state)
        kw = ({"shards": self._means} if self.cfg.optimizer == "adafactor"
              else {})
        new_p, new_o = self._opt_update(g_loc, o_loc, p_loc, lr=lr,
                                        weight_decay=self.cfg.weight_decay,
                                        **kw)
        self.state.param_shards = {
            k: DTensor.from_local(v, mesh, self._place[k], run_check=False)
            for k, v in new_p.items()}
        self.state.opt_state = self._wrap(new_o)
        return {k: v.full_tensor() for k, v in self.state.param_shards.items()}

    def _watchdog(self, dt: float, factor: float = 3.0):
        """Straggler detection: flags steps more than factor x the rolling
        median of the last `_STRAGGLER_WINDOW` steps (logged)."""
        times = self._step_times
        if len(times) >= 5:
            med = float(np.median(times))
            if dt > factor * med:
                log.warning("straggler: step %d took %.3fs (median %.3fs)",
                            self.state.step, dt, med)

    # ------------------------------------------------------- fault tolerance
    def install_preemption_handler(self):
        """SIGTERM -> checkpoint at the next step boundary, then exit(42)
        (the launcher restarts us; 42 = 'clean preemption')."""

        def handler(signum, frame):
            log.warning("SIGTERM received: will checkpoint and exit")
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)

    def _gather(self, t: torch.Tensor, dims: dict) -> torch.Tensor:
        """A block gathered whole along its split dims."""
        with torch.no_grad():
            for d, axes in dims.items():
                t = self._tp.comm.all_gather(t, axes, d)
        return t

    def _block(self, t: torch.Tensor, dims: dict) -> torch.Tensor:
        """This rank's block of a whole tensor."""
        for d, axes in dims.items():
            t = self._tp.comm.block(t, axes, d)
        return t.contiguous()

    @property
    def _distributed(self) -> bool:
        return self.mesh is not None or (
            self._tp is not None and self._tp.comm.mode == "group")

    def _live_tree(self) -> Dict[str, Any]:
        params = self.state.params
        if self._tp is not None:
            params = {k: self._gather(p.detach(), self._split[k])
                      for k, p in params.items()}
        return {"params": params, "opt": self._full_opt_state()}

    def checkpoint_tree(self) -> Dict[str, Any]:
        """{"params": ..., "opt": ...}: what a checkpoint holds, keyed as
        the JAX Trainer's tree. A model with a `pack_checkpoint` hook (the
        Stage-1 encoder, whose JAX tree stacks its layers) lays out the
        flattened tree itself. Under a mesh the optimizer state is
        gathered whole (every rank enters)."""
        pack = getattr(self.model, "pack_checkpoint", None)
        tree = self._live_tree()
        return tree if pack is None else pack(ckpt._flatten(tree))

    def maybe_checkpoint(self, force: bool = False) -> Optional[str]:
        cfg = self.cfg
        due = cfg.checkpoint_every and \
            self.state.step % cfg.checkpoint_every == 0
        if not (due or force or self._preempted):
            return None
        tree = self.checkpoint_tree()
        if not self._distributed or torch.distributed.get_rank() == 0:
            path = ckpt.save_checkpoint(
                cfg.checkpoint_dir, self.state.step, tree,
                meta={"step": self.state.step}, keep=cfg.keep_checkpoints)
        else:
            path = ckpt.checkpoint_path(cfg.checkpoint_dir, self.state.step)
        if self._distributed:
            torch.distributed.barrier()
        if self._preempted:
            log.warning("preemption checkpoint done; exiting 42")
            raise SystemExit(42)
        return path

    def load(self, path: str) -> int:
        """Restores params, optimizer state and step from the checkpoint
        at `path` (written by either package). Returns the step."""
        tree, step, _ = ckpt.restore_checkpoint(path, self.checkpoint_tree())
        unpack = getattr(self.model, "unpack_checkpoint", None)
        if unpack is not None:
            live = self._live_tree()
            tree = ckpt.unflatten_like(unpack(tree, ckpt._flatten(live)),
                                       live)
        with torch.no_grad():
            for name, p in self.state.params.items():
                full = tree["params"][name]
                p.copy_(full if self._tp is None
                        else self._block(full, self._split[name]))
        if self._tp is not None:    # this rank's blocks
            self.state.opt_state = tree_map(self._block, tree["opt"],
                                            self._opt_dims())
        elif self.mesh is None:
            self.state.opt_state = tree["opt"]
        else:       # re-shard onto this mesh
            with torch.no_grad():
                self.state.param_shards = {
                    k: distribute(p.detach(), self.mesh, self._place[k])
                    for k, p in self.state.params.items()}
            self.state.opt_state = tree_map(
                lambda t, pl: distribute(t, self.mesh, pl), tree["opt"],
                self._opt_place)
        self.state.step = step
        log.info("restored step=%d from %s", step, path)
        return step

    def restore(self) -> bool:
        """Resume from the newest valid checkpoint; False if none. The data
        stream derives purely from the restored step, so the replay is
        exact."""
        path = ckpt.latest_checkpoint(self.cfg.checkpoint_dir)
        if path is None:
            return False
        self.load(path)
        return True

    # -------------------------------------------------------------- training
    def fit(self, batch_fn: Callable[[int], Any], num_steps: int,
            log_every: int = 10) -> Dict[str, float]:
        """Run the restart-safe training loop."""
        self.restore()
        metrics: Dict[str, float] = {}
        while self.state.step < num_steps:
            batch = batch_fn(self.state.step)
            metrics = self.step(batch)
            if self.state.step % log_every == 0:
                log.info("step %d: %s", self.state.step,
                         {k: round(v, 4) for k, v in metrics.items()})
            self.maybe_checkpoint()
        return metrics

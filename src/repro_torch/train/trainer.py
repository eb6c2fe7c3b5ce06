"""Trainer, port of `repro.train.trainer`: microbatch accumulation,
global-norm clipping, the warmup + cosine schedule, the optimizer update,
checkpoint/restart with exact resume, preemption handling, a straggler
watchdog, and data-parallel training with sharded state over a mesh.

The model's parameters are updated in place (`copy_` of the optimizer's
new values into the `nn.Parameter`s), so the module stays the one
source of the weights; the optimizer functions themselves are pure.

With `mesh` (a `torch.distributed` DeviceMesh on the parameters' device
type), `rules` and the parameters' logical specs (`param_specs`, by
default the model's own `param_specs()`), every rank holds its shard of
each parameter and of its optimizer state as DTensors placed by the
rules (`state.param_shards`, `state.opt_state`), as JAX's `device_put`
places them. A step on the GLOBAL batch:

  * splits it in `microbatch` slices, then gives this rank its share of
    each slice along the data axes (the rules' "batch" axes): rank r's
    microbatch i is the r-th share of global microbatch i, as in JAX;
  * runs forward and backward on the share with the full parameters (the
    kernels read raw pointers and take no DTensor), the losses reading
    global counts and gathered rows through
    `repro_torch.distributed.collectives` (a mean over this rank's rows
    is its share of the global mean);
  * sums the gradients, the loss and the metrics over the data axes, clips
    by the global norm of the whole gradient, updates this rank's shards
    (Adafactor's row, column and RMS means summed over the groups that
    split each dim) and gathers the full parameters into the model.

Ranks along "model" compute the same rows (tensor-parallel compute is not
ported). Every rank must call `step`, `maybe_checkpoint` and `restore`
alike: each enters collectives. Checkpoints hold full tensors in the
unsharded layout: every rank gathers, global rank 0 writes, and a restore
re-shards onto the current mesh, whatever mesh wrote it.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.config import TrainConfig
from repro_torch.distributed.collectives import DataShard, active_shard
from repro_torch.distributed.sharding import (
    distribute, logical_to_pspec, make_shardings, set_logical_mesh,
)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import (
    Shards, global_norm_clip, lr_schedule, make_optimizer,
)
from repro_torch.utils.log import get_logger

log = get_logger("repro_torch.train")


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


def _tree_map(fn, tree, *others):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


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
        self._step_times: list = []
        self._data: Optional[DataShard] = None
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
        return _tree_map(lambda t, pl: DTensor.from_local(
            t, self.mesh, pl, run_check=False), local_state, self._opt_place)

    def _full_opt_state(self) -> dict:
        """The optimizer state gathered whole (every rank enters)."""
        if self.mesh is None:
            return self.state.opt_state
        return _tree_map(lambda t: t.full_tensor(), self.state.opt_state)

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

    def step(self, batch: Any) -> Dict[str, float]:
        """One step on the global batch."""
        t0 = time.monotonic()
        cfg = self.cfg
        loss, metrics, grads = self._grads(batch)
        if self._data is not None:
            # sums over the data axes of the ranks' shares
            for g in grads.values():
                self._data.all_reduce(g)
            keys = list(metrics)
            tot = self._data.all_reduce(torch.stack(
                [loss] + [metrics[k] for k in keys]).float())
            loss, metrics = tot[0], dict(zip(keys, tot[1:]))
        grads, gnorm = global_norm_clip(grads, cfg.grad_clip)
        lr = lr_schedule(self.state.step, base_lr=cfg.learning_rate,
                         warmup_steps=cfg.warmup_steps,
                         total_steps=cfg.total_steps)
        if self.mesh is None:
            new_params, self.state.opt_state = self._opt_update(
                grads, self.state.opt_state, self.state.params, lr=float(lr),
                weight_decay=cfg.weight_decay)
        else:
            new_params = self._sharded_update(grads, float(lr))
        with torch.no_grad():
            for name, p in self.state.params.items():
                p.copy_(new_params[name])
        self.state.step += 1
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.monotonic() - t0
        self._step_times.append(dt)
        self._watchdog(dt)
        return metrics

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
        o_loc = _tree_map(lambda t: t.to_local(), self.state.opt_state)
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

    def _watchdog(self, dt: float, factor: float = 3.0, window: int = 20):
        """Straggler detection: flags steps more than factor x the rolling
        median (logged)."""
        times = self._step_times[-window:]
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

    def _live_tree(self) -> Dict[str, Any]:
        return {"params": self.state.params, "opt": self._full_opt_state()}

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
        if self.mesh is None or torch.distributed.get_rank() == 0:
            path = ckpt.save_checkpoint(
                cfg.checkpoint_dir, self.state.step, tree,
                meta={"step": self.state.step}, keep=cfg.keep_checkpoints)
        else:
            path = ckpt.checkpoint_path(cfg.checkpoint_dir, self.state.step)
        if self.mesh is not None:
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
                p.copy_(tree["params"][name])
        if self.mesh is None:
            self.state.opt_state = tree["opt"]
        else:       # re-shard onto this mesh
            with torch.no_grad():
                self.state.param_shards = {
                    k: distribute(p.detach(), self.mesh, self._place[k])
                    for k, p in self.state.params.items()}
            self.state.opt_state = _tree_map(
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

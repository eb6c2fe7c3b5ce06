"""Trainer, port of `repro.train.trainer` on one device: microbatch
accumulation, global-norm clipping, the warmup + cosine schedule, the
optimizer update, checkpoint/restart with exact resume, preemption
handling and a straggler watchdog.

The model's parameters are updated in place (`copy_` of the optimizer's
new values into the `nn.Parameter`s), so the module stays the one
source of the weights; the optimizer functions themselves are pure.
Sharding over a mesh (`mesh=`, `rules=` in the JAX Trainer) waits for the
port's distributed slice.
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
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import (
    global_norm_clip, lr_schedule, make_optimizer,
)
from repro_torch.utils.log import get_logger

log = get_logger("repro_torch.train")


@dataclasses.dataclass
class TrainState:
    params: Dict[str, nn.Parameter]   # "/"-joined names, the JAX tree keys
    opt_state: Any
    step: int


def _split(batch: Any, mb: int, i: int) -> Any:
    """The i-th of mb equal leading-dim slices of every tensor in batch."""
    if isinstance(batch, dict):
        return {k: _split(v, mb, i) for k, v in batch.items()}
    n = batch.shape[0] // mb
    return batch[i * n:(i + 1) * n]


class Trainer:
    """loss_fn(model, batch) -> (loss, {name: scalar tensor})."""

    def __init__(self, loss_fn: Callable, model: nn.Module,
                 cfg: TrainConfig):
        self.loss_fn = loss_fn
        self.model = model
        self.cfg = cfg
        opt_init, self._opt_update = make_optimizer(cfg.optimizer)
        params = {name.replace(".", "/"): p
                  for name, p in model.named_parameters()}
        self.state = TrainState(params=params, opt_state=opt_init(params),
                                step=0)
        self._preempted = False
        self._step_times: list = []

    # ------------------------------------------------------------------ step
    def _grads(self, batch: Any) -> Tuple[torch.Tensor, Dict, Dict]:
        """(loss, metrics, grads) of one batch; with cfg.microbatch > 1
        the grads of its leading-dim splits are summed, then scaled by
        1/mb (loss and metrics alike), as the JAX Trainer's scan does."""
        names = list(self.state.params)
        leaves = list(self.state.params.values())
        mb = self.cfg.microbatch if self.cfg.microbatch > 1 else 1
        loss = metrics = grads = None
        for i in range(mb):
            part = _split(batch, mb, i) if mb > 1 else batch
            l_i, m_i = self.loss_fn(self.model, part)
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
        t0 = time.monotonic()
        cfg = self.cfg
        loss, metrics, grads = self._grads(batch)
        grads, gnorm = global_norm_clip(grads, cfg.grad_clip)
        lr = lr_schedule(self.state.step, base_lr=cfg.learning_rate,
                         warmup_steps=cfg.warmup_steps,
                         total_steps=cfg.total_steps)
        new_params, self.state.opt_state = self._opt_update(
            grads, self.state.opt_state, self.state.params, lr=float(lr),
            weight_decay=cfg.weight_decay)
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
        return {"params": self.state.params, "opt": self.state.opt_state}

    def checkpoint_tree(self) -> Dict[str, Any]:
        """{"params": ..., "opt": ...}: what a checkpoint holds, keyed as
        the JAX Trainer's tree. A model with a `pack_checkpoint` hook (the
        Stage-1 encoder, whose JAX tree stacks its layers) lays out the
        flattened tree itself."""
        pack = getattr(self.model, "pack_checkpoint", None)
        tree = self._live_tree()
        return tree if pack is None else pack(ckpt._flatten(tree))

    def maybe_checkpoint(self, force: bool = False) -> Optional[str]:
        cfg = self.cfg
        due = cfg.checkpoint_every and \
            self.state.step % cfg.checkpoint_every == 0
        if not (due or force or self._preempted):
            return None
        path = ckpt.save_checkpoint(
            cfg.checkpoint_dir, self.state.step, self.checkpoint_tree(),
            meta={"step": self.state.step}, keep=cfg.keep_checkpoints)
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
        self.state.opt_state = tree["opt"]
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

"""Traffic kind "pretrain": the Stage-1 encoder's NTP + NIP pre-training
job, `Trainer.step` with `core/bbe.pretrain_loss` and AdamW at the
configuration's `train` settings, on batches of `rows` pre-tokenized
rows of 128 tokens.

Set-up: the encoder's weights drawn from the seed on the card; a pool
of token rows made from the benchmark's copy of the synthetic corpus
(`corpus_functions` functions at five optimization levels, every block
tokenized once, duplicates dropped; the same pool for every seed, so
that every seed does the same work); step s takes rows of a seeded
permutation of the pool, `rows` at a time, so that the first
pool/rows steps' rows all differ, and moves them to the card through
the system's `BatchLoader`. The first `check_steps` steps run in
set-up, through the same `Trainer` and feed the window then drives; the
first step's optimizer state and the parameters after the last of them
are kept for the check. Each step ends in `Trainer.step`'s host read.

The check, after the window: the reference runs the same steps from
the same weights on the same rows; each step's loss, the first step's
gradient as the optimizer got it (its first moment / (1 - b1)) and each
parameter's change over the steps are compared.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from chipbench import bench
from chipbench.drivers import port
from chipbench.reference import train as ref_train
from chipbench.reference.precision import Precision, exact_float32
from chipbench.traffic import corpus
from chipbench.traffic.isa import stable_hash

B1 = 0.9     # AdamW's first-moment decay, as the system's `adamw_update`


class Job:
    def __init__(self, cell: bench.Cell, seed: int, device, spans):
        from repro_torch.config import TrainConfig
        from repro_torch.core.bbe import pretrain_loss
        from repro_torch.data import BatchLoader
        from repro_torch.train.trainer import Trainer
        cfg, mix = cell.config, cell.mix
        self.cell, self.seed, self.spans = cell, seed, spans
        self.encoder, self.w0 = port.encoder(cfg, seed, device)
        tc = cfg["train"]
        self.trainer = Trainer(pretrain_loss, self.encoder, TrainConfig(
            learning_rate=tc["learning_rate"], warmup_steps=tc["warmup_steps"],
            total_steps=tc["total_steps"], weight_decay=tc["weight_decay"],
            grad_clip=tc["grad_clip"], optimizer=tc["optimizer"],
            checkpoint_every=0,
            checkpoint_dir=os.path.join(tempfile.gettempdir(),
                                        "chipbench_ckpt")))
        # one pool for every seed: the seed draws the order of its rows
        self.pool = corpus.pretrain_pool(corpus.SyntheticBinaryCorp(
            n_functions=mix["corpus_functions"],
            max_len=cfg["stage1"]["max_len"], seed=mix["corpus_seed"]))
        self.lengths = (self.pool[..., 0] != 0).sum(1)
        self.order = np.random.RandomState(
            stable_hash("rows", seed)).permutation(len(self.pool))
        self.rows = mix["rows"]
        self.loader = BatchLoader(lambda s: {"tokens": self.pool[self.idx(s)]},
                                  device=device)
        self.step = 0
        self.losses = []
        for s in range(mix["check_steps"]):
            self.losses.append(self.train_step()["loss"])
            if s == 0:
                m = self.trainer.state.opt_state["m"]
                self.first_grad = {k.replace("/", "."): (v / (1 - B1)).to(
                    "cpu", copy=True) for k, v in m.items()}
        self.after = {k.replace("/", "."): p.detach().to("cpu", copy=True)
                      for k, p in self.trainer.state.params.items()}
        self.window_s, self.tokens, self.steps = 0.0, 0, 0

    def idx(self, s: int) -> np.ndarray:
        n = len(self.order)
        return self.order[(s * self.rows + np.arange(self.rows)) % n]

    def train_step(self):
        with self.spans("feed"):
            batch = self.loader(self.step)
        with self.spans("step"):
            out = self.trainer.step(batch)
        self.step += 1
        return out

    def window(self, seconds: float):
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            self.tokens += int(self.lengths[self.idx(self.step)].sum())
            self.train_step()
            self.steps += 1
        self.window_s = time.perf_counter() - t0

    def counts(self) -> Dict[str, float]:
        return {"attempted": self.steps, "failed": 0,
                "window_s": self.window_s, "steps": self.steps,
                "tokens": self.tokens,
                "padded_tokens": self.steps * self.rows * self.pool.shape[1],
                "train_tokens_per_s": self.tokens / self.window_s}

    def notes(self):
        return [f"train_tokens_per_s over {self.steps} steps of "
                f"{self.rows} rows; non-pad share "
                f"{self.lengths.mean() / self.pool.shape[1]:.4f}"]

    def outputs(self) -> dict:
        return {"losses": list(self.losses), "first_grad": self.first_grad,
                "after": self.after}

    def inputs(self) -> dict:
        device = next(iter(self.w0.values())).device
        return {"w0": self.w0, "config": self.cell.config,
                "batches": [torch.from_numpy(self.pool[self.idx(s)]).to(
                    device).long() for s in range(len(self.losses))],
                "rows": self.cell.mix["reference_rows"]}

    def release(self):
        self.trainer = self.encoder = self.loader = None


def reference(cell: bench.Cell, inputs: dict, precision: str) -> dict:
    with exact_float32():
        losses, first, after = ref_train.steps(
            inputs["w0"], inputs["config"]["stage1"], inputs["config"]["train"],
            inputs["batches"], Precision(precision), inputs["rows"])
    return {"losses": losses,
            "first_grad": {k: v.cpu() for k, v in first.items()},
            "after": {k: v.cpu() for k, v in after.items()},
            "w0": {k: v.cpu() for k, v in inputs["w0"].items()}}


def _leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keep) -> float:
    """The worst leaf's gap between the two norms, over the larger of the
    reference leaf's norm and the median reference leaf's."""
    a = {k: float(torch.linalg.vector_norm(got[k].double())) for k in keep}
    b = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keep}
    median = float(np.median(list(b.values())))
    return max(abs(a[k] - b[k]) / max(b[k], median) for k in keep)


def compare(got: dict, ref: dict) -> Dict[str, float]:
    """loss_gap    each step's relative loss gap, the worst step;
    grad_gap    the first step's gradient as the optimizer got it, by
                the worst leaf (`_leaf_gaps`);
    change_gap  each parameter's change over the steps, by the worst
                leaf, leaving out leaves whose reference gradient is
                under a thousandth of the median leaf's: off the loss,
                they move by weight decay and round-off alone."""
    names = list(ref["first_grad"])
    grad = _leaf_gaps(got["first_grad"], ref["first_grad"], names)
    gnorm = {k: float(torch.linalg.vector_norm(ref["first_grad"][k].double()))
             for k in names}
    floor = 1e-3 * float(np.median(list(gnorm.values())))
    moved = [k for k in names if gnorm[k] >= floor]
    w0 = ref["w0"]
    delta = lambda after: {k: after[k].double() - w0[k].double()  # noqa: E731
                           for k in moved}
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(
                got["losses"], ref["losses"])),
            "grad_gap": grad,
            "change_gap": _leaf_gaps(delta(got["after"]), delta(ref["after"]),
                                     moved)}


def as_outputs(got: dict, low: dict) -> dict:
    """The reference run at a lower precision, in the place of the
    system's outputs (the control)."""
    return {"losses": low["losses"], "first_grad": low["first_grad"],
            "after": low["after"]}


def faulty(cell: bench.Cell, got: dict, inputs: dict, ref: dict,
           fault: str) -> dict:
    """The reference with a fault planted, in the system's place:
    "half", each step's loss and gradients over the first half of its
    rows alone."""
    if fault != "half":
        raise ValueError(f"no fault {fault!r}")
    half = dict(inputs, batches=[b[:b.shape[0] // 2]
                                 for b in inputs["batches"]])
    return as_outputs(got, reference(cell, half, "fp32"))

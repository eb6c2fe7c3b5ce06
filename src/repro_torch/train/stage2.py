"""Stage-2 training engine (paper §III-B), port of `repro.train.stage2`.

`Stage2Engine` wraps the `Trainer` with the Stage-2 triplet + CPI +
consistency loss over ROW-ID batches: each step ships only integer ids,
frequencies and masks; the (B, N, bbe_dim) anchor/positive/negative
gathers run on the device against one uploaded BBE matrix
(`stage2_loss_from_rows`). On CUDA both directions of every set
attention run the hand-written kernels (`masked_set_attention` and its
backward); on the CPU their plain versions.

`triplet_row_batch` assembles a batch from already-selected intervals
through the same `batch_set_ids` sort the inference path uses.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import TrainConfig
from repro_torch.core.pipeline import BBEIndex, batch_set_ids
from repro_torch.core.signature import (
    SignatureConfig, SignatureModel, stage2_loss_from_rows,
)
from repro_torch.device import Device, resolve_device
from repro_torch.train.trainer import Trainer


def triplet_row_batch(sets: Dict[str, Sequence], cpis, index: BBEIndex,
                      max_set: int, device: Device = "cuda"
                      ) -> Dict[str, Any]:
    """sets: {"anchor"|"positive"|"negative": [Interval] x B}; cpis: (B,)
    ground-truth CPI of the anchors. One vectorized `batch_set_ids` pass
    per role; the batch holds row ids into `BBEIndex.ext` (int64), freqs
    (fp32) and masks (bool) as tensors on `device`, never the BBEs."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for key in ("anchor", "positive", "negative"):
        rows, freqs, mask = batch_set_ids(sets[key], index, max_set)
        out[key] = {"rows": torch.from_numpy(rows).to(dev, torch.long),
                    "freqs": torch.from_numpy(freqs).to(dev),
                    "mask": torch.from_numpy(mask).to(dev)}
    out["cpi"] = torch.from_numpy(
        np.asarray(cpis, np.float32)).to(dev)
    return out


class Stage2Engine:
    """Trainer-backed Stage-2 training over row-id triplet batches.

    Trains a COPY of `model` (on the model's device), so the caller's
    weights stay as they were, as the JAX engine's `donate=False` default
    leaves the caller's params alone. matrix: (V+1, bbe_dim) BBE matrix
    with the zero sentinel row appended (`BBEIndex.ext`), fp32 or bf16,
    moved to the model's device once. batch_fn(step) must return `triplet_row_batch`
    output and be deterministic in `step`, so checkpoint restarts replay
    the exact stream (the Trainer contract). `mesh` and `rules` go to the
    Trainer; every rank then steps on the same global batch. A model
    built as one rank's blocks (`collectives.shard_module`) takes the
    Trainer's tensor-parallel route (the rank's heads and ff columns,
    its blocks of the state); a whole model under `mesh` its replicated
    route (data-parallel steps with sharded state, the specs
    `signature_specs`)."""

    def __init__(self, sig_cfg: SignatureConfig, model: SignatureModel,
                 matrix, cfg: TrainConfig, mesh=None,
                 rules: Optional[Dict] = None):
        self.sig_cfg = sig_cfg
        self.model = copy.deepcopy(model).train()
        for p, q in zip(model.parameters(), self.model.parameters()):
            if hasattr(p, "tp_spec"):   # a deep copy drops the attribute
                q.tp_spec = p.tp_spec
        device = next(self.model.parameters()).device
        # the matrix keeps bf16 (Stage 2 on bf16 BBEs), as JAX's engine
        # keeps its dtype; anything else is held in fp32
        matrix = torch.as_tensor(matrix)
        if matrix.dtype != torch.bfloat16:
            matrix = matrix.float()
        self.matrix = matrix.to(device)

        def loss_fn(m, batch):
            return stage2_loss_from_rows(m, sig_cfg, self.matrix, batch)

        self.trainer = Trainer(loss_fn, self.model, cfg, mesh=mesh,
                               rules=rules)

    # thin passthroughs: the Trainer owns state, checkpoints, preemption
    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """{"/"-joined name: parameter} of the trained copy."""
        return self.trainer.state.params

    @property
    def step_count(self) -> int:
        return self.trainer.state.step

    def step(self, batch) -> Dict[str, float]:
        return self.trainer.step(batch)

    def fit(self, batch_fn: Callable[[int], Any], num_steps: int,
            log_every: int = 10) -> Dict[str, float]:
        return self.trainer.fit(batch_fn, num_steps, log_every)

    def restore(self) -> bool:
        return self.trainer.restore()

    def maybe_checkpoint(self, force: bool = False) -> Optional[str]:
        return self.trainer.maybe_checkpoint(force)

    def install_preemption_handler(self):
        self.trainer.install_preemption_handler()

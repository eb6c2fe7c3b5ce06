"""Training CLI, port of `repro.launch.train`.

Examples:
  # train any zoo arch (reduced preset on the CPU, full width on the card)
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --preset smoke --steps 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --preset full --batch 8 --seq 2048 --steps 20

  # the paper's Stage-1 encoder pre-training + triplet fine-tuning
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch semanticbbv-encoder --stage pretrain --steps 200

`--stage lm` trains through `Model.loss` (`transformer.lm_loss`); on the
card every attention layer's forward and backward run on the flash
kernels (JAX's CLI runs `impl="ref"`; the port has no `impl`).
`--stage pretrain|triplet` trains the ported Stage-1 losses. Restart
safety as in JAX: SIGTERM checkpoints and exits 42, and a relaunch
resumes from the newest checkpoint in `--checkpoint-dir` (by default
`build/train_ckpt/` in the checkout). `make_run` builds what `main`
trains, for callers that drive the steps themselves.
"""
from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.config import TrainConfig, get_arch, scaled_down
from repro_torch.data.isa import stable_hash
from repro_torch.device import Device, resolve_device
from repro_torch.distributed.sharding import arch_rules
from repro_torch.models.model_zoo import build_model
from repro_torch.train.trainer import Trainer
from repro_torch.utils.log import get_logger

log = get_logger("repro_torch.launch.train")

DEFAULT_CHECKPOINT_DIR = str(Path(__file__).resolve().parents[3] / "build"
                             / "train_ckpt")


def lm_batch_fn(vocab: int, batch: int, seq: int, cfg=None,
                device: Device = "cuda") -> Callable[[int], Dict]:
    """step -> batch, a copy of JAX's `lm_batch_fn`: uniform tokens (B,
    seq) from `RandomState(stable_hash("batch", step))`, then, drawn from
    the same stream, frames (B, min(seq, 64), d_model) for an
    encoder-decoder and patches (B, num_prefix_embeddings, d_model) for
    a vision-patch frontend; as tensors on `device`."""
    dev = resolve_device(device)

    def fn(step: int) -> Dict[str, torch.Tensor]:
        r = np.random.RandomState(stable_hash("batch", step))
        out = {"tokens": r.randint(0, vocab, (batch, seq))}
        if cfg is not None and cfg.encoder_layers:
            out["frames"] = r.randn(batch, min(seq, 64),
                                    cfg.d_model).astype(np.float32)
        if cfg is not None and cfg.frontend == "vision_patches":
            out["patches"] = r.randn(batch, cfg.num_prefix_embeddings,
                                     cfg.d_model).astype(np.float32)
        return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}

    return fn


@dataclasses.dataclass
class Run:
    """What `main` trains: the Trainer (its model on the device) and the
    step -> batch function."""
    trainer: Trainer
    batch_fn: Callable[[int], Any]
    cfg: Any


def make_run(arch: str, preset: str = "smoke", stage: str = "lm",
             steps: int = 50, batch: int = 8, seq: int = 64,
             lr: float = 3e-4, checkpoint_dir: str = DEFAULT_CHECKPOINT_DIR,
             checkpoint_every: int = 25, device: Device = "cuda",
             remat: str = "none", mesh=None, rules=None) -> Run:
    """The Trainer and batches of `main`'s flags: `stage` "lm" trains the
    zoo arch `arch` (its `scaled_down` config under preset "smoke")
    through `Model.loss` under the remat policy `remat` ("none", "dots" or
    "full"), with weights drawn from seed 0 as in JAX; "pretrain" and
    "triplet" train the paper's Stage-1 encoder (the default BBEConfig
    under "full", a tiny one under "smoke") on a SyntheticBinaryCorp of
    500 functions. With `mesh` (a DeviceMesh; `rules` default
    `sharding.LOGICAL_RULES`) the LM is built as this rank's blocks where
    its blocks are all attention (`Model.init(mesh=)`: the Trainer's
    tensor-parallel route), else whole (its replicated route)."""
    dev = resolve_device(device)
    tc = TrainConfig(learning_rate=lr, total_steps=steps,
                     warmup_steps=max(2, steps // 20),
                     checkpoint_dir=checkpoint_dir,
                     checkpoint_every=checkpoint_every, remat=remat)
    if stage == "lm":
        cfg = get_arch(arch)
        if preset == "smoke":
            cfg = scaled_down(cfg)
        model = build_model(cfg)
        params = model.init(device=dev, mesh=mesh, rules=rules)

        def loss_fn(p, b):
            return model.loss(p, b, remat=tc.remat)

        return Run(Trainer(loss_fn, params, tc, mesh=mesh,
                           rules=arch_rules(cfg, rules)),
                   lm_batch_fn(cfg.vocab_size, batch, seq, cfg, dev), cfg)
    if stage not in ("pretrain", "triplet"):
        raise ValueError(f"stage {stage!r}: lm, pretrain or triplet")
    from repro_torch.core.bbe import (
        BBEConfig, BBEEncoder, finetune_triplet_loss, pretrain_loss,
    )
    from repro_torch.data import BatchLoader, SyntheticBinaryCorp

    bcfg = BBEConfig() if preset == "full" else BBEConfig(
        dim_embeds=(48, 8, 8, 8, 8, 8), num_layers=2, num_heads=2,
        bbe_dim=64, max_len=64)
    corp = SyntheticBinaryCorp(n_functions=500, max_len=bcfg.max_len)
    encoder = BBEEncoder(bcfg).to(dev)
    if stage == "pretrain":
        loader = BatchLoader(lambda s: {"tokens": corp.pretrain_batch(
            s, batch)["tokens"]}, device=dev)
        return Run(Trainer(pretrain_loss, encoder, tc, mesh=mesh,
                           rules=rules), loader, bcfg)
    loader = BatchLoader(lambda s: corp.triplet_batch(s, batch), device=dev)
    return Run(Trainer(finetune_triplet_loss, encoder, tc, mesh=mesh,
                       rules=rules), loader, bcfg)


def train(run: Run, steps: int) -> Dict[str, float]:
    """`steps` restart-safe Trainer steps (resuming from the newest
    checkpoint), then a final checkpoint. Returns the last metrics."""
    metrics = run.trainer.fit(run.batch_fn, steps)
    run.trainer.maybe_checkpoint(force=True)
    return metrics


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=DEFAULT_CHECKPOINT_DIR)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--stage", choices=["lm", "pretrain", "triplet"],
                    default="lm",
                    help="semanticbbv stages use the paper's objectives")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    run = make_run(args.arch, args.preset, args.stage, args.steps,
                   args.batch, args.seq, args.lr, args.checkpoint_dir,
                   args.checkpoint_every, args.device)
    run.trainer.install_preemption_handler()
    metrics = train(run, args.steps)
    log.info("done: %s", {k: round(v, 4) for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main()

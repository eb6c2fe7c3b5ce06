"""Training configuration of the port: its own copy of
`repro.config.TrainConfig`, with the same fields and defaults, so one
configuration reads the same in both packages. The `Trainer` reads the
optimizer, schedule, `grad_clip`, `microbatch` and checkpoint fields;
`remat`, `grad_compression`, `seed` and `label_smoothing` are read by
neither package's Trainer."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    optimizer: str = "adamw"  # adamw | adafactor
    microbatch: int = 0  # 0 = no grad accumulation
    remat: str = "none"  # none | full | dots
    # fault tolerance
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    checkpoint_dir: str = "/tmp/repro_ckpt"
    # distributed tricks
    grad_compression: str = "none"  # none | int8_ef
    seed: int = 0
    label_smoothing: float = 0.0

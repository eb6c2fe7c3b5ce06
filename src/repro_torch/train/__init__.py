# Training, port of `repro.train`: optimizers, checkpoints in the JAX
# package's format, the Trainer (one device or a mesh) and the Stage-2
# engine; compression.py (int8 error feedback) and fault_tolerance.py.
from repro_torch.train.optimizer import (
    adamw_init, adamw_update, adafactor_init, adafactor_update,
    make_optimizer, lr_schedule, global_norm_clip,
)
from repro_torch.train.checkpoint import save_checkpoint, restore_checkpoint, \
    latest_checkpoint
from repro_torch.train.trainer import Trainer, TrainState
from repro_torch.train.stage2 import Stage2Engine, triplet_row_batch

"""Launcher-side fault tolerance, port of `repro.train.fault_tolerance`:
a supervised restart loop.

The division of labour:

  - `Trainer.install_preemption_handler`: in-process SIGTERM ->
    checkpoint -> exit(42).
  - `supervise()` (here): re-runs the training command while its exits
    are retryable (42 = preemption, 137 = OOM kill / SIGKILL, 139, 143)
    or it ran longer than a minute before failing, up to `max_restarts`.
    The restarted Trainer resumes through `Trainer.restore()`.
  - Elasticity: checkpoints hold full tensors in the logical layout,
    whatever the mesh that wrote them, and the data stream is a pure
    function of the step, so a restart may come back with a different
    number of ranks: pass the new mesh and the shards follow the rules.
"""
from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, List, Optional

from repro_torch.utils.log import get_logger

log = get_logger("repro_torch.ft")

RETRYABLE_EXITS = {42, 137, 139, 143}


def supervise(cmd: List[str], max_restarts: int = 100,
              backoff_s: float = 2.0, env: Optional[dict] = None) -> int:
    """Runs `cmd` under restart supervision. Returns the final exit
    code."""
    restarts = 0
    while True:
        t0 = time.monotonic()
        proc = subprocess.run(cmd, env={**os.environ, **(env or {})})
        code = proc.returncode
        if code == 0:
            log.info("job finished cleanly after %d restarts", restarts)
            return 0
        if restarts >= max_restarts:
            log.error("giving up after %d restarts (exit %d)", restarts, code)
            return code
        if code in RETRYABLE_EXITS or (time.monotonic() - t0) > 60:
            restarts += 1
            log.warning("restart %d after exit %d", restarts, code)
            time.sleep(backoff_s)
            continue
        log.error("non-retryable fast failure (exit %d)", code)
        return code


def run_with_restarts(step_fn: Callable[[], None], max_restarts: int = 3):
    """In-process variant: calls step_fn, retrying on a SystemExit with a
    retryable code. Returns the number of restarts taken."""
    for attempt in range(max_restarts + 1):
        try:
            step_fn()
            return attempt
        except SystemExit as e:
            if e.code in RETRYABLE_EXITS and attempt < max_restarts:
                log.warning("in-process restart %d (exit %s)", attempt + 1,
                            e.code)
                continue
            raise
    return max_restarts

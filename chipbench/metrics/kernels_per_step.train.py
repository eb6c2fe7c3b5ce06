"""The trainer's and optimizer's dispatch (`train/trainer.py`,
`train/optimizer.py`): kernels the card ran a training step in the
traced window (copies and fills left out)."""


def read(run):
    steps = run.counts["steps"]
    if not steps:
        return None
    n = sum(1 for name, _, _ in run.trace.ops
            if not name.startswith(("Memcpy", "Memset")))
    return n / steps

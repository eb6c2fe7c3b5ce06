"""The optimizer's dispatch (`train/optimizer.py`, `Trainer._update`):
milliseconds of the program's `train.optimizer` spans (the update and
the copy into the parameters), a `train.step`."""
from chipbench import program_spans


def read(run):
    v = program_spans.view(run)
    n = v.count("train.step") if v else 0
    return 1e3 * v.total("train.optimizer") / n if n else None

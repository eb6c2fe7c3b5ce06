"""The trainer's dispatch (`train/trainer.py`): milliseconds the card
stood idle under the program's `train.*` spans other than `train.read`
(the host's read of the metrics, which waits for the card), a
`train.step`."""
from chipbench import program_spans


def read(run):
    v = program_spans.view(run)
    n = v.count("train.step") if v else 0
    return 1e3 * v.idle_under("train.", but=("train.read",)) / n if n else None

"""Stage 1's encoder (`core/bbe`): the share of its token slots that held
padding (a chunk's padded rows and the pad of short blocks in `max_len`
rows), from the counts of the program's `stage1.model` spans, in
percent."""
from chipbench import program_spans


def read(run):
    v = program_spans.view(run)
    slots = v.counted("stage1.model", "slots") if v else 0
    if not slots:
        return None
    return 100.0 * (1.0 - v.counted("stage1.model", "tokens") / slots)

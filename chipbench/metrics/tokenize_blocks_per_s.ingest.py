"""Stage 1's host tokenizer (`core/tokenizer`): blocks tokenized a second
inside the program's `stage1.tokenize` spans."""
from chipbench import program_spans


def read(run):
    v = program_spans.view(run)
    busy = v.total("stage1.tokenize") if v else 0.0
    return v.counted("stage1.tokenize", "blocks") / busy if busy > 0 else None

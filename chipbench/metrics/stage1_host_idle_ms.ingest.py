"""Stage 1 (`core/pipeline.encode_blocks`): milliseconds the card stood
idle under the program's `stage1.*` spans, a `service.ingest_blocks`
call."""
from chipbench import program_spans


def read(run):
    v = program_spans.view(run)
    n = v.count("service.ingest_blocks") if v else 0
    return 1e3 * v.idle_under("stage1.") / n if n else None

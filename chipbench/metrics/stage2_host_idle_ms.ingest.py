"""Stage 2 and the store (`core/pipeline.interval_signatures`,
`api/store`): milliseconds the card stood idle under the program's
`stage2.*` spans, a `service.ingest_intervals` call."""
from chipbench import program_spans


def read(run):
    v = program_spans.view(run)
    n = v.count("service.ingest_intervals") if v else 0
    return 1e3 * v.idle_under("stage2.") / n if n else None

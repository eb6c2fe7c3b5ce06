"""Stage 2's `BBEIndex` (`core/pipeline._table_index`): milliseconds of
the program's `stage2.index` spans (the index rebuilt over the whole BBE
table and uploaded), a `service.ingest_intervals` call."""
from chipbench import program_spans


def read(run):
    v = program_spans.view(run)
    n = v.count("service.ingest_intervals") if v else 0
    return 1e3 * v.total("stage2.index") / n if n else None

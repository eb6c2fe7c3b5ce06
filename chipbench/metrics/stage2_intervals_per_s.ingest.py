"""Stage 2 and the store (`core/pipeline.interval_signatures`,
`core/signature`, `models/set_transformer`, `api/store`): intervals
signed and stored a second inside `ingest_intervals`, from the
benchmark's spans around the calls."""


def read(run):
    busy = run.spans.total("ingest_intervals")
    return run.counts["intervals"] / busy if busy > 0 else None

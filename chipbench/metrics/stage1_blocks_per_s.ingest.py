"""Stage 1 (`core/pipeline.encode_blocks`, `core/tokenizer`, `core/bbe`):
new blocks signed a second inside `ingest_blocks`, from the benchmark's
spans around the calls."""


def read(run):
    busy = run.spans.total("ingest_blocks")
    return run.counts["new_blocks"] / busy if busy > 0 else None

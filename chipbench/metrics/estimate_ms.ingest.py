"""The knowledge base (`api/knowledge`, `core/clustering`): milliseconds
inside `estimate` a program, from the benchmark's spans."""


def read(run):
    n = run.spans.count("estimate")
    return 1e3 * run.spans.total("estimate") / n if n else None

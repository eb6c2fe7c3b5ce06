"""The program's spans on the benchmark's clock (`program_spans`) and the
per-layer metrics that read them: by hand, on a made-up run with a known
clock offset and rate; then on traced tiny CPU runs of both cells, one
after the other in one process."""
import importlib.util
import sys

import pytest
import torch

from chipbench import bench, program_spans, tiny
from chipbench.bench import HERE, Trace
from repro_torch.utils import spans

SEED = 2 ** 31 + 11
NEW = ("tokenize_blocks_per_s.ingest", "encoder_pad_pct.ingest",
       "stage1_host_idle_ms.ingest", "bbe_index_ms.ingest",
       "stage2_host_idle_ms.ingest", "optimizer_ms.train", "step_host_idle_ms.train")
HOST0, RATE = 5000.0, 1.0005        # host seconds at the window's start


def _host(t: float) -> float:
    return HOST0 + RATE * t


def _record(i, name, a, b, **counts):
    return spans.Record(i, name, round(_host(a) * 1e9), round(_host(b) * 1e9),
                        None, i, 0, counts)


def _run(bench_spans, ops, records, window=1.0, dropped=0, monkeypatch=None):
    host = bench.Spans(False)
    host.spans = [(n, _host(a), _host(b)) for n, a, b in bench_spans] + [
        ("window", _host(0.0), _host(window))]
    run = bench.Run(bench.Cell("x", {}, {}, {}, 1), host, {},
                    Trace(window, list(ops), list(bench_spans)))
    monkeypatch.setattr(program_spans, "_recorded",
                        lambda: (records, dropped))
    return run


INGEST_SPANS = [("ingest_blocks", 0.1, 0.4), ("ingest_intervals", 0.5, 0.8)]
INGEST_OPS = [("k", 0.0, 0.15), ("k", 0.3, 0.35), ("k", 0.6, 0.7)]
INGEST = [
    _record(0, "service.ingest_blocks", -5.0, -4.0),    # an earlier window
    _record(1, "stage1.tokenize", 0.15, 0.25, blocks=50),
    _record(2, "stage1.model", 0.26, 0.36, tokens=60, slots=100),
    _record(3, "service.ingest_blocks", 0.12, 0.38),
    _record(4, "stage2.index", 0.53, 0.57),
    _record(5, "stage2.assemble", 0.57, 0.65),
    _record(6, "service.ingest_intervals", 0.52, 0.78),
]


def test_ingest_readers_by_hand(monkeypatch):
    run = _run(INGEST_SPANS, INGEST_OPS, INGEST, monkeypatch=monkeypatch)
    v = program_spans.view(run)
    assert v.residual_s < 1e-9
    assert v.count("service.ingest_blocks") == 1
    # idle [0.15, 0.3], [0.35, 0.6], [0.7, 1.0], by the innermost span
    assert v.idle == pytest.approx({
        "stage1.tokenize": 0.10, "service.ingest_blocks": 0.03,
        "stage1.model": 0.05, "ingest_blocks": 0.02, "outside": 0.30,
        "ingest_intervals": 0.04, "service.ingest_intervals": 0.09,
        "stage2.index": 0.04, "stage2.assemble": 0.03})
    want = {"tokenize_blocks_per_s.ingest": 50 / 0.1,
            "encoder_pad_pct.ingest": 40.0,
            "stage1_host_idle_ms.ingest": 150.0,
            "bbe_index_ms.ingest": 40.0,
            "stage2_host_idle_ms.ingest": 70.0}
    for name, value in want.items():
        assert bench.reader(name)(run) == pytest.approx(value), name


def test_train_readers_by_hand(monkeypatch):
    records = [_record(0, "train.grads", 0.1, 0.3),
               _record(1, "train.clip", 0.3, 0.32),
               _record(2, "train.optimizer", 0.32, 0.45),
               _record(3, "train.read", 0.45, 0.5),
               _record(4, "train.step", 0.1, 0.5)]
    run = _run([("step", 0.09, 0.51)], [("k", 0.2, 0.3), ("k", 0.46, 0.5)],
               records, monkeypatch=monkeypatch)
    assert bench.reader("optimizer_ms.train")(run) == pytest.approx(130.0)
    # grads 0.1, clip 0.02, optimizer 0.13; not the read's 0.01
    assert bench.reader("step_host_idle_ms.train")(run) == pytest.approx(250.0)


def test_benchmark_spans_alone_split_idle_as_the_trace_does(monkeypatch):
    run = _run(INGEST_SPANS, INGEST_OPS, [], monkeypatch=monkeypatch)
    got = program_spans.idle_by_innermost(program_spans._idle(run.trace), [],
                                          run.trace.spans)
    assert got == pytest.approx(dict(map(tuple, run.trace.idle_by_span())))


def test_nothing_to_read_gives_none(monkeypatch):
    for recorded in (None, ([], 0)):        # a program without spans; none
        run = _run(INGEST_SPANS, INGEST_OPS, [], monkeypatch=monkeypatch)
        monkeypatch.setattr(program_spans, "_recorded", lambda: recorded)
        for name in NEW:
            assert bench.reader(name)(run) is None, name


def test_a_port_without_the_recorder_records_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.utils.spans", None)
    assert program_spans._recorded() is None


def test_a_window_that_lost_records_is_refused(monkeypatch):
    run = _run(INGEST_SPANS, INGEST_OPS, INGEST[1:], dropped=1,
               monkeypatch=monkeypatch)
    assert program_spans.view(run) is None
    # what was pushed out ended before the oldest record kept: before
    # the window
    run = _run(INGEST_SPANS, INGEST_OPS, INGEST, dropped=1,
               monkeypatch=monkeypatch)
    assert program_spans.view(run) is not None


def test_the_fit_recovers_offset_and_rate():
    pairs = [(HOST0 + RATE * t + 0.3, t) for t in (0.0, 0.2, 0.7, 1.0)]
    offset, rate, residual = program_spans.fit(pairs)
    assert rate == pytest.approx(1 / RATE, rel=1e-9)
    assert offset + rate * (HOST0 + 0.3) == pytest.approx(0.0, abs=1e-9)
    assert residual < 1e-9


# ------------------------------------------------ traced tiny CPU runs
@pytest.fixture(scope="module")
def traced():
    """{cell: (the result, the run handed to the readers)}, the ingest
    cell's window then the pre-training cell's, in one process."""
    spec = importlib.util.spec_from_file_location("chipbench_run",
                                                  HERE / "run.py")
    run_py = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_py)
    bench_json = bench.load_json(bench.ROOT / "BENCHMARK.json")
    made, make = [], bench.Run

    def keep(*args, **kw):
        made.append(make(*args, **kw))
        return made[-1]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    spans.reset()
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(bench, "Run", keep)
            for name in ("ingest-new.fp32", "pretrain.fp32"):
                result, _ = run_py.execute(tiny.cell(name), bench_json, SEED,
                                           0.5, True, torch.device("cpu"))
                out[name] = (result, made[-1])
    finally:
        torch.set_num_threads(n)
    return out, bench_json


def test_traced_runs_report_every_new_metric(traced):
    out, bench_json = traced
    metrics = {m["name"]: m for m in bench_json["per_layer"]}
    for name in NEW:
        m = metrics[name]
        assert m["source"] == "program_span"
        (cell,) = m["workloads"]
        result, _ = out[cell]
        assert result["correct"]
        assert result["metrics"][m["name"]]["value"] is not None, m["name"]


def test_program_counts_agree_with_the_driver(traced):
    out, _ = traced
    _, run = out["ingest-new.fp32"]
    v = program_spans.view(run)
    assert v.counted("stage1.tokenize", "blocks") == \
        run.counts["new_blocks"] > 0
    # the denominators of the per-call readings
    for name in ("service.ingest_blocks", "service.ingest_intervals",
                 "service.estimate"):
        assert v.count(name) == run.counts["attempted"] > 0, name
    _, run = out["pretrain.fp32"]
    assert program_spans.view(run).count("train.step") == run.counts["steps"]


def test_stage1_spans_lie_inside_the_benchmarks_ingest_blocks(traced):
    out, _ = traced
    _, run = out["ingest-new.fp32"]
    calls = [(a, b) for n, a, b in run.spans.spans if n == "ingest_blocks"]
    window = [(a, b) for n, a, b in run.spans.spans if n == "window"][0]
    inside = [r for r in spans.records() if r.name.startswith("stage1.")
              and window[0] <= r.start_ns * 1e-9 <= window[1]]
    assert inside
    for r in inside:
        assert any(a <= r.start_ns * 1e-9 <= r.end_ns * 1e-9 <= b
                   for a, b in calls), r


def test_each_run_reads_only_its_own_window(traced):
    out, _ = traced
    names = {r.name for r in spans.records()}
    assert "stage1.model" in names and "train.step" in names
    ingest = {s[0] for s in program_spans.view(out["ingest-new.fp32"][1]).spans}
    train = {s[0] for s in program_spans.view(out["pretrain.fp32"][1]).spans}
    assert "stage1.model" in ingest and not any(
        n.startswith("train.") for n in ingest)
    assert "train.step" in train and not any(
        n.startswith(("stage1.", "stage2.", "service.")) for n in train)

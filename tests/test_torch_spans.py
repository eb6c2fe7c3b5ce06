"""The port's span recorder (`repro_torch.utils.spans`) on the CPU: off
without a profiler, on under one; parents, request ids, per-thread
stacks, counts and the bound on what it keeps; and the spans of the
service's and the Trainer's calls."""
import logging
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.utils import spans  # noqa: E402


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _fresh():
    spans.reset()
    yield
    spans.reset()


def _by_name(records):
    return {r.name: r for r in records}


def test_nothing_is_recorded_without_a_profiler():
    assert not spans.recording()
    with spans.span("a", x=1) as s:
        spans.add(y=2)
        with spans.span("b"):
            pass
    assert s is None
    assert spans.records() == [] and spans.dropped() == 0


def test_a_cpu_profiler_turns_recording_on():
    with _profiled():
        assert spans.recording()
        with spans.span("on", x=1):
            pass
    with spans.span("off"):
        pass
    (r,) = spans.records()
    assert (r.name, r.counts, r.parent) == ("on", {"x": 1}, None)
    assert 0 < r.start_ns <= r.end_ns


def test_parents_and_request_ids_follow_the_nesting():
    with _profiled():
        with spans.span("root"):
            with spans.span("child"):
                with spans.span("leaf"):
                    pass
            with spans.span("sibling"):
                pass
        with spans.span("next"):
            pass
    got = _by_name(spans.records())
    root = got["root"]
    assert root.parent is None and root.request == root.index
    assert got["child"].parent == root.index
    assert got["leaf"].parent == got["child"].index
    assert got["sibling"].parent == root.index
    assert {got[n].request for n in ("child", "leaf", "sibling")} == \
        {root.index}
    assert got["next"].parent is None
    assert got["next"].request == got["next"].index != root.index
    # finished in the order they closed
    assert [r.name for r in spans.records()] == [
        "leaf", "child", "sibling", "root", "next"]


def test_each_thread_has_its_own_stack():
    both = threading.Barrier(2, timeout=10)

    def rank(r):
        with spans.span(f"root{r}"):
            both.wait()             # both roots open at once
            with spans.span(f"child{r}"):
                both.wait()

    with _profiled():
        threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    got = _by_name(spans.records())
    for r in (0, 1):
        root, child = got[f"root{r}"], got[f"child{r}"]
        assert root.parent is None
        assert child.parent == root.index and child.request == root.index
        assert child.thread == root.thread
    assert got["root0"].thread != got["root1"].thread


def test_counts_land_on_the_innermost_open_span():
    with _profiled():
        with spans.span("outer", rows=1):
            with spans.span("inner"):
                spans.add(rows=2, tokens=5)
                spans.add(tokens=1)
            spans.add(rows=3)
    got = _by_name(spans.records())
    assert got["inner"].counts == {"rows": 2, "tokens": 6}
    assert got["outer"].counts == {"rows": 4}


def test_the_bound_keeps_the_newest_and_counts_the_dropped():
    rec = spans.Recorder(capacity=3)
    with _profiled():
        for i in range(5):
            with rec.span(f"s{i}"):
                pass
    assert [r.name for r in rec.records()] == ["s2", "s3", "s4"]
    assert rec.dropped() == 2
    rec.reset()
    assert rec.records() == [] and rec.dropped() == 0


# ----------------------------------------------------------- the sites
def _tiny_service():
    from repro_torch.api import SemanticBBVService, ServiceConfig
    from repro_torch.core.bbe import BBEConfig
    from repro_torch.core.signature import SignatureConfig
    bbe = BBEConfig(dim_embeds=(24, 8, 8, 8, 8, 8), num_layers=1,
                    num_heads=2, bbe_dim=16, max_len=16)
    sig = SignatureConfig(bbe_dim=16, d_model=16, sig_dim=8, max_set=4,
                          num_heads=2)
    cfg = ServiceConfig(bbe=bbe, sig=sig, k=2, encode_batch=8,
                        signature_batch=4)
    return SemanticBBVService.create(cfg, device="cpu")


def _tiny_program():
    from repro_torch.data import asmgen, trace
    prog = asmgen.spec_programs("int")[0]
    return list(prog.unique_blocks), trace.trace_program(prog, 5, seed=0)


def test_service_calls_record_their_stages():
    torch.manual_seed(0)
    svc = _tiny_service()
    blocks, ivs = _tiny_program()
    with _profiled():
        svc.ingest_blocks(blocks)
        svc.ingest_blocks(blocks[:3])            # all three cached
        svc.ingest_intervals("p", ivs)
    recs = spans.records()
    roots = [r for r in recs if r.name.startswith("service.")]
    assert [r.name for r in roots] == ["service.ingest_blocks"] * 2 + [
        "service.ingest_intervals"]
    for r in recs:
        assert r.request in {s.index for s in roots}, r
    first, second = roots[0].index, roots[1].index
    assert [r.request for r in recs if r.name == "stage1.keys"] == [
        first, second]
    # the second call's blocks were all cached: nothing to tokenize
    tokenize = [r for r in recs if r.name == "stage1.tokenize"]
    assert [(r.request, r.counts) for r in tokenize] == [
        (first, {"blocks": len(blocks)})]
    model = [r for r in recs if r.name == "stage1.model"]
    assert len(model) == -(-len(blocks) // 8)
    assert all(r.counts["slots"] == 8 * 16 for r in model)
    lengths = svc.pipe.tok.lengths(svc.pipe.tok.encode_blocks(blocks, 16))
    assert sum(r.counts["tokens"] for r in model) == int(lengths.sum())
    assert len([r for r in recs if r.name == "stage2.model"]) == \
        -(-len(ivs) // 4)
    assert [r.name for r in recs if r.name == "stage2.index"] == \
        ["stage2.index"]
    for name in ("stage1.upload", "stage1.read", "stage1.table",
                 "stage2.assemble", "stage2.upload", "stage2.read",
                 "stage2.store"):
        assert any(r.name == name for r in recs), name


def test_service_counts_cost_nothing_without_a_profiler(monkeypatch):
    torch.manual_seed(0)
    svc = _tiny_service()
    blocks, ivs = _tiny_program()

    def counted(*a, **kw):
        raise AssertionError("a count computed with recording off")
    monkeypatch.setattr(svc.pipe.tok, "lengths", counted)
    svc.ingest_blocks(blocks)
    assert len(svc.ingest_intervals("p", ivs)) == len(ivs)
    assert spans.records() == [] and spans.dropped() == 0


def _linear_loss(model, batch):
    err = batch["x"] @ model.w - batch["y"]
    loss = torch.mean(torch.square(err))
    return loss, {"mse": loss}


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4, 2))


def _trainer(tmp_path):
    from repro_torch.config import TrainConfig
    from repro_torch.train.trainer import Trainer
    return Trainer(_linear_loss, _Linear(), TrainConfig(
        learning_rate=1e-2, warmup_steps=1, total_steps=30,
        checkpoint_every=0, checkpoint_dir=str(tmp_path)))


def test_a_training_step_records_its_phases(tmp_path):
    from repro_torch.train import trainer as trainer_mod
    tr = _trainer(tmp_path)
    rng = np.random.RandomState(0)
    batch = {"x": torch.from_numpy(rng.randn(8, 4).astype(np.float32)),
             "y": torch.from_numpy(rng.randn(8, 2).astype(np.float32))}
    with _profiled():
        for _ in range(2):
            tr.step(batch)
    for _ in range(trainer_mod._STRAGGLER_WINDOW + 5):
        tr.step(batch)
    recs = spans.records()
    steps = [r for r in recs if r.name == "train.step"]
    assert len(steps) == 2
    for step in steps:
        mine = [r for r in recs if r.request == step.index and r is not step]
        assert sorted(r.name for r in mine) == [
            "train.clip", "train.grads", "train.optimizer", "train.read"]
        assert all(r.parent == step.index for r in mine)
    # the watchdog keeps only the steps it compares with
    assert len(tr._step_times) == trainer_mod._STRAGGLER_WINDOW


def test_the_watchdog_still_flags_a_straggler(tmp_path, caplog):
    tr = _trainer(tmp_path)
    tr._step_times.extend([0.1] * 30)
    with caplog.at_level(logging.WARNING, logger="repro_torch.train"):
        tr._watchdog(0.25)
        assert not caplog.records
        tr._step_times.append(1.0)
        tr._watchdog(1.0)
    assert "straggler: step 0 took 1.000s (median 0.100s)" in caplog.text

"""A run driven on the CPU at a tiny size, past the look for a card,
with the timed path broken underneath: `correct` has to come out false
for each fault the cell can have. Unbroken, the ingest cell comes out
correct."""
import importlib.util

import pytest
import torch

from chipbench import bench, tiny
from chipbench.bench import HERE

SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def _few_threads():
    """Tiny models run no faster on many threads; the test runner's
    other workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _execute(name, seconds=0.5):
    spec = importlib.util.spec_from_file_location("chipbench_run",
                                                  HERE / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    bench_json = bench.load_json(bench.ROOT / "BENCHMARK.json")
    result, lines = run.execute(tiny.cell(name), bench_json, SEED, seconds,
                                False, torch.device("cpu"))
    return result


def test_ingest_unbroken_is_correct():
    assert _execute("ingest-new.fp32")["correct"]


def _alter_first_bbe(monkeypatch):
    from repro_torch.core.pipeline import SemanticBBVPipeline
    encode = SemanticBBVPipeline.encode_tokens

    def altered(self, tokens, batch=256):
        out = encode(self, tokens, batch)
        out[:1] += 0.01
        return out
    monkeypatch.setattr(SemanticBBVPipeline, "encode_tokens", altered)


def _half_sets(monkeypatch):
    from repro_torch.core import pipeline
    ids = pipeline.batch_set_ids
    monkeypatch.setattr(pipeline, "batch_set_ids",
                        lambda ivs, index, n: ids(ivs, index, n // 2))


def _alter_estimate(monkeypatch):
    import dataclasses
    from repro_torch.api.knowledge import KnowledgeBase
    estimate = KnowledgeBase.estimate
    monkeypatch.setattr(KnowledgeBase, "estimate", lambda self, p: (
        dataclasses.replace(estimate(self, p),
                            est_cpi=estimate(self, p).est_cpi * 1.01)))


def _farthest_representatives(monkeypatch):
    import numpy as np
    from repro_torch.api import knowledge

    def farthest(x, centroids, assign):
        d = ((x[:, None, :] - centroids[None]) ** 2).sum(-1)
        return np.asarray([int(np.argmax(np.where(assign == j, d[:, j], -1)))
                           for j in range(len(centroids))])
    monkeypatch.setattr(knowledge, "representatives", farthest)


@pytest.mark.parametrize("fault", [_alter_first_bbe, _half_sets,
                                   _alter_estimate,
                                   _farthest_representatives])
def test_ingest_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = _execute("ingest-new.fp32")
    assert not result["correct"], result["checks"]


def _unchanged_state(monkeypatch):
    from repro_torch.train.trainer import Trainer
    monkeypatch.setattr(Trainer, "_update", lambda self, grads, lr: {
        k: p.detach() for k, p in self.state.params.items()})


def _half_batch(monkeypatch):
    from repro_torch.train.trainer import Trainer
    init = Trainer.__init__

    def halved(self, loss_fn, *args, **kw):
        init(self, lambda model, batch: loss_fn(model, {
            k: v[:v.shape[0] // 2] for k, v in batch.items()}), *args, **kw)
    monkeypatch.setattr(Trainer, "__init__", halved)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch])
def test_pretrain_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = _execute("pretrain.fp32", seconds=0.2)
    assert not result["correct"], result["checks"]

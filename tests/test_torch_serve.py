"""The port's ServeEngine on the CPU against `repro.serve.ServeEngine` on
the same bridged weights: the same token lists, and the seven properties
of tests/test_serve.py (completion with refills, greedy determinism,
slot isolation, temperature sampling, prefill-vs-tokenwise parity, the
prefill step's riding-slot isolation, max_seq)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve.engine import _prefill_scan  # noqa: E402

SMALL = dict(num_layers=2, d_model=32, num_heads=2, d_ff=64, vocab_size=64)


@pytest.fixture(scope="module")
def served():
    """(port cfg, port model, port params, JAX model, JAX params) on the
    weights of tests/test_serve.py's fixture (JAX init, key 0), fp32."""
    jcfg = jconfig.scaled_down(jconfig.get_arch("smollm_135m"), **SMALL)
    tcfg = tconfig.scaled_down(tconfig.get_arch("smollm_135m"), **SMALL)
    jmodel = jax_build_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    lm = bridge.lm_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jparams), tcfg)
    return tcfg, build_model(tcfg), lm, jmodel, jparams


def _outs(engine_cls, request_cls, model, params, requests, **kw):
    if engine_cls is ServeEngine:
        kw["device"] = "cpu"
    eng = engine_cls(model, params, **kw)
    for rid, prompt, max_new in requests:
        eng.submit(request_cls(rid=rid, prompt=list(prompt), max_new=max_new))
    return {r: list(req.out) for r, req in eng.run().items()}


def _both(served, requests, **kw):
    """(port's token lists, JAX's token lists) for the same requests."""
    tcfg, model, lm, jmodel, jparams = served
    return (_outs(ServeEngine, Request, model, lm, requests, **kw),
            _outs(JServeEngine, JRequest, jmodel, jparams, requests, **kw))


def test_engine_completes_all_requests_as_jax(served):
    cfg = served[0]
    requests = [(i, [1 + i, 2, 3], 4) for i in range(5)]   # 5 > 2 slots
    got, want = _both(served, requests, num_slots=2, max_seq=32)
    assert got == want
    assert set(got) == set(range(5))
    for out in got.values():
        assert len(out) == 4
        assert all(0 <= t < cfg.vocab_size for t in out)


def test_greedy_decode_deterministic(served):
    tcfg, model, lm, _, _ = served
    outs = [_outs(ServeEngine, Request, model, lm, [(0, [5, 6], 6)],
                  num_slots=1, max_seq=32) for _ in range(2)]
    assert outs[0] == outs[1]


def test_refilled_slot_isolated_from_previous_request(served):
    """A request decoded in a refilled slot gives exactly what a fresh
    engine gives, and what JAX's engine gives."""
    tcfg, model, lm, _, _ = served
    got, want = _both(served, [(0, [7, 8, 9], 5), (1, [3, 4], 5)],
                      num_slots=1, max_seq=32)
    fresh = _outs(ServeEngine, Request, model, lm, [(1, [3, 4], 5)],
                  num_slots=1, max_seq=32)
    assert got[1] == fresh[1]
    assert got == want


def test_temperature_sampling_matches_jax(served):
    """Gumbel-max with the same numpy noise (seed 7) on both sides."""
    cfg = served[0]
    requests = [(i, [1 + i, 2], 6) for i in range(3)]
    got, want = _both(served, requests, num_slots=2, max_seq=32,
                      temperature=1.0, seed=7)
    assert got == want
    assert set(got) == {0, 1, 2}
    for out in got.values():
        assert len(out) == 6
        assert all(0 <= t < cfg.vocab_size for t in out)


def test_prefill_matches_tokenwise_decode(served):
    """The batched prefill reproduces token-by-token prompt consumption
    exactly, across ragged prompts, queueing and mid-run refills, and
    both equal JAX's engine."""
    tcfg, model, lm, jmodel, jparams = served
    requests = [(i, [1 + i, 2, 3] + [4] * i, 5) for i in range(5)]
    outs = {pf: _outs(ServeEngine, Request, model, lm, requests, num_slots=2,
                      max_seq=32, use_prefill=pf) for pf in (True, False)}
    assert outs[True] == outs[False]
    assert outs[True] == _outs(JServeEngine, JRequest, jmodel, jparams,
                               requests, num_slots=2, max_seq=32)


def test_prefill_scan_logits_and_riding_slot_isolation(served):
    """The prefill loop: (a) last-token logits and cache equal sequential
    decode steps; (b) a slot riding along with lens=0 keeps its cache row
    and position bit-identical."""
    tcfg, model, lm, _, _ = served
    B, prompt = 2, [5, 6, 7]
    cache = model.init_cache(B, 32, torch.float32, device="cpu")
    pos = torch.tensor([0, 0])
    for t in (9, 10):   # slot 1 first decodes two tokens of its own
        _, cache = model.decode_step(lm, cache, torch.tensor([[0], [t]]), pos)
        pos = pos + 1
    for leaves in cache.values():
        for leaf in leaves.values():
            leaf[:, 0] = 0
    start = torch.tensor([0, 2])
    # sequential truth: slot 0 consumes the prompt, slot 1 untouched
    c_seq = {n: {k: v.clone() for k, v in lv.items()}
             for n, lv in cache.items()}
    p_seq = start
    for t in prompt:
        logits, c_new = model.decode_step(lm, {n: {k: v.clone() for k, v in
                                                   lv.items()}
                                               for n, lv in c_seq.items()},
                                          torch.tensor([[t], [0]]), p_seq)
        for n, lv in c_new.items():
            for k, v in lv.items():
                v[:, 1] = c_seq[n][k][:, 1]
        c_seq = c_new
        p_seq = p_seq + torch.tensor([1, 0])
    before = {n: {k: v.clone() for k, v in lv.items()}
              for n, lv in cache.items()}
    toks = torch.tensor([prompt + [0], [0] * 4])
    last, c_pf = _prefill_scan(model.decode_step, tcfg.vocab_size, lm, cache,
                               toks, torch.tensor([3, 0]), start)
    np.testing.assert_allclose(last[0].numpy(), logits[0, 0].numpy(),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(last[1], torch.zeros(tcfg.vocab_size))
    for n, lv in c_pf.items():
        for k, v in lv.items():
            assert torch.equal(v, c_seq[n][k])
            assert torch.equal(v[:, 1], before[n][k][:, 1])


def test_engine_respects_max_seq_as_jax(served):
    got, want = _both(served, [(0, [1, 2, 3], 100)], num_slots=1, max_seq=8)
    assert len(got[0]) < 100  # truncated by the sequence budget
    assert got == want


def test_engine_defaults_and_device_checks(served):
    tcfg, model, lm, _, _ = served
    eng = ServeEngine(model, lm, num_slots=2, max_seq=16, device="cpu")
    leaves = [v for lv in eng.cache.values() for v in lv.values()]
    assert leaves and all(v.dtype == torch.float32 for v in leaves)
    assert all(v.shape == (tcfg.num_layers, 2, 16, tcfg.num_kv_heads,
                           tcfg.resolved_head_dim) for v in leaves)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeEngine(model, lm)
    with pytest.raises(ValueError, match="params are on"):
        ServeEngine(model, model.init(0, device="cpu").to("meta"),
                    device="cpu")

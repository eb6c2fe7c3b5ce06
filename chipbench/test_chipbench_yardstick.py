"""The frozen work and mfu formulas against hand counts at small
shapes."""

import pytest

from chipbench import bench, yardstick
from chipbench.bench import Trace

S1 = {"dim_embeds": [6, 2], "num_layers": 2, "num_heads": 2, "bbe_dim": 4,
      "nip_horizon": 3, "max_len": 16, "dtype": "float32"}
S2 = {"bbe_dim": 4, "d_model": 8, "sig_dim": 2, "num_heads": 2,
      "num_sabs": 2, "num_seeds": 1}


def test_wkv_work_by_hand():
    # B 1, S 2, H 1, dh 2: n = 4 elements, 2 gates, a 4-element state
    ops, nbytes = yardstick.wkv_work(1, 2, 1, 2, "float32", train=False)
    assert ops == 7 * 4 * 2
    assert nbytes == 3 * 16 + 16 + 8 + 16 + 32
    ops, nbytes = yardstick.wkv_work(1, 2, 1, 2, "bfloat16", train=True)
    assert ops == (7 + 22) * 4 * 2
    assert nbytes == (24 + 16 + 8 + 16 + 32) + (16 + 24 + 16 + 8 + 32)


def test_least_seconds_takes_the_larger_bound():
    assert yardstick.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert yardstick.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_parameter_counts_by_hand():
    d = 8
    assert yardstick.stage1_params(S1) == 2 * (13 * 64 + 16) + 64 + 8
    assert yardstick.stage1_block_params(S1) == 32
    assert yardstick.pretrain_params(S1, 5) == \
        2 * (13 * 64 + 16) + 2 * 64 + 8 * 5 * 4
    assert yardstick.stage2_element_params(S2) == 5 * d + 2 * 8 * d * d \
        + 2 * d * d
    assert yardstick.stage2_set_params(S2) == 6 * d * d + d * 2 + 2 * d + d


def _run(counts, config, ops=(), mix=None, window=2.0):
    cell = bench.Cell("x", config, mix or {}, {}, 1)
    return bench.Run(cell, bench.Spans(False), counts,
                     Trace(window, list(ops), []))


def test_mfu_readers_by_hand():
    cfg = {"stage1": S1}
    run = _run({"window_s": 2.0, "tokens": 1000}, cfg)
    n = yardstick.pretrain_params(S1, 352)
    assert bench.reader("mfu.train")(run) == pytest.approx(
        100 * 6 * n * 1000 / (2.0 * 67e12))
    cfg = {"stage1": S1, "stage2": S2}
    c = {"window_s": 1.0, "stage1_tokens": 10, "new_blocks": 2,
         "set_elements": 30, "intervals": 3}
    want = 2 * (yardstick.stage1_params(S1) * 10 + 32 * 2
                + yardstick.stage2_element_params(S2) * 30
                + yardstick.stage2_set_params(S2) * 3)
    assert bench.reader("mfu.ingest")(_run(c, cfg)) == pytest.approx(
        100 * want / 67e12)


def test_trace_readers_by_hand():
    cfg = {"stage1": S1, "service": {"encode_batch": 4}}
    ops = [("void wkv_forward_kernel<float>", 0.1, 0.3),
           ("void bwd::wkv_backward_kernel<float>", 0.3, 0.6),
           ("Memcpy HtoD", 0.5, 0.7), ("gemm", 1.5, 1.6)]
    run = _run({"steps": 2}, cfg, ops, mix={"rows": 4})
    assert run.trace.busy_s() == pytest.approx(0.7)
    assert bench.reader("device_idle.train")(run) == pytest.approx(65.0)
    assert bench.reader("kernels_per_step.train")(run) == pytest.approx(1.5)
    ops_, b = yardstick.wkv_work(4, 16, 2, 4, "float32", True)
    assert bench.reader("wkv_roofline.train")(run) == pytest.approx(
        100 * yardstick.least_seconds(ops_, b) / 0.5)
    ops_, b = yardstick.wkv_work(4, 16, 2, 4, "float32", False)
    assert bench.reader("wkv_roofline.ingest")(run) == pytest.approx(
        100 * yardstick.least_seconds(ops_, b) / 0.2)
    assert bench.reader("wkv_roofline.ingest")(_run({}, cfg, [])) is None


def test_idle_is_labelled_by_the_host_span():
    t = Trace(1.0, [("k", 0.0, 0.5)], [("estimate", 0.6, 0.9)])
    got = dict(map(tuple, t.idle_by_span()))
    assert got == pytest.approx({"estimate": 0.3, "outside": 0.2})


def test_quantile_interpolates():
    assert bench.quantile([4, 1, 3, 2], 0.5) == 2.5
    assert bench.quantile(range(101), 0.95) == 95.0

"""The port's step count (`repro_torch.analysis.counting`), the kernels'
work (`analysis.costs`) and the H100 roofline (`analysis.roofline`) on the
CPU: the count against JAX's HLO analysis on its scan module, the CPU
against meta tensors (exactly: the same FLOPs by dtype, bytes and kernel
records), the token loops' probes on meta against the full loops on the
CPU, CPU outputs bitwise unchanged under a count, each kernel's meta
route and record, and the costs at PERF.md's timed shapes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis.hlo_parse import analyze_hlo  # noqa: E402
from repro_torch.analysis import costs, counting  # noqa: E402
from repro_torch.analysis.counting import StepCount, token_loop  # noqa: E402
from repro_torch.analysis.roofline import (  # noqa: E402
    format_report, link_for, roofline_terms,
)
from repro_torch.config import TrainConfig, get_arch, scaled_down  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_backward_reference, attention_reference,
    flash_attention_backward, flash_forward,
)
from repro_torch.kernels.kmeans_assign import (  # noqa: E402
    kmeans_assign, kmeans_assign_reference, kmeans_update,
    kmeans_update_reference,
)
from repro_torch.kernels.set_attention import (  # noqa: E402
    masked_set_attention, set_attention_backward,
    set_attention_backward_reference, set_attention_reference,
)
from repro_torch.kernels.wkv import (  # noqa: E402
    wkv, wkv_backward, wkv_backward_reference, wkv_reference,
)
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402


# ------------------------------------------------------------ JAX's module

def test_scan_module_count_matches_hlo():
    """JAX's test_analysis scan module (7 x tanh(c @ w_i) over 64 x 64),
    written as a torch loop: 2 * 64^3 * 7 product FLOPs exactly, as JAX's
    trip-count-corrected HLO analysis counts them."""
    def f(x, w):
        def body(c, wi):
            return jnp.tanh(c @ wi), None

        y, _ = jax.lax.scan(body, x, w)
        return y.sum()

    text = jax.jit(f).lower(jax.ShapeDtypeStruct((64, 64), jnp.float32),
                            jax.ShapeDtypeStruct((7, 64, 64), jnp.float32)
                            ).compile().as_text()
    want = 2 * 64 ** 3 * 7
    assert analyze_hlo(text).dot_flops == want
    for dev in ("cpu", "meta"):
        x = torch.ones((64, 64), device=dev)
        w = torch.ones((7, 64, 64), device=dev)
        with StepCount() as count:
            c = x
            for i in range(7):
                c = torch.tanh(c @ w[i])
            c.sum()
        assert count.total.flops == {"float32": want}
        assert count.flops_fp32 == want and count.flops_bf16 == 0
        # the weights are read once (each slice), and not 100 times over
        assert 7 * 64 * 64 * 4 < count.bytes < 7 * 64 * 64 * 4 * 100


# ----------------------------------------------------------------- roofline

class _Count:
    def __init__(self, fp32=0.0, bf16=0.0, nbytes=0.0, coll=None):
        self.flops_fp32, self.flops_bf16, self.bytes = fp32, bf16, nbytes
        self.collective_bytes = coll or {}


def test_roofline_terms_math():
    """Each term is 1 s at the H100's constants: 989e12 bf16 FLOPs, 3.35e12
    bytes, 50e9 collective bytes across nodes (a 16-way axis); 67e12 fp32
    FLOPs are another second; 450e9 bytes within a node (8 ranks)."""
    hw = costs.H100_SXM
    sizes = {"data": 16, "model": 16}
    rep = roofline_terms(_Count(bf16=989e12, nbytes=3.35e12,
                                coll={"all-reduce": 50e9}),
                         arch="x", shape="y", mesh="16x16", chips=256,
                         model_flops=989e12 * 256, axis_sizes=sizes)
    t = rep.terms()
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0)
    assert t["useful_flops_ratio"] == pytest.approx(1.0)
    assert t["mfu_upper_bound"] == pytest.approx(1.0)
    assert t["roofline_fraction"] == pytest.approx(1.0)
    both = roofline_terms(_Count(fp32=67e12, bf16=989e12), arch="x",
                          shape="y", mesh="m", chips=1, model_flops=0.0)
    assert both.terms()["compute_s"] == pytest.approx(2.0)
    assert link_for({"data": 8, "model": 1}) == hw.link_bw == 450e9
    assert link_for(sizes) == link_for({"pod": 2, "data": 4}) \
        == hw.inter_node_bw == 50e9
    assert "16x16" in format_report(rep)
    # the compute term reckons as chip_smoke's bound does
    work = costs.Work(3e9, 5e10, 1e6)
    assert costs.work_bound(work)[0] / 1e3 == pytest.approx(
        roofline_terms(_Count(3e9, 5e10, 1e6), arch="x", shape="y",
                       mesh="m", chips=1, model_flops=0.0
                       ).terms()["compute_s"])


# --------------------------------------------------------------- the costs

def test_costs_give_perf_bounds():
    """`costs` reproduces PERF.md section 6's bounds at its timed shapes
    (fp32 but flash; flash at smollm's shapes in bf16), to 4 digits."""
    def ms(work):
        return round(costs.work_bound(work)[0], 4)

    assert ms(costs.wkv(256, 128, 6, 64)) == 0.0841
    assert ms(costs.kmeans_assign(32768, 128, 14)) == 0.0051
    assert ms(costs.set_attention(512, 4, 64, 64, 64)) == 0.0401
    assert ms(costs.set_attention(512, 4, 1, 64, 64)) == 0.0204
    assert ms(costs.set_attention_backward(64, 4, 64, 64, 64)) == 0.0102
    assert ms(costs.flash_attention(4, 2048, 2048, 9, 3, 64)) == 0.0196
    assert ms(costs.flash_attention_backward(8, 2048, 2048, 9, 3, 64)) \
        == 0.0978
    assert costs.work_bound(costs.Work(0.0, 0.0, 1.0))[1] == "bytes"


@pytest.mark.parametrize("S,T,causal,window,prefix", [
    (1, 1, True, 0, 0), (7, 7, True, 0, 0), (9, 5, True, 0, 0),
    (5, 9, True, 0, 3), (33, 33, True, 8, 0), (33, 33, True, 8, 12),
    (20, 31, False, 0, 0), (20, 31, False, 6, 0), (40, 40, True, 0, 99),
    (64, 64, True, 0, 64)])
def test_visible_pairs_closed_form(S, T, causal, window, prefix):
    q = np.arange(S)[:, None]
    k = np.arange(T)[None, :]
    vis = np.ones((S, T), bool)
    if causal:
        vis = (k <= q) | (k < prefix)
    if window > 0:
        vis = vis & (q - k < window)
    assert costs.visible_pairs(S, T, causal, window, prefix) == vis.sum()


# ------------------------------------------------- wrappers: records, meta

def _kernel_calls(dev, dtype=torch.float32, plain=False):
    """Every wrapper, forward and backward, at small shapes on `dev`; with
    `plain`, the plain versions (the CPU route) on the same inputs."""
    g = torch.Generator().manual_seed(0)

    def t(*shape, dt=dtype):
        x = torch.randn(shape, generator=g).to(dt)
        return x if dev == "cpu" else torch.empty(shape, dtype=dt,
                                                  device=dev)

    B, S, H, dh = 2, 5, 2, 8
    r, k, v, w, dy = (t(B, S, H, dh) for _ in range(5))
    beta = t(B, S, H)
    st, dsf = t(B, H, dh, dh), t(B, H, dh, dh)
    states = t(B, S, H, dh, dh)
    q4, k4, v4, do4 = t(2, 2, 3, 8), t(2, 2, 4, 8), t(2, 2, 4, 8), \
        t(2, 2, 3, 8)
    bias = t(2, 4)
    mask = torch.ones((2, 4), dtype=torch.bool, device=dev)
    fq, fk, fv = t(2, 6, 4, 8), t(2, 6, 2, 8), t(2, 6, 2, 8)
    fo, fdo, lse = t(2, 6, 4, 8), t(2, 6, 4, 8), t(2, 4, 6)
    x, c = t(10, 8), t(3, 8)
    if plain:
        return {
            "wkv": lambda: wkv_reference(r, k, v, w, beta, st),
            "wkv_backward": lambda: wkv_backward_reference(
                r, k, v, w, beta, st, dy, dsf),
            "set_attention": lambda: set_attention_reference(
                q4, k4, v4, bias, mask),
            "set_attention_backward": lambda: (
                set_attention_backward_reference(q4, k4, v4, bias, mask,
                                                 do4)),
            "flash_attention": lambda: attention_reference(
                fq, fk, fv, return_lse=True),
            "flash_attention_backward": lambda: attention_backward_reference(
                fq, fk, fv, fo, fdo, lse, True, 0, 0),
            "kmeans_assign": lambda: kmeans_assign_reference(x, c),
            "kmeans_update": lambda: (lambda s, n, e: (s, n, e[0]))(
                *kmeans_update_reference(x, c, torch.ones((10,)))),
        }
    return {
        "wkv": lambda: wkv(r, k, v, w, beta, st),
        "wkv_backward": lambda: wkv_backward(r, k, v, w, beta, st, states,
                                             dy, dsf),
        "set_attention": lambda: masked_set_attention(q4, k4, v4, bias, mask),
        "set_attention_backward": lambda: set_attention_backward(
            q4, k4, v4, bias, mask, do4),
        "flash_attention": lambda: flash_forward(fq, fk, fv,
                                                 return_lse=True),
        "flash_attention_backward": lambda: flash_attention_backward(
            fq, fk, fv, fo, fdo, lse),
        "kmeans_assign": lambda: kmeans_assign(x, c),
        "kmeans_update": lambda: kmeans_update(x, c),
    }


def _shapes(out):
    out = out if isinstance(out, tuple) else (out,)
    return [None if o is None else (tuple(o.shape), o.dtype) for o in out]


def test_meta_route_only_on_meta_and_shapes_match():
    """On meta tensors each wrapper, forward and backward, returns empty
    outputs of exactly the CPU's shapes and dtypes (wkv's states aside:
    the CPU's plain forward keeps none); a CPU call never takes that route:
    it returns the plain version's values."""
    calls, plain = _kernel_calls("cpu"), _kernel_calls("cpu", plain=True)
    for name, fn in calls.items():
        got, want = fn(), plain[name]()
        got, want = ((o,) if torch.is_tensor(o) else o for o in (got, want))
        got = [o for o in got if o is not None]
        assert len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want)), name
    cpu = {name: _shapes(fn()) for name, fn in calls.items()}
    outs = {name: fn() for name, fn in _kernel_calls("meta").items()}
    assert all(t.device.type == "meta" for out in outs.values()
               for t in (out if isinstance(out, tuple) else (out,))
               if t is not None)
    assert {name: _shapes(out) for name, out in outs.items()} == cpu


def test_each_wrapper_is_one_record_of_its_costs():
    """Under a count each call is one kernel record, the `costs` work of its
    shapes, and none of its ops is counted, on the CPU and on meta alike."""
    for dev in ("cpu", "meta"):
        for name, fn in _kernel_calls(dev).items():
            with StepCount() as count:
                fn()
            assert [r.name for r in count.records] == [name]
            rec = count.records[0]
            assert count.bytes == rec.bytes
            assert count.flops == rec.flops_fp32 + rec.flops_bf16
    with StepCount() as count:
        _kernel_calls("meta")["wkv"]()
        _kernel_calls("meta")["flash_attention"]()
    assert tuple(count.records[0])[2:5] == tuple(costs.wkv(
        2, 5, 2, 8, torch.float32, True, False))
    assert tuple(count.records[1])[2:5] == tuple(costs.flash_attention(
        2, 6, 6, 4, 2, 8, torch.float32, lse=True))


# -------------------------------------------------- whole steps, CPU = meta

def _lm(arch, layers, S, dev, **extra):
    cfg = scaled_down(get_arch(arch), num_layers=layers, d_model=64,
                      vocab_size=300, **extra)
    model = build_model(cfg)
    if dev == "meta":
        with torch.device("meta"):
            params = tfm.LM(cfg)
        tokens = torch.empty((2, S), dtype=torch.int64, device="meta")
    else:
        params = model.init(0, device="cpu")
        tokens = torch.randint(0, 300, (2, S),
                               generator=torch.Generator().manual_seed(1))
    return model, params, {"tokens": tokens}


def _loss_and_grads(model, params, batch, remat="none"):
    loss, _ = model.loss(params, batch, remat=remat)
    return loss, torch.autograd.grad(loss, list(params.parameters()),
                                     allow_unused=True)


def _counted(arch, layers, S, dev, remat="none"):
    model, params, batch = _lm(arch, layers, S, dev)
    with StepCount() as count:
        out = _loss_and_grads(model, params, batch, remat)
    return count, out


def _same_count(a: StepCount, b: StepCount):
    assert a.total.flops == b.total.flops
    assert a.bytes == b.bytes
    assert a.records == b.records


def test_lm_step_counts_the_same_on_cpu_and_meta():
    """A 2-layer narrow LM's loss forward plus backward (two flash calls
    each way): the CPU's count is the meta count, exactly."""
    cpu, _ = _counted("smollm_135m", 2, 16, "cpu")
    meta, _ = _counted("smollm_135m", 2, 16, "meta")
    _same_count(cpu, meta)
    assert [r.name for r in cpu.records] == (
        ["flash_attention"] * 2 + ["flash_attention_backward"] * 2)
    assert cpu.flops_fp32 > 0 and cpu.peak_bytes > 0 and meta.peak_bytes > 0


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_trainer_step_counts_as_its_advance_on_meta(optimizer):
    """The Trainer's own step on the CPU (its metrics read to the host)
    counts exactly as its `advance` on meta tensors, the optimizer's
    update and the copy into the parameters included: a 2-layer narrow
    LM."""
    model, params, batch = _lm("smollm_135m", 2, 16, "cpu")
    _, meta_params, meta_batch = _lm("smollm_135m", 2, 16, "meta")
    cfg = TrainConfig(optimizer=optimizer)

    def loss_fn(p, b):
        return model.loss(p, b)

    cpu = Trainer(loss_fn, params, cfg)
    meta = Trainer(loss_fn, meta_params, cfg)
    with StepCount() as a:
        metrics = cpu.step(batch)
    with StepCount() as b:
        out = meta.advance(meta_batch)
    _same_count(a, b)
    assert set(metrics) == set(out) and np.isfinite(metrics["loss"])
    assert cpu.state.step == meta.state.step == 1


@pytest.mark.parametrize("arch,loop,remat", [
    ("xlstm_1_3b", "slstm_scan", "none"),
    ("jamba_1_5_large_398b", "mamba_scan", "none"),
    ("jamba_1_5_large_398b", "mamba_scan", "full")])
def test_token_loops_probed_on_meta_equal_full_loops(arch, loop, remat):
    """Tiny xlstm- and jamba-shaped stacks at S 16: the meta count, whose
    token loops run at 2, 3 and 4 tokens and are extrapolated, equals the
    CPU's count of the full loops, forward and backward (and the
    recompute under remat "full", the dry-run's policy)."""
    cpu, _ = _counted(arch, 2, 16, "cpu", remat)
    calls = []
    real = counting._Loop.forward

    def spy(self, grad):
        calls.append(self.S)
        return real(self, grad)

    counting._Loop.forward = spy
    try:
        meta, _ = _counted(arch, 2, 16, "meta", remat)
    finally:
        counting._Loop.forward = real
    runs = 1 if remat == "none" else 2       # the recompute runs it again
    assert calls == [16] * runs              # probed, not run
    _same_count(cpu, meta)
    assert [r.name for r in cpu.records if r.kind == "loop"] == [loop] * runs
    assert [r.trips for r in meta.records if r.kind == "loop"] == [16] * runs


def test_mlstm_token_scan_probed_equals_full():
    """The mLSTM token scan (the ragged-S route) through `token_loop`: meta
    probes extrapolated to S 16 against the CPU's full loop, forward and
    backward."""
    def run(dev):
        g = torch.Generator().manual_seed(2)
        shapes = [(2, 16, 2, 8)] * 3 + [(2, 16, 2)] * 2
        xs = [(torch.randn(s, generator=g) if dev == "cpu" else
               torch.empty(s, device="meta")).requires_grad_(True)
              for s in shapes]
        with StepCount() as count:
            h = token_loop("mlstm_scan", ssm._mlstm_scan, xs,
                           seq_args=(0, 1, 2, 3, 4))
            torch.autograd.grad(h, xs, torch.ones_like(h))
        return count

    _same_count(run("cpu"), run("meta"))


@pytest.mark.parametrize("arch", ["smollm_135m", "jamba_1_5_large_398b"])
def test_cpu_outputs_bitwise_under_a_count(arch):
    """A count changes no bit of the CPU's loss or gradients (flash's
    backward recomputed by autograd of the plain version, the loops run in
    full)."""
    model, params, batch = _lm(arch, 2, 16, "cpu")
    ref = _loss_and_grads(model, params, batch)
    with StepCount():
        got = _loss_and_grads(model, params, batch)
    assert torch.equal(ref[0], got[0])
    for a, b in zip(ref[1], got[1]):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("arch,dtype", [("smollm_135m", "float32"),
                                        ("jamba_1_5_large_398b",
                                         "bfloat16")])
def test_cpu_flash_grads_bitwise_plain_autograd(arch, dtype, monkeypatch):
    """On the CPU, flash with a gradient goes through `_FlashAttention`
    (one record a call under a count), its backward autograd of the plain
    version, recomputed, its gradients contiguous: a 2-layer LM's loss
    and every gradient, with RoPE (smollm, fp32) and without (jamba,
    bf16), are bitwise those of autograd straight through
    `attention_reference`."""
    import dataclasses
    from repro_torch.models import attention
    cfg = dataclasses.replace(scaled_down(get_arch(arch), num_layers=2,
                                          d_model=64, vocab_size=300),
                              param_dtype=dtype)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = {"tokens": torch.randint(
        0, 300, (2, 16), generator=torch.Generator().manual_seed(1))}
    got = _loss_and_grads(model, params, batch)
    monkeypatch.setattr(
        attention, "flash_attention",
        lambda q, k, v, causal=True, window=0, prefix_len=0:
        attention_reference(q, k, v, causal=causal, window=window,
                            prefix_len=prefix_len))
    want = _loss_and_grads(model, params, batch)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_inference_mode_counts_as_grad_free_mode():
    """Composite ops reach a mode whole under inference mode: they are
    counted as their parts, so a prefill counts the same either way."""
    model, params, batch = _lm("smollm_135m", 2, 16, "meta")
    counts = []
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx(), StepCount() as count:
            tfm.lm_apply(params, model.cfg, batch["tokens"],
                         return_hidden=True)
        counts.append(count)
    _same_count(*counts)
    assert counts[0].flops > 0


def test_collectives_and_nesting():
    """`add_collective` adds bytes by kind; an inner count takes the ops
    of its block and the outer one counts none of them."""
    x = torch.empty((32, 32), device="meta")
    with StepCount() as outer:
        x @ x
        with StepCount() as inner:
            x @ x
            inner.add_collective("all-reduce", 100.0)
    assert inner.flops == outer.flops == 2 * 32 ** 3
    assert inner.collective_bytes == {"all-reduce": 100.0}
    assert outer.collective_bytes == {}
    assert counting.ACTIVE is None

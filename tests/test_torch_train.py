"""The port's training slice on the CPU, held against the JAX package on
the same numpy inputs: schedule, clipping, AdamW and Adafactor updates,
microbatch accumulation, the checkpoint format (its msgpack codec byte
for byte, atomic writes and pruning, checkpoints crossing both ways),
exact resume, preemption, and `Stage2Engine` losses step for step."""
import dataclasses
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core.pipeline import BBEIndex as JaxBBEIndex  # noqa: E402
from repro.core import signature as jsig  # noqa: E402
from repro.data.trace import Interval as JaxInterval  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.stage2 import Stage2Engine as JaxStage2Engine  # noqa: E402
from repro.train.stage2 import triplet_row_batch as jax_triplet_row_batch  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.core.pipeline import BBEIndex  # noqa: E402
from repro_torch.core.signature import (  # noqa: E402
    SignatureConfig, SignatureModel, stage2_loss, stage2_loss_from_rows,
)
from repro_torch.data.trace import Interval  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import (  # noqa: E402
    Stage2Engine, Trainer, triplet_row_batch,
)

SIG = dict(bbe_dim=16, d_model=16, sig_dim=8, num_heads=2, num_sabs=1,
           max_set=8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol, err_msg=msg)


# ---------------------------------------------------------------------------
# schedule, clipping, optimizers
# ---------------------------------------------------------------------------

def test_train_config_copy_matches_jax():
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JaxTrainConfig())


@pytest.mark.parametrize("base_lr,warmup,total", [(3e-4, 100, 1000),
                                                  (1e-3, 2, 20), (1.0, 0, 1)])
def test_lr_schedule_matches_jax(base_lr, warmup, total):
    for step in range(0, total + 5, max(1, total // 40)):
        got = opt.lr_schedule(step, base_lr=base_lr, warmup_steps=warmup,
                              total_steps=total)
        want = jopt.lr_schedule(jnp.asarray(step), base_lr=base_lr,
                                warmup_steps=warmup, total_steps=total)
        assert got.dtype == torch.float32
        _close(float(got), float(want), atol=0, rtol=1e-6, msg=str(step))


def _named_arrays(rng):
    """Leaves of every kind the optimizers branch on: a factored matrix,
    a stacked (3-d) one, a bias, and shapes that are not factored."""
    shapes = {"w": (6, 5), "stack": (3, 4, 7), "b": (5,), "row": (1, 9),
              "col": (8, 1)}
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_global_norm_clip_matches_jax(max_norm):
    g = _named_arrays(np.random.RandomState(0))
    got, norm = opt.global_norm_clip({k: torch.from_numpy(v)
                                      for k, v in g.items()}, max_norm)
    want, jnorm = jopt.global_norm_clip(g, max_norm)
    _close(float(norm), float(jnorm), atol=0, rtol=1e-6)
    for k in g:
        _close(got[k].numpy(), want[k], atol=1e-7, rtol=1e-6, msg=k)


def _state_leaves(state):
    """{key path: numpy} of an optimizer state (JAX or port)."""
    flat = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}/")
        else:
            flat[prefix[:-1]] = np.asarray(
                t.float() if isinstance(t, torch.Tensor) else
                jnp.asarray(t, jnp.float32) if t.dtype == jnp.bfloat16 else t)
    walk(state, "")
    return flat


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_jax(name):
    """Three updates on the same grads: params and every state leaf
    within 1e-6 of `repro.train.optimizer`."""
    rng = np.random.RandomState(1)
    params = _named_arrays(rng)
    init, update, _ = opt.make_optimizer(name)
    jinit, jupdate, _ = jopt.make_optimizer(name)
    p_t = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    s_t, s_j = init(p_t), jinit(p_j)
    for step in range(3):
        grads = {k: (rng.randn(*v.shape) * 10 ** (step - 1)).astype(
            np.float32) for k, v in params.items()}
        lr = 1e-2 / (step + 1)
        kw = dict(weight_decay=0.01) if name == "adamw" else \
            dict(weight_decay=0.02)
        p_t, s_t = update({k: torch.from_numpy(g) for k, g in grads.items()},
                          s_t, p_t, lr=lr, **kw)
        p_j, s_j = jupdate(grads, s_j, p_j, lr=lr, **kw)
        for k in params:
            _close(p_t[k].numpy(), p_j[k], atol=1e-6, msg=f"{step} {k}")
        got, want = _state_leaves(s_t), _state_leaves(s_j)
        assert sorted(got) == sorted(want)
        for k in want:
            # bf16 first moments: the same fp32 value rounds to the same
            # bf16, unless it lies on a rounding boundary (one bf16 ulp)
            bf16 = name == "adafactor" and k.endswith("/m")
            _close(got[k], want[k], atol=1e-6, rtol=2 ** -7 if bf16 else 0.0,
                   msg=f"{step} {k}")
    assert int(s_t["count"]) == 3 and s_t["count"].dtype == torch.int32


def test_make_optimizer_rejects_unknown():
    with pytest.raises(ValueError):
        opt.make_optimizer("sgd")


def _linear_loss(model, batch):
    err = batch["x"] @ model.w - batch["y"]
    loss = torch.mean(torch.square(err))
    return loss, {"mse": loss, "bias": torch.mean(err)}


class _Linear(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))


def test_microbatched_grads_match_full_batch_and_jax(tmp_path):
    """Summed microbatch grads scaled by 1/mb equal the full batch's for a
    per-example mean loss; one Trainer step with microbatch=2 matches the
    JAX Trainer's (same init, same batch)."""
    rng = np.random.RandomState(2)
    w = rng.randn(6, 3).astype(np.float32)
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randn(8, 3).astype(np.float32)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    runs = {}
    for mb in (0, 2, 4):
        tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=4,
                         microbatch=mb, checkpoint_every=0,
                         checkpoint_dir=str(tmp_path))
        tr = Trainer(_linear_loss, _Linear(w), tc)
        runs[mb] = tr._grads(batch), tr
    (l0, m0, g0), _ = runs[0]
    for mb in (2, 4):
        (l1, m1, g1), _ = runs[mb]
        _close(float(l1), float(l0), atol=1e-6)
        _close(float(m1["bias"]), float(m0["bias"]), atol=1e-6)
        _close(g1["w"].numpy(), g0["w"].numpy(), atol=1e-6)
    metrics = runs[2][1].step(batch)

    def jloss(p, b):
        err = b["x"] @ p["w"] - b["y"]
        loss = jnp.mean(jnp.square(err))
        return loss, {"mse": loss, "bias": jnp.mean(err)}

    tc = JaxTrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=4,
                        microbatch=2, checkpoint_every=0,
                        checkpoint_dir=str(tmp_path))
    jtr = JaxTrainer(jloss, {"w": jnp.asarray(w)}, {"w": (None, None)}, tc,
                     donate=False)
    jmetrics = jtr.step({"x": jnp.asarray(x), "y": jnp.asarray(y)})
    _close(runs[2][1].state.params["w"].detach().numpy(),
           jtr.state.params["w"], atol=1e-6)
    for k in ("loss", "grad_norm", "lr", "bias"):
        _close(metrics[k], jmetrics[k], atol=1e-6, rtol=1e-6, msg=k)


# ---------------------------------------------------------------------------
# checkpoint format
# ---------------------------------------------------------------------------

MSGPACK_VALUES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.0, -1.5, 3.141592653589793, 1e300,
    "", "a" * 31, "a" * 32, "é" * 200, "b" * 256, "c" * 65536,
    [], list(range(15)), list(range(16)), list(range(70000)),
    {f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
    {f"k{i}": [i] for i in range(70000)},
    {"step": 10, "keys": ["params/set_transformer/sabs/0/mha/wq",
                          "opt/count"],
     "shapes": {"opt/count": [], "params/w": [257, 256]},
     "dtypes": {"opt/count": "int32", "params/w": "float32"},
     "meta": {"step": 10, "lr": 1e-3, "tag": None, "ok": True}},
]


@pytest.mark.parametrize("value", MSGPACK_VALUES,
                         ids=[str(i) for i in range(len(MSGPACK_VALUES))])
def test_msgpack_codec_matches_msgpack(value):
    data = ckpt.packb(value)
    assert data == msgpack.packb(value)
    assert ckpt.unpackb(data) == msgpack.unpackb(data) == value
    # and reads what msgpack writes in its other forms (float32)
    single = msgpack.packb(value, use_single_float=True)
    assert ckpt.unpackb(single) == msgpack.unpackb(single)


def test_msgpack_codec_rejects_what_it_does_not_know():
    with pytest.raises(TypeError):
        ckpt.packb(b"bytes")
    with pytest.raises(ValueError):
        ckpt.unpackb(msgpack.packb(b"bytes"))
    with pytest.raises(ValueError):
        ckpt.unpackb(msgpack.packb(1) + b"\x00")


def test_checkpoint_atomic_and_pruning(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.tensor([[1.5, -2.0, 3.25]] * 3,
                                    dtype=torch.bfloat16)},
            "n": torch.tensor(7, dtype=torch.int32)}
    # a stale half-written directory from a crash is ignored and replaced
    os.makedirs(tmp_path / "tmp.4")
    (tmp_path / "tmp.4" / "arrays.npz").write_bytes(b"junk")
    for step in (1, 2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), step, tree, keep=2)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_0000000003", "step_0000000004"]
    assert not any(d.startswith("tmp.") for d in os.listdir(tmp_path))
    path = ckpt.latest_checkpoint(str(tmp_path))
    # a step directory without its manifest (never published) is skipped
    os.makedirs(tmp_path / "step_0000000009")
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    restored, step, meta = ckpt.restore_checkpoint(path, tree)
    assert step == 4 and meta == {}
    for (k, want), got in zip(ckpt._flatten(tree).items(),
                              ckpt._flatten(restored).values()):
        assert got.dtype == want.dtype and torch.equal(got, want), k
    manifest = ckpt.read_manifest(path)
    assert manifest["dtypes"] == {"a": "float32", "b/c": "bfloat16",
                                  "n": "int32"}
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    with pytest.raises(KeyError):
        ckpt.restore_checkpoint(path, {"missing": torch.zeros(1)})


def test_bf16_leaves_cross_both_ways(tmp_path):
    """bf16 bits written by either package restore to the same values in
    the port; the port's bf16 leaves restore in the JAX reader."""
    vals = np.array([1.5, -2.0, 3.25, 1e-3], np.float32)
    jax_tree = {"m": jnp.asarray(vals, jnp.bfloat16)}
    port_tree = {"m": torch.from_numpy(vals).to(torch.bfloat16)}
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, jax_tree)
    ckpt.save_checkpoint(str(tmp_path / "p"), 1, port_tree)
    got, _, _ = ckpt.restore_checkpoint(
        ckpt.latest_checkpoint(str(tmp_path / "j")), port_tree)
    assert torch.equal(got["m"], port_tree["m"])
    jgot, _, _ = jckpt.restore_checkpoint(
        jckpt.latest_checkpoint(str(tmp_path / "p")), jax_tree)
    assert jgot["m"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jgot["m"], np.float32),
                                  np.asarray(jax_tree["m"], np.float32))


# ---------------------------------------------------------------------------
# Stage-2 engine
# ---------------------------------------------------------------------------

def _world(n_blocks=64, n_intervals=24, seed=0, bbe_dim=SIG["bbe_dim"]):
    """A BBE table and intervals, as tests/test_stage2_engine.py makes
    them; the intervals in both packages' types."""
    rng = np.random.RandomState(seed)
    table = {bid: rng.randn(bbe_dim).astype(np.float32)
             for bid in range(n_blocks)}
    ivs, jivs = [], []
    for i in range(n_intervals):
        sel = rng.choice(n_blocks, size=rng.randint(3, 14), replace=False)
        counts = {int(b): int(c) for b, c in
                  zip(sel, rng.randint(1, 1000, sel.size))}
        kw = dict(program="t", index=i, counts=counts, phase_id=i % 3,
                  working_scale=1.0, num_instrs=10_000)
        ivs.append(Interval(**kw))
        jivs.append(JaxInterval(**kw))
    return table, ivs, jivs


def _picks(step, n, batch):
    rng = np.random.RandomState(1000 + step)
    idx = {k: rng.randint(n, size=batch)
           for k in ("anchor", "positive", "negative")}
    return idx, rng.uniform(0.5, 4.0, batch)


def _batch_fns(table, ivs, jivs, batch=4, max_set=SIG["max_set"]):
    """Deterministic-in-step row-id triplet batches for both engines."""
    index, jindex = BBEIndex(table), JaxBBEIndex(table)

    def port(step):
        idx, cpis = _picks(step, len(ivs), batch)
        return triplet_row_batch({k: [ivs[i] for i in v]
                                  for k, v in idx.items()}, cpis, index,
                                 max_set, device="cpu")

    def jax_fn(step):
        idx, cpis = _picks(step, len(jivs), batch)
        return jax_triplet_row_batch({k: [jivs[i] for i in v]
                                      for k, v in idx.items()}, cpis, jindex,
                                     max_set)
    return index, port, jax_fn


def _jax_model(seed, sig=SIG):
    jcfg = jsig.SignatureConfig(**sig)
    params, specs = jsig.signature_init(jax.random.PRNGKey(seed), jcfg)
    model = bridge.signature_params_from_jax(_np(params),
                                             SignatureConfig(**sig))
    return jcfg, params, specs, model


def _tc(tmp, **kw):
    base = dict(learning_rate=1e-3, total_steps=8, warmup_steps=2,
                checkpoint_every=0, checkpoint_dir=str(tmp))
    base.update(kw)
    return base


def test_triplet_row_batch_matches_jax():
    table, ivs, jivs = _world(seed=5)
    _, port, jax_fn = _batch_fns(table, ivs, jivs, batch=6)
    got, want = port(3), jax_fn(3)
    for key in ("anchor", "positive", "negative"):
        assert got[key]["rows"].dtype == torch.long
        for f in ("rows", "freqs", "mask"):
            np.testing.assert_array_equal(got[key][f].numpy(),
                                          np.asarray(want[key][f]))
    np.testing.assert_array_equal(got["cpi"].numpy(), np.asarray(want["cpi"]))


def test_stage2_loss_from_rows_matches_dense_loss():
    table, ivs, jivs = _world(seed=3)
    index, port, _ = _batch_fns(table, ivs, jivs)
    cfg = SignatureConfig(**SIG)
    model = SignatureModel(cfg, seed=0)
    rows_batch = port(0)
    ext = torch.from_numpy(index.ext)
    dense = {"cpi": rows_batch["cpi"]}
    for key in ("anchor", "positive", "negative"):
        dense[key] = {"bbes": ext[rows_batch[key]["rows"]],
                      "freqs": rows_batch[key]["freqs"],
                      "mask": rows_batch[key]["mask"]}
    l_rows, parts = stage2_loss_from_rows(model, cfg, ext, rows_batch)
    l_dense, _ = stage2_loss(model, cfg, dense)
    assert float(l_rows.detach()) == float(l_dense.detach())
    assert sorted(parts) == ["consistency", "cpi_reg", "triplet"]


def test_engine_losses_match_jax_over_five_steps(tmp_path):
    """From bridged weights on the same row batches, the port engine's
    losses follow JAX's `Stage2Engine` (impl="xla") step for step."""
    table, ivs, jivs = _world(seed=1)
    index, port, jax_fn = _batch_fns(table, ivs, jivs)
    jcfg, params, specs, model = _jax_model(1)
    eng = Stage2Engine(SignatureConfig(**SIG), model, index.ext,
                       TrainConfig(**_tc(tmp_path / "p", total_steps=5)))
    jeng = JaxStage2Engine(jcfg, params, specs, JaxBBEIndex(table).ext,
                           JaxTrainConfig(**_tc(tmp_path / "j",
                                                total_steps=5)))
    for s in range(5):
        m, jm = eng.step(port(s)), jeng.step(jax_fn(s))
        for k in ("loss", "triplet", "cpi_reg", "consistency", "grad_norm",
                  "lr"):
            _close(m[k], jm[k], atol=1e-7, rtol=1e-3, msg=f"step {s} {k}")
    assert eng.step_count == jeng.step_count == 5


def test_engine_training_reduces_loss(tmp_path):
    table, ivs, jivs = _world(seed=1)
    index, port, _ = _batch_fns(table, ivs, jivs)
    eng = Stage2Engine(SignatureConfig(**SIG),
                       SignatureModel(SignatureConfig(**SIG), seed=1),
                       index.ext, TrainConfig(**_tc(
                           tmp_path, learning_rate=3e-3, total_steps=25)))
    first = eng.step(port(0))["loss"]
    for s in range(1, 25):
        last = eng.step(port(s))["loss"]
    assert last < first, f"no learning: {first} -> {last}"


def test_engine_leaves_the_callers_model_untouched(tmp_path):
    table, ivs, jivs = _world(seed=4)
    index, port, _ = _batch_fns(table, ivs, jivs)
    model = SignatureModel(SignatureConfig(**SIG), seed=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    eng = Stage2Engine(SignatureConfig(**SIG), model, index.ext,
                       TrainConfig(**_tc(tmp_path)))
    eng.step(port(0))
    eng.step(port(1))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    trained = eng.model.state_dict()
    assert any(not torch.equal(trained[k], before[k]) for k in before)
    assert eng.params["cpi_head/w1"] is eng.model.cpi_head.w1


def test_engine_checkpoint_exact_resume(tmp_path):
    """Branch A: 8 steps straight. Branch B: 4 steps, checkpoint, restore
    into a FRESH engine, 4 more. Params equal bitwise."""
    table, ivs, jivs = _world(seed=2)
    index, port, _ = _batch_fns(table, ivs, jivs)

    def mk(ckdir, every):
        return Stage2Engine(SignatureConfig(**SIG),
                            SignatureModel(SignatureConfig(**SIG), seed=1),
                            index.ext, TrainConfig(**_tc(
                                ckdir, checkpoint_every=every)))

    ea = mk(tmp_path / "a", 0)
    for s in range(8):
        ea.step(port(s))
    eb1 = mk(tmp_path / "b", 4)
    eb1.fit(port, 4, log_every=1000)
    eb1.maybe_checkpoint(force=True)
    eb2 = mk(tmp_path / "b", 4)
    assert eb2.restore() and eb2.step_count == 4
    eb2.fit(port, 8, log_every=1000)
    for k, v in ea.params.items():
        assert torch.equal(v, eb2.params[k]), k
    for part in ("m", "v"):
        for k, v in ea.trainer.state.opt_state[part].items():
            assert torch.equal(v, eb2.trainer.state.opt_state[part][k]), k


def test_preemption_handler_checkpoints_and_exits_42(tmp_path):
    table, ivs, jivs = _world(seed=6)
    index, port, _ = _batch_fns(table, ivs, jivs)
    eng = Stage2Engine(SignatureConfig(**SIG),
                       SignatureModel(SignatureConfig(**SIG), seed=3),
                       index.ext, TrainConfig(**_tc(tmp_path,
                                                    checkpoint_every=100)))
    old = signal.getsignal(signal.SIGTERM)
    try:
        eng.install_preemption_handler()
        eng.step(port(0))
        assert eng.maybe_checkpoint() is None        # not due yet
        os.kill(os.getpid(), signal.SIGTERM)
        eng.step(port(1))
        with pytest.raises(SystemExit) as exit_info:
            eng.maybe_checkpoint()
        assert exit_info.value.code == 42
    finally:
        signal.signal(signal.SIGTERM, old)
    path = ckpt.latest_checkpoint(str(tmp_path))
    assert path.endswith("step_0000000002")
    again = Stage2Engine(SignatureConfig(**SIG),
                         SignatureModel(SignatureConfig(**SIG), seed=9),
                         index.ext, TrainConfig(**_tc(tmp_path)))
    assert again.restore() and again.step_count == 2
    for k, v in eng.params.items():
        assert torch.equal(v, again.params[k]), k


def _jax_engine_state(jeng):
    params = jax.tree_util.tree_leaves_with_path(jeng.params)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(v) for path, v in params}


def test_jax_engine_checkpoint_restores_in_port(tmp_path):
    """A directory written by the JAX `Stage2Engine` (params + AdamW state
    + step) restores into a port engine with equal values and step; its
    weights alone load through the bridge."""
    table, ivs, jivs = _world(seed=7)
    index, port, jax_fn = _batch_fns(table, ivs, jivs)
    jcfg, params, specs, _ = _jax_model(4)
    tc = _tc(tmp_path / "j", checkpoint_every=3)
    jeng = JaxStage2Engine(jcfg, params, specs, JaxBBEIndex(table).ext,
                           JaxTrainConfig(**tc))
    jeng.fit(jax_fn, 3, log_every=1000)
    path = jckpt.latest_checkpoint(tc["checkpoint_dir"])
    assert path.endswith("step_0000000003")
    eng = bridge.stage2_engine_from_checkpoint(
        path, SignatureConfig(**SIG), index.ext, TrainConfig(**tc),
        device="cpu")
    assert eng.step_count == 3
    want = _jax_engine_state(jeng)
    assert sorted(want) == sorted(eng.params)
    for k, v in want.items():
        np.testing.assert_array_equal(eng.params[k].detach().numpy(), v,
                                      err_msg=k)
    jopt_state = jeng.trainer.state.opt_state
    assert int(eng.trainer.state.opt_state["count"]) == \
        int(jopt_state["count"]) == 3
    for part in ("m", "v"):
        leaves = _jax_engine_state(type("E", (), {"params": jopt_state[part]}))
        for k, v in leaves.items():
            np.testing.assert_array_equal(
                eng.trainer.state.opt_state[part][k].numpy(), v, err_msg=k)
    model = bridge.signature_params_from_checkpoint(path,
                                                    SignatureConfig(**SIG))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k.replace(".", "/")])
    # the restored engine trains on as the JAX one does
    m, jm = eng.step(port(3)), jeng.step(jax_fn(3))
    _close(m["loss"], jm["loss"], atol=1e-7, rtol=1e-3)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port engine's checkpoint restores in
    `repro.train.checkpoint.restore_checkpoint` with a JAX template, with
    equal values; so does a bare model written through the bridge."""
    table, ivs, jivs = _world(seed=8)
    index, port, _ = _batch_fns(table, ivs, jivs)
    jcfg, params, specs, model = _jax_model(5)
    eng = Stage2Engine(SignatureConfig(**SIG), model, index.ext,
                       TrainConfig(**_tc(tmp_path / "p")))
    eng.step(port(0))
    eng.step(port(1))
    path = eng.maybe_checkpoint(force=True)
    template = {"params": params, "opt": jopt.adamw_init(params)}
    tree, step, meta = jckpt.restore_checkpoint(path, template)
    assert step == 2 and meta == {"step": 2}
    flat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path_): np.asarray(v)
            for path_, v in jax.tree_util.tree_leaves_with_path(tree)}
    port_flat = ckpt._flatten(eng.trainer.checkpoint_tree())
    assert sorted(flat) == sorted(port_flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(
            v, port_flat[k].detach().cpu().numpy(), err_msg=k)
    bare = bridge.save_signature_checkpoint(eng.model, str(tmp_path / "b"),
                                            step=7)
    tree, step, _ = jckpt.restore_checkpoint(bare, {"params": params})
    assert step == 7
    sig, _ = jsig.signature_apply(tree["params"], jcfg,
                                  jnp.ones((1, 3, SIG["bbe_dim"])),
                                  jnp.ones((1, 3)), jnp.ones((1, 3), bool))
    with torch.no_grad():
        sig_t, _ = eng.model(torch.ones((1, 3, SIG["bbe_dim"])),
                             torch.ones((1, 3)),
                             torch.ones((1, 3), dtype=torch.bool))
    _close(sig_t.numpy(), sig, atol=1e-5)

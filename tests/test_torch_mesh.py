"""The port's data-parallel training and sharded k-means on the CPU, in
gloo process groups of 2 and 4 spawned ranks (two spawns, each within
SPAWN_TIMEOUT_S), held against the unsharded port and JAX:

  * world 2, mesh (2, 1): Stage-1 pre-training on shards with different
    valid-token counts, with and without microbatches; a scaled-down
    smollm and qwen3-moe through `Model.loss` with AdamW and Adafactor
    (Adafactor's means over the FSDP-sharded dims); MoE groups that would
    span ranks raise; a checkpoint written mid-run;
  * world 4: Stage 2 on a (2, 2) mesh against the unsharded port and JAX's
    Trainer on the same weights; `kmeans_device(mesh=)` over a (4, 1) mesh
    (labels, seeds, dead rows, rows that do not divide); the world-2
    checkpoint restored on a (2, 2) mesh and continued; the mesh helpers.

The ranks import the port only (this module imports JAX inside the
tests); rank 0 writes what the tests compare into the spawn's directory.
"""
import datetime
import os
import sys
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import config as tconfig  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.core.bbe import BBEConfig, BBEEncoder, pretrain_loss  # noqa: E402
from repro_torch.core.clustering import kmeans_device  # noqa: E402
from repro_torch.core.pipeline import BBEIndex  # noqa: E402
from repro_torch.core.signature import SignatureConfig, SignatureModel  # noqa: E402
from repro_torch.data.trace import Interval  # noqa: E402
from repro_torch.distributed.sharding import arch_rules  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.train import Stage2Engine, Trainer, triplet_row_batch  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

SPAWN_TIMEOUT_S = 110
TINY = dict(dim_embeds=(48, 8, 8, 8, 8, 8), num_layers=2, num_heads=2,
            bbe_dim=32, max_len=64)
SIG = dict(bbe_dim=16, d_model=16, sig_dim=8, num_heads=2, num_sabs=1,
           max_set=8)
LM_CASES = [("smollm_135m", "adamw"), ("smollm_135m", "adafactor"),
            ("qwen3_moe_235b_a22b", "adamw"),
            ("qwen3_moe_235b_a22b", "adafactor")]
LM_BATCH = {"smollm_135m": (4, 16), "qwen3_moe_235b_a22b": (4, 128)}


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------

def _rank_main(rank, fn, world, init_file, out):
    assert "jax" not in sys.modules, "a rank imported JAX"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    try:
        fn(rank, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, out):
    """fn(rank, out) in `world` ranks of a gloo group (init by file, never
    a TCP port); a rank that fails fails the spawn, and so does one that
    outlives SPAWN_TIMEOUT_S."""
    init_file = os.path.join(out, f"pg_{fn.__name__}")   # a fresh store
    ctx = mp.start_processes(_rank_main, args=(fn, world, init_file, out),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            pytest.fail(f"{world} spawned ranks outlived {SPAWN_TIMEOUT_S} s")


@pytest.fixture(autouse=True)
def _one_thread():
    """The unsharded runs at one thread, as the ranks run: the CPU is
    shared with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _save(out, name, obj):
    if dist.get_rank() == 0:
        torch.save(obj, os.path.join(out, name + ".pt"))


def _load(out, name):
    return torch.load(os.path.join(out, name + ".pt"), weights_only=False)


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.state.params.items()}


def _tc(**kw):
    # lr 1e-4: AdamW's step is lr g / (|g| + 1e-8), so an element whose
    # gradient is near 1e-8 turns fp32 summation-order differences
    # (sharded sums) into differences up to about lr / 100; the
    # gradients themselves are held through the loss and grad_norm
    base = dict(learning_rate=1e-4, total_steps=8, warmup_steps=2,
                checkpoint_every=0, checkpoint_dir="/nonexistent")
    base.update(kw)
    return TrainConfig(**base)


# ---------------------------------------------------------------------------
# the runs, sharded (in the ranks) and unsharded (in the tests)
# ---------------------------------------------------------------------------

def _stage1_tokens(step):
    """(4, 64, 6) corpus tokens whose two 2-row shards hold different
    numbers of valid tokens."""
    from repro_torch.data import SyntheticBinaryCorp
    corp = SyntheticBinaryCorp(n_functions=40, max_len=TINY["max_len"])
    toks = corp.pretrain_batch(step, 4)["tokens"].copy()
    toks[:2, 20:] = 0                       # pad most of the first shard
    return {"tokens": torch.from_numpy(toks)}


def _stage1_run(mesh, microbatch):
    tr = Trainer(pretrain_loss, BBEEncoder(BBEConfig(**TINY), seed=3),
                 _tc(microbatch=microbatch), mesh=mesh)
    metrics = [tr.step(_stage1_tokens(s)) for s in range(2)]
    return _params(tr), metrics


def _lm(arch, opt_name, mesh, ckpt_dir=None):
    cfg = tconfig.scaled_down(tconfig.get_arch(arch))
    model = build_model(cfg)
    B, S = LM_BATCH[arch]
    batches = launch_train.lm_batch_fn(cfg.vocab_size, B, S, cfg, "cpu")
    tc = _tc(optimizer=opt_name, checkpoint_dir=ckpt_dir or "/nonexistent")
    tr = Trainer(lambda p, b: model.loss(p, b), model.init(1, "cpu"), tc,
                 mesh=mesh, rules=arch_rules(cfg))
    return tr, batches


def _lm_run(arch, opt_name, mesh):
    tr, batches = _lm(arch, opt_name, mesh)
    metrics = [tr.step(batches(s)) for s in range(2)]
    return _params(tr), metrics


def _full_state(tr):
    """Params and the optimizer state, gathered whole, by flat name."""
    return {k: v.detach().clone() for k, v in ckpt._flatten(
        {"params": tr.state.params, "opt": tr._full_opt_state()}).items()}


def _sig_world():
    rng = np.random.RandomState(4)
    table = {bid: rng.randn(SIG["bbe_dim"]).astype(np.float32)
             for bid in range(64)}
    ivs = []
    for i in range(24):
        sel = rng.choice(64, size=rng.randint(3, 14), replace=False)
        ivs.append(dict(program="t", index=i, phase_id=i % 3,
                        working_scale=1.0, num_instrs=10_000,
                        counts={int(b): int(c) for b, c in
                                zip(sel, rng.randint(1, 1000, sel.size))}))
    return table, ivs


def _picks(step, n, batch=8):
    rng = np.random.RandomState(1000 + step)
    idx = {k: rng.randint(n, size=batch)
           for k in ("anchor", "positive", "negative")}
    return idx, rng.uniform(0.5, 4.0, batch)


def _stage2_run(mesh, state):
    table, ivs = _sig_world()
    index = BBEIndex(table)
    ivs = [Interval(**kw) for kw in ivs]
    model = SignatureModel(SignatureConfig(**SIG))
    model.load_state_dict(state)
    eng = Stage2Engine(SignatureConfig(**SIG), model, index.ext,
                       _tc(total_steps=5), mesh=mesh)
    metrics = []
    for s in range(3):
        idx, cpis = _picks(s, len(ivs))
        metrics.append(eng.step(triplet_row_batch(
            {k: [ivs[i] for i in v] for k, v in idx.items()}, cpis, index,
            SIG["max_set"], device="cpu")))
    return _params(eng.trainer), metrics


def _kmeans_data():
    """tests/test_core.py's sharded build data: 4 tight clusters of 50 rows
    in 8 dims, padded with 56 zero rows to 256."""
    rng = np.random.RandomState(0)
    centers = rng.randn(4, 8) * 6
    x = np.concatenate([c + rng.randn(50, 8) * 0.05 for c in centers]
                       ).astype(np.float32)
    return x, np.concatenate([x, np.zeros((56, 8), np.float32)])


def _kmeans_runs(mesh):
    x, xp = _kmeans_data()
    mask = np.zeros(len(xp), np.float32)
    mask[:len(x)] = 1.0
    mask[5:60:3] = 0.0                       # dead rows among the live
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        odd = kmeans_device(xp[:254], 4, seed=1, n_valid=len(x), mesh=mesh)
    return {"prefix": kmeans_device(xp, 4, seed=1, n_valid=len(x),
                                    mesh=mesh),
            "mask": kmeans_device(xp, 4, seed=2, valid_mask=mask, mesh=mesh),
            "odd": odd, "warned": [str(w.message) for w in caught],
            "mask_rows": mask}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _world2(rank, out):
    mesh = launch_mesh.make_mesh((2, 1), ("data", "model"))
    for mb in (0, 2):
        _save(out, f"stage1_mb{mb}", _stage1_run(mesh, mb))
    for arch, opt_name in LM_CASES:
        _save(out, f"lm_{arch}_{opt_name}", _lm_run(arch, opt_name, mesh))
    # MoE groups of the global batch that would span two ranks
    cfg = tconfig.scaled_down(tconfig.get_arch("qwen3_moe_235b_a22b"))
    model = build_model(cfg)
    tr = Trainer(lambda p, b: model.loss(p, b), model.init(1, "cpu"), _tc(),
                 mesh=mesh)
    try:
        tr.step({"tokens": torch.zeros((2, 16), dtype=torch.int64)})
        raised = ""
    except ValueError as e:
        raised = str(e)
    _save(out, "moe_raised", raised)
    # a mesh on another device type than the tensors
    raised = []
    for fn in (lambda: Trainer(pretrain_loss, BBEEncoder(BBEConfig(**TINY))
                               .to("meta"), _tc(), mesh=mesh),
               lambda: kmeans_device(torch.zeros((8, 4), device="meta"), 2,
                                     mesh=mesh)):
        try:
            fn()
            raised.append("")
        except ValueError as e:
            raised.append(str(e))
    _save(out, "device_raised", raised)
    # a checkpoint at step 1 of an Adafactor run, then one more step
    tr, batches = _lm("smollm_135m", "adafactor", mesh,
                      os.path.join(out, "ckpt"))
    tr.step(batches(0))
    tr.maybe_checkpoint(force=True)
    _save(out, "ckpt_state", _full_state(tr))
    tr.step(batches(1))
    _save(out, "ckpt_continued", _params(tr))


def _world4(rank, out):
    mesh = launch_mesh.make_mesh((2, 2), ("data", "model"))
    _save(out, "stage2", _stage2_run(mesh, _load(out, "stage2_weights")))
    _save(out, "kmeans", _kmeans_runs(
        launch_mesh.make_mesh((4, 1), ("data", "model"))))
    tr, batches = _lm("smollm_135m", "adafactor", mesh,
                      os.path.join(out, "ckpt"))
    tr.restore()
    restored = _full_state(tr)
    tr.step(batches(1))
    _save(out, "ckpt_world4", (restored, _params(tr), tr.state.step))
    try:
        launch_mesh.make_production_mesh()
        raised = ""
    except ValueError as e:
        raised = str(e)
    host = launch_mesh.make_host_mesh()
    _save(out, "meshes", (raised, tuple(host.mesh.shape),
                          host.mesh_dim_names, host.device_type))


# ---------------------------------------------------------------------------
# the spawns (one each) and their checks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("world2"))
    _spawn(_world2, 2, out)
    return out


def _nested(flat, leaf=lambda v: v):
    """{"/"-joined name: value} -> the nested tree JAX's modules take
    (a dict whose keys are 0..n-1 becomes a list)."""
    tree = {}
    for name, v in flat.items():
        *path, key = name.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[key] = leaf(v)

    def lists(t):
        if not isinstance(t, dict):
            return t
        t = {k: lists(v) for k, v in t.items()}
        return ([t[str(i)] for i in range(len(t))]
                if all(k.isdigit() for k in t) else t)
    return lists(tree)


@pytest.fixture(scope="module")
def stage2_jax(tmp_path_factory):
    """The port's seeded Stage-2 weights, and JAX's Trainer's params and
    metrics over the 3 steps the ranks take, from the same weights."""
    import jax
    import jax.numpy as jnp

    from repro.config import TrainConfig as JaxTrainConfig
    from repro.core import signature as jsig
    from repro.core.pipeline import BBEIndex as JaxBBEIndex
    from repro.data.trace import Interval as JaxInterval
    from repro.train.stage2 import Stage2Engine as JaxStage2Engine
    from repro.train.stage2 import triplet_row_batch as jax_row_batch
    from repro_torch.core.signature import signature_specs
    cfg = SignatureConfig(**SIG)
    state = SignatureModel(cfg, seed=7).state_dict()
    params = _nested({k.replace(".", "/"): v.numpy()
                      for k, v in state.items()}, jnp.asarray)
    table, ivs = _sig_world()
    jivs = [JaxInterval(**kw) for kw in ivs]
    jindex = JaxBBEIndex(table)
    tc = _tc(total_steps=5, checkpoint_dir=str(
        tmp_path_factory.mktemp("jax_stage2")))
    jeng = JaxStage2Engine(
        jsig.SignatureConfig(**SIG), params, _nested(signature_specs(cfg)),
        jindex.ext, JaxTrainConfig(**{f: getattr(tc, f)
                                      for f in tc.__dataclass_fields__}))
    metrics = []
    for s in range(3):
        idx, cpis = _picks(s, len(jivs))
        metrics.append(jeng.step(jax_row_batch(
            {k: [jivs[i] for i in v] for k, v in idx.items()}, cpis, jindex,
            SIG["max_set"])))
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jeng.params)}
    return state, flat, metrics


@pytest.fixture(scope="module")
def world4(world2, stage2_jax):
    torch.save(stage2_jax[0], os.path.join(world2, "stage2_weights.pt"))
    _spawn(_world4, 4, world2)
    return world2


def _assert_close(got, want, atol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64), rtol=0,
                                   atol=atol, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("microbatch", [0, 2])
def test_stage1_sharded_matches_unsharded(world2, microbatch):
    """2 pre-training steps on shards with 2x different valid-token counts
    (global NTP/NIP counts), with and without microbatch=2 (rank r's
    microbatch i is the r-th share of global microbatch i)."""
    toks = _stage1_tokens(0)["tokens"]
    valid = (toks[..., 0] != 0).sum(-1)
    assert int(valid[:2].sum()) * 2 <= int(valid[2:].sum())
    params, metrics = _load(world2, f"stage1_mb{microbatch}")
    want, want_m = _stage1_run(None, microbatch)
    _assert_close(params, want, 1e-5, f"stage1 mb{microbatch}")
    for m, w in zip(metrics, want_m):
        for k in ("loss", "ntp", "nip", "grad_norm"):
            np.testing.assert_allclose(m[k], w[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch,opt_name", LM_CASES)
def test_lm_steps_match_unsharded(world2, arch, opt_name):
    """2 steps of `Model.loss` under a (2, 1) mesh: FSDP shards of every
    "embed" dim; AdamW on shards, Adafactor with its means summed over
    the sharded dims; the MoE aux over the global groups."""
    params, metrics = _load(world2, f"lm_{arch}_{opt_name}")
    want, want_m = _lm_run(arch, opt_name, None)
    _assert_close(params, want, 1e-5, f"{arch} {opt_name}")
    for m, w in zip(metrics, want_m):
        for k in ("loss", "nll", "aux", "grad_norm"):
            np.testing.assert_allclose(m[k], w[k], rtol=1e-5, atol=1e-7)


def test_moe_groups_that_span_ranks_raise(world2):
    msg = _load(world2, "moe_raised")
    assert "MoE routing groups of 32 tokens" in msg and "16" in msg


def test_a_mesh_on_another_device_type_raises(world2):
    """A CPU mesh with meta-device parameters or rows: the Trainer and
    k-means raise, never fall back."""
    for msg in _load(world2, "device_raised"):
        assert "the mesh is on 'cpu'" in msg and "meta" in msg


def test_checkpoint_restores_across_worlds(world4):
    """The world-2 checkpoint restores bitwise at world 1 (no mesh) and at
    world 4 (a (2, 2) mesh, other shards) and both continue as world 2
    did."""
    saved = _load(world4, "ckpt_state")
    tr, batches = _lm("smollm_135m", "adafactor", None,
                      os.path.join(world4, "ckpt"))
    assert tr.restore() and tr.state.step == 1
    for name, got in (("world 1", _full_state(tr)),
                      ("world 4", _load(world4, "ckpt_world4")[0])):
        assert sorted(got) == sorted(saved), name
        for k, v in saved.items():
            assert torch.equal(got[k], v), (name, k)
    tr.step(batches(1))
    continued = _load(world4, "ckpt_continued")
    _assert_close(_params(tr), continued, 1e-5, "world 1 continued")
    _, params4, step4 = _load(world4, "ckpt_world4")
    assert step4 == 2
    _assert_close(params4, continued, 1e-5, "world 4 continued")


def test_stage2_mesh_matches_unsharded_and_jax(world4, stage2_jax):
    """3 Stage2Engine steps on a (2, 2) mesh, 4 rows a data rank: the
    consistency term pairs anchors across ranks."""
    state, jax_params, jax_metrics = stage2_jax
    params, metrics = _load(world4, "stage2")
    want, want_m = _stage2_run(None, state)
    _assert_close(params, want, 1e-5, "stage 2 vs unsharded")
    _assert_close(params, jax_params, 1e-4, "stage 2 vs JAX")
    for m, w, j in zip(metrics, want_m, jax_metrics):
        for k in ("loss", "triplet", "cpi_reg", "consistency", "grad_norm"):
            np.testing.assert_allclose(m[k], w[k], rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(m[k], float(j[k]), rtol=1e-4,
                                       atol=1e-6)


def test_kmeans_device_sharded(world4):
    """Over a 4-way data axis: labels equal the unsharded port's for the
    same seeds (the seeding draws the same rows), centroids within 1e-5,
    cluster-aligned with JAX's host `kmeans`; dead rows of a valid_mask;
    254 rows warn and run unsharded."""
    from repro.core.clustering import kmeans as jax_kmeans
    got = _load(world4, "kmeans")
    x, xp = _kmeans_data()
    want = {"prefix": kmeans_device(xp, 4, seed=1, n_valid=len(x)),
            "mask": kmeans_device(xp, 4, seed=2,
                                  valid_mask=got["mask_rows"]),
            "odd": kmeans_device(xp[:254], 4, seed=1, n_valid=len(x))}
    live = got["mask_rows"] > 0
    for key, (c, a, inertia) in want.items():
        gc, ga, gi = got[key]
        rows = live[:len(a)] if key == "mask" else slice(None)
        np.testing.assert_array_equal(ga[rows], a[rows], err_msg=key)
        np.testing.assert_allclose(gc, c, atol=1e-5, rtol=0, err_msg=key)
        # the x²−2xc+c² form cancels (|x|² ~ 300, d2 ~ 0.02 a row): a 1e-6
        # centroid difference moves the inertia by about 1e-4 of itself
        np.testing.assert_allclose(gi, inertia, rtol=1e-3, err_msg=key)
    assert len(got["warned"]) == 1 and "254" in got["warned"][0]
    c_h, a_h, _ = jax_kmeans(x, 4, seed=1)
    c_d, a_d = got["prefix"][0], got["prefix"][1]
    perm = ((c_d[:, None, :] - c_h[None, :, :]) ** 2).sum(-1).argmin(1)
    assert sorted(perm.tolist()) == [0, 1, 2, 3]
    np.testing.assert_array_equal(perm[a_d], a_h)


def test_mesh_helpers(world4):
    raised, shape, names, device_type = _load(world4, "meshes")
    assert "needs 256 ranks" in raised and "has 4" in raised
    assert (shape, names, device_type) == ((4,), ("data",), "cpu")

"""The port's Stage-1 training slice on the CPU, held against the JAX
package on the same numpy inputs: the wkv backward (plain reverse loop
against torch autograd and `jax.grad` of the scan), `pretrain_loss` and
`finetune_triplet_loss` (values, metrics and every parameter's gradient
from bridged weights), the corpus and loader copies, the port `Trainer`
on the pre-training loss step for step, exact resume, and Stage-1
checkpoints crossing both ways (`blocks` stacked as `bbe_init` has it)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core import bbe as jbbe  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.data.corpus import SyntheticBinaryCorp as JaxCorp  # noqa: E402
from repro.models.rwkv import wkv_scan_ref  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.core.bbe import (  # noqa: E402
    BBEConfig, BBEEncoder, encode_bbe, finetune_triplet_loss, pretrain_loss,
    stack_layers, unstack_layers,
)
from repro_torch.data import loader  # noqa: E402
from repro_torch.data.corpus import SyntheticBinaryCorp  # noqa: E402
from repro_torch.kernels.wkv import (  # noqa: E402
    wkv, wkv_backward, wkv_backward_reference, wkv_reference,
)
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

# the verify skill's tiny Stage-1 config
TINY = dict(dim_embeds=(48, 8, 8, 8, 8, 8), num_layers=2, num_heads=2,
            bbe_dim=32, max_len=64)
N_FUNCTIONS = 40


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _path_key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _flat_jax(tree):
    return {_path_key(path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _close(got, want, atol=1e-4, rtol=1e-3, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol, err_msg=msg)


_CORPORA = {}


def _corpora():
    """(port corpus, JAX corpus) of the tiny config, built once."""
    if not _CORPORA:
        _CORPORA["pair"] = (
            SyntheticBinaryCorp(n_functions=N_FUNCTIONS,
                                max_len=TINY["max_len"]),
            JaxCorp(n_functions=N_FUNCTIONS, max_len=TINY["max_len"]))
    return _CORPORA["pair"]


def _bridged(seed=0):
    jcfg = jbbe.BBEConfig(**TINY)
    params, specs = jbbe.bbe_init(jax.random.PRNGKey(seed), jcfg)
    tree = _np_tree(params)
    return jcfg, tree, specs, bridge.bbe_params_from_jax(tree,
                                                         BBEConfig(**TINY))


# ---------------------------------------------------------------------------
# the wkv backward
# ---------------------------------------------------------------------------

def _wkv_inputs(rng, B, S, H, dh):
    r, k, v = (rng.randn(B, S, H, dh).astype(np.float32) for _ in range(3))
    k /= np.maximum(np.linalg.norm(k, axis=-1, keepdims=True), 1e-6)
    w = (0.7 + 0.3 * rng.rand(B, S, H, dh)).astype(np.float32)
    beta = rng.rand(B, S, H).astype(np.float32)
    return r, k, v, w, beta


def _jax_wkv_grads(args, s0, dy, dsf):
    """jax.grad of <y, dy> + <S_T, dsf> through the scan of
    `wkv_scan_ref`, in every input (and the initial state if given)."""
    def f(*xs):
        state = xs[5] if s0 is not None else None
        y, sf = wkv_scan_ref(*xs[:5], state=state)
        out = jnp.sum(y * dy)
        return out + jnp.sum(sf * dsf) if dsf is not None else out
    xs = [jnp.asarray(a) for a in args] + (
        [jnp.asarray(s0)] if s0 is not None else [])
    return [np.asarray(g) for g in jax.grad(f, range(len(xs)))(*xs)]


@pytest.mark.parametrize("with_state,with_dsf", [(False, False), (True, True),
                                                 (True, False), (False, True)])
@pytest.mark.parametrize("B,S,H,dh", [(1, 1, 1, 4), (2, 7, 3, 5),
                                      (2, 13, 2, 16), (1, 9, 2, 48)])
def test_wkv_backward_reference_matches_autograd_and_jax(B, S, H, dh,
                                                         with_state, with_dsf):
    rng = np.random.RandomState(B * 100 + S * 10 + dh)
    args = _wkv_inputs(rng, B, S, H, dh)
    s0 = (0.1 * rng.randn(B, H, dh, dh)).astype(np.float32) \
        if with_state else None
    dy = rng.randn(B, S, H, dh).astype(np.float32)
    dsf = rng.randn(B, H, dh, dh).astype(np.float32) if with_dsf else None
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = wkv_backward_reference(*map(t, args), t(s0), t(dy), t(dsf))
    names = ("dr", "dk", "dv", "dw", "dbeta", "dstate")

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    if with_state:
        leaves.append(torch.from_numpy(s0).requires_grad_(True))
    y, sf = wkv_reference(*leaves[:5], leaves[5] if with_state else None)
    obj = (y * t(dy)).sum() + ((sf * t(dsf)).sum() if with_dsf else 0.0)
    auto = torch.autograd.grad(obj, leaves)
    jgrads = _jax_wkv_grads(args, s0, dy, dsf)
    for name, g, a, j in zip(names, got, auto, jgrads):
        _close(g.numpy(), a.numpy(), msg=f"{name} vs autograd")
        _close(g.numpy(), j, msg=f"{name} vs jax.grad")
    if not with_state:     # the gradient of a zero initial state
        assert got[5].shape == (B, H, dh, dh)


def test_wkv_autograd_function_on_cpu():
    """On CPU tensors that require grad, `wkv` runs through the autograd
    Function: its gradients are the plain backward's, the state's
    included, and no kernel launches; under no_grad nothing is saved."""
    rng = np.random.RandomState(3)
    B, S, H, dh = 2, 11, 2, 8
    args = _wkv_inputs(rng, B, S, H, dh)
    s0 = (0.1 * rng.randn(B, H, dh, dh)).astype(np.float32)
    dy = torch.from_numpy(rng.randn(B, S, H, dh).astype(np.float32))
    dsf = torch.from_numpy(rng.randn(B, H, dh, dh).astype(np.float32))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (*args, s0)]
    launches = wkv.launches, wkv_backward.launches
    y, sf = wkv(*leaves)
    assert y.grad_fn is not None and sf.grad_fn is not None
    grads = torch.autograd.grad((y * dy).sum() + (sf * dsf).sum(), leaves)
    want = wkv_backward_reference(*map(torch.from_numpy, args),
                                  torch.from_numpy(s0), dy, dsf)
    for g, w_ in zip(grads, want):
        torch.testing.assert_close(g, w_, atol=0, rtol=0)
    assert (wkv.launches, wkv_backward.launches) == launches
    with torch.no_grad():
        y2, _ = wkv(*leaves)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())
    # the wrapper takes the plain backward on CPU tensors, states unused
    got = wkv_backward(*map(torch.from_numpy, args), torch.from_numpy(s0),
                       None, dy, dsf)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


# ---------------------------------------------------------------------------
# the losses against jax.grad
# ---------------------------------------------------------------------------

def _port_grads(model, loss):
    named = {k.replace(".", "/"): p for k, p in model.named_parameters()}
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    return {k: g.numpy() for k, g in zip(named, grads)}


def _jax_grads_by_port_name(jgrads, num_layers):
    """JAX gradient leaves keyed as the port names its parameters
    (`blocks` unstacked)."""
    flat = _flat_jax(jgrads)
    out = {}
    for key, g in flat.items():
        if key.startswith("blocks/"):
            for n in range(num_layers):
                out[f"blocks/{n}/{key[len('blocks/'):]}"] = g[n]
        else:
            out[key] = g
    return out


def _assert_grads_close(got, want):
    assert sorted(got) == sorted(want)
    for key, g in want.items():
        _close(got[key], g, msg=key)


def test_pretrain_loss_and_grads_match_jax():
    """NTP + NIP on corpus tokens (SEPs, pads, a horizon clipped at the
    end), every parameter's gradient included, from bridged weights."""
    jcfg, tree, _, enc = _bridged(seed=1)
    corp, _ = _corpora()
    toks = corp.pretrain_batch(0, 4)["tokens"]
    toks[1, -3:] = toks[1, :3]           # tokens up to the last position
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    (j_loss, j_m), j_g = jax.jit(jax.value_and_grad(
        lambda p, x: jbbe.pretrain_loss(p, jcfg, x, impl="scan"),
        has_aux=True))(params, jnp.asarray(toks))
    loss, m = pretrain_loss(enc, {"tokens": torch.from_numpy(toks)})
    _close(float(loss.detach()), float(j_loss), atol=1e-5, rtol=1e-5)
    for k in ("ntp", "nip"):
        _close(float(m[k].detach()), float(j_m[k]), atol=1e-5, rtol=1e-5,
               msg=k)
    assert float(j_m["nip"]) > 0.0         # SEP targets were counted
    _assert_grads_close(_port_grads(enc, loss),
                        _jax_grads_by_port_name(j_g, jcfg.num_layers))


def test_finetune_triplet_loss_and_grads_match_jax():
    jcfg, tree, _, enc = _bridged(seed=2)
    corp, _ = _corpora()
    batch = corp.triplet_batch(1, 4)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    (j_loss, j_m), j_g = jax.jit(jax.value_and_grad(
        lambda p, b: jbbe.finetune_triplet_loss(p, jcfg, b, impl="scan"),
        has_aux=True))(params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, m = finetune_triplet_loss(
        enc, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(float(loss.detach()), float(j_loss), atol=1e-5, rtol=1e-5)
    for k in ("d_ap", "d_an"):
        _close(float(m[k].detach()), float(j_m[k]), atol=1e-5, rtol=1e-5,
               msg=k)
    _assert_grads_close(_port_grads(enc, loss),
                        _jax_grads_by_port_name(j_g, jcfg.num_layers))


def test_mlp_head_uses_tanh_gelu():
    """jax.nn.gelu's default (tanh approximation), not torch's erf."""
    _, tree, _, enc = _bridged(seed=0)
    h = np.random.RandomState(0).randn(3, 5, enc.cfg.d_model).astype(
        np.float32)
    want = jbbe._mlp_head(jax.tree_util.tree_map(jnp.asarray,
                                                 tree["ntp_head"]),
                          jnp.asarray(h))
    with torch.no_grad():
        got = enc.ntp_head(torch.from_numpy(h))
    _close(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# corpus and loader copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,split", [(0, "train"), (5, "train"),
                                        (2, "test")])
def test_corpus_batches_match_jax(step, split):
    corp, jcorp = _corpora()
    np.testing.assert_array_equal(corp.train_fids, jcorp.train_fids)
    np.testing.assert_array_equal(corp.test_fids, jcorp.test_fids)
    for got, want in ((corp.pretrain_batch(step, 6, split),
                       jcorp.pretrain_batch(step, 6, split)),
                      (corp.triplet_batch(step, 5, split),
                       jcorp.triplet_batch(step, 5, split))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_corpus_pool_and_functions_match_jax():
    corp, jcorp = _corpora()
    for pair in (("O0", "O3"), ("O1", "Os")):
        got, want = corp.bcsd_pool(pair, 5, 8, seed=1), \
            jcorp.bcsd_pool(pair, 5, 8, seed=1)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    fid = int(corp.train_fids[3])
    got, want = corp.encode_function(fid, "O2"), \
        jcorp.encode_function(fid, "O2")
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)


@pytest.mark.parametrize("gb,host,hosts", [(8, None, None), (8, 1, 4),
                                           (12, 2, 3), (6, 0, 1)])
def test_host_slice_and_loader_match_jax(gb, host, hosts):
    assert loader.host_slice(gb, host, hosts) == \
        jloader.host_slice(gb, host, hosts)
    corp, _ = _corpora()

    def batch_fn(step):
        return corp.pretrain_batch(step, gb)

    want = jloader.BatchLoader(batch_fn, host_id=host, num_hosts=hosts)(4)
    got = loader.BatchLoader(batch_fn, host_id=host, num_hosts=hosts)(4)
    on_cpu = loader.BatchLoader(batch_fn, device="cpu", host_id=host,
                                num_hosts=hosts)(4)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v))
        assert isinstance(on_cpu[k], torch.Tensor)
        np.testing.assert_array_equal(on_cpu[k].numpy(), np.asarray(v))


def test_host_slice_refuses_an_uneven_split():
    with pytest.raises(AssertionError):
        loader.host_slice(10, 0, 4)


# ---------------------------------------------------------------------------
# Trainer, resume, checkpoints across the packages
# ---------------------------------------------------------------------------

def _tc(tmp, **kw):
    base = dict(learning_rate=2e-3, total_steps=5, warmup_steps=2,
                checkpoint_every=0, checkpoint_dir=str(tmp))
    base.update(kw)
    return base


def _pretrain_fns(batch=4):
    corp, _ = _corpora()

    def port(step):
        return {"tokens": torch.from_numpy(corp.pretrain_batch(step, batch)
                                           ["tokens"])}

    def jax_fn(step):
        return {"tokens": jnp.asarray(corp.pretrain_batch(step, batch)
                                      ["tokens"])}
    return port, jax_fn


def _jax_trainer(jcfg, tree, specs, tc):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return JaxTrainer(lambda p, b: jbbe.pretrain_loss(p, jcfg, b["tokens"]),
                      params, specs, JaxTrainConfig(**tc))


def test_trainer_pretrain_losses_match_jax_over_five_steps(tmp_path):
    """The port Trainer on `pretrain_loss` follows the JAX Trainer step
    for step from the same bridged weights and batches."""
    jcfg, tree, specs, enc = _bridged(seed=3)
    port, jax_fn = _pretrain_fns()
    tr = Trainer(pretrain_loss, enc, TrainConfig(**_tc(tmp_path / "p")))
    jtr = _jax_trainer(jcfg, tree, specs, _tc(tmp_path / "j"))
    for s in range(5):
        m, jm = tr.step(port(s)), jtr.step(jax_fn(s))
        for k in ("loss", "ntp", "nip", "grad_norm", "lr"):
            _close(m[k], jm[k], atol=1e-7, rtol=1e-3, msg=f"step {s} {k}")


def test_stack_layers_round_trip():
    flat = {"params/embeds/0": torch.zeros(2),
            "params/blocks/0/a/w": torch.ones(3),
            "params/blocks/1/a/w": 2 * torch.ones(3),
            "opt/m/blocks/1/b": torch.full((2, 2), 4.0),
            "opt/m/blocks/0/b": torch.full((2, 2), 3.0),
            "opt/count": torch.zeros((), dtype=torch.int32)}
    stacked = stack_layers(flat, 2)
    assert list(stacked) == ["params/embeds/0", "params/blocks/a/w",
                             "opt/m/blocks/b", "opt/count"]
    assert stacked["params/blocks/a/w"].shape == (2, 3)
    assert float(stacked["opt/m/blocks/b"][0, 0, 0]) == 3.0
    back = unstack_layers(stacked, flat)
    assert list(back) == list(flat)
    for k, v in flat.items():
        assert torch.equal(back[k], v)


def test_stage1_exact_resume(tmp_path):
    """A fresh Trainer restored from the step-2 checkpoint and run to step
    4 ends with bitwise the weights of the uninterrupted run."""
    port, _ = _pretrain_fns()
    tc = TrainConfig(**_tc(tmp_path / "a", total_steps=4,
                           checkpoint_every=2))
    tr = Trainer(pretrain_loss, BBEEncoder(BBEConfig(**TINY), seed=5), tc)
    tr.fit(port, 4, log_every=100)
    resumed = tmp_path / "b"
    resumed.mkdir()
    import shutil
    shutil.copytree(tmp_path / "a" / "step_0000000002",
                    resumed / "step_0000000002")
    tr_b = Trainer(pretrain_loss, BBEEncoder(BBEConfig(**TINY), seed=5),
                   TrainConfig(**_tc(resumed, total_steps=4,
                                     checkpoint_every=2)))
    tr_b.fit(port, 4, log_every=100)
    assert tr_b.state.step == 4
    for name, p in tr.state.params.items():
        assert torch.equal(p, tr_b.state.params[name]), name
    for part in ("m", "v"):
        for name, x in tr.state.opt_state[part].items():
            assert torch.equal(x, tr_b.state.opt_state[part][name]), name


def test_stage1_port_checkpoint_restores_in_jax(tmp_path):
    """A port Stage-1 Trainer's checkpoint (params and AdamW moments)
    restores in `repro.train.checkpoint.restore_checkpoint` with a
    `bbe_init` template, `blocks` stacked; so does a bare encoder."""
    jcfg, tree, _, enc = _bridged(seed=4)
    port, _ = _pretrain_fns()
    tr = Trainer(pretrain_loss, enc, TrainConfig(**_tc(tmp_path / "p")))
    tr.step(port(0))
    tr.step(port(1))
    path = tr.maybe_checkpoint(force=True)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jtree, step, meta = jckpt.restore_checkpoint(
        path, {"params": params, "opt": jopt.adamw_init(params)})
    assert step == 2 and meta == {"step": 2}
    flat = _flat_jax(jtree)
    live = ckpt._flatten({"params": tr.state.params,
                          "opt": tr.state.opt_state})
    assert len(flat) == len(stack_layers(live, jcfg.num_layers))
    for key, t in live.items():
        parts = key.split("/")
        if "blocks" in parts:
            i = parts.index("blocks")
            want = flat["/".join(parts[:i + 1] + parts[i + 2:])][
                int(parts[i + 1])]
        else:
            want = flat[key]
        np.testing.assert_array_equal(want, t.detach().numpy(), err_msg=key)
    bare = bridge.save_bbe_checkpoint(tr.model, str(tmp_path / "b"), step=7)
    jtree, step, _ = jckpt.restore_checkpoint(bare, {"params": params})
    assert step == 7
    toks = _corpora()[0].pretrain_batch(9, 3)["tokens"]
    want = jbbe.encode_bbe(jtree["params"], jcfg, jnp.asarray(toks))
    with torch.no_grad():
        got = encode_bbe(tr.model, torch.from_numpy(toks))
    _close(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_stage1_jax_checkpoint_restores_in_port(tmp_path):
    """A JAX Stage-1 Trainer's checkpoint restores into a port Trainer
    (params, AdamW moments, count, step) with equal values, loads through
    the bridge, and trains on as the JAX Trainer does."""
    jcfg, tree, specs, _ = _bridged(seed=6)
    port, jax_fn = _pretrain_fns()
    tc = _tc(tmp_path / "j", checkpoint_every=3)
    jtr = _jax_trainer(jcfg, tree, specs, tc)
    jtr.fit(jax_fn, 3, log_every=1000)
    path = jckpt.latest_checkpoint(tc["checkpoint_dir"])
    assert path.endswith("step_0000000003")
    tr = Trainer(pretrain_loss, BBEEncoder(BBEConfig(**TINY), seed=9),
                 TrainConfig(**tc))
    assert tr.load(path) == 3 and tr.state.step == 3
    want = _jax_grads_by_port_name(jtr.state.params, jcfg.num_layers)
    assert sorted(want) == sorted(tr.state.params)
    for k, v in want.items():
        np.testing.assert_array_equal(tr.state.params[k].detach().numpy(), v,
                                      err_msg=k)
    jopt_state = jtr.state.opt_state
    assert int(tr.state.opt_state["count"]) == int(jopt_state["count"]) == 3
    for part in ("m", "v"):
        for k, v in _jax_grads_by_port_name(jopt_state[part],
                                            jcfg.num_layers).items():
            np.testing.assert_array_equal(
                tr.state.opt_state[part][k].numpy(), v, err_msg=k)
    model = bridge.bbe_params_from_checkpoint(path, BBEConfig(**TINY))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k.replace(".", "/")])
    m, jm = tr.step(port(3)), jtr.step(jax_fn(3))
    _close(m["loss"], jm["loss"], atol=1e-7, rtol=1e-3)

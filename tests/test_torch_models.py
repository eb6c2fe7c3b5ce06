"""The port's modules from bridged JAX weights against their JAX twins on
the CPU: layers and losses, one RWKV block, `encode_bbe` (tiny and at the
default width), `signature_apply` and `predict_cpi`, plus the bridge's
checks and the tokenizer copy."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bbe as jbbe  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import signature as jsig  # noqa: E402
from repro.core.tokenizer import default_tokenizer as jax_tokenizer  # noqa: E402
from repro.data.asmgen import spec_programs as jax_spec_programs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.rwkv import rwkv_block_apply  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.core.bbe import BBEConfig, BBEEncoder, encode_bbe  # noqa: E402
from repro_torch.core.signature import (  # noqa: E402
    SignatureConfig, predict_cpi, signature_apply, stage2_loss,
    stage2_loss_from_rows,
)
from repro_torch.core.tokenizer import default_tokenizer  # noqa: E402
from repro_torch.data.asmgen import spec_programs  # noqa: E402
from repro_torch.models.layers import layernorm, rmsnorm  # noqa: E402

TINY_BBE = dict(dim_embeds=(48, 8, 8, 8, 8, 8), num_layers=2, num_heads=2,
                bbe_dim=32, max_len=64)
TINY_SIG = dict(bbe_dim=32, d_model=32, sig_dim=16, max_set=48, num_heads=2)
# benchmarks/lab.py's SIG_CFG
LAB_SIG = dict(bbe_dim=96, d_model=96, sig_dim=64, max_set=48, num_heads=4,
               w_r=1.0, w_c=0.5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(rng, B, L, vocab=40, pad_from=None):
    toks = rng.randint(1, vocab, (B, L, 6)).astype(np.int32)
    if pad_from is not None:
        toks[:, pad_from:] = 0
    return toks


# ---------------------------------------------------------------------------
# layers and losses
# ---------------------------------------------------------------------------

def test_norms_match_jax():
    rng = np.random.RandomState(0)
    x = (3.0 * rng.randn(4, 7, 24)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    np.testing.assert_allclose(
        rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jlayers.rmsnorm_apply({"scale": scale}, x)),
        atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(
        layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                  torch.from_numpy(bias)).numpy(),
        np.asarray(jlayers.layernorm_apply({"scale": scale, "bias": bias},
                                           x)),
        atol=1e-5, rtol=1e-5)


def test_losses_forward_match_jax():
    rng = np.random.RandomState(1)
    a, p, n = (rng.randn(6, 16).astype(np.float32) for _ in range(3))
    a[0] = 0.0                                    # l2 eps branch
    pred = rng.randn(6).astype(np.float32)
    cpi = rng.uniform(0.2, 30.0, 6).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(losses.l2_normalize(t(a)).numpy(),
                               np.asarray(jlosses.l2_normalize(a)),
                               atol=1e-6)
    total, parts = losses.combined_stage2_loss(t(a), t(p), t(n), t(pred),
                                               t(cpi))
    j_total, j_parts = jlosses.combined_stage2_loss(a, p, n, pred, cpi)
    np.testing.assert_allclose(float(total), float(j_total), rtol=1e-5)
    for key in j_parts:
        np.testing.assert_allclose(float(parts[key]), float(j_parts[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)


# ---------------------------------------------------------------------------
# Stage 1
# ---------------------------------------------------------------------------

def _bridged_encoder(cfg_kwargs, seed=0):
    jcfg = jbbe.BBEConfig(**cfg_kwargs)
    params, _ = jbbe.bbe_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, params, bridge.bbe_params_from_jax(_np_tree(params),
                                                    BBEConfig(**cfg_kwargs))


def test_rwkv_block_matches_jax():
    jcfg, params, enc = _bridged_encoder(TINY_BBE)
    rng = np.random.RandomState(2)
    x = rng.randn(3, 19, jcfg.d_model).astype(np.float32)
    layer0 = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    want = rwkv_block_apply(layer0, jnp.asarray(x), jcfg.num_heads, "scan")
    with torch.no_grad():
        got = enc.blocks[0](torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("cfg_kwargs", [
    TINY_BBE,
    dict(num_layers=2),          # default width: d_model 384, 6 heads of 64
], ids=["tiny", "default-width-2-layers"])
def test_encode_bbe_matches_jax(cfg_kwargs):
    jcfg, params, enc = _bridged_encoder(cfg_kwargs, seed=3)
    rng = np.random.RandomState(4)
    L = jcfg.max_len
    toks = _tokens(rng, 3, L, pad_from=L - 9)
    toks[0, 5, 1] = 10_000                 # out of range: clamped as "clip"
    toks[2, :] = 0                         # an all-pad row
    want = jbbe.encode_bbe(params, jcfg, jnp.asarray(toks), impl="scan")
    with torch.no_grad():
        got = encode_bbe(enc, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_bridge_rejects_mismatched_trees():
    jcfg, params, _ = _bridged_encoder(TINY_BBE)
    tree = _np_tree(params)
    with pytest.raises(ValueError):
        bridge.bbe_params_from_jax(
            tree, BBEConfig(**dict(TINY_BBE, num_layers=3)))
    del tree["pool"]["ua"]
    with pytest.raises(KeyError):
        bridge.bbe_params_from_jax(tree, BBEConfig(**TINY_BBE))


def test_seeded_init_is_reproducible_and_shaped_like_jax():
    """The port's own init: same seed, same weights; parameter shapes
    equal the JAX tree's, leaf for leaf."""
    cfg = BBEConfig(**TINY_BBE)
    a, b = BBEEncoder(cfg, seed=5), BBEEncoder(cfg, seed=5)
    for (ka, va), (_, vb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(va, vb), ka
    _, params, bridged = _bridged_encoder(TINY_BBE)
    shapes = {k: tuple(v.shape) for k, v in bridged.state_dict().items()}
    assert shapes == {k: tuple(v.shape) for k, v in a.state_dict().items()}


# ---------------------------------------------------------------------------
# dtype "bfloat16": every route a user takes builds JAX's bf16 models
# ---------------------------------------------------------------------------

def _bf16_route(which, route):
    """(port module, JAX tree, JAX config) for the Stage-1 ("bbe") or
    Stage-2 ("signature") model with dtype "bfloat16", the module built
    through one route a user would take."""
    from repro_torch.api import SemanticBBVService, ServiceConfig
    from repro_torch.core.pipeline import SemanticBBVPipeline
    from repro_torch.core.signature import SignatureModel
    if which == "bbe":
        kw, jmod, init = TINY_BBE, jbbe, jbbe.bbe_init
        cfg, Model = BBEConfig(**kw, dtype="bfloat16"), BBEEncoder
        load = bridge.bbe_params_from_jax
        cfgs = dict(bbe_cfg=cfg, sig_cfg=SignatureConfig(**TINY_SIG))
        attr = "encoder"
    else:
        kw, jmod, init = TINY_SIG, jsig, jsig.signature_init
        cfg, Model = SignatureConfig(**kw, dtype="bfloat16"), SignatureModel
        load = bridge.signature_params_from_jax
        cfgs = dict(bbe_cfg=BBEConfig(**TINY_BBE), sig_cfg=cfg)
        attr = "sig_model"
    jcfg = dataclasses.replace(getattr(jmod, type(cfg).__name__)(**kw),
                               dtype="bfloat16")
    tree = _np_tree(init(jax.random.PRNGKey(0), jcfg)[0])
    if route in ("bridge", "bridge-fp32-config"):
        fp32 = dataclasses.replace(cfg, dtype="float32")
        return load(tree, cfg if route == "bridge" else fp32), tree, jcfg
    if route == "module":
        model = Model(cfg)
    elif route == "pipeline":
        model = getattr(SemanticBBVPipeline.create(**cfgs, device="cpu"),
                        attr)
    else:
        svc = SemanticBBVService.create(ServiceConfig(
            bbe=cfgs["bbe_cfg"], sig=cfgs["sig_cfg"]), device="cpu")
        model = getattr(svc.pipe, attr)
    # JAX's weights into the module the route built (seeded otherwise)
    model.load_state_dict(load(tree, cfg).state_dict())
    return model, tree, jcfg


@pytest.mark.parametrize("route", ["module", "bridge", "bridge-fp32-config",
                                   "pipeline", "service"])
@pytest.mark.parametrize("which", ["bbe", "signature"])
def test_bf16_stage1_stage2_routes(which, route):
    """dtype "bfloat16" through each route: the module's leaves have the
    dtypes of JAX's tree (bf16, Stage 1's `w_bias` fp32), and its outputs
    match JAX's on JAX's weights (bf16 BBEs within the Stage-1 bf16
    bounds; fp32 signatures of fp32 BBEs on bf16 weights within 1e-5). A
    bf16 tree into an fp32 config raises TypeError naming both dtypes."""
    if route == "bridge-fp32-config":
        with pytest.raises(TypeError, match="bfloat16.*float32"):
            _bf16_route(which, route)
        return
    model, tree, jcfg = _bf16_route(which, route)
    want = dict(bridge._flatten({k: v for k, v in tree.items()
                                 if k != "blocks"}))
    for key, leaf in bridge._flatten(tree.get("blocks", {})):
        want.update({f"blocks.{n}.{key}": leaf[n]
                     for n in range(jcfg.num_layers)})
    leaves = {k: str(v.dtype) for k, v in model.state_dict().items()}
    assert leaves == {k: f"torch.{v.dtype.name}" for k, v in want.items()}
    assert set(leaves.values()) == ({"torch.bfloat16", "torch.float32"}
                                    if which == "bbe" else {"torch.bfloat16"})
    rng = np.random.RandomState(7)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    if which == "bbe":
        toks = _tokens(rng, 2, jcfg.max_len, pad_from=jcfg.max_len - 5)
        want = jbbe.encode_bbe(params, jcfg, jnp.asarray(toks),
                               impl="pallas_interpret")
        with torch.no_grad():
            got = encode_bbe(model, torch.from_numpy(toks))
        assert got.dtype == torch.bfloat16
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert np.abs(got - want).max() <= 1e-2
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 5e-3
        return
    B, N = 2, jcfg.max_set
    bbes = rng.randn(B, N, jcfg.bbe_dim).astype(np.float32)
    freqs = rng.uniform(1, 500, (B, N)).astype(np.float32)
    mask = rng.rand(B, N) > 0.4
    mask[:, 0] = True
    sig_j, _ = jsig.signature_apply(params, jcfg, jnp.asarray(bbes),
                                    jnp.asarray(freqs), jnp.asarray(mask),
                                    impl="pallas_interpret")
    with torch.no_grad():
        sig, _ = signature_apply(model, *map(torch.from_numpy,
                                             (bbes, freqs, mask)))
    assert sig.dtype == torch.float32
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=1e-5)


def test_bridge_rejects_a_float64_tree():
    _, params, _ = _bridged_encoder(TINY_BBE)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    with pytest.raises(TypeError, match="float64"):
        bridge.bbe_params_from_jax(tree, BBEConfig(**TINY_BBE))


# ---------------------------------------------------------------------------
# Stage 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_signature_apply_matches_jax(impl):
    jcfg = jsig.SignatureConfig(**TINY_SIG)
    params, _ = jsig.signature_init(jax.random.PRNGKey(1), jcfg)
    model = bridge.signature_params_from_jax(_np_tree(params),
                                             SignatureConfig(**TINY_SIG))
    rng = np.random.RandomState(5)
    B, N = 4, jcfg.max_set
    bbes = rng.randn(B, N, jcfg.bbe_dim).astype(np.float32)
    freqs = rng.uniform(1, 500, (B, N)).astype(np.float32)
    mask = rng.rand(B, N) > 0.4
    mask[:, 0] = True
    mask[3] = False                        # a padded, fully masked row
    args = (jnp.asarray(bbes), jnp.asarray(freqs), jnp.asarray(mask))
    sig_j, cpi_j = jsig.signature_apply(params, jcfg, *args, impl=impl)
    t_args = tuple(map(torch.from_numpy, (bbes, freqs, mask)))
    with torch.no_grad():
        sig, cpi = signature_apply(model, *t_args)
        pred = predict_cpi(model, *t_args)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=1e-5)
    np.testing.assert_allclose(cpi.numpy(), np.asarray(cpi_j), atol=1e-5)
    np.testing.assert_allclose(
        pred.numpy(), np.asarray(jsig.predict_cpi(params, jcfg, *args, impl)),
        atol=1e-5, rtol=1e-5)


def test_signature_default_width_matches_jax():
    """The default SignatureConfig (d_model 256, 4 heads of 64, max_set
    64), the widths the set-attention kernel sees on the main path."""
    jcfg = jsig.SignatureConfig(bbe_dim=32)
    cfg = SignatureConfig(**dataclasses.asdict(jcfg))
    params, _ = jsig.signature_init(jax.random.PRNGKey(2), jcfg)
    model = bridge.signature_params_from_jax(_np_tree(params), cfg)
    rng = np.random.RandomState(6)
    B, N = 2, jcfg.max_set
    bbes = rng.randn(B, N, jcfg.bbe_dim).astype(np.float32)
    freqs = rng.uniform(1, 50, (B, N)).astype(np.float32)
    mask = rng.rand(B, N) > 0.5
    mask[:, 0] = True
    sig_j, _ = jsig.signature_apply(params, jcfg, jnp.asarray(bbes),
                                    jnp.asarray(freqs), jnp.asarray(mask))
    with torch.no_grad():
        sig, _ = signature_apply(model, *map(torch.from_numpy,
                                             (bbes, freqs, mask)))
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=1e-5)


# ---------------------------------------------------------------------------
# Stage-2 loss gradients
# ---------------------------------------------------------------------------

def _stage2_batch(rng, B, N, bbe_dim, weighted, masked):
    """tests/test_kernels.py's stage2 gradient batch (numpy)."""
    def one_set():
        m = rng.rand(B, N) > (0.3 if masked else -1.0)
        m[:, 0] = True
        return {"bbes": rng.randn(B, N, bbe_dim).astype(np.float32),
                "freqs": (rng.uniform(1, 500, (B, N)) if weighted
                          else np.ones((B, N))).astype(np.float32),
                "mask": m}
    batch = {r: one_set() for r in ("anchor", "positive", "negative")}
    batch["cpi"] = rng.uniform(0.5, 4.0, (B,)).astype(np.float32)
    return batch


_JAX_VALUE_AND_GRAD = {}


def _jax_value_and_grad(loss_fn, key, params, *args):
    """(loss, {"/"-joined path: grad}) of loss_fn(params, *args) under one
    jit per `key`, so the cases of one shape compile once."""
    if key not in _JAX_VALUE_AND_GRAD:
        _JAX_VALUE_AND_GRAD[key] = jax.jit(jax.value_and_grad(loss_fn))
    loss, g = _JAX_VALUE_AND_GRAD[key](params, *args)
    return float(loss), {
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
        np.asarray(v) for path, v in jax.tree_util.tree_leaves_with_path(g)}


def _port_grads(model, loss):
    named = {k.replace(".", "/"): p for k, p in model.named_parameters()}
    grads = torch.autograd.grad(loss, list(named.values()))
    return {k: g.numpy() for k, g in zip(named, grads)}


def _assert_grads_close(got, want):
    assert sorted(got) == sorted(want)
    for key, g in want.items():
        np.testing.assert_allclose(got[key], g, atol=1e-4, rtol=1e-3,
                                   err_msg=key)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("weighted,masked", [(True, True), (False, True),
                                             (True, False), (False, False)])
@pytest.mark.parametrize("cfg_kwargs", [TINY_SIG, LAB_SIG],
                         ids=["verify-tiny", "lab"])
def test_stage2_loss_grads_match_jax(cfg_kwargs, weighted, masked, impl):
    """torch autograd of `stage2_loss` (through the set-attention
    Function and its plain backward) against jax.grad of the JAX loss,
    on every parameter, from bridged weights."""
    jcfg = jsig.SignatureConfig(**cfg_kwargs)
    params, _ = jsig.signature_init(jax.random.PRNGKey(2), jcfg)
    model = bridge.signature_params_from_jax(_np_tree(params),
                                             SignatureConfig(**cfg_kwargs))
    batch = _stage2_batch(np.random.RandomState(5), 3, jcfg.max_set,
                          jcfg.bbe_dim, weighted, masked)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    tbatch = jax.tree_util.tree_map(torch.from_numpy, batch)
    j_loss, want = _jax_value_and_grad(
        lambda p, b: jsig.stage2_loss(p, jcfg, b, impl)[0],
        ("stage2_loss", jcfg, impl), params, jbatch)
    loss, _ = stage2_loss(model, model.cfg, tbatch)
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=1e-5)
    _assert_grads_close(_port_grads(model, loss), want)


@pytest.mark.parametrize("cfg_kwargs", [TINY_SIG, LAB_SIG],
                         ids=["verify-tiny", "lab"])
def test_stage2_loss_from_rows_grads_match_jax(cfg_kwargs):
    """The row-id loss (device-side gathers, sentinel rows in padded
    slots) differentiates as JAX's does."""
    jcfg = jsig.SignatureConfig(**cfg_kwargs)
    params, _ = jsig.signature_init(jax.random.PRNGKey(3), jcfg)
    model = bridge.signature_params_from_jax(_np_tree(params),
                                             SignatureConfig(**cfg_kwargs))
    rng = np.random.RandomState(8)
    V, B, N = 40, 4, jcfg.max_set
    matrix = np.concatenate([rng.randn(V, jcfg.bbe_dim),
                             np.zeros((1, jcfg.bbe_dim))]).astype(np.float32)
    batch = {"cpi": rng.uniform(0.5, 4.0, (B,)).astype(np.float32)}
    for role in ("anchor", "positive", "negative"):
        mask = rng.rand(B, N) > 0.5
        mask[:, 0] = True
        rows = np.where(mask, rng.randint(V, size=(B, N)), V)
        batch[role] = {"rows": rows.astype(np.int32),
                       "freqs": np.where(mask, rng.uniform(1, 500, (B, N)),
                                         0).astype(np.float32),
                       "mask": mask}
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    tbatch = jax.tree_util.tree_map(torch.from_numpy, batch)
    _, want = _jax_value_and_grad(
        lambda p, m, b: jsig.stage2_loss_from_rows(p, jcfg, m, b)[0],
        ("stage2_loss_from_rows", jcfg), params, jnp.asarray(matrix), jbatch)
    loss, _ = stage2_loss_from_rows(model, model.cfg,
                                    torch.from_numpy(matrix), tbatch)
    _assert_grads_close(_port_grads(model, loss), want)


# ---------------------------------------------------------------------------
# tokenizer copy
# ---------------------------------------------------------------------------

def test_tokenizer_copy_matches_jax():
    blocks = [b for p in spec_programs("int")[:3] for b in p.unique_blocks]
    jblocks = [b for p in jax_spec_programs("int")[:3]
               for b in p.unique_blocks]
    got = default_tokenizer().encode_blocks(blocks, 64)
    want = jax_tokenizer().encode_blocks(jblocks, 64)
    np.testing.assert_array_equal(got, want)
    assert default_tokenizer().spec.dim_sizes == jax_tokenizer().spec.dim_sizes

"""bf16 Stage 1 and Stage 2 (`dtype="bfloat16"`) of the port on the CPU,
held against the JAX package on seeded numpy inputs with weights from
`bbe_init` / `signature_init` at bf16: the plain versions of the kernels
at the JAX suite's bf16 cases and bounds, one RWKV block and one MAB,
`encode_bbe`, Stage 2 on fp32 and on bf16 BBEs, the service end to end,
gradients per leaf, Trainer and Stage2Engine steps, and bf16 checkpoints
in both directions.

Each bound comes with a mutation test: the port's own result computed
another way (in fp32 on the same bf16-valued weights, or in bf16 where
JAX promotes to fp32) must fall outside it, so a silent wrong-dtype path
cannot pass. The JAX references are the package's functions called as a
user calls them (un-jitted); the Stage-1 scan body compiles regardless.
JAX rounds a bf16 program differently under `jax.jit` (XLA keeps some
intermediates in fp32, and sums the gradient of a broadcast in bf16):
the block tests take the compiled block, the gradient tests JAX's eager
gradients with every leaf summed in fp32, as the port sums them."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import SemanticBBVService as JaxService  # noqa: E402
from repro.api import ServiceConfig as JaxServiceConfig  # noqa: E402
from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core import bbe as jbbe  # noqa: E402
from repro.core import signature as jsig  # noqa: E402
from repro.core.clustering import kmeans_pp_init_masked  # noqa: E402
from repro.core.pipeline import BBEIndex as JaxBBEIndex  # noqa: E402
from repro.core.pipeline import SemanticBBVPipeline as JaxPipeline  # noqa: E402
from repro.data import asmgen as jasmgen  # noqa: E402
from repro.data import perfmodel as jperfmodel  # noqa: E402
from repro.data import trace as jtrace  # noqa: E402
from repro.data.corpus import SyntheticBinaryCorp as JaxCorp  # noqa: E402
from repro.kernels.set_attention.ops import (  # noqa: E402
    masked_set_attention as jax_set_attention,
)
from repro.kernels.set_attention.ref import (  # noqa: E402
    set_attention_reference as jax_set_attention_ref,
)
from repro.kernels.wkv.ops import wkv_chunked  # noqa: E402
from repro.kernels.wkv.ref import wkv_reference as jax_wkv_ref  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import set_transformer as jst  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.stage2 import Stage2Engine as JaxStage2Engine  # noqa: E402
from repro.train.stage2 import triplet_row_batch as jax_triplet_row_batch  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import SemanticBBVService, ServiceConfig  # noqa: E402
from repro_torch.api.knowledge import KnowledgeBase  # noqa: E402
from repro_torch.api.store import SignatureStore  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.core.bbe import (  # noqa: E402
    BBEConfig, encode_bbe, pretrain_loss,
)
from repro_torch.core.pipeline import (  # noqa: E402
    BBEIndex, SemanticBBVPipeline,
)
from repro_torch.core.signature import (  # noqa: E402
    SignatureConfig, signature_apply, stage2_loss,
)
from repro_torch.data import asmgen, perfmodel, trace  # noqa: E402
from repro_torch.data.corpus import SyntheticBinaryCorp  # noqa: E402
from repro_torch.kernels.set_attention import masked_set_attention  # noqa: E402
from repro_torch.kernels.wkv import wkv  # noqa: E402
from repro_torch.train import Stage2Engine, Trainer  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import triplet_row_batch  # noqa: E402

TINY_BBE = dict(dim_embeds=(48, 8, 8, 8, 8, 8), num_layers=2, num_heads=2,
                bbe_dim=32, max_len=64)
TINY_SIG = dict(bbe_dim=32, d_model=32, sig_dim=16, max_set=48, num_heads=2)
BF16 = "bfloat16"
# the bounds: encode_bbe, max abs and relative L2; Stage 2 on bf16 BBEs,
# relative L2; on fp32 BBEs, max abs; gradients per leaf, relative L2
# (and of the median leaf, on bf16 weights and bf16 BBEs); one block or
# MAB, relative L2
ENCODE_BOUNDS = (1e-2, 5e-3)
SIG_BF16_REL = 3e-3
SIG_FP32_ATOL = 1e-5
GRAD_REL = 2e-2
MEDIAN_REL = 1e-2
MODULE_REL = 1e-3


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(x):
    """A JAX array or a torch tensor as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_tensor(j):
    """A bf16 JAX array as a bf16 tensor with the same values."""
    return torch.from_numpy(np.array(_np(j))).to(torch.bfloat16)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _fp32_tree(params):
    """The same values at fp32: the port's fp32 path on bf16 weights."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


@pytest.fixture(scope="module")
def stage1():
    """JAX's bf16 Stage-1 tree, and the port encoders loaded from it at
    bf16 and (the same values) at fp32."""
    jcfg = jbbe.BBEConfig(**TINY_BBE, dtype=BF16)
    params, specs = jbbe.bbe_init(jax.random.PRNGKey(3), jcfg)
    enc = bridge.bbe_params_from_jax(_tree(params),
                                     BBEConfig(**TINY_BBE, dtype=BF16))
    enc32 = bridge.bbe_params_from_jax(_fp32_tree(params),
                                       BBEConfig(**TINY_BBE))
    return jcfg, params, specs, enc, enc32


@pytest.fixture(scope="module")
def stage2():
    jcfg = jsig.SignatureConfig(**TINY_SIG, dtype=BF16)
    params, specs = jsig.signature_init(jax.random.PRNGKey(1), jcfg)
    model = bridge.signature_params_from_jax(
        _tree(params), SignatureConfig(**TINY_SIG, dtype=BF16))
    model32 = bridge.signature_params_from_jax(_fp32_tree(params),
                                               SignatureConfig(**TINY_SIG))
    return jcfg, params, specs, model, model32


# ---------------------------------------------------------------------------
# the plain versions at the JAX suite's bf16 kernel cases
# ---------------------------------------------------------------------------

def test_wkv_plain_bf16_matches_jax_kernel():
    """tests/test_kernels.py's bf16 wkv case (every input bf16): y and
    the state fp32, within the suite's 5e-2 + 1e-3 of JAX's kernel."""
    B, S, H, dh = 2, 64, 2, 16
    rng = np.random.RandomState(B * 1000 + S)
    bf = jnp.bfloat16
    r, k, v = (jnp.asarray(rng.randn(B, S, H, dh), bf) for _ in range(3))
    k = k / jnp.maximum(jnp.linalg.norm(k.astype(jnp.float32), axis=-1,
                                        keepdims=True), 1e-6).astype(bf)
    w = jnp.asarray(rng.uniform(0.7, 1.0, (B, S, H, dh)), bf)
    beta = jnp.asarray(rng.uniform(0, 1, (B, S, H)), bf)
    y_k, s_k = wkv_chunked(r, k, v, w, beta, chunk=16, interpret=True)
    y, sf = wkv(*map(_bf16_tensor, (r, k, v, w, beta)))
    assert y.dtype == sf.dtype == torch.float32
    for got, want in ((y, y_k), (sf, s_k)):
        np.testing.assert_allclose(_np(got), _np(want), atol=5e-2,
                                   rtol=1e-3)
    y_ref, _ = jax_wkv_ref(r, k, v, w, beta)
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=5e-2, rtol=1e-3)


def _set_attn_inputs(rng, B, H, N, M, dh):
    bf = jnp.bfloat16
    q = jnp.asarray(rng.randn(B, H, N, dh), bf)
    k = jnp.asarray(rng.randn(B, H, M, dh), bf)
    v = jnp.asarray(rng.randn(B, H, M, dh), bf)
    bias = jnp.asarray(rng.uniform(0, 1, (B, M)), jnp.float32)
    m = rng.rand(B, M) > 0.3
    m[:, 0] = True
    return q, k, v, bias, jnp.asarray(m)


def _t_inputs(q, k, v, bias, mask):
    return (*map(_bf16_tensor, (q, k, v)), torch.from_numpy(_np(bias)),
            torch.from_numpy(np.asarray(mask)))


def test_set_attention_plain_bf16_matches_jax_kernel():
    """The suite's bf16 forward case: bf16 out, within 3e-2 + 1e-3 of
    JAX's kernel (interpret mode) and of its reference."""
    rng = np.random.RandomState(31 * 32 + 32)
    args = _set_attn_inputs(rng, 2, 2, 32, 32, 32)
    o = masked_set_attention(*_t_inputs(*args))
    assert o.dtype == torch.bfloat16
    for want in (jax_set_attention(*args, interpret=True),
                 jax_set_attention_ref(*args)):
        np.testing.assert_allclose(_np(o), _np(want), atol=3e-2, rtol=1e-3)


@pytest.mark.parametrize("B,H,N,M,dh", [(2, 2, 32, 32, 32),
                                        (2, 2, 5, 13, 16)])
def test_set_attention_plain_bf16_grads_match_jax_kernel(B, H, N, M, dh):
    """The suite's bf16 gradient cases: dq, dk, dv bf16 and the bias's
    gradient fp32, within 5e-2 + 1e-3 of jax.grad through the kernel."""
    rng = np.random.RandomState(7 * N + M)
    q, k, v, bias, mask = _set_attn_inputs(rng, B, H, N, M, dh)
    ct = np.asarray(rng.randn(B, H, N, dh), np.float32)

    def scalar(q, k, v, b):
        o = jax_set_attention(q, k, v, b, mask, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * ct)

    want = jax.grad(scalar, argnums=(0, 1, 2, 3))(q, k, v, bias)
    tq, tk, tv, tb, tm = _t_inputs(q, k, v, bias, mask)
    leaves = [t.requires_grad_(True) for t in (tq, tk, tv, tb)]
    out = masked_set_attention(*leaves, tm)
    got = torch.autograd.grad(torch.sum(out.float() * torch.from_numpy(ct)),
                              leaves)
    for name, g, w, dt in zip(("dq", "dk", "dv", "dbias"), got, want,
                              (torch.bfloat16,) * 3 + (torch.float32,)):
        assert g.dtype == dt, name
        np.testing.assert_allclose(_np(g), _np(w), atol=5e-2, rtol=1e-3,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# one RWKV block, one MAB
# ---------------------------------------------------------------------------

def _block_inputs(d):
    rng = np.random.RandomState(2)
    return jnp.asarray(rng.randn(3, 19, d), jnp.bfloat16)


def test_rwkv_block_bf16_matches_jax(stage1):
    """One block at bf16 against JAX's compiled block (the Stage-1 scan
    compiles it): within MODULE_REL; the fp32 block on the same weights
    is not (test below)."""
    jcfg, params, _, enc, _ = stage1
    x = _block_inputs(jcfg.d_model)
    layer0 = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    want = jax.jit(lambda p, x: jrwkv.rwkv_block_apply(
        p, x, jcfg.num_heads, "scan"))(layer0, x)
    with torch.no_grad():
        got = enc.blocks[0](_bf16_tensor(x))
    assert got.dtype == torch.bfloat16
    assert _rel(_np(got), _np(want)) <= MODULE_REL


def test_rwkv_block_fp32_falls_outside_the_bound(stage1):
    jcfg, params, _, _, enc32 = stage1
    x = _block_inputs(jcfg.d_model)
    layer0 = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    want = jax.jit(lambda p, x: jrwkv.rwkv_block_apply(
        p, x, jcfg.num_heads, "scan"))(layer0, x)
    with torch.no_grad():
        got = enc32.blocks[0](torch.from_numpy(_np(x)))
    assert _rel(_np(got), _np(want)) > MODULE_REL


def _mab_case(stage2):
    jcfg, params, _, model, model32 = stage2
    rng = np.random.RandomState(9)
    B, N, d = 4, 24, jcfg.d_model
    xq = jnp.asarray(rng.randn(B, N, d), jnp.bfloat16)
    bias = jnp.asarray(rng.uniform(0, 1, (B, N)), jnp.float32)
    mask = rng.rand(B, N) > 0.3
    mask[:, 0] = True
    mab = params["set_transformer"]["sabs"][0]
    want = jst._mab_apply(mab, xq, xq, jcfg.num_heads, bias,
                          jnp.asarray(mask), "pallas_interpret")
    t = (_bf16_tensor(xq), torch.from_numpy(_np(bias)),
         torch.from_numpy(mask))
    return want, t, model.set_transformer.sabs[0], \
        model32.set_transformer.sabs[0]


def test_mab_bf16_matches_jax(stage2):
    """One SAB on bf16 activations through the set-attention plain
    version against JAX's `_mab_apply` through its kernel."""
    want, (x, bias, mask), mab, _ = _mab_case(stage2)
    with torch.no_grad():
        got = mab(x, x, bias, mask)
    assert got.dtype == torch.bfloat16
    assert _rel(_np(got), _np(want)) <= MODULE_REL


def test_mab_fp32_falls_outside_the_bound(stage2):
    want, (x, bias, mask), _, mab32 = _mab_case(stage2)
    with torch.no_grad():
        got = mab32(x.float(), x.float(), bias, mask)
    assert _rel(_np(got), _np(want)) > MODULE_REL


# ---------------------------------------------------------------------------
# encode_bbe
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def encoded(stage1):
    jcfg, params, _, enc, enc32 = stage1
    rng = np.random.RandomState(4)
    L = jcfg.max_len
    toks = rng.randint(1, 40, (8, L, 6)).astype(np.int32)
    toks[:, L - 9:] = 0
    toks[2, :] = 0                         # an all-pad row
    want = jbbe.encode_bbe(params, jcfg, jnp.asarray(toks),
                           impl="pallas_interpret")
    with torch.no_grad():
        got = encode_bbe(enc, torch.from_numpy(toks))
        got32 = encode_bbe(enc32, torch.from_numpy(toks))
    return want, got, got32


def test_encode_bbe_bf16_matches_jax(encoded):
    want, got, _ = encoded
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    atol, rel = ENCODE_BOUNDS
    assert np.abs(_np(got) - _np(want)).max() <= atol
    assert _rel(_np(got), _np(want)) <= rel


def test_encode_bbe_fp32_falls_outside_the_bound(encoded):
    """The fp32 encoder on the same bf16-valued weights is further from
    JAX's bf16 BBEs than the relative bound."""
    want, _, got32 = encoded
    assert _rel(_np(got32), _np(want)) > ENCODE_BOUNDS[1]


# ---------------------------------------------------------------------------
# Stage 2 on fp32 and on bf16 BBEs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def signed(stage2):
    jcfg, params, _, model, model32 = stage2
    rng = np.random.RandomState(5)
    B, N = 4, jcfg.max_set
    bbes = rng.randn(B, N, jcfg.bbe_dim).astype(np.float32)
    freqs = rng.uniform(1, 500, (B, N)).astype(np.float32)
    mask = rng.rand(B, N) > 0.4
    mask[:, 0] = True
    mask[3] = False                        # a padded, fully masked row
    out = {}
    for name, dt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        jb = jnp.asarray(bbes).astype(dt)
        want = jsig.signature_apply(params, jcfg, jb, jnp.asarray(freqs),
                                    jnp.asarray(mask),
                                    impl="pallas_interpret")
        tb = torch.from_numpy(_np(jb))
        args = (torch.from_numpy(freqs), torch.from_numpy(mask))
        with torch.no_grad():
            got = signature_apply(
                model, tb.to(torch.bfloat16) if name == "bf16" else tb, *args)
            got32 = signature_apply(model32, tb, *args)
        out[name] = (want, got, got32)
    return out


def test_stage2_on_fp32_bbes_matches_jax(signed):
    """fp32 BBEs on bf16 weights: JAX promotes every product to fp32, and
    so does the port: fp32 signatures and CPIs within 1e-5."""
    (sig_j, cpi_j), (sig, cpi), _ = signed["fp32"]
    assert sig.dtype == cpi.dtype == torch.float32
    assert sig_j.dtype == jnp.float32
    for got, want in ((sig, sig_j), (cpi, cpi_j)):
        np.testing.assert_allclose(_np(got), _np(want), atol=SIG_FP32_ATOL)


def test_stage2_in_bf16_on_fp32_bbes_falls_outside_the_bound(signed):
    """Computing in the weights' dtype instead of promoting (the BBEs
    cast to bf16) misses JAX's fp32 signatures by more than 1e-5."""
    (sig_j, _), _, _ = signed["fp32"]
    _, (sig, _), _ = signed["bf16"]
    assert np.abs(_np(sig) - _np(sig_j)).max() > SIG_FP32_ATOL


def test_stage2_on_bf16_bbes_matches_jax(signed):
    (sig_j, cpi_j), (sig, cpi), _ = signed["bf16"]
    assert sig.dtype == cpi.dtype == torch.bfloat16
    assert sig_j.dtype == jnp.bfloat16
    assert _rel(_np(sig), _np(sig_j)) <= SIG_BF16_REL
    assert _rel(_np(cpi), _np(cpi_j)) <= SIG_BF16_REL


def test_stage2_fp32_on_bf16_bbes_falls_outside_the_bound(signed):
    (sig_j, _), _, (sig32, _) = signed["bf16"]
    assert _rel(_np(sig32), _np(sig_j)) > SIG_BF16_REL


# ---------------------------------------------------------------------------
# the service end to end
# ---------------------------------------------------------------------------

def _world(asm, tr, pm):
    programs = asm.spec_programs("int")[:4]
    blocks = {b.bid: b for p in programs for b in p.unique_blocks}
    ivs = {p.name: tr.trace_program(p, 24, seed=0) for p in programs}
    cpis = {n: [pm.interval_cpi(iv, blocks) for iv in v]
            for n, v in ivs.items()}
    return programs, blocks, ivs, cpis


def test_service_bf16_end_to_end_labels_match_jax():
    """A JAX service and a port service at bf16 (the port's weights
    bridged from JAX's) over the same world: the port's signatures within
    the Stage-1 bound of JAX's, and, clustering JAX's signatures from
    JAX's seeds, the same labels, representatives and fingerprints."""
    K = 4
    batches = dict(encode_batch=64, signature_batch=32)
    programs, blocks, ivs, cpis = _world(asmgen, trace, perfmodel)
    _, jblocks, jivs, _ = _world(jasmgen, jtrace, jperfmodel)
    jpipe = JaxPipeline.create(jax.random.PRNGKey(0),
                               jbbe.BBEConfig(**TINY_BBE, dtype=BF16),
                               jsig.SignatureConfig(**TINY_SIG, dtype=BF16))
    pipe = SemanticBBVPipeline(
        bridge.bbe_params_from_jax(_tree(jpipe.bbe_params),
                                   BBEConfig(**TINY_BBE, dtype=BF16)),
        bridge.signature_params_from_jax(
            _tree(jpipe.sig_params), SignatureConfig(**TINY_SIG, dtype=BF16)),
        device="cpu")
    jsvc = JaxService.from_pipeline(jpipe, JaxServiceConfig(
        bbe=jpipe.bbe_cfg, sig=jpipe.sig_cfg, k=K, build_impl="device",
        **batches))
    svc = SemanticBBVService.from_pipeline(pipe, ServiceConfig(
        bbe=pipe.bbe_cfg, sig=pipe.sig_cfg, k=K, **batches))
    jsvc.ingest_blocks(list(jblocks.values()))
    svc.ingest_blocks(list(blocks.values()))
    names = [p.name for p in programs]
    for n in names:
        jsvc.ingest_intervals(n, jivs[n], cpis=cpis[n])
        svc.ingest_intervals(n, ivs[n], cpis=cpis[n])
    assert _rel(svc.store.signatures[:len(svc.store)],
                np.asarray(jsvc.store.signatures)[:len(jsvc.store)]) \
        <= ENCODE_BOUNDS[1]
    jsvc.build()
    seeds = np.stack([np.asarray(kmeans_pp_init_masked(
        jax.random.PRNGKey(r), jsvc.store.device_matrix, K,
        len(jsvc.store))) for r in range(3)])
    store = SignatureStore(jsvc.store.sig_dim, device="cpu")
    for n in names:
        rows = jsvc.store.rows_for(n)
        store.add(n, jsvc.store.signatures[rows], jsvc.store.weights[rows],
                  jsvc.store.cpis[rows])
    kb = KnowledgeBase(store).build(k=K, init_centroids=seeds)
    x = np.asarray(jsvc.store.signatures)[:len(jsvc.store)]
    np.testing.assert_array_equal(kb.assign(x)[0], jsvc.kb.assign(x)[0])
    np.testing.assert_array_equal(kb.rep_global_idx, jsvc.kb.rep_global_idx)
    for n in names:
        np.testing.assert_array_equal(kb.fingerprints[n],
                                      jsvc.kb.fingerprints[n])


# ---------------------------------------------------------------------------
# gradients per leaf
# ---------------------------------------------------------------------------

def _path_key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _jax_by_port_name(tree, num_layers=None):
    """JAX leaves keyed as the port names its parameters ("/"-joined,
    Stage-1 `blocks` unstacked)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = _path_key(path)
        if num_layers and key.startswith("blocks/"):
            for n in range(num_layers):
                out[f"blocks/{n}/{key[len('blocks/'):]}"] = leaf[n]
        else:
            out[key] = leaf
    return out


def _port_grads(model, loss):
    named = {k.replace(".", "/"): p for k, p in model.named_parameters()}
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    return dict(zip(named, grads)), named


def _leaf_errors(got, named, want):
    """{leaf: relative L2} of the port's gradients (each in its leaf's
    dtype, checked) against JAX's."""
    assert sorted(got) == sorted(want)
    errs = {}
    for key, g in got.items():
        assert g.dtype == named[key].dtype, key
        assert str(want[key].dtype) == str(named[key].dtype).split(".")[-1]
        w = _np(want[key])
        errs[key] = 0.0 if not w.any() and not _np(g).any() else \
            _rel(_np(g), w)
    return errs


def _expand_channels(params, B, S):
    """The Stage-1 tree with its per-channel leaves (the blocks' token-
    shift `mu`, `w_bias`, `ln_x` and norm scales, the final norm's scale)
    broadcast to one copy a token, (..., B, S, d). The model computes the
    same values, and JAX's gradient of each copy is one product, summed
    by `_fold_channels`."""
    def ex(a):
        return jnp.broadcast_to(a[..., None, None, :],
                                a.shape[:-1] + (B, S, a.shape[-1]))
    blocks = {k: dict(v) for k, v in params["blocks"].items()}
    for sub, keys in (("time_mix", ("mu", "w_bias", "ln_x")),
                      ("channel_mix", ("mu",)), ("norm1", ("scale",)),
                      ("norm2", ("scale",))):
        for k in keys:
            blocks[sub][k] = ex(blocks[sub][k])
    return dict(params, blocks=blocks,
                final_norm={"scale": ex(params["final_norm"]["scale"])})


def _fold_channels(grads, params):
    """Gradients of `_expand_channels`'s tree summed over the copies in
    fp32 and rounded once to the leaf's dtype (as the port sums them)."""
    def fold(g, p):
        if g.shape == p.shape:
            return g
        g = np.asarray(g, np.float32).reshape(p.shape[:-1] + (-1,
                                                              p.shape[-1]))
        return jnp.asarray(g.sum(-2)).astype(p.dtype)
    return jax.tree_util.tree_map(fold, grads, params)


def _check_grads(errs):
    """Every leaf within GRAD_REL, and the median leaf within MEDIAN_REL."""
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL, (worst, errs[worst])
    assert float(np.median(list(errs.values()))) <= MEDIAN_REL


@pytest.fixture(scope="module")
def stage1_grads(stage1):
    """The pre-training loss's gradients: JAX's (impl="scan": JAX cannot
    differentiate its wkv kernel) and the port's at bf16 and at fp32 on
    the same bf16-valued weights.

    JAX's reference is its eager evaluation, with the per-channel leaves
    summed in fp32 (`_expand_channels`): the scan over the blocks
    compiles even then, and XLA's compiled gradient of a bf16 broadcast
    sums it in bf16 (40,000 ones give 8,192), so JAX's own leaves of that
    kind (a token-shift `mu` 2.4e-2 from the port) move by up to 2.2e-2
    between its eager and jitted evaluations; the port sums them in fp32,
    as this reference does."""
    jcfg, params, _, enc, enc32 = stage1
    toks = SyntheticBinaryCorp(n_functions=40,
                               max_len=64).pretrain_batch(0, 4)["tokens"]
    fn = jax.grad(lambda p, x: jbbe.pretrain_loss(p, jcfg, x,
                                                   impl="scan")[0])
    eg = fn(_expand_channels(params, *toks.shape[:2]), jnp.asarray(toks))
    want = _jax_by_port_name(_fold_channels(eg, params), jcfg.num_layers)
    out = {}
    for name, model in (("bf16", enc), ("fp32", enc32)):
        loss, _ = pretrain_loss(model, {"tokens": torch.from_numpy(toks)})
        got, named = _port_grads(model, loss)
        if name == "fp32":       # the fp32 path's gradients are fp32
            want = {k: jnp.asarray(v).astype(jnp.float32)
                    for k, v in want.items()}
        out[name] = _leaf_errors(got, named, want)
    return out


def test_stage1_grads_per_leaf_match_jax(stage1_grads):
    """Every leaf's gradient in its dtype (bf16, fp32 for w_bias) within
    GRAD_REL of JAX's, the median leaf within MEDIAN_REL. Largest seen:
    1.55e-2 (an embedding table); median 5.9e-3."""
    _check_grads(stage1_grads["bf16"])


def test_stage1_grads_fp32_fall_outside_the_bound(stage1_grads):
    """The fp32 path on the same weights: largest 9.7e-2 (a time-mix
    `mu`), median 3.6e-2."""
    errs = stage1_grads["fp32"]
    assert max(errs.values()) > GRAD_REL
    assert float(np.median(list(errs.values()))) > MEDIAN_REL


def _stage2_sets(jcfg, dtype, seed=0):
    rng = np.random.RandomState(seed)
    B, N = 2, jcfg.max_set

    def one():
        b = rng.randn(B, N, jcfg.bbe_dim).astype(np.float32)
        f = rng.uniform(1, 500, (B, N)).astype(np.float32)
        m = rng.rand(B, N) > 0.4
        m[:, 0] = True
        return b, f, m

    sets = {r: one() for r in ("anchor", "positive", "negative")}
    cpi = rng.uniform(0.5, 3, (B,)).astype(np.float32)
    jb = {r: {"bbes": jnp.asarray(s[0]).astype(dtype),
              "freqs": jnp.asarray(s[1]), "mask": jnp.asarray(s[2])}
          for r, s in sets.items()}
    jb["cpi"] = jnp.asarray(cpi)
    tb = {r: {"bbes": torch.from_numpy(_np(jb[r]["bbes"])),
              "freqs": torch.from_numpy(s[1]), "mask": torch.from_numpy(s[2])}
          for r, s in sets.items()}
    tb["cpi"] = torch.from_numpy(cpi)
    return jb, tb


def test_stage2_grads_per_leaf_match_jax(stage2):
    """The Stage-2 loss on fp32 BBEs (the service's and the engine's
    path) with bf16 weights: every leaf's gradient bf16 and within
    GRAD_REL of JAX's (jitted, through its kernel's custom VJP); the
    same loss. Largest seen: 6.2e-3."""
    jcfg, params, _, model, _ = stage2
    jb, tb = _stage2_sets(jcfg, jnp.float32)
    (j_loss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jsig.stage2_loss(p, jcfg, b, impl="pallas_interpret"),
        has_aux=True))(params, jb)
    loss, _ = stage2_loss(model, model.cfg, tb)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    got, named = _port_grads(model, loss)
    errs = _leaf_errors(got, named, _jax_by_port_name(jg))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL, (worst, errs[worst])


@pytest.fixture(scope="module")
def stage2_bf16_grads(stage2):
    """Stage 2 on bf16 BBEs: JAX's eager loss and gradients (its eager
    reductions sum in fp32, as the port's do; its forward is the port's
    bit for bit) and the port's at bf16 and at fp32 on the same
    bf16-valued weights and BBEs."""
    jcfg, params, _, model, model32 = stage2
    jb, tb = _stage2_sets(jcfg, jnp.bfloat16)
    tb16 = {k: (dict(v, bbes=v["bbes"].to(torch.bfloat16)) if k != "cpi"
                else v) for k, v in tb.items()}
    (j_loss, _), jg = jax.value_and_grad(
        lambda p, b: jsig.stage2_loss(p, jcfg, b, impl="pallas_interpret"),
        has_aux=True)(params, jb)
    want = _jax_by_port_name(jg)
    out = {}
    for name, m, batch in (("bf16", model, tb16), ("fp32", model32, tb)):
        loss, _ = stage2_loss(m, m.cfg, batch)
        got, named = _port_grads(m, loss)
        w = want if name == "bf16" else {
            k: jnp.asarray(v).astype(jnp.float32) for k, v in want.items()}
        out[name] = (float(loss.detach()), _leaf_errors(got, named, w))
    return float(j_loss), out


def test_stage2_grads_on_bf16_bbes_match_jax(stage2_bf16_grads):
    """The same loss as JAX's, and every leaf's gradient (bf16) within
    GRAD_REL of JAX's, the median leaf within MEDIAN_REL. Largest seen:
    1.91e-2 (an ff2 bias, a sum whose terms cancel); median 9.1e-3."""
    j_loss, out = stage2_bf16_grads
    loss, errs = out["bf16"]
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    _check_grads(errs)


def test_stage2_grads_fp32_on_bf16_bbes_fall_outside_the_bound(
        stage2_bf16_grads):
    """The fp32 path on the same weights and BBEs: its median leaf is
    outside MEDIAN_REL (seen: 1.22e-2; largest leaf 1.98e-2, inside
    GRAD_REL, which alone cannot tell the two paths apart)."""
    _, out = stage2_bf16_grads
    errs = out["fp32"][1]
    assert float(np.median(list(errs.values()))) > MEDIAN_REL


# ---------------------------------------------------------------------------
# Trainer and Stage2Engine steps
# ---------------------------------------------------------------------------

def _close(got, want, rtol, msg=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7, err_msg=msg)


def test_trainer_bf16_steps_match_jax(stage1, tmp_path):
    """Three pre-training steps of the port Trainer on the bf16 encoder
    (AdamW in fp32, bf16 leaves written back) beside JAX's Trainer: the
    same losses (1e-3) and learning rates; the first step's gradient norm
    within GRAD_REL. Later norms are not compared: from the second step
    the two runs hold weights a bf16 rounding apart, and at those two
    weight sets JAX's own gradient norms differ by 10-20% (the port's and
    JAX's gradients at the same weights agree within GRAD_REL per
    leaf). The leaves stay bf16 (w_bias fp32)."""
    jcfg, params, specs, _, _ = stage1
    enc = bridge.bbe_params_from_jax(_tree(params),
                                     BBEConfig(**TINY_BBE, dtype=BF16))
    corp = SyntheticBinaryCorp(n_functions=40, max_len=64)
    jcorp = JaxCorp(n_functions=40, max_len=64)
    tc = dict(learning_rate=2e-3, total_steps=5, warmup_steps=2,
              checkpoint_every=0)
    tr = Trainer(pretrain_loss, enc, TrainConfig(
        **tc, checkpoint_dir=str(tmp_path / "p")))
    # JAX's Trainer donates the buffers of the tree it is given: a copy
    jtr = JaxTrainer(lambda p, b: jbbe.pretrain_loss(p, jcfg, b["tokens"]),
                     jax.tree_util.tree_map(jnp.array, params), specs,
                     JaxTrainConfig(**tc,
                                    checkpoint_dir=str(tmp_path / "j")))
    for s in range(3):
        m = tr.step({"tokens": torch.from_numpy(
            corp.pretrain_batch(s, 4)["tokens"])})
        jm = jtr.step({"tokens": jnp.asarray(
            jcorp.pretrain_batch(s, 4)["tokens"])})
        _close(m["loss"], jm["loss"], 1e-3, f"step {s} loss")
        _close(m["lr"], jm["lr"], 1e-6, f"step {s} lr")
        if s == 0:
            _close(m["grad_norm"], jm["grad_norm"], GRAD_REL, "norm")
    assert {str(p.dtype) for p in enc.parameters()} == {
        "torch.bfloat16", "torch.float32"}
    assert enc.blocks[0].time_mix.w_bias.dtype == torch.float32


def _iv_world(n_blocks=64, n_intervals=24, seed=0, bbe_dim=32):
    from repro.data.trace import Interval as JaxInterval
    from repro_torch.data.trace import Interval
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


def test_stage2_engine_bf16_steps_match_jax(stage2, tmp_path):
    """Three steps of the port's Stage2Engine on bf16 weights and the fp32
    BBE matrix beside JAX's engine (impl "pallas_interpret"): the same
    losses and learning rates, gradient norms within GRAD_REL."""
    jcfg, params, specs, _, _ = stage2
    model = bridge.signature_params_from_jax(
        _tree(params), SignatureConfig(**TINY_SIG, dtype=BF16))
    table, ivs, jivs = _iv_world()
    index, jindex = BBEIndex(table), JaxBBEIndex(table)
    tc = dict(learning_rate=1e-3, total_steps=3, warmup_steps=1,
              checkpoint_every=0)
    eng = Stage2Engine(model.cfg, model, index.ext, TrainConfig(
        **tc, checkpoint_dir=str(tmp_path / "p")))
    jeng = JaxStage2Engine(jcfg, jax.tree_util.tree_map(jnp.array, params),
                           specs, jindex.ext, JaxTrainConfig(
                               **tc, checkpoint_dir=str(tmp_path / "j")),
                           impl="pallas_interpret")
    for s in range(3):
        rng = np.random.RandomState(1000 + s)
        idx = {k: rng.randint(len(ivs), size=4)
               for k in ("anchor", "positive", "negative")}
        cpis = rng.uniform(0.5, 4.0, 4)
        m = eng.step(triplet_row_batch(
            {k: [ivs[i] for i in v] for k, v in idx.items()}, cpis, index,
            jcfg.max_set, device="cpu"))
        jm = jeng.step(jax_triplet_row_batch(
            {k: [jivs[i] for i in v] for k, v in idx.items()}, cpis, jindex,
            jcfg.max_set))
        for k in ("loss", "triplet", "cpi_reg", "consistency"):
            _close(m[k], jm[k], 1e-3, f"step {s} {k}")
        _close(m["lr"], jm["lr"], 1e-6, f"step {s} lr")
        _close(m["grad_norm"], jm["grad_norm"], GRAD_REL, f"step {s} norm")
    assert all(p.dtype == torch.bfloat16 for p in eng.params.values())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_stage1_bf16_checkpoints_cross_both_ways(stage1, tmp_path):
    """A port Stage-1 checkpoint of bf16 leaves restores bitwise in JAX's
    reader (the port records "bfloat16"); JAX's (bf16 leaves stored as
    their uint16 bits, recorded "uint16") restores bitwise in the port;
    a bf16 checkpoint into an fp32 config raises TypeError."""
    jcfg, params, _, enc, _ = stage1
    path = bridge.save_bbe_checkpoint(enc, str(tmp_path / "p"), step=2)
    jtree, step, _ = jckpt.restore_checkpoint(path, {"params": params})
    assert step == 2
    for key, leaf in _jax_by_port_name(jtree["params"],
                                       jcfg.num_layers).items():
        t = dict(enc.named_parameters())[key.replace("/", ".")]
        assert str(leaf.dtype) == str(t.dtype).split(".")[-1], key
        np.testing.assert_array_equal(_np(leaf), _np(t), err_msg=key)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 5, {"params": params})
    model = bridge.bbe_params_from_checkpoint(
        jpath, BBEConfig(**TINY_BBE, dtype=BF16))
    want = _jax_by_port_name(params, jcfg.num_layers)
    for key, t in model.state_dict().items():
        assert torch.equal(t, torch.from_numpy(
            np.asarray(want[key.replace(".", "/")]).view(np.int16)).view(
                torch.bfloat16) if t.dtype == torch.bfloat16 else
            torch.from_numpy(np.asarray(want[key.replace(".", "/")]))), key
    with pytest.raises(TypeError, match="bfloat16|uint16"):
        bridge.bbe_params_from_checkpoint(jpath, BBEConfig(**TINY_BBE))


def test_stage2_bf16_checkpoints_cross_both_ways(stage2, tmp_path):
    jcfg, params, _, model, _ = stage2
    path = bridge.save_signature_checkpoint(model, str(tmp_path / "p"),
                                            step=1)
    jtree, _, _ = jckpt.restore_checkpoint(path, {"params": params})
    for key, leaf in _jax_by_port_name(jtree["params"]).items():
        assert leaf.dtype == jnp.bfloat16, key
        np.testing.assert_array_equal(
            _np(leaf), _np(dict(model.named_parameters())[
                key.replace("/", ".")]), err_msg=key)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 3, {"params": params})
    back = bridge.signature_params_from_checkpoint(
        jpath, SignatureConfig(**TINY_SIG, dtype=BF16))
    for (k, a), (_, b) in zip(back.state_dict().items(),
                              model.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(TypeError, match="bfloat16|uint16"):
        bridge.signature_params_from_checkpoint(path, SignatureConfig(
            **TINY_SIG))


def test_bf16_trainer_checkpoint_restores_in_jax(stage1, tmp_path):
    """The port Trainer's bf16 checkpoint (params bf16, AdamW moments
    fp32, `blocks` stacked) restores in JAX's reader with a bf16
    `bbe_init` template, values equal."""
    jcfg, params, _, _, _ = stage1
    enc = bridge.bbe_params_from_jax(_tree(params),
                                     BBEConfig(**TINY_BBE, dtype=BF16))
    tr = Trainer(pretrain_loss, enc, TrainConfig(
        learning_rate=2e-3, total_steps=2, warmup_steps=1,
        checkpoint_every=0, checkpoint_dir=str(tmp_path)))
    toks = SyntheticBinaryCorp(n_functions=40,
                               max_len=64).pretrain_batch(0, 4)["tokens"]
    tr.step({"tokens": torch.from_numpy(toks)})
    path = tr.maybe_checkpoint(force=True)
    jtree, step, _ = jckpt.restore_checkpoint(
        path, {"params": params, "opt": jopt.adamw_init(params)})
    assert step == 1
    got = _jax_by_port_name(jtree["params"], jcfg.num_layers)
    for key, p in tr.state.params.items():
        assert str(got[key].dtype) == str(p.dtype).split(".")[-1], key
        np.testing.assert_array_equal(_np(got[key]), _np(p), err_msg=key)
    moments = _jax_by_port_name(jtree["opt"]["m"], jcfg.num_layers)
    for key, m in tr.state.opt_state["m"].items():
        assert moments[key].dtype == jnp.float32
        np.testing.assert_array_equal(_np(moments[key]), m.numpy(),
                                      err_msg=key)
    assert ckpt.latest_checkpoint(str(tmp_path)) == path

"""The port's encoder-decoder (whisper-tiny) on the CPU against the JAX
package: the encoder, cross-attention, `Model.prefill` with frames, the
cross caches and the decode step's cross term, the ServeEngine and the
bridge's encoder unstacking, at fp32 under `scaled_down`, on the same
(bridged) weights. JAX's kernel path cannot run a ragged frame count
(its flash kernel needs block-divisible lengths), so the port is held to
`impl="chunked"` and `impl="ref"`."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCH = "whisper_tiny"
SMALL = dict(num_layers=2, d_model=48, num_heads=4, num_kv_heads=2, d_ff=96,
             vocab_size=96)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(tree, seed):
    """Every leaf moved off its init (zero biases, unit norm scales), so a
    wrongly wired bias or scale shows."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32)
                   + 0.05 * rng.randn(*x.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def whisper():
    """(JAX cfg, port cfg, JAX model, JAX params, numpy tree, port LM) on
    the same perturbed weights, fp32; 2 encoder and 2 decoder layers."""
    jcfg = jconfig.scaled_down(jconfig.get_arch(ARCH), **SMALL)
    tcfg = tconfig.scaled_down(tconfig.get_arch(ARCH), **SMALL)
    jmodel = jax_build_model(jcfg)
    params, _ = jmodel.init(jax.random.PRNGKey(2))
    tree = _perturbed(_np_tree(params), 5)
    return (jcfg, tcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, tree),
            tree, bridge.lm_params_from_jax(tree, tcfg))


def _frames(B, T, d, seed=0):
    return np.random.RandomState(seed).randn(B, T, d).astype(np.float32)


# ---------------------------------------------------------------------------
# config, parameters, bridge
# ---------------------------------------------------------------------------

def test_param_count_matches_jax():
    """36,464,256 at full width and depth, from shapes alone."""
    want = jax_build_model(jconfig.get_arch(ARCH)).param_count()
    assert want == 36_464_256
    assert build_model(tconfig.get_arch(ARCH)).param_count() == want


def test_blocks_have_cross_attention_without_bias(whisper):
    """Decoder blocks hold cross_norm and cross, the latter without qkv
    bias or qk norm although the config sets qkv_bias; encoder blocks
    have no cross-attention."""
    jcfg, tcfg, _, _, _, lm = whisper
    assert tcfg.qkv_bias and len(lm.encoder.layers) == tcfg.encoder_layers
    for block in lm.layers:
        assert block.cross is not None and not block.cross.qkv_bias
        assert not hasattr(block.cross, "bq") and block.mixer.qkv_bias
    for block in lm.encoder.layers:
        assert block.cross is None and block.cross_norm is None
        assert block.mixer.qkv_bias and block.mlp is not None


def test_bridge_unstacks_the_encoder(whisper):
    """encoder/layers leaves carry a leading encoder_layers axis: layer i
    gets index i; a wrong leading axis raises."""
    _, tcfg, _, _, tree, lm = whisper
    enc = tree["encoder"]
    for i, block in enumerate(lm.encoder.layers):
        np.testing.assert_array_equal(block.mixer.wq.detach().numpy(),
                                      enc["layers"]["mixer"]["wq"][i])
        np.testing.assert_array_equal(block.mlp.wi.detach().numpy(),
                                      enc["layers"]["mlp"]["wi"][i])
    np.testing.assert_array_equal(lm.encoder.norm.scale.detach().numpy(),
                                  enc["norm"]["scale"])
    np.testing.assert_array_equal(lm.layers[1].cross.wk.detach().numpy(),
                                  tree["layers"]["p0"]["cross"]["wk"][1])
    bad = jax.tree_util.tree_map(lambda x: x, tree)
    bad["encoder"]["layers"] = jax.tree_util.tree_map(
        lambda x: x[:1], tree["encoder"]["layers"])
    with pytest.raises(ValueError, match="encoder_layers"):
        bridge.lm_params_from_jax(bad, tcfg)
    bad = jax.tree_util.tree_map(lambda x: x, tree)
    del bad["encoder"]["norm"]
    with pytest.raises(KeyError):
        bridge.lm_params_from_jax(bad, tcfg)


# ---------------------------------------------------------------------------
# attention and the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,T,use_rope", [(7, 13, False), (20, 9, False),
                                          (11, 16, True)])
def test_cross_attn_apply_matches_jax(S, T, use_rope):
    """attn_apply with kv_x of another length (kv positions arange(T)),
    full mask, against JAX's ref and chunked paths."""
    d, H, K, hd = 32, 4, 2, 8
    params, _ = jattn.attn_init(jax.random.PRNGKey(S), d, H, K, hd,
                                jnp.float32, qkv_bias=True)
    tree = _perturbed(_np_tree(params), S)
    mod = tattn.Attention(torch.Generator().manual_seed(0), d, H, K, hd,
                          torch.float32, qkv_bias=True)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()})
    rng = np.random.RandomState(T)
    x = rng.randn(2, S, d).astype(np.float32)
    mem = rng.randn(2, T, d).astype(np.float32)
    kw = dict(num_heads=H, num_kv_heads=K, head_dim=hd, mask_mode="full",
              use_rope=use_rope)
    got = tattn.attn_apply(mod, torch.from_numpy(x),
                           kv_x=torch.from_numpy(mem), **kw)
    assert tuple(got.shape) == (2, S, d)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    for impl in ("ref", "chunked"):
        want = jattn.attn_apply(jp, jnp.asarray(x), kv_x=jnp.asarray(mem),
                                impl=impl, **kw)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-4, err_msg=impl)


@pytest.mark.parametrize("T", [16, 13])
def test_encoder_apply_matches_jax(whisper, T):
    """The encoder at an even and a ragged frame count."""
    jcfg, tcfg, _, jparams, _, lm = whisper
    frames = _frames(2, T, tcfg.d_model, T)
    with torch.no_grad():
        got = ttfm.encoder_apply(lm, tcfg, torch.from_numpy(frames))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, T, 48)
    for impl in ("chunked", "ref"):
        want = jtfm.encoder_apply(jparams, jcfg, jnp.asarray(frames), impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4, err_msg=impl)


def test_prefill_with_frames_matches_jax(whisper):
    """`Model.prefill` with tokens and frames (hidden states), and
    `lm_apply`'s logits over the encoder's output."""
    jcfg, tcfg, jmodel, jparams, _, lm = whisper
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, tcfg.vocab_size, (2, 11)).astype(np.int32)
    frames = _frames(2, 13, tcfg.d_model, 4)
    batch = {"tokens": tokens, "frames": frames}
    hidden, aux = build_model(tcfg).prefill(lm, batch)
    assert tuple(hidden.shape) == (2, 11, 48) and float(aux) == 0.0
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for impl in ("chunked", "ref"):
        want, _ = jmodel.prefill(jparams, jbatch, impl=impl)
        np.testing.assert_allclose(hidden.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4, err_msg=impl)
    with torch.no_grad():
        mem = ttfm.encoder_apply(lm, tcfg, torch.from_numpy(frames))
        logits, _ = ttfm.lm_apply(lm, tcfg, torch.from_numpy(tokens),
                                  enc_memory=mem)
    jmem = jtfm.encoder_apply(jparams, jcfg, jnp.asarray(frames), "ref")
    want, _ = jtfm.lm_apply(jparams, jcfg, jnp.asarray(tokens), impl="ref",
                            enc_memory=jmem)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# decode: the cross caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("enc_len,dtype", [(None, "float32"),
                                           (13, "float32"),
                                           (7, "bfloat16")])
def test_init_cache_matches_eval_shape(whisper, enc_len, dtype):
    """Leaf for leaf the shapes and dtypes of JAX's `init_cache`, ck/cv
    included (enc_len 1500 by default), all zero."""
    _, tcfg, jmodel, _, _, _ = whisper
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.eval_shape(lambda: jmodel.init_cache(3, 10, jd, enc_len)[0])
    got = build_model(tcfg).init_cache(3, 10, td, device="cpu",
                                       enc_len=enc_len)
    assert set(got) == set(want)
    for name, leaves in want.items():
        assert set(got[name]) == set(leaves) == {"k", "v", "ck", "cv"}
        for key, leaf in leaves.items():
            t = got[name][key]
            assert tuple(t.shape) == tuple(leaf.shape), (name, key)
            assert str(t.dtype).split(".")[-1] == str(leaf.dtype)
            assert not t.any()
    assert got["p0"]["ck"].shape[2] == (enc_len or 1500)


def _filled_cross(lm, tcfg, tree, mem, cache_np):
    """ck/cv of every layer from the encoder output `mem` (B, T, d) as
    tests/test_models.py fills JAX's: mem @ cross.wk / wv, no bias,
    written at the start of the enc_len axis."""
    B, T = mem.shape[:2]
    K, hd = tcfg.num_kv_heads, tcfg.resolved_head_dim
    lp = tree["layers"]["p0"]["cross"]
    for key, w in (("ck", lp["wk"]), ("cv", lp["wv"])):
        val = np.einsum("bsd,ldk->lbsk", mem, w).reshape(-1, B, T, K, hd)
        cache_np["p0"][key][:, :, :T] = val


@pytest.mark.parametrize("filled", [False, True])
def test_decode_steps_match_jax(whisper, filled):
    """Four decode steps with per-row positions over random self-attention
    caches and cross caches of zeros (as JAX leaves them) or filled from
    the encoder's output: logits and every cache leaf."""
    jcfg, tcfg, jmodel, jparams, tree, lm = whisper
    model = build_model(tcfg)
    rng = np.random.RandomState(11 + filled)
    B, T, enc_len = 3, 12, 16
    jcache, _ = jmodel.init_cache(B, T, jnp.float32, enc_len)
    init = {n: {k: np.zeros(v.shape, np.float32) for k, v in lv.items()}
            for n, lv in jcache.items()}
    for leaves in init.values():
        for key in ("k", "v"):
            leaves[key][:] = 0.3 * rng.randn(*leaves[key].shape)
    if filled:
        frames = _frames(B, 13, tcfg.d_model, 6)
        mem = np.asarray(jtfm.encoder_apply(jparams, jcfg,
                                            jnp.asarray(frames), "ref"))
        _filled_cross(lm, tcfg, tree, mem, init)
        assert np.abs(init["p0"]["ck"]).max() > 0.1
    jcache = jax.tree_util.tree_map(jnp.asarray, init)
    cache = model.init_cache(B, T, torch.float32, device="cpu",
                             enc_len=enc_len)
    for name, leaves in cache.items():
        for key in leaves:
            leaves[key].copy_(torch.from_numpy(init[name][key]))
    pos = np.array([0, 3, 5], np.int32)
    for step in range(4):
        tok = rng.randint(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        want, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                          jnp.asarray(pos))
        got, cache = model.decode_step(lm, cache, torch.from_numpy(tok),
                                       torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {step}")
        pos = pos + 1
    for name, leaves in cache.items():
        for key, leaf in leaves.items():
            np.testing.assert_allclose(leaf.numpy(),
                                       np.asarray(jcache[name][key]),
                                       atol=1e-5, rtol=1e-4)


def test_filled_decode_follows_the_prefill(whisper):
    """With ck/cv filled from the encoder's output, token-by-token decode
    from an empty cache gives the logits of the teacher-forced prefill
    over the same frames (the check of tests/test_models.py, held here at
    fp32 closeness)."""
    jcfg, tcfg, jmodel, jparams, tree, lm = whisper
    model = build_model(tcfg)
    B, S, T = 2, 8, 13
    rng = np.random.RandomState(8)
    tokens = rng.randint(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    frames = _frames(B, T, tcfg.d_model, 9)
    with torch.no_grad():
        mem = ttfm.encoder_apply(lm, tcfg, torch.from_numpy(frames))
        want, _ = ttfm.lm_apply(lm, tcfg, torch.from_numpy(tokens),
                                enc_memory=mem)
    cache = model.init_cache(B, S, torch.float32, device="cpu", enc_len=T)
    init = {n: {k: v.numpy().copy() for k, v in lv.items()}
            for n, lv in cache.items()}
    _filled_cross(lm, tcfg, tree, mem.numpy(), init)
    for name, leaves in cache.items():
        for key in leaves:
            leaves[key].copy_(torch.from_numpy(init[name][key]))
    for t in range(S):
        got, cache = model.decode_step(lm, cache, tokens[:, t:t + 1], t)
        np.testing.assert_allclose(got[:, 0].numpy(), want[:, t].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=f"t {t}")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _outs(engine_cls, request_cls, model, params, requests, **kw):
    if engine_cls is ServeEngine:
        kw["device"] = "cpu"
    eng = engine_cls(model, params, **kw)
    for rid, prompt, max_new in requests:
        eng.submit(request_cls(rid=rid, prompt=list(prompt), max_new=max_new))
    return {r: list(req.out) for r, req in eng.run().items()}


@pytest.mark.parametrize("use_prefill", [True, False])
def test_serve_engine_matches_jax(whisper, use_prefill):
    """The same token lists as JAX's engine (5 requests on 2 slots, mid-
    run refills); the cross caches stay zero, as in JAX."""
    _, tcfg, jmodel, jparams, _, lm = whisper
    rng = np.random.RandomState(4)
    requests = [(i, rng.randint(0, tcfg.vocab_size, 2 + 3 * i).tolist(), 5)
                for i in range(5)]
    kw = dict(num_slots=2, max_seq=32, use_prefill=use_prefill)
    got = _outs(ServeEngine, Request, build_model(tcfg), lm, requests, **kw)
    want = _outs(JServeEngine, JRequest, jmodel, jparams, requests, **kw)
    assert got == want and sorted(got) == list(range(5))


def test_scaled_down_keeps_the_family():
    """`scaled_down` keeps the encoder (at most 2 layers), the cross-
    attention and the frontend, as JAX's does."""
    for layers in (1, 3):
        got = tconfig.scaled_down(tconfig.get_arch(ARCH), num_layers=layers)
        want = jconfig.scaled_down(jconfig.get_arch(ARCH), num_layers=layers)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.encoder_layers == 2 and got.cross_attention

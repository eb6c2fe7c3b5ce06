"""The port's prefix-LM (paligemma-3b) on the CPU against the JAX package:
the prefix mask in `attn_apply`, `lm_apply` / `Model.prefill` with patch
embeddings, patches on a config that is no prefix-LM, decode steps and
the ServeEngine, at fp32 under `scaled_down`, on the same (bridged)
weights. JAX's kernel path drops the prefix rule (its flash kernel takes
causal or full only), so the port is held to `impl="ref"` and
`impl="chunked"`, whose mask bias carries it."""
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
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCH = "paligemma_3b"
# 8 query heads over 1 kv head, as paligemma's
SMALL = dict(num_layers=2, d_model=64, num_heads=8, num_kv_heads=1, d_ff=96,
             vocab_size=96)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32)
                   + 0.05 * rng.randn(*x.shape)).astype(np.float32), tree)


def _pair(arch, seed, **kw):
    """(JAX cfg, port cfg, JAX model, JAX params, port LM) on the same
    perturbed weights, fp32."""
    jcfg = jconfig.scaled_down(jconfig.get_arch(arch), **kw)
    tcfg = tconfig.scaled_down(tconfig.get_arch(arch), **kw)
    jmodel = jax_build_model(jcfg)
    params, _ = jmodel.init(jax.random.PRNGKey(seed))
    tree = _perturbed(_np_tree(params), seed)
    return (jcfg, tcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.lm_params_from_jax(tree, tcfg))


@pytest.fixture(scope="module")
def pali():
    return _pair(ARCH, 3, **SMALL)


def _inputs(cfg, B, P, S, seed):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.randn(B, P, cfg.d_model).astype(np.float32)
    return tokens, patches


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

def test_param_count_matches_jax():
    """2,508,662,784 at full width and depth, from shapes alone."""
    want = jax_build_model(jconfig.get_arch(ARCH)).param_count()
    assert want == 2_508_662_784
    assert build_model(tconfig.get_arch(ARCH)).param_count() == want


def test_scaled_down_keeps_the_family():
    got = tconfig.scaled_down(tconfig.get_arch(ARCH), **SMALL)
    want = jconfig.scaled_down(jconfig.get_arch(ARCH), **SMALL)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.prefix_lm and got.num_prefix_embeddings == 16
    assert got.frontend == "vision_patches" and not got.cross_attention


# ---------------------------------------------------------------------------
# the prefix mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,P,window", [(24, 0, 0), (24, 9, 0), (24, 30, 0),
                                        (31, 12, 5), (17, 17, 0)])
def test_attn_apply_prefix_matches_jax(S, P, window):
    """attn_apply(mask_mode="prefix") with 8 query heads over 1 kv head
    against JAX's ref and chunked paths: no prefix, a prefix inside the
    sequence, one past its end, with a window, and exactly S."""
    d, H, K, hd = 32, 8, 1, 8
    params, _ = jattn.attn_init(jax.random.PRNGKey(S + P), d, H, K, hd,
                                jnp.float32, qk_norm=True)
    tree = _perturbed(_np_tree(params), P)
    mod = tattn.Attention(torch.Generator().manual_seed(0), d, H, K, hd,
                          torch.float32, qk_norm=True)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()})
    x = np.random.RandomState(S).randn(2, S, d).astype(np.float32)
    kw = dict(num_heads=H, num_kv_heads=K, head_dim=hd, mask_mode="prefix",
              prefix_len=P, window=window, qk_norm=True)
    got = tattn.attn_apply(mod, torch.from_numpy(x), **kw).detach().numpy()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    for impl in ("ref", "chunked"):
        want = jattn.attn_apply(jp, jnp.asarray(x), impl=impl, **kw)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=1e-4, err_msg=impl)
    if P == 0:      # no prefix: the causal mask
        causal = tattn.attn_apply(mod, torch.from_numpy(x),
                                  **dict(kw, mask_mode="causal"))
        np.testing.assert_array_equal(got, causal.detach().numpy())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,S", [(16, 21), (5, 9)])
def test_prefill_with_patches_matches_jax(pali, P, S):
    """`Model.prefill` with tokens and patches: hidden (B, P + S, d)
    against JAX's ref and chunked paths; `lm_apply`'s logits."""
    jcfg, tcfg, jmodel, jparams, lm = pali
    tokens, patches = _inputs(tcfg, 2, P, S, P + S)
    hidden, aux = build_model(tcfg).prefill(
        lm, {"tokens": tokens, "patches": patches})
    assert tuple(hidden.shape) == (2, P + S, tcfg.d_model)
    assert float(aux) == 0.0
    jbatch = {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)}
    for impl in ("ref", "chunked"):
        want, _ = jmodel.prefill(jparams, jbatch, impl=impl)
        np.testing.assert_allclose(hidden.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4, err_msg=impl)
    with torch.no_grad():
        logits, _ = ttfm.lm_apply(lm, tcfg, torch.from_numpy(tokens),
                                  prefix_embeds=torch.from_numpy(patches))
    want, _ = jtfm.lm_apply(jparams, jcfg, jnp.asarray(tokens), impl="ref",
                            prefix_embeds=jnp.asarray(patches))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_prefix_rows_see_the_whole_prefix(pali):
    """The prefix is bidirectional: changing the last patch moves the
    first patch's hidden state (it would not under a causal mask); the
    text stays causal: changing the last token leaves every other row
    as it was."""
    _, tcfg, _, _, lm = pali
    tokens, patches = _inputs(tcfg, 1, 6, 5, 1)
    model = build_model(tcfg)
    base, _ = model.prefill(lm, {"tokens": tokens, "patches": patches})
    moved = patches.copy()
    moved[:, -1] += 1.0
    other, _ = model.prefill(lm, {"tokens": tokens, "patches": moved})
    assert (base[:, 0] - other[:, 0]).abs().max() > 1e-3
    later = tokens.copy()
    later[:, -1] = (later[:, -1] + 1) % tcfg.vocab_size
    third, _ = model.prefill(lm, {"tokens": later, "patches": patches})
    assert torch.equal(third[:, :-1], base[:, :-1])


def test_patches_on_a_causal_config_match_jax():
    """Patches given to a config that is no prefix-LM are concatenated
    ahead of the text all the same, under the causal mask, as in JAX."""
    jcfg, tcfg, jmodel, jparams, lm = _pair(
        "smollm_135m", 4, num_layers=2, d_model=32, num_heads=4, d_ff=64,
        vocab_size=64)
    assert not tcfg.prefix_lm
    tokens, patches = _inputs(tcfg, 2, 4, 7, 2)
    hidden, _ = build_model(tcfg).prefill(
        lm, {"tokens": tokens, "patches": patches})
    jbatch = {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)}
    for impl in ("ref", "chunked"):
        want, _ = jmodel.prefill(jparams, jbatch, impl=impl)
        np.testing.assert_allclose(hidden.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4, err_msg=impl)
    # causal: the first patch sees only itself
    moved = patches.copy()
    moved[:, 1:] += 1.0
    other, _ = build_model(tcfg).prefill(
        lm, {"tokens": tokens, "patches": moved})
    assert torch.equal(other[:, 0], hidden[:, 0])


def test_decode_steps_match_jax(pali):
    """Four text-only decode steps (the decode step has no prefix) with
    per-row positions over random caches: logits and caches."""
    jcfg, tcfg, jmodel, jparams, lm = pali
    model = build_model(tcfg)
    rng = np.random.RandomState(12)
    B, T = 3, 12
    jcache, _ = jmodel.init_cache(B, T, jnp.float32)
    init = jax.tree_util.tree_map(
        lambda c: (0.3 * rng.randn(*c.shape)).astype(np.float32), jcache)
    jcache = jax.tree_util.tree_map(jnp.asarray, init)
    cache = model.init_cache(B, T, torch.float32, device="cpu")
    assert set(cache["p0"]) == {"k", "v"}
    assert tuple(cache["p0"]["k"].shape) == (2, B, T, 1, 8)
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


def test_serve_engine_matches_jax(pali):
    """The same token lists as JAX's engine: 5 requests on 2 slots."""
    _, tcfg, jmodel, jparams, lm = pali
    rng = np.random.RandomState(6)
    requests = [(i, rng.randint(0, tcfg.vocab_size, 3 + 2 * i).tolist(), 5)
                for i in range(5)]
    outs = []
    for cls, req_cls, model, params, extra in (
            (ServeEngine, Request, build_model(tcfg), lm, {"device": "cpu"}),
            (JServeEngine, JRequest, jmodel, jparams, {})):
        eng = cls(model, params, num_slots=2, max_seq=32, **extra)
        for rid, prompt, max_new in requests:
            eng.submit(req_cls(rid=rid, prompt=list(prompt), max_new=max_new))
        outs.append({r: list(q.out) for r, q in eng.run().items()})
    assert outs[0] == outs[1] and sorted(outs[0]) == list(range(5))


def test_cpu_prefill_with_patches_launches_no_kernel(pali):
    _, tcfg, _, _, lm = pali
    before = flash_attention.launches
    tokens, patches = _inputs(tcfg, 1, 3, 4, 0)
    build_model(tcfg).prefill(lm, {"tokens": tokens, "patches": patches})
    assert flash_attention.launches == before == 0

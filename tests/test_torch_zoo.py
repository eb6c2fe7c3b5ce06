"""The port's LM zoo (dense decoders) on the CPU against the JAX package:
configs, layers, attention, prefill and decode from bridged weights, at
fp32 under `scaled_down` (bf16 rounds at other places in the two
frameworks; the kernel's bf16 bound is held in test_torch_kernels.py).
The encoder-decoder and the prefix-LM have files of their own
(test_torch_encdec.py, test_torch_prefix_lm.py)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
DENSE = ["smollm_135m", "granite_3_2b", "qwen2_7b", "qwen3_4b"]
RECURRENT = ["semanticbbv_encoder", "xlstm_1_3b"]   # test_torch_recurrent.py
MOE = ["qwen3_moe_235b_a22b", "grok_1_314b",         # test_torch_moe.py
       "jamba_1_5_large_398b"]
MODAL = ["whisper_tiny", "paligemma_3b"]   # test_torch_{encdec,prefix_lm}.py
SMALL = dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
             vocab_size=128)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(tree, seed):
    """The tree with every leaf moved off its init (zero biases, unit norm
    scales), so a wrongly wired bias or scale shows."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32)
                   + 0.05 * rng.randn(*x.shape)).astype(np.float32), tree)


def _configs(arch, **kw):
    return (jconfig.scaled_down(jconfig.get_arch(arch), **kw),
            tconfig.scaled_down(tconfig.get_arch(arch), **kw))


@pytest.fixture(scope="module", params=DENSE)
def zoo(request):
    """(arch, JAX cfg, port cfg, JAX model, JAX params, port module) on
    the same perturbed weights, fp32."""
    jcfg, tcfg = _configs(request.param, **SMALL)
    jmodel = jax_build_model(jcfg)
    params, _ = jmodel.init(jax.random.PRNGKey(1))
    tree = _perturbed(_np_tree(params), 7)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return (request.param, jcfg, tcfg, jmodel, jparams,
            bridge.lm_params_from_jax(tree, tcfg))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE + MODAL)
def test_config_copies_match_jax(arch):
    want = dataclasses.asdict(jconfig.get_arch(arch))
    got = dataclasses.asdict(tconfig.get_arch(arch.replace("_", "-")))
    assert got == want
    jc, tc = _configs(arch, num_layers=2, d_model=48, num_heads=6)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.resolved_head_dim == jc.resolved_head_dim


def test_config_fields_and_shapes_match_jax():
    for name in ("ModelConfig", "MoEConfig", "ShapeConfig", "TrainConfig"):
        fields = [(f.name, f.default) for f in
                  dataclasses.fields(getattr(jconfig, name))]
        assert [(f.name, f.default) for f in dataclasses.fields(
            getattr(tconfig, name))] == fields, name
    assert sorted(tconfig.PORTED_ARCHS) == sorted(
        DENSE + RECURRENT + MOE + MODAL) == sorted(jconfig.list_archs())


def test_unported_archs_raise():
    """Every arch of the JAX zoo builds now, the encoder-decoder and the
    VLM among them; an unknown id still raises. MoE layers on a dense
    base, an encoder with cross-attention and a prefix-LM build too."""
    assert tconfig.get_arch("grok-1-314b").name == "grok-1-314b"
    assert tconfig.get_arch("whisper-tiny").name == "whisper-tiny"
    assert tconfig.get_arch("paligemma-3b").name == "paligemma-3b"
    with pytest.raises(KeyError, match="not ported yet"):
        tconfig.get_arch("no_such_arch")
    base = tconfig.scaled_down(tconfig.get_arch("smollm_135m"))
    for changes in [
            dict(block_pattern=("mamba", "attn"), moe_layer_stride=2,
                 moe=tconfig.MoEConfig(4, 2, 64)),              # jamba
            dict(moe=tconfig.MoEConfig(4, 2, 64))]:
        cfg = dataclasses.replace(base, **changes)
        lm = build_model(cfg).init(0, device="cpu")
        assert [b.moe is not None for b in lm.layers] == \
            [cfg.is_moe_layer(i) for i in range(cfg.num_layers)]
    lm = build_model(dataclasses.replace(
        base, encoder_layers=2, cross_attention=True)).init(0, device="cpu")
    assert len(lm.encoder.layers) == 2
    assert all(b.cross is not None for b in lm.layers)
    lm = build_model(dataclasses.replace(
        base, prefix_lm=True, frontend="vision_patches")).init(0, "cpu")
    assert lm.encoder is None and all(b.cross is None for b in lm.layers)


@pytest.mark.parametrize("arch", DENSE + MODAL)
def test_param_count_matches_jax(arch):
    """At full width and depth, from shapes alone on both sides."""
    want = jax_build_model(jconfig.get_arch(arch)).param_count()
    assert build_model(tconfig.get_arch(arch)).param_count() == want


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_embed_rope_unembed_match_jax():
    rng = np.random.RandomState(0)
    table = rng.randn(11, 8).astype(np.float32)
    ids = np.array([[0, 3, 10, 11, 40, -2]], np.int32)   # clipped out of range
    np.testing.assert_array_equal(
        tlayers.embed(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
        np.asarray(jlayers.embed_apply({"table": jnp.asarray(table)},
                                       jnp.asarray(ids))))
    x = rng.randn(2, 5, 8).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.unembed(torch.from_numpy(table), torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.unembed_apply({"table": jnp.asarray(table)},
                                         jnp.asarray(x))), atol=1e-5,
        rtol=1e-5)
    for dtype, atol in (("float32", 1e-5), ("bfloat16", 1e-2)):
        xr = jnp.asarray(rng.randn(2, 7, 3, 16).astype(np.float32),
                         getattr(jnp, dtype))
        pos = np.array([[0, 1, 2, 3, 10, 100, 4000]], np.int32)
        want = jlayers.rope(xr, jnp.asarray(pos), 1e6)
        got = tlayers.rope(
            torch.from_numpy(np.array(xr.astype(jnp.float32))).to(
                getattr(torch, dtype)), torch.from_numpy(pos), 1e6)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=atol,
                                   rtol=1e-2 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_jax(gated):
    params, _ = jlayers.mlp_init(jax.random.PRNGKey(3), 16, 40, jnp.float32,
                                 gated=gated)
    tree = _perturbed(_np_tree(params), 3)
    mlp = tlayers.MLP(torch.Generator().manual_seed(0), 16, 40,
                      torch.float32, gated=gated)
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()})
    x = np.random.RandomState(4).randn(2, 5, 16).astype(np.float32)
    want = jlayers.mlp_apply(jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(x), gated=gated)
    np.testing.assert_allclose(mlp(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attention(seed, d, H, K, hd, qkv_bias, qk_norm):
    params, _ = jattn.attn_init(jax.random.PRNGKey(seed), d, H, K, hd,
                                jnp.float32, qkv_bias=qkv_bias,
                                qk_norm=qk_norm)
    tree = _perturbed(_np_tree(params), seed)
    mod = tattn.Attention(torch.Generator().manual_seed(0), d, H, K, hd,
                          torch.float32, qkv_bias=qkv_bias, qk_norm=qk_norm)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()})
    return jax.tree_util.tree_map(jnp.asarray, tree), mod


ATTN_CASES = [
    # (S, H, K, hd, mask_mode, window, qkv_bias, qk_norm)
    (24, 4, 2, 16, "causal", 0, False, False),
    (24, 4, 1, 16, "causal", 7, True, False),
    (19, 6, 3, 8, "full", 0, False, True),
    (19, 4, 4, 16, "full", 5, True, True),
]


@pytest.mark.parametrize("S,H,K,hd,mask_mode,window,qkv_bias,qk_norm",
                         ATTN_CASES)
def test_attn_apply_matches_jax(S, H, K, hd, mask_mode, window, qkv_bias,
                                qk_norm):
    d = 32
    jp, mod = _attention(S, d, H, K, hd, qkv_bias, qk_norm)
    x = np.random.RandomState(S).randn(2, S, d).astype(np.float32)
    kw = dict(num_heads=H, num_kv_heads=K, head_dim=hd, mask_mode=mask_mode,
              window=window, rope_theta=1e4, qk_norm=qk_norm)
    got = tattn.attn_apply(mod, torch.from_numpy(x), **kw).detach().numpy()
    for impl in ("ref", "chunked"):
        want = jattn.attn_apply(jp, jnp.asarray(x), impl=impl, **kw)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=1e-4)


def test_attn_apply_prefix_mask_raises():
    """The prefix mask runs now, as JAX's ref and chunked paths run it
    (more cases in test_torch_prefix_lm.py); an unknown mask mode and a
    negative prefix length still raise."""
    jp, mod = _attention(0, 16, 2, 1, 8, False, False)
    x = np.random.RandomState(1).randn(2, 10, 16).astype(np.float32)
    kw = dict(num_heads=2, num_kv_heads=1, head_dim=8, mask_mode="prefix",
              prefix_len=4)
    got = tattn.attn_apply(mod, torch.from_numpy(x), **kw).detach().numpy()
    for impl in ("ref", "chunked"):
        want = jattn.attn_apply(jp, jnp.asarray(x), impl=impl, **kw)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=1e-4)
    with pytest.raises(ValueError, match="mask_mode"):
        tattn.attn_apply(mod, torch.zeros(1, 4, 16), num_heads=2,
                         num_kv_heads=1, head_dim=8, mask_mode="sliding")
    with pytest.raises(ValueError, match="prefix_len"):
        tattn.attn_apply(mod, torch.zeros(1, 4, 16), num_heads=2,
                         num_kv_heads=1, head_dim=8, mask_mode="prefix",
                         prefix_len=-2)


@pytest.mark.parametrize("window,qk_norm", [(0, False), (3, True)])
def test_attn_decode_matches_jax(window, qk_norm):
    """One decode step with per-row positions (one row past the cache's
    end: its write is dropped, as JAX's scatter drops it)."""
    d, H, K, hd, T, B = 32, 4, 2, 8, 6, 3
    jp, mod = _attention(5, d, H, K, hd, True, qk_norm)
    rng = np.random.RandomState(9)
    x = rng.randn(B, 1, d).astype(np.float32)
    ck = rng.randn(B, T, K, hd).astype(np.float32)
    cv = rng.randn(B, T, K, hd).astype(np.float32)
    pos = np.array([0, 4, T], np.int32)
    kw = dict(num_heads=H, num_kv_heads=K, head_dim=hd, qk_norm=qk_norm,
              window=window)
    want = jattn.attn_decode(jp, jnp.asarray(x), jnp.asarray(ck),
                             jnp.asarray(cv), jnp.asarray(pos), **kw)
    got = tattn.attn_decode(mod, torch.from_numpy(x), torch.from_numpy(ck),
                            torch.from_numpy(cv), torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the model: prefill and decode from bridged weights
# ---------------------------------------------------------------------------

def test_prefill_matches_jax(zoo):
    """Hidden states of `Model.prefill` against JAX's chunked and ref
    attention paths, and the logits of `lm_apply`."""
    from repro.models import transformer as jtfm

    from repro_torch.models import transformer as ttfm
    arch, jcfg, tcfg, jmodel, jparams, lm = zoo
    tokens = np.random.RandomState(2).randint(
        0, tcfg.vocab_size + 5, (2, 37)).astype(np.int32)  # some clipped
    hidden, aux = build_model(tcfg).prefill(lm, {"tokens": tokens})
    assert hidden.dtype == torch.float32 and float(aux) == 0.0
    for impl in ("chunked", "ref"):
        want, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                 impl=impl)
        np.testing.assert_allclose(hidden.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4, err_msg=impl)
    with torch.no_grad():
        logits, _ = ttfm.lm_apply(lm, tcfg, torch.from_numpy(tokens))
    want, _ = jtfm.lm_apply(jparams, jcfg, jnp.asarray(tokens), impl="ref")
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_decode_steps_match_jax(zoo):
    """Four decode steps with per-row positions (rows starting at 0, 3
    and 5 over a cache prefilled with values): logits and caches."""
    arch, jcfg, tcfg, jmodel, jparams, lm = zoo
    model = build_model(tcfg)
    rng = np.random.RandomState(11)
    B, T = 3, 12
    jcache, _ = jmodel.init_cache(B, T, jnp.float32)
    init = jax.tree_util.tree_map(
        lambda c: (0.3 * rng.randn(*c.shape)).astype(np.float32), jcache)
    jcache = jax.tree_util.tree_map(jnp.asarray, init)
    cache = model.init_cache(B, T, torch.float32, device="cpu")
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
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {step}")
        pos = pos + 1
    for name, leaves in cache.items():
        for key, leaf in leaves.items():
            np.testing.assert_allclose(leaf.numpy(),
                                       np.asarray(jcache[name][key]),
                                       atol=1e-5, rtol=1e-4)


def test_bridge_takes_bf16_bits_and_rejects_mismatches():
    jcfg, tcfg = _configs("qwen3_4b", num_layers=2, d_model=32, num_heads=2,
                          d_ff=48, vocab_size=40)
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16", dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16", dtype="bfloat16")
    params, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tree = _np_tree(params)
    lm = bridge.lm_params_from_jax(tree, tcfg)
    for layer in range(2):
        for name in ("wq", "k_norm"):
            got = getattr(lm.layers[layer].mixer, name).detach()
            assert got.dtype == torch.bfloat16
            want = tree["layers"]["p0"]["mixer"][name][layer]
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16))
    bad = jax.tree_util.tree_map(lambda x: x, tree)
    del bad["final_norm"]
    with pytest.raises(KeyError):
        bridge.lm_params_from_jax(bad, tcfg)
    with pytest.raises(TypeError):
        bridge.lm_params_from_jax(tree, dataclasses.replace(
            tcfg, param_dtype="float32"))
    with pytest.raises(ValueError):
        bridge.lm_params_from_jax(tree, dataclasses.replace(tcfg,
                                                            num_layers=1))


def test_seeded_init_is_reproducible_and_in_param_dtype():
    cfg = tconfig.scaled_down(tconfig.get_arch("qwen2_7b"), **SMALL)
    model = build_model(cfg)
    a, b = model.init(3, device="cpu"), model.init(3, device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        assert p.dtype == torch.float32
    big = dataclasses.replace(cfg, param_dtype="bfloat16")
    assert {p.dtype for p in build_model(big).init(3, "cpu").parameters()} \
        == {torch.bfloat16}
    assert sum(p.numel() for p in a.parameters()) == model.param_count()


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot show")
    model = build_model(tconfig.scaled_down(tconfig.get_arch("smollm_135m")))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(1, 8)


def test_cpu_prefill_launches_no_kernel(zoo):
    arch, jcfg, tcfg, jmodel, jparams, lm = zoo
    build_model(tcfg).prefill(lm, {"tokens": np.ones((1, 5), np.int32)})
    assert flash_attention.launches == 0


def test_importing_the_zoo_loads_no_jax():
    code = ("import sys; import repro_torch.models.model_zoo, "
            "repro_torch.serve, repro_torch.bridge; "
            "print('jax' in sys.modules, 'repro' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]

"""The port's recurrent zoo (Mamba, mLSTM, sLSTM, RWKV blocks; xlstm-1.3b
and the paper's encoder as zoo archs) on the CPU against the JAX package:
each mixer's prefill and one-token decode, `Model.prefill` and decode
steps with every cache leaf, `ServeEngine`'s token lists, the riding
slot of the batched prefill, parameter counts and per-leaf dtypes, at
fp32 under `scaled_down` from bridged (perturbed) weights."""
import dataclasses

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.kernels.wkv import wkv  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models.transformer import period_of  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve.engine import _prefill_scan  # noqa: E402

RECURRENT = ["xlstm_1_3b", "semanticbbv_encoder"]
FULL_PARAMS = {"xlstm_1_3b": 1_494_174_032, "semanticbbv_encoder": 23_273_856}
SMALL = dict(num_layers=4, d_model=32, num_heads=2, d_ff=64, vocab_size=96)
OUT = dict(atol=1e-4, rtol=1e-4)        # outputs and logits
STATE = dict(atol=1e-5, rtol=1e-4)      # recurrent states


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(module, seed):
    """Moves every fp32 parameter of `module` off its init, in place, so a
    wrongly wired bias, gate or scale shows."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.from_numpy(0.05 * rng.randn(*p.shape)).to(p.dtype))


def _mixer(cls, jinit, seed, *args):
    """(port mixer, JAX params) holding the same perturbed weights; the
    names and shapes are JAX's init's (`jinit`, traced abstractly)."""
    mod = cls(torch.Generator().manual_seed(seed), *args, torch.float32)
    _perturb(mod, seed)
    tree = {k: v.numpy() for k, v in mod.state_dict().items()}
    want = jax.eval_shape(
        lambda: jinit(jax.random.PRNGKey(0), *args, jnp.float32)[0])
    assert {k: v.shape for k, v in tree.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    return mod, {k: jnp.asarray(v) for k, v in tree.items()}


def _jax_tree(lm, cfg):
    """The JAX parameter tree (numpy) of a port LM: `layers.<i>...` stacked
    into `layers/p<i % period>/...` along a leading period axis; bf16
    leaves as `ml_dtypes.bfloat16` by their bits."""
    period = period_of(cfg)
    tree, stacks = {}, {}
    for name, t in lm.state_dict().items():
        a = (t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
             if t.dtype == torch.bfloat16 else t.numpy()).copy()
        path = name.split(".")
        if path[0] == "layers":
            i = int(path[1])
            key = ("layers", f"p{i % period}", *path[2:])
            stacks.setdefault(key, {})[i // period] = a
            continue
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = a
    for key, by_n in stacks.items():
        node = tree
        for p in key[:-1]:
            node = node.setdefault(p, {})
        node[key[-1]] = np.stack([by_n[n] for n in sorted(by_n)])
    return tree


def _flat(tree):
    return {jax.tree_util.keystr(path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _seeded(arch, dtype="float32"):
    """(JAX cfg, port cfg, port LM seeded and, in fp32, perturbed, its JAX
    tree); the tree's names, shapes and dtypes are those of JAX's
    `lm_init` (traced abstractly)."""
    jcfg = dataclasses.replace(_jax_cfg(arch, **SMALL), dtype=dtype,
                               param_dtype=dtype)
    tcfg = _port_cfg(jcfg)
    lm = build_model(tcfg).init(3, device="cpu")
    if dtype == "float32":
        _perturb(lm, 7)
    tree = _jax_tree(lm, tcfg)
    want = jax.eval_shape(
        lambda: jax_build_model(jcfg).init(jax.random.PRNGKey(0))[0])
    assert {k: (a.shape, a.dtype.name) for k, a in _flat(tree).items()} == \
        {k: (tuple(s.shape), s.dtype.name) for k, s in _flat(want).items()}
    return jcfg, tcfg, lm, tree


def _jax_cfg(arch, **kw):
    """A `scaled_down` JAX config: the two recurrent archs, or "mamba_attn",
    jamba's Mamba + attention pattern without its MoE layers."""
    if arch == "mamba_attn":
        cfg = jconfig.scaled_down(jconfig.get_arch("jamba_1_5_large_398b"),
                                  **kw)
        return dataclasses.replace(cfg, moe=None)
    return jconfig.scaled_down(jconfig.get_arch(arch), **kw)


def _port_cfg(jcfg):
    return tconfig.ModelConfig(**dataclasses.asdict(jcfg))


_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bits(a):
    """The raw bits of a bf16 tensor or numpy array; fp32 as it is."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16).numpy().view(np.uint16)
                if a.dtype == torch.bfloat16 else a.numpy())
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               err_msg=msg, **tol)


# ---------------------------------------------------------------------------
# configs, counts, dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RECURRENT)
def test_config_copies_match_jax(arch):
    want = dataclasses.asdict(jconfig.get_arch(arch))
    assert dataclasses.asdict(tconfig.get_arch(arch.replace("_", "-"))) \
        == want
    jc = jconfig.scaled_down(jconfig.get_arch(arch), **SMALL)
    tc = tconfig.scaled_down(tconfig.get_arch(arch), **SMALL)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


@pytest.mark.parametrize("arch", RECURRENT)
def test_param_count_matches_jax(arch):
    """At full width and depth, from shapes alone on both sides."""
    got = build_model(tconfig.get_arch(arch)).param_count()
    assert got == jax_build_model(jconfig.get_arch(arch)).param_count()
    assert got == FULL_PARAMS[arch]


@pytest.mark.parametrize("arch", RECURRENT + ["mamba_attn"])
def test_leaf_dtypes_follow_jax_in_bf16(arch):
    """A bf16 model keeps the leaves JAX keeps in fp32 (w_bias, A_log, D,
    b_i, b_f, b_zifo) in fp32, in `Model.init` (checked against JAX's
    tree in `_seeded`) and through the bridge (bf16 leaves by their
    bits); a leaf of another dtype than JAX's is refused."""
    _, tcfg, lm, tree = _seeded(arch, "bfloat16")
    fp32 = {k.split("'")[-2] for k, a in _flat(tree).items()
            if a.dtype == np.float32 and "layers" in k}
    assert fp32 == {"xlstm_1_3b": {"b_i", "b_f", "b_zifo"},
                    "semanticbbv_encoder": {"w_bias"},
                    "mamba_attn": {"A_log", "D"}}[arch]
    got = bridge.lm_params_from_jax(tree, tcfg).state_dict()
    for name, t in lm.state_dict().items():
        assert got[name].dtype == t.dtype, name
        np.testing.assert_array_equal(_bits(got[name]), _bits(t))
    mixer = tree["layers"]["p0"]["mixer"]
    name = next(k for k, a in mixer.items() if a.dtype != np.float32)
    mixer[name] = mixer[name].astype(np.float32)
    with pytest.raises(TypeError):
        bridge.lm_params_from_jax(tree, tcfg)


def test_moe_encoder_and_prefix_configs_still_raise():
    """MoE on a recurrent base builds (xLSTM blocks take no FFN, so no MoE
    either, as in JAX), and jamba is ported. The encoder and prefix
    configs, which raised until the encoder-decoder and prefix-LM were
    ported, build now on a recurrent base too, with JAX's tree (an
    attention encoder, cross-attention beside each recurrent mixer), and
    so do the archs that need them; an unknown id still raises."""
    base = tconfig.scaled_down(tconfig.get_arch("xlstm_1_3b"))
    lm = build_model(dataclasses.replace(
        base, moe=tconfig.MoEConfig(4, 2, 64))).init(0, device="cpu")
    assert all(b.moe is None and b.mlp is None for b in lm.layers)
    jbase = jconfig.scaled_down(jconfig.get_arch("xlstm_1_3b"))
    for changes in (dict(encoder_layers=2, cross_attention=True),
                    dict(prefix_lm=True, frontend="vision_patches")):
        jcfg = dataclasses.replace(jbase, **changes)
        shapes = jax.eval_shape(
            lambda: jax_build_model(jcfg).init(jax.random.PRNGKey(0))[0])
        tree = jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, a.dtype), shapes)
        bridge.lm_params_from_jax(
            tree, dataclasses.replace(base, **changes))   # names, shapes
    assert tconfig.get_arch("jamba-1.5-large-398b").moe.num_experts == 16
    for arch in ("whisper-tiny", "paligemma-3b"):
        assert tconfig.get_arch(arch).family in ("encdec", "vlm")
    with pytest.raises(KeyError, match="not ported yet"):
        tconfig.get_arch("no-such-arch")


# ---------------------------------------------------------------------------
# mixers
# ---------------------------------------------------------------------------

def test_causal_conv_matches_jax():
    rng = np.random.RandomState(0)
    x, w, b = (rng.randn(*s).astype(np.float32)
               for s in ((2, 6, 5), (4, 5), (5,)))
    state = rng.randn(2, 3, 5).astype(np.float32)
    for st in (None, state):
        want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if st is None else jnp.asarray(st))
        got = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b),
                                None if st is None else torch.from_numpy(st))
        for g, wt in zip(got, want):
            _close(g, wt, dict(atol=1e-6, rtol=1e-6))


def _decode_chain(jdecode, tdecode, jparams, mod, x, state, steps):
    """`steps` one-token decodes on both sides from one state: outputs at
    OUT, every state leaf at STATE."""
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    for t in range(steps):
        xt = x[:, t:t + 1]
        want, jstate = jdecode(jparams, jnp.asarray(xt), jstate)
        got, tstate = tdecode(mod, torch.from_numpy(xt), tstate)
        _close(got, want, OUT, f"step {t}")
        assert set(tstate) == set(jstate)
        for k in jstate:
            assert tstate[k].dtype == torch.float32, k
            _close(tstate[k], jstate[k], STATE, f"step {t} {k}")


def _random_state(init_state, rng):
    """A state of init_state's layout with moderate random values (sLSTM's
    normaliser n kept positive, as a run keeps it)."""
    return {k: ((1 + np.abs(rng.randn(*v.shape))) if k == "n" and v.ndim == 2
                else 0.3 * rng.randn(*v.shape)).astype(np.float32)
            for k, v in init_state.items()}


def test_mamba_apply_and_decode_match_jax():
    d, DS, K = 32, 8, 4
    mod, jp = _mixer(tssm.Mamba, jssm.mamba_init, 1, d, DS, K)
    x = np.random.RandomState(2).randn(2, 12, d).astype(np.float32)
    for chunk in (4, 12):
        want = jssm.mamba_apply(jp, jnp.asarray(x), DS, chunk=chunk)
        got = tssm.mamba_apply(mod, torch.from_numpy(x), DS, chunk=chunk)
        _close(got, want, OUT, f"chunk {chunk}")
    for fn in (jssm.mamba_apply, tssm.mamba_apply):
        with pytest.raises((AssertionError, ValueError),
                           match="not divisible by chunk 5"):
            fn(jp if fn is jssm.mamba_apply else mod,
               jnp.asarray(x) if fn is jssm.mamba_apply
               else torch.from_numpy(x), DS, chunk=5)
    state = _random_state(_np_tree(jssm.mamba_init_state(2, d, DS, K)),
                          np.random.RandomState(3))
    _decode_chain(lambda p, xt, s: jssm.mamba_decode(p, xt, s, DS),
                  lambda m, xt, s: tssm.mamba_decode(m, xt, s, DS),
                  jp, mod, x, state, 3)


@pytest.mark.parametrize("S,chunk", [(37, 16), (64, 16), (37, 256)])
def test_mlstm_apply_matches_jax(S, chunk):
    """S 37 at chunk 16 takes the token scan, 64 at 16 the chunkwise form
    (4 chunks), 37 at 256 the chunkwise form in one chunk of 37."""
    d, H, K = 32, 2, 4
    mod, jp = _mixer(tssm.MLSTM, jssm.mlstm_init, 4, d, H, K)
    x = np.random.RandomState(S).randn(2, S, d).astype(np.float32)
    want = jssm.mlstm_apply(jp, jnp.asarray(x), H, chunk=chunk)
    got = tssm.mlstm_apply(mod, torch.from_numpy(x), H, chunk=chunk)
    _close(got, want, OUT)


def test_mlstm_chunkwise_equals_scan():
    rng = np.random.RandomState(5)
    B, S, H, dh = 2, 48, 2, 8
    q, k, v = (torch.from_numpy(rng.randn(B, S, H, dh).astype(np.float32))
               for _ in range(3))
    i_pre = torch.from_numpy(rng.randn(B, S, H).astype(np.float32))
    f_pre = torch.nn.functional.logsigmoid(
        torch.from_numpy(rng.randn(B, S, H).astype(np.float32) + 2))
    want = tssm._mlstm_scan(q, k, v, i_pre, f_pre)
    for chunk in (8, 16, 48):
        _close(tssm._mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk), want,
               dict(atol=1e-5, rtol=1e-4), f"chunk {chunk}")


def test_mlstm_decode_matches_jax():
    d, H, K = 32, 2, 4
    mod, jp = _mixer(tssm.MLSTM, jssm.mlstm_init, 6, d, H, K)
    x = np.random.RandomState(7).randn(3, 4, d).astype(np.float32)
    state = _random_state(_np_tree(jssm.mlstm_init_state(3, d, H, K)),
                          np.random.RandomState(8))
    _decode_chain(lambda p, xt, s: jssm.mlstm_decode(p, xt, s, H),
                  lambda m, xt, s: tssm.mlstm_decode(m, xt, s, H),
                  jp, mod, x, state, 4)


def test_slstm_apply_and_decode_match_jax():
    d, H, K = 32, 4, 4
    mod, jp = _mixer(tssm.SLSTM, jssm.slstm_init, 9, d, H, K)
    x = np.random.RandomState(10).randn(2, 13, d).astype(np.float32)
    _close(tssm.slstm_apply(mod, torch.from_numpy(x), H),
           jssm.slstm_apply(jp, jnp.asarray(x), H), OUT)
    state = _random_state(_np_tree(jssm.slstm_init_state(2, d)),
                          np.random.RandomState(11))
    _decode_chain(lambda p, xt, s: jssm.slstm_decode(p, xt, s, H),
                  lambda m, xt, s: tssm.slstm_decode(m, xt, s, H),
                  jp, mod, x, state, 4)


def test_rwkv_decode_matches_jax():
    """The time-mix and channel-mix one-token steps from random shift and
    wkv states (the wkv plain version at S = 1 with the state in)."""
    d, H = 32, 2
    rng = np.random.RandomState(12)
    ttm, tm = _mixer(trwkv.TimeMix, jrwkv.timemix_init, 12, d, H)
    tcm, cm = _mixer(trwkv.ChannelMix, jrwkv.channelmix_init, 13, d)
    state = _random_state(_np_tree(jrwkv.rwkv_init_state(3, d, H)), rng)
    x = rng.randn(3, 1, d).astype(np.float32)
    want = jrwkv.timemix_decode(tm, jnp.asarray(x), jnp.asarray(state["tm_shift"]),
                                jnp.asarray(state["S"]), H)
    got = trwkv.timemix_decode(ttm, torch.from_numpy(x),
                               torch.from_numpy(state["tm_shift"]),
                               torch.from_numpy(state["S"]))
    for g, w, tol in zip(got, want, (OUT, STATE, STATE)):
        _close(g, w, tol)
    want = jrwkv.channelmix_decode(cm, jnp.asarray(x),
                                   jnp.asarray(state["cm_shift"]))
    got = trwkv.channelmix_decode(tcm, torch.from_numpy(x),
                                  torch.from_numpy(state["cm_shift"]))
    for g, w, tol in zip(got, want, (OUT, STATE)):
        _close(g, w, tol)


# ---------------------------------------------------------------------------
# the model: prefill, decode, serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=RECURRENT + ["mamba_attn"])
def zoo(request):
    """(arch, port cfg, JAX model, JAX params, port module) on the same
    perturbed weights, fp32."""
    jcfg, tcfg, _, tree = _seeded(request.param)
    return (request.param, tcfg, jax_build_model(jcfg),
            jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.lm_params_from_jax(tree, tcfg))


def test_prefill_matches_jax(zoo):
    """Hidden states of `Model.prefill`; xlstm also at S 300, where its
    mLSTM takes the token scan (300 is no multiple of the chunk, 256)."""
    arch, tcfg, jmodel, jparams, lm = zoo
    before = wkv.launches
    for S in ((37, 300) if arch == "xlstm_1_3b" else (37,)):
        tokens = np.random.RandomState(S).randint(
            0, tcfg.vocab_size, (2, S)).astype(np.int32)
        hidden, aux = build_model(tcfg).prefill(lm, {"tokens": tokens})
        assert hidden.dtype == torch.float32 and float(aux) == 0.0
        want, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
        _close(hidden, want, OUT, f"S {S}")
    assert wkv.launches == before           # the plain version on the CPU


def _seeded_cache(jmodel, model, B, T, rng):
    """The same random cache on both sides (sLSTM's n kept positive)."""
    jcache, _ = jmodel.init_cache(B, T, jnp.float32)
    init = {name: _random_state(_np_tree(leaves), rng)
            for name, leaves in jcache.items()}
    cache = model.init_cache(B, T, torch.float32, device="cpu")
    for name, leaves in cache.items():
        assert set(leaves) == set(init[name])
        for key, leaf in leaves.items():
            assert leaf.shape == init[name][key].shape, (name, key)
            assert leaf.dtype == torch.float32
            leaf.copy_(torch.from_numpy(init[name][key]))
    return jax.tree_util.tree_map(jnp.asarray, init), cache


def test_decode_steps_match_jax(zoo):
    """Four decode steps from a random cache, rows at positions 0, 3 and
    5: the logits and every cache leaf."""
    arch, tcfg, jmodel, jparams, lm = zoo
    model = build_model(tcfg)
    rng = np.random.RandomState(11)
    B = 3
    jcache, cache = _seeded_cache(jmodel, model, B, 12, rng)
    pos = np.array([0, 3, 5], np.int32)
    for step in range(4):
        tok = rng.randint(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        want, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                          jnp.asarray(pos))
        got, cache = model.decode_step(lm, cache, torch.from_numpy(tok),
                                       torch.from_numpy(pos))
        _close(got, want, OUT, f"step {step}")
        pos = pos + 1
    for name, leaves in cache.items():
        for key, leaf in leaves.items():
            _close(leaf, jcache[name][key], STATE, f"{name}/{key}")


def _outs(engine_cls, request_cls, model, params, requests, **kw):
    if engine_cls is ServeEngine:
        kw["device"] = "cpu"
    eng = engine_cls(model, params, **kw)
    for rid, prompt, max_new in requests:
        eng.submit(request_cls(rid=rid, prompt=list(prompt), max_new=max_new))
    return {r: list(req.out) for r, req in eng.run().items()}


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_engine_token_lists_match_jax(zoo, temperature):
    """Ragged prompts, more requests than slots (mid-run refills through
    the batched prefill): the same tokens as JAX's engine, greedy and
    Gumbel-max with the same numpy noise."""
    arch, tcfg, jmodel, jparams, lm = zoo
    requests = [(i, [1 + i, 2, 3] + [4 + i] * i, 4) for i in range(4)]
    kw = dict(num_slots=2, max_seq=24, temperature=temperature, seed=7)
    got = _outs(ServeEngine, Request, build_model(tcfg), lm, requests, **kw)
    assert got == _outs(JServeEngine, JRequest, jmodel, jparams, requests,
                        **kw)
    assert sorted(got) == [0, 1, 2, 3]
    assert all(len(out) == 4 for out in got.values())


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_scan_riding_slot_keeps_its_state(arch):
    """A slot riding along with lens = 0 keeps every recurrent state leaf
    bit-identical while slot 0 prefills; slot 0 ends where three
    sequential decode steps end."""
    cfg = tconfig.scaled_down(tconfig.get_arch(arch), **SMALL)
    model = build_model(cfg)
    lm = model.init(0, device="cpu")
    cache = model.init_cache(2, 16, torch.float32, device="cpu")
    pos = torch.tensor([0, 0])
    for t in (9, 10):                     # slot 1 decodes two tokens first
        _, cache = model.decode_step(lm, cache, torch.tensor([[0], [t]]), pos)
        pos = pos + 1
    for leaves in cache.values():
        for leaf in leaves.values():
            leaf[:, 0] = 0
    prompt = [5, 6, 7]
    seq = {n: {k: v.clone() for k, v in lv.items()} for n, lv in cache.items()}
    for t in prompt:                      # the truth: slot 0 alone
        logits, seq = model.decode_step(lm, seq, torch.tensor([[t], [0]]),
                                        torch.tensor([0, 0]))
    before = {n: {k: v.clone() for k, v in lv.items()}
              for n, lv in cache.items()}
    last, after = _prefill_scan(model.decode_step, cfg.vocab_size, lm, cache,
                                torch.tensor([prompt + [0], [0] * 4]),
                                torch.tensor([3, 0]), torch.tensor([0, 2]))
    _close(last[0], logits[0, 0].numpy(), dict(atol=1e-6, rtol=1e-6))
    assert torch.equal(last[1], torch.zeros(cfg.vocab_size))
    for name, leaves in after.items():
        for key, leaf in leaves.items():
            assert torch.equal(leaf[:, 1], before[name][key][:, 1]), key
            assert not torch.equal(leaf[:, 0], before[name][key][:, 0]), key
            _close(leaf[:, 0], seq[name][key][:, 0].numpy(),
                   dict(atol=1e-6, rtol=1e-6), key)


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot show")
    cfg = tconfig.scaled_down(tconfig.get_arch("semanticbbv_encoder"))
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, model.init(0, device="cpu"))

"""The port's MoE layers (`models/moe.py`) and the MoE archs of the zoo
(qwen3-moe, grok-1, the jamba hybrid) on the CPU against the JAX package:
routing (top-k experts, slots, kept pairs) exactly, `moe_apply`'s output
and aux loss, configs and parameter counts, per-leaf dtypes, prefill and
decode from bridged (perturbed) weights, decode against the teacher-
forced logits, `ServeEngine`'s token lists and the batched prefill with
riding slots that take expert capacity; fp32 under `scaled_down`."""
import dataclasses

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.engine import _prefill_scan as j_prefill_scan  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve.engine import _prefill_scan  # noqa: E402
from test_torch_recurrent import (  # noqa: E402
    _bits, _close, _flat, _jax_tree, _outs, _perturb,
)

MOE = ["qwen3_moe_235b_a22b", "grok_1_314b", "jamba_1_5_large_398b"]
# (param_count, active_param_count) at full width and depth
FULL_PARAMS = {"qwen3_moe_235b_a22b": (235_093_634_560, 22_190_763_520),
               "grok_1_314b": (316_489_340_928, 84_561_106_944),
               "jamba_1_5_large_398b": (398_555_111_424, 94_149_304_320)}
# scaled_down keeps 4 experts, top-2; jamba keeps 8 layers (Mamba /
# attention alternating, MoE on every other layer: the Mamba ones)
SMALL = dict(d_model=32, num_heads=2, d_ff=48, vocab_size=96)
LAYERS = {"qwen3_moe_235b_a22b": 2, "grok_1_314b": 2,
          "jamba_1_5_large_398b": 8}
OUT = dict(atol=1e-4, rtol=1e-4)        # outputs and logits
STATE = dict(atol=1e-5, rtol=1e-4)      # caches
AUX_RTOL = 1e-6


def _jax_route(router, x, top_k, capacity_factor, group_size=256):
    """JAX's routing, step by step as `repro.models.moe.moe_apply` takes
    it: (top-k experts, slots, kept) over (G, g, k)."""
    B, S, d = x.shape
    E = router.shape[1]
    N = B * S
    g = min(group_size, N)
    while N % g:
        g -= 1
    xt = jnp.asarray(x).reshape(N // g, g, d)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jnp.asarray(router), -1)
    _, idx = jax.lax.top_k(probs, top_k)
    capacity = max(4, int(g * top_k * capacity_factor / E))
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    flat = onehot.reshape(N // g, g * top_k, E)
    slot = jnp.cumsum(flat, axis=1) - 1
    slot = (slot * flat).sum(-1).reshape(N // g, g, top_k)
    return np.asarray(idx), np.asarray(slot), np.asarray(slot < capacity)


def _assert_same_routing(r, want, msg=""):
    idx, slot, kept = want
    np.testing.assert_array_equal(r.idx.numpy(), idx, err_msg=msg)
    np.testing.assert_array_equal(r.slot.numpy(), slot, err_msg=msg)
    np.testing.assert_array_equal(r.kept.numpy(), kept, err_msg=msg)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

# (B, S, d, f, E, k, capacity_factor, gated, what)
MOE_CASES = {
    "gated": (2, 300, 24, 40, 8, 2, 1.25, True, None),    # 3 groups of 200
    "gelu": (3, 40, 24, 40, 6, 3, 1.25, False, None),
    "drops": (2, 16, 24, 40, 4, 2, 0.25, True, "drops"),  # 4 rows, 64 pairs
    "ties": (2, 16, 24, 40, 8, 3, 1.25, True, "ties"),    # equal logits
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_jax(case):
    """Routing exactly, the output at 1e-4 and the aux loss at 1e-6
    relative, against `repro.models.moe.moe_apply` on the same weights."""
    B, S, d, f, E, k, cf, gated, what = MOE_CASES[case]
    mod = tmoe.MoE(torch.Generator().manual_seed(5), d, f, E, torch.float32,
                   gated=gated)
    _perturb(mod, 6)
    params = {name: p.detach().numpy() for name, p in mod.named_parameters()}
    want_shapes = jax.eval_shape(lambda: jmoe.moe_init(
        jax.random.PRNGKey(0), d, f, E, jnp.float32, gated=gated)[0])
    assert {n: a.shape for n, a in params.items()} == \
        {n: tuple(s.shape) for n, s in want_shapes.items()}
    x = np.random.RandomState(len(case)).randn(B, S, d).astype(np.float32)
    if what == "ties":
        x[0, ::3] = 0.0                     # router logits all 0 there
    r = tmoe.route(mod.router.detach(), torch.from_numpy(x), k, cf)
    _assert_same_routing(r, _jax_route(params["router"], x, k, cf), case)
    if what == "drops":
        assert r.capacity == 4 and int((~r.kept).sum()) > 0
    if what == "ties":
        tied = r.idx.reshape(B, S, k)[0, ::3]
        assert (tied == torch.arange(k)).all()
    with torch.no_grad():
        out, aux = tmoe.moe_apply(mod, torch.from_numpy(x), top_k=k,
                                  capacity_factor=cf, gated=gated)
    jout, jaux = jmoe.moe_apply({n: jnp.asarray(a) for n, a in params.items()},
                                jnp.asarray(x), top_k=k, capacity_factor=cf,
                                gated=gated)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    _close(out, jout, OUT, case)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)


def test_moe_keeps_the_input_dtype_in_bf16():
    """bf16 input and weights: the output in bf16, the router and the
    aux loss in fp32, routing from the fp32 logits."""
    mod = tmoe.MoE(torch.Generator().manual_seed(0), 16, 24, 4,
                   torch.bfloat16)
    assert mod.router.dtype == torch.float32
    assert {mod.wi.dtype, mod.wg.dtype, mod.wo.dtype} == {torch.bfloat16}
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out, aux = mod(x.bfloat16(), top_k=2)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert bool(torch.isfinite(out.float()).all()) and float(aux) > 0


# ---------------------------------------------------------------------------
# configs, counts, dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_config_copies_match_jax(arch):
    want = dataclasses.asdict(jconfig.get_arch(arch))
    assert dataclasses.asdict(tconfig.get_arch(arch.replace("_", "-"))) \
        == want
    kw = dict(SMALL, num_layers=LAYERS[arch])
    assert dataclasses.asdict(tconfig.scaled_down(tconfig.get_arch(arch),
                                                  **kw)) == \
        dataclasses.asdict(jconfig.scaled_down(jconfig.get_arch(arch), **kw))


@pytest.mark.parametrize("arch", MOE)
def test_param_counts_match_jax(arch):
    """`param_count` and `active_param_count` at full width and depth,
    from shapes alone on both sides."""
    model = build_model(tconfig.get_arch(arch))
    jmodel = jax_build_model(jconfig.get_arch(arch))
    got = (model.param_count(), model.active_param_count())
    assert got == (jmodel.param_count(), jmodel.active_param_count())
    assert got == FULL_PARAMS[arch]


def _seeded(arch, dtype="float32"):
    """(JAX cfg, port cfg, port LM seeded and, in fp32, perturbed, its JAX
    tree); the tree's names, shapes and dtypes are those of JAX's
    `lm_init` (traced abstractly)."""
    jcfg = jconfig.scaled_down(jconfig.get_arch(arch),
                               **dict(SMALL, num_layers=LAYERS[arch]))
    jcfg = dataclasses.replace(jcfg, dtype=dtype, param_dtype=dtype)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    tcfg = dataclasses.replace(tcfg, moe=tconfig.MoEConfig(
        **dataclasses.asdict(jcfg.moe)))
    lm = build_model(tcfg).init(3, device="cpu")
    if dtype == "float32":
        _perturb(lm, 7)
    tree = _jax_tree(lm, tcfg)
    want = jax.eval_shape(
        lambda: jax_build_model(jcfg).init(jax.random.PRNGKey(0))[0])
    assert {k: (a.shape, a.dtype.name) for k, a in _flat(tree).items()} == \
        {k: (tuple(s.shape), s.dtype.name) for k, s in _flat(want).items()}
    return jcfg, tcfg, lm, tree


@pytest.mark.parametrize("arch", MOE)
def test_leaf_dtypes_follow_jax_in_bf16(arch):
    """A bf16 model keeps the router (and jamba's A_log, D) in fp32, as
    JAX's `lm_init` does (checked in `_seeded`); the bridge takes the
    tree back bit for bit and refuses a leaf of another dtype."""
    _, tcfg, lm, tree = _seeded(arch, "bfloat16")
    fp32 = {k.split("'")[-2] for k, a in _flat(tree).items()
            if a.dtype == np.float32 and "layers" in k}
    assert fp32 == ({"router", "A_log", "D"} if arch.startswith("jamba")
                    else {"router"})
    got = bridge.lm_params_from_jax(tree, tcfg).state_dict()
    for name, t in lm.state_dict().items():
        assert got[name].dtype == t.dtype, name
        np.testing.assert_array_equal(_bits(got[name]), _bits(t))
    moe = tree["layers"]["p0"]["moe"]
    moe["router"] = moe["router"].astype(ml_dtypes.bfloat16)
    with pytest.raises(TypeError):
        bridge.lm_params_from_jax(tree, tcfg)


# ---------------------------------------------------------------------------
# the models: prefill, decode, serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE)
def zoo(request):
    """(arch, port cfg, JAX cfg, JAX model, JAX params, port module) on the
    same perturbed weights, fp32, the port's through the bridge."""
    jcfg, tcfg, _, tree = _seeded(request.param)
    return (request.param, tcfg, jcfg, jax_build_model(jcfg),
            jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.lm_params_from_jax(tree, tcfg))


class _Recorder:
    """Captures the input of every MoE layer of an LM (a forward pre-hook
    on each `MoE` module), to recompute its routing (`moe.route`)."""

    def __init__(self, lm):
        self.inputs = []
        self.handles = [m.register_forward_pre_hook(self._hook)
                        for m in lm.modules() if isinstance(m, tmoe.MoE)]
        self.routers = [m.router.detach() for m in lm.modules()
                        if isinstance(m, tmoe.MoE)]

    def _hook(self, module, args):
        self.inputs.append(args[0].detach().clone())

    def routings(self, top_k, capacity_factor):
        n = len(self.routers)
        return [tmoe.route(self.routers[i % n], x, top_k, capacity_factor)
                for i, x in enumerate(self.inputs)]

    def close(self):
        for h in self.handles:
            h.remove()


def test_prefill_matches_jax(zoo):
    """Hidden states, logits and aux of the forward; the routing of every
    MoE layer (its input taken from the port) equals JAX's."""
    arch, tcfg, jcfg, jmodel, jparams, lm = zoo
    tokens = np.random.RandomState(4).randint(
        0, tcfg.vocab_size, (2, 37)).astype(np.int32)
    rec = _Recorder(lm)
    hidden, aux = build_model(tcfg).prefill(lm, {"tokens": tokens})
    rec.close()
    want, jaux = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    _close(hidden, want, OUT)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)
    assert float(aux) > 0
    n_moe = sum(tcfg.is_moe_layer(i) for i in range(tcfg.num_layers))
    assert len(rec.inputs) == n_moe
    for r, x, router in zip(rec.routings(tcfg.moe.top_k,
                                         tcfg.moe.capacity_factor),
                            rec.inputs, rec.routers):
        _assert_same_routing(r, _jax_route(router.numpy(), x.numpy(),
                                           tcfg.moe.top_k,
                                           tcfg.moe.capacity_factor))
    with torch.no_grad():
        logits, aux2 = ttfm.lm_apply(lm, tcfg, torch.from_numpy(tokens))
    want, _ = jtfm.lm_apply(jparams, jcfg, jnp.asarray(tokens), impl="ref")
    _close(logits, want, OUT)
    assert float(aux2) == float(aux)


def test_decode_steps_match_jax(zoo):
    """Four decode steps from a random cache, rows at positions 0, 3 and
    5: the logits and every cache leaf."""
    arch, tcfg, jcfg, jmodel, jparams, lm = zoo
    model = build_model(tcfg)
    rng = np.random.RandomState(11)
    B = 3
    jcache, _ = jmodel.init_cache(B, 12, jnp.float32)
    init = jax.tree_util.tree_map(
        lambda c: (0.3 * rng.randn(*c.shape)).astype(np.float32), jcache)
    jcache = jax.tree_util.tree_map(jnp.asarray, init)
    cache = model.init_cache(B, 12, torch.float32, device="cpu")
    for name, leaves in cache.items():
        assert set(leaves) == set(init[name])
        for key, leaf in leaves.items():
            leaf.copy_(torch.from_numpy(init[name][key]))
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


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_teacher_forced_logits(arch):
    """Step-by-step decode reproduces the forward's logits. As JAX's
    `tests/test_models.py` does, at capacity factor 8.0: capacity drops
    legitimately differ between the forward's groups (all B*S tokens) and
    a decode step's (B tokens), so the cache path is held dropless."""
    _, tcfg, _, _ = _seeded(arch)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=8.0))
    model = build_model(tcfg)
    lm = model.init(0, device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, tcfg.vocab_size, (2, 8)))
    with torch.no_grad():
        want, _ = ttfm.lm_apply(lm, tcfg, tokens)
    cache = model.init_cache(2, 8, torch.float32, device="cpu")
    for t in range(8):
        got, cache = model.decode_step(lm, cache, tokens[:, t:t + 1], t)
        _close(got[:, 0], want[:, t].numpy(), OUT, f"position {t}")


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_engine_token_lists_match_jax(zoo, temperature):
    """Ragged prompts on 6 slots (a decode step's group of 6 tokens has 4
    rows of expert capacity for up to 6 pairs an expert: drops), more
    requests than slots: the same tokens as JAX's engine at the default
    capacity factor, greedy and Gumbel-max with the same numpy noise."""
    arch, tcfg, jcfg, jmodel, jparams, lm = zoo
    requests = [(i, [1 + i, 2, 3] + [4 + i] * (i % 5), 3 + i % 3)
                for i in range(8)]
    kw = dict(num_slots=6, max_seq=16, temperature=temperature, seed=7)
    got = _outs(ServeEngine, Request, build_model(tcfg), lm, requests, **kw)
    assert got == _outs(JServeEngine, JRequest, jmodel, jparams, requests,
                        **kw)
    assert sorted(got) == list(range(8))


def test_prefill_scan_riding_rows_route_as_jax(zoo):
    """The batched prefill with slots riding along (lens 0, mid-
    generation): their cache rows stay bit for bit, yet they go through
    every MoE layer and take expert capacity as in JAX's `_prefill_scan`
    (at capacity factor 0.5 some pairs are dropped): the last logits and
    the caches equal JAX's."""
    arch, tcfg, jcfg, jmodel, jparams, lm = zoo
    cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.5))
    jc = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.5))
    model, jm = build_model(cfg), jax_build_model(jc)
    rng = np.random.RandomState(3)
    B, T, L = 8, 16, 6
    jcache, _ = jm.init_cache(B, T, jnp.float32)
    init = jax.tree_util.tree_map(
        lambda c: (0.3 * rng.randn(*c.shape)).astype(np.float32), jcache)
    cache = model.init_cache(B, T, torch.float32, device="cpu")
    for name, leaves in cache.items():
        for key, leaf in leaves.items():
            leaf.copy_(torch.from_numpy(init[name][key]))
    lens = np.array([6, 0, 3, 0, 0, 5, 0, 1], np.int32)
    pos = np.array([0, 7, 0, 2, 9, 0, 4, 0], np.int32)
    toks = rng.randint(0, cfg.vocab_size, (B, L)).astype(np.int32)
    toks[lens == 0] = 0
    before = {n: {k: v.clone() for k, v in lv.items()}
              for n, lv in cache.items()}
    rec = _Recorder(lm)
    last, after = _prefill_scan(model.decode_step, cfg.vocab_size, lm, cache,
                                torch.from_numpy(toks),
                                torch.from_numpy(lens), torch.from_numpy(pos))
    rec.close()
    dropped = sum(int((~r.kept).sum())
                  for r in rec.routings(cfg.moe.top_k, 0.5))
    assert dropped > 0
    jlast, jafter = j_prefill_scan(
        jm.decode_step, cfg.vocab_size, jparams,
        jax.tree_util.tree_map(jnp.asarray, init), jnp.asarray(toks),
        jnp.asarray(lens), jnp.asarray(pos))
    _close(last, jlast, OUT)
    riding = torch.from_numpy(lens == 0)
    for name, leaves in after.items():
        for key, leaf in leaves.items():
            assert torch.equal(leaf[:, riding], before[name][key][:, riding])
            _close(leaf, jafter[name][key], STATE, f"{name}/{key}")


def test_moe_configs_build_and_run_on_the_cpu_only_when_asked():
    """The three MoE archs build; an MoE model's entry points refuse CUDA
    without a card (no fallback)."""
    for arch in MOE:
        build_model(tconfig.get_arch(arch))
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot show")
    model = build_model(tconfig.scaled_down(tconfig.get_arch(MOE[0])))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, model.init(0, device="cpu"))

"""The port's sharding rules, spec trees, gradient compression, fault
tolerance and mesh config on the CPU, pure functions only (no ranks),
held against the JAX package: every arch's parameter, cache and input
specs by name, `logical_to_pspec` / `prune_pspec` on both production
meshes for every leaf of every arch, the optimizer state specs, and
int8 error-feedback compression bit for bit."""
import functools
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.core import bbe as jbbe  # noqa: E402
from repro.core import signature as jsig  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model_zoo import build_model as jbuild  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.core import bbe  # noqa: E402
from repro_torch.core import signature as sig  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train import fault_tolerance as ft  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

ARCHS = jconfig.list_archs()


def _abstract(sizes, names):
    try:
        return AbstractMesh(sizes, names)            # jax >= 0.5 signature
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))  # jax 0.4.x signature


MESHES = {
    "pod": ({"data": 16, "model": 16},
            _abstract((16, 16), ("data", "model"))),
    "multi_pod": ({"pod": 2, "data": 16, "model": 16},
                  _abstract((2, 16, 16), ("pod", "data", "model"))),
}
SINGLE = MESHES["pod"][0]


def _flat_specs(tree):
    """{"/"-joined path: spec} of a JAX spec tree (lists by index)."""
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=sharding.is_logical)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in leaves}


def _flat_shapes(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(x.shape)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _jax_lm(arch):
    """JAX's (specs, shapes) of an arch at full width, flattened."""
    box = {}

    def f():
        p, s = jtfm.lm_init(jax.random.PRNGKey(0), jconfig.get_arch(arch))
        box["s"] = s
        return p

    shapes = jax.eval_shape(f)
    return _flat_specs(box["s"]), _flat_shapes(shapes)


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    with torch.device("meta"):
        lm = tfm.LM(config.get_arch(arch))
    return {n.replace(".", "/"): tuple(p.shape)
            for n, p in lm.named_parameters()}


def _stacked(arch):
    """{port name: (JAX stacked name, index or None)}."""
    cfg = config.get_arch(arch)
    return {n: (tfm.stacked_key(cfg, n) or (n, None))
            for n in build_model(cfg).param_specs()}


# ---------------------------------------------------------------------------
# the rules on plain mesh descriptions
# ---------------------------------------------------------------------------

def test_logical_rules_basic():
    multi = MESHES["multi_pod"][0]
    assert sharding.LOGICAL_RULES == jshard.LOGICAL_RULES
    assert sharding.logical_to_pspec(("batch", "seq"), multi) == \
        (("pod", "data"), None)
    assert sharding.logical_to_pspec(("embed", "ff"), multi) == \
        ("data", "model")
    assert sharding.logical_to_pspec(("vocab", "embed"), multi) == \
        ("model", "data")
    assert sharding.logical_to_pspec(("batch",), SINGLE) == ("data",)
    spec = sharding.logical_to_pspec(("heads", "ff"), multi)
    assert spec == ("model", None)           # no mesh axis used twice
    # a MeshConfig and a sequence of pairs read as the dict does
    assert sharding.axis_sizes(config.MeshConfig(multi_pod=True)) == multi
    assert sharding.axis_sizes((("data", 16), ("model", 16))) == SINGLE


def test_prune_small_dims():
    multi = MESHES["multi_pod"][0]
    assert sharding.prune_pspec(("model",), (8,), SINGLE) == (None,)
    assert sharding.prune_pspec((("pod", "data"), None), (1, 128),
                                multi) == (None, None)
    assert sharding.prune_pspec(("model", "data"), (49155, 2048),
                                SINGLE) == (None, "data")
    assert sharding.prune_pspec(("data", "model"), (4096, 32768),
                                SINGLE) == ("data", "model")


@settings(max_examples=50, deadline=None)
@given(dim=st.integers(1, 10_000),
       axis=st.sampled_from(["data", "model", ("data", "model")]))
def test_prune_always_valid(dim, axis):
    """After pruning, every kept mesh-axis product divides its dim, and
    the port prunes as JAX does."""
    spec = sharding.prune_pspec((axis,), (dim,), SINGLE)
    assert spec == tuple(jshard.prune_pspec(jax.sharding.PartitionSpec(axis),
                                            (dim,), MESHES["pod"][1]))
    kept = spec[0]
    if kept is None:
        return
    kept = (kept,) if isinstance(kept, str) else kept
    n = 1
    for a in kept:
        n *= SINGLE[a]
    assert dim % n == 0


def test_arch_rules_apply_overrides():
    grok = config.get_arch("grok_1_314b")
    rules = sharding.arch_rules(grok)
    want = dict(jshard.LOGICAL_RULES)
    want.update(dict(jconfig.get_arch("grok_1_314b").sharding_overrides))
    assert rules == want and rules["expert"] is None
    assert sharding.arch_rules(config.get_arch("smollm_135m")) == \
        sharding.LOGICAL_RULES


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch):
    """Every leaf's spec equals JAX's (a per-layer leaf's with JAX's
    leading "layers" axis), and both trees have the same leaves."""
    jspecs, _ = _jax_lm(arch)
    ported = build_model(config.get_arch(arch)).param_specs()
    assert set(ported) == set(_port_shapes(arch))
    seen = set()
    for name, (key, idx) in _stacked(arch).items():
        want = jspecs[key]
        got = ported[name] if idx is None else ("layers",) + ported[name]
        assert got == want, (name, got, want)
        seen.add(key)
    assert seen == set(jspecs)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_input_specs_and_shapes_match_jax(arch):
    jm, m = jbuild(jconfig.get_arch(arch)), build_model(config.get_arch(arch))
    for name, shape in config.SHAPES.items():
        jshape = jconfig.SHAPES[name]
        assert m.supports_shape(shape) == jm.supports_shape(jshape), name
        assert m.cache_specs(shape) == jm.cache_specs(jshape)
        got, want = m.input_specs(shape), jm.input_specs(jshape)
        assert sorted(got) == sorted(want)
        flat_got = {k: v for k, v in _walk(got)}
        flat_want = _flat_shapes(want)
        assert sorted(flat_got) == sorted(flat_want), name
        for k, t in flat_got.items():
            leaf = _leaf(want, k)
            assert tuple(t.shape) == tuple(leaf.shape), (name, k)
            assert str(t.dtype).split(".")[-1] == str(leaf.dtype), (name, k)


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _leaf(tree, key):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def test_bbe_and_signature_specs_match_jax():
    cfg = bbe.BBEConfig(dim_embeds=(48, 8, 8, 8, 8, 8), num_layers=3,
                        num_heads=2, bbe_dim=32)
    box = {}

    def f():
        p, s = jbbe.bbe_init(jax.random.PRNGKey(0), jbbe.BBEConfig(
            **{k: getattr(cfg, k) for k in ("dim_embeds", "num_layers",
                                            "num_heads", "bbe_dim")}))
        box["s"] = s
        return p

    jax.eval_shape(f)
    want = _flat_specs(box["s"])
    got = bbe.bbe_specs(cfg)
    encoder_names = {n.replace(".", "/") for n, _ in
                     bbe.BBEEncoder(cfg).named_parameters()}
    assert set(got) == encoder_names
    seen = set()
    for name, spec in got.items():
        at = bbe._layer_of(name)
        key, spec = (name, spec) if at is None else (at[0],
                                                     ("layers",) + spec)
        assert want[key] == spec, name
        seen.add(key)
    assert seen == set(want)

    scfg = sig.SignatureConfig(bbe_dim=16, d_model=16, sig_dim=8,
                               num_heads=2, num_sabs=3)
    want = _flat_specs(jsig.signature_specs(jsig.SignatureConfig(
        bbe_dim=16, d_model=16, sig_dim=8, num_heads=2, num_sabs=3)))
    got = sig.signature_specs(scfg)
    assert got == want
    assert set(got) == {n.replace(".", "/") for n, _ in
                        sig.SignatureModel(scfg).named_parameters()}
    assert sig.SignatureModel(scfg).param_specs() == got


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_state_specs_match_jax(name):
    specs = build_model(config.get_arch("jamba_1_5_large_398b")).param_specs()
    _, _, port_fn = opt.make_optimizer(name)
    _, _, jax_fn = jopt.make_optimizer(name)
    assert port_fn(specs) == jax_fn(specs)


# ---------------------------------------------------------------------------
# every leaf of every arch on both production meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_pspecs_match_jax_on_production_meshes(arch, mesh):
    """logical_to_pspec then prune_pspec at each leaf's shape, under the
    arch's rules (grok-1's overrides included), give JAX's spec (a per-
    layer leaf's without the stacked axis)."""
    port_mesh, jax_mesh = MESHES[mesh]
    rules = sharding.arch_rules(config.get_arch(arch))
    jrules = dict(jshard.LOGICAL_RULES)
    jrules.update(dict(jconfig.get_arch(arch).sharding_overrides or ()))
    assert rules == jrules
    jspecs, jshapes = _jax_lm(arch)
    specs = build_model(config.get_arch(arch)).param_specs()
    shapes = _port_shapes(arch)
    for name, (key, idx) in _stacked(arch).items():
        got = sharding.prune_pspec(
            sharding.logical_to_pspec(specs[name], port_mesh, rules),
            shapes[name], port_mesh)
        want = tuple(jshard.prune_pspec(
            jshard.logical_to_pspec(jspecs[key], jax_mesh, jrules),
            jshapes[key], jax_mesh))
        if idx is not None:
            assert want[0] is None, key
            want = want[1:]
        assert got == want, (name, got, want)


# ---------------------------------------------------------------------------
# gradient compression, fault tolerance, configs
# ---------------------------------------------------------------------------

def _grad_tree(rng):
    ties = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 100.25, -126.5],
                    np.float32)
    return {"ties": ties.reshape(2, 4),
            "zeros": np.zeros((3, 5), np.float32),
            "w": (rng.randn(7, 9) * 3e-3).astype(np.float32),
            "b": (rng.randn(11) * 40).astype(np.float32)}


def test_compression_bitwise_jax():
    """Values, scales and residuals of two error-feedback steps, and the
    decompressed trees, bit for bit JAX's (round half to even; the
    all-zero leaf takes the 1e-12 scale floor)."""
    rng = np.random.RandomState(0)
    g1, g2 = _grad_tree(rng), _grad_tree(rng)
    err = jerr = None
    for g in (g1, g2):
        q, s, e = comp.compress_tree({k: torch.from_numpy(v)
                                      for k, v in g.items()}, err)
        jq, js, je = jcomp.compress_tree({k: jnp.asarray(v)
                                          for k, v in g.items()}, jerr)
        for k in g:
            assert q[k].dtype == torch.int8 and s[k].dtype == torch.float32
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
            assert s[k].numpy().tobytes() == np.asarray(js[k]).tobytes(), k
            assert e[k].numpy().tobytes() == np.asarray(je[k]).tobytes(), k
        d, jd = comp.decompress_tree(q, s), jcomp.decompress_tree(jq, js)
        for k in g:
            assert d[k].numpy().tobytes() == np.asarray(jd[k]).tobytes(), k
        if err is None:        # the first step: scale 1, ties to even
            np.testing.assert_array_equal(q["ties"].numpy().ravel()[:6],
                                          [127, 2, -4, 0, 0, 2])
            assert float(s["zeros"]) == np.float32(1e-12) / np.float32(127)
        err, jerr = e, je


def test_supervise_restarts_retryable_exits(tmp_path):
    flag = tmp_path / "ran_once"
    child = ("import os, sys\n"
             f"p = {str(flag)!r}\n"
             "if os.path.exists(p): sys.exit(0)\n"
             "open(p, 'w').close(); sys.exit(42)\n")
    assert ft.supervise([sys.executable, "-c", child], backoff_s=0) == 0
    assert flag.exists()
    # a fast non-retryable failure is returned, not retried
    assert ft.supervise([sys.executable, "-c", "import sys; sys.exit(3)"],
                        backoff_s=0) == 3
    assert ft.RETRYABLE_EXITS == {42, 137, 139, 143}


def test_run_with_restarts():
    calls = []

    def step():
        calls.append(1)
        if len(calls) < 3:
            raise SystemExit(42)

    assert ft.run_with_restarts(step, max_restarts=3) == 2
    with pytest.raises(SystemExit):
        ft.run_with_restarts(lambda: (_ for _ in ()).throw(SystemExit(1)))


def test_mesh_config_and_list_archs_match_jax():
    for multi in (False, True):
        a, b = config.MeshConfig(multi), jconfig.MeshConfig(multi)
        assert (a.shape, a.axes, a.num_devices) == \
            (b.shape, b.axes, b.num_devices)
    assert config.list_archs() == jconfig.list_archs()
    assert {k: dataclass_tuple(v) for k, v in config.SHAPES.items()} == \
        {k: dataclass_tuple(v) for k, v in jconfig.SHAPES.items()}


def dataclass_tuple(x):
    return tuple(getattr(x, f) for f in x.__dataclass_fields__)

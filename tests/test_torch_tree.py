"""The port's tree helpers (`repro_torch.utils.tree`) and the pipeline's
looped set oracles (`SemanticBBVPipeline.interval_set`,
`_batch_sets_looped`) against their JAX twins, on the same numpy data."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.signature import SignatureConfig as JSigConfig  # noqa: E402
from repro.utils import tree as jtree  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.signature import SignatureConfig  # noqa: E402
from repro_torch.utils import tree as ttree  # noqa: E402


def _numpy_tree():
    r = np.random.RandomState(0)
    return {"embed": {"table": r.randn(5, 3).astype(np.float32)},
            "layers": {"0": {"w": r.randn(3, 4).astype(np.float32),
                             "steps": np.arange(6, dtype=np.int32)},
                       "1": {"b": r.randn(4).astype(np.float16)}},
            "scale": np.asarray(r.randn(), np.float32)}


def _torch(tree):
    return ttree.tree_map(torch.from_numpy, tree)


def _flat(tree):
    out = {}
    ttree.tree_map_with_path_str(lambda p, x: out.__setitem__(p, x), tree)
    return out


def _leaves_equal(port, want):
    """Leaf for leaf by path (JAX flattens dicts in sorted key order):
    the same dtype (bf16 compared as its fp32 values), shape and values."""
    port, want = _flat(port), _flat(want)
    assert port.keys() == want.keys()
    for key, a in port.items():
        b = np.asarray(want[key])
        if a.dtype == torch.bfloat16:
            assert b.dtype == jnp.bfloat16
            a, b = a.float().numpy(), b.astype(np.float32)
        else:
            a = a.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b)


def test_counts_and_paths_match_jax():
    tree = _numpy_tree()
    assert ttree.tree_param_count(tree) == jtree.tree_param_count(tree)
    assert ttree.tree_param_count(_torch(tree)) == \
        jtree.tree_param_count(tree) == 15 + 12 + 6 + 4 + 1
    assert ttree.tree_size_bytes(tree) == jtree.tree_size_bytes(tree)
    assert ttree.tree_size_bytes(_torch(tree)) == jtree.tree_size_bytes(tree)
    port = ttree.tree_map_with_path_str(lambda p, x: (p, x.shape), tree)
    want = jtree.tree_map_with_path_str(lambda p, x: (p, x.shape), tree)
    assert port == want
    assert port["layers"]["0"]["w"] == ("layers/0/w", (3, 4))


def test_arithmetic_matches_jax():
    tree, other = _numpy_tree(), _numpy_tree()
    t, o = _torch(tree), _torch(other)
    _leaves_equal(ttree.tree_cast(t, torch.bfloat16),
                  jtree.tree_cast(tree, jnp.bfloat16))
    _leaves_equal(ttree.tree_zeros_like(t), jtree.tree_zeros_like(tree))
    _leaves_equal(ttree.tree_zeros_like(t, torch.float32),
                  jtree.tree_zeros_like(tree, jnp.float32))
    _leaves_equal(ttree.tree_add(t, o), jtree.tree_add(tree, other))
    f32 = {"a": tree["embed"]["table"], "b": tree["layers"]["0"]["w"]}
    _leaves_equal(ttree.tree_scale(_torch(f32), 0.5),
                  jtree.tree_scale(f32, 0.5))
    assert float(ttree.tree_norm(_torch(f32))) == pytest.approx(
        float(jtree.tree_norm(f32)), rel=1e-6)


def _pipelines(max_set, bbe_dim):
    """The two pipelines' set assembly, without their models: instances
    made without __init__, holding only the signature config."""
    jp = object.__new__(jpipe.SemanticBBVPipeline)
    jp.sig_cfg = JSigConfig(bbe_dim=bbe_dim, max_set=max_set)
    tp = object.__new__(tpipe.SemanticBBVPipeline)
    tp.sig_cfg = SignatureConfig(bbe_dim=bbe_dim, max_set=max_set)
    return jp, tp


def test_batch_sets_looped_bitwise_jax_and_vectorised():
    """Intervals over and under max_set, with tied counts and an empty
    one: the port's per-interval oracle is bitwise JAX's, and the port's
    vectorised `_batch_sets` (and `batch_set_ids`' rows) bitwise it."""
    r = np.random.RandomState(3)
    table = {int(b): r.randn(6).astype(np.float32)
             for b in r.choice(1000, 40, replace=False)}
    bids = list(table)
    intervals = []
    for n in (0, 3, 8, 12, 25):
        chosen = r.choice(bids, n, replace=False)
        counts = {int(b): int(c) for b, c in
                  zip(chosen, r.randint(1, 4, size=n))}   # many ties
        intervals.append(types.SimpleNamespace(counts=counts))
    jp, tp = _pipelines(max_set=8, bbe_dim=6)
    want = jp._batch_sets_looped(intervals, table)
    got = tp._batch_sets_looped(intervals, table)
    index = tpipe.BBEIndex(table)
    vec = tp._batch_sets(intervals, index)
    for w, g, v in zip(want, got, vec):
        assert w.dtype == g.dtype == v.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(v, w)
    rows, _, mask = tpipe.batch_set_ids(intervals, index, 8)
    np.testing.assert_array_equal(index.ext[rows], want[0])
    np.testing.assert_array_equal(mask, want[2])
    for iv, w in zip(intervals, zip(*want)):
        for a, b in zip(tp.interval_set(iv, table), w):
            np.testing.assert_array_equal(a, b)

"""The port's kernel families on the CPU: each wrapper's plain PyTorch
version against the JAX package's Pallas kernel (interpret mode) and its
jnp oracle, on the same numpy inputs, at the JAX suite's tolerances."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.kmeans_assign.ops import (  # noqa: E402
    kmeans_assign as jax_kmeans_assign, kmeans_update as jax_kmeans_update,
)
from repro.kernels.kmeans_assign.ref import (  # noqa: E402
    kmeans_assign_reference as jax_assign_ref,
    kmeans_update_reference as jax_update_ref,
)
from repro.kernels.set_attention.ops import (  # noqa: E402
    masked_set_attention as jax_set_attention,
)
from repro.kernels.set_attention.ref import (  # noqa: E402
    set_attention_reference as jax_set_attention_ref,
)
from repro.kernels.wkv.ops import wkv_chunked as jax_wkv  # noqa: E402
from repro.kernels.wkv.ref import wkv_reference as jax_wkv_ref  # noqa: E402
from repro_torch.kernels.kmeans_assign import (  # noqa: E402
    kmeans_assign, kmeans_update,
)
from repro_torch.kernels.set_attention import masked_set_attention  # noqa: E402
from repro_torch.kernels.wkv import wkv  # noqa: E402


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _as_dtype(x, dtype):
    """numpy fp32 values as the JAX side sees them in `dtype` (bf16 rounds)
    — the port gets the same rounded values, in fp32."""
    return np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))


# ---------------------------------------------------------------------------
# wkv
# ---------------------------------------------------------------------------

WKV_CASES = [
    # (B, S, H, dh, chunk, dtype): tests/test_kernels.py's, then dh 44
    # with a sequence no chunk divides
    (1, 32, 1, 8, 8, "float32"),
    (2, 64, 3, 16, 16, "float32"),
    (2, 128, 2, 32, 32, "float32"),
    (1, 64, 4, 64, 64, "float32"),
    (2, 64, 2, 16, 16, "bfloat16"),
    (2, 37, 2, 44, 37, "float32"),
]


def _wkv_inputs(rng, B, S, H, dh, dtype):
    r, k, v = (rng.randn(B, S, H, dh).astype(np.float32) for _ in range(3))
    k = k / np.maximum(np.linalg.norm(k, axis=-1, keepdims=True), 1e-6)
    w = rng.uniform(0.7, 1.0, (B, S, H, dh)).astype(np.float32)
    beta = rng.uniform(0, 1, (B, S, H)).astype(np.float32)
    return [_as_dtype(a, getattr(jnp, dtype)) for a in (r, k, v, w, beta)]


@pytest.mark.parametrize("B,S,H,dh,chunk,dtype", WKV_CASES)
def test_wkv_plain_matches_jax(B, S, H, dh, chunk, dtype):
    rng = np.random.RandomState(B * 1000 + S)
    args = _wkv_inputs(rng, B, S, H, dh, dtype)
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in args]
    y, sf = wkv(*map(_t, args))
    atol = 1e-4 if dtype == "float32" else 5e-2
    for y_j, s_j in (jax_wkv_ref(*jargs),
                     jax_wkv(*jargs, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j, np.float32),
                                   atol=atol, rtol=1e-3)
        np.testing.assert_allclose(sf.numpy(), np.asarray(s_j, np.float32),
                                   atol=atol, rtol=1e-3)


def test_wkv_state_chaining():
    """Two halves with the state carried equal one pass, and an incoming
    state is taken as JAX takes it."""
    rng = np.random.RandomState(0)
    B, S, H, dh = 1, 64, 2, 16
    r, k, v, w, beta = _wkv_inputs(rng, B, S, H, dh, "float32")
    s0 = (0.1 * rng.randn(B, H, dh, dh)).astype(np.float32)
    y_full, s_full = wkv(*map(_t, (r, k, v, w, beta)), state=_t(s0))
    h = S // 2
    y1, s1 = wkv(*(_t(a[:, :h]) for a in (r, k, v, w, beta)), state=_t(s0))
    y2, s2 = wkv(*(_t(a[:, h:]) for a in (r, k, v, w, beta)), state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=1e-4,
                               rtol=1e-3)
    y_j, s_j = jax_wkv_ref(*map(jnp.asarray, (r, k, v, w, beta)),
                           state=jnp.asarray(s0))
    np.testing.assert_allclose(y_full.numpy(), np.asarray(y_j), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(s_full.numpy(), np.asarray(s_j), atol=1e-4,
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# set attention
# ---------------------------------------------------------------------------

SET_ATTN_CASES = [
    # (B, H, N, M, dh, weighted, masked, dtype): tests/test_kernels.py's,
    # then the PMA's one query at dh 44 and odd M
    (1, 2, 16, 16, 16, False, False, "float32"),
    (2, 4, 64, 64, 64, True, True, "float32"),
    (2, 2, 1, 64, 32, True, True, "float32"),
    (2, 2, 5, 13, 16, True, True, "float32"),
    (1, 3, 17, 33, 8, False, True, "float32"),
    (2, 2, 7, 130, 16, True, False, "float32"),
    (2, 2, 32, 32, 32, True, True, "bfloat16"),
    (3, 2, 1, 13, 44, True, True, "float32"),
    (2, 2, 9, 21, 44, False, True, "float32"),
]


def _set_attn_inputs(rng, B, H, N, M, dh, weighted, masked, dtype="float32"):
    jd = getattr(jnp, dtype)
    q = _as_dtype(rng.randn(B, H, N, dh).astype(np.float32), jd)
    k = _as_dtype(rng.randn(B, H, M, dh).astype(np.float32), jd)
    v = _as_dtype(rng.randn(B, H, M, dh).astype(np.float32), jd)
    bias = (rng.uniform(0, 1, (B, M)).astype(np.float32) if weighted
            else None)
    mask = None
    if masked:
        mask = rng.rand(B, M) > 0.3
        mask[:, 0] = True
    return q, k, v, bias, mask


def _jax_set_attention(q, k, v, bias, mask, dtype="float32", kernel=True):
    jd = getattr(jnp, dtype)
    args = (jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
            None if bias is None else jnp.asarray(bias),
            None if mask is None else jnp.asarray(mask))
    out = (jax_set_attention(*args, interpret=True) if kernel
           else jax_set_attention_ref(*args))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("B,H,N,M,dh,weighted,masked,dtype", SET_ATTN_CASES)
def test_set_attention_plain_matches_jax(B, H, N, M, dh, weighted, masked,
                                         dtype):
    rng = np.random.RandomState(31 * N + M)
    args = _set_attn_inputs(rng, B, H, N, M, dh, weighted, masked, dtype)
    out = masked_set_attention(*map(_t, args)).numpy()
    atol = 1e-5 if dtype == "float32" else 3e-2
    for kernel in (False, True):
        np.testing.assert_allclose(
            out, _jax_set_attention(*args, dtype=dtype, kernel=kernel),
            atol=atol, rtol=1e-3)


def test_set_attention_fully_masked_rows_match_jax():
    """Rows with no valid key collapse to the same uniform softmax over
    the M keys as the JAX kernel and oracle (additive NEG_INF), never
    NaN."""
    rng = np.random.RandomState(3)
    q, k, v, bias, _ = _set_attn_inputs(rng, 3, 2, 8, 21, 16, True, False)
    mask = rng.rand(3, 21) > 0.3
    mask[1, :] = False
    out = masked_set_attention(*map(_t, (q, k, v, bias, mask))).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), out[1].shape), atol=1e-5)
    for kernel in (False, True):
        np.testing.assert_allclose(
            out, _jax_set_attention(q, k, v, bias, mask, kernel=kernel),
            atol=1e-5, rtol=1e-3)


def test_set_attention_padding_independence():
    """Growing M with masked-out garbage keys leaves the output as it is."""
    rng = np.random.RandomState(7)
    q, k, v, bias, mask = _set_attn_inputs(rng, 2, 2, 9, 21, 16, True, True)
    out = masked_set_attention(*map(_t, (q, k, v, bias, mask)))
    pad = 40
    kp = np.pad(k, ((0, 0), (0, 0), (0, pad), (0, 0)), constant_values=3.0)
    vp = np.pad(v, ((0, 0), (0, 0), (0, pad), (0, 0)), constant_values=5.0)
    bp = np.pad(bias, ((0, 0), (0, pad)), constant_values=9.0)
    mp = np.pad(mask, ((0, 0), (0, pad)))
    out_p = masked_set_attention(*map(_t, (q, kp, vp, bp, mp)))
    np.testing.assert_allclose(out_p.numpy(), out.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

KM_CASES = [
    # (N, d, K, dtype): tests/test_kernels.py's (block sizes do not apply)
    (100, 8, 4, "float32"),
    (1000, 64, 14, "float32"),
    (513, 32, 30, "float32"),
    (256, 16, 5, "bfloat16"),
]


def _km_inputs(N, d, K, dtype):
    rng = np.random.RandomState(N)
    jd = getattr(jnp, dtype)
    x = _as_dtype(rng.randn(N, d).astype(np.float32), jd)
    c = _as_dtype(rng.randn(K, d).astype(np.float32), jd)
    return x, c


@pytest.mark.parametrize("N,d,K,dtype", KM_CASES)
def test_kmeans_assign_plain_matches_jax(N, d, K, dtype):
    x, c = _km_inputs(N, d, K, dtype)
    a, d2 = kmeans_assign(_t(x), _t(c))
    assert a.dtype == torch.int32
    atol = 1e-3 if dtype == "float32" else 1.0
    for a_j, d2_j in (jax_assign_ref(jnp.asarray(x), jnp.asarray(c)),
                      jax_kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                        interpret=True)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
        np.testing.assert_allclose(d2.numpy(), np.asarray(d2_j), atol=atol,
                                   rtol=1e-2)


def test_kmeans_assign_ties_go_to_lowest_index():
    """Exact ties (a centroid listed twice, points equidistant from two
    centroids) pick the lowest index, as jnp.argmin does."""
    c = np.array([[1.0, 0.0], [-1.0, 0.0], [1.0, 0.0]], np.float32)
    x = np.array([[0.0, 2.0], [0.0, -1.0], [3.0, 0.0], [0.5, 0.0],
                  [-2.0, 0.0]], np.float32)
    a, _ = kmeans_assign(_t(x), _t(c))
    a_j, _ = jax_kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                               interpret=True)
    np.testing.assert_array_equal(a.numpy(), [0, 0, 0, 0, 1])
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))


@pytest.mark.parametrize("N,d,K,dtype", KM_CASES)
def test_kmeans_update_plain_matches_jax(N, d, K, dtype):
    """Fused step with a masked tail (the store's padded shape), against
    the JAX kernel and oracle: counts exact, sums/inertia in fp32."""
    x, c = _km_inputs(N, d, K, dtype)
    valid = (np.arange(N) < (3 * N) // 4).astype(np.float32)
    s, n, i = kmeans_update(_t(x), _t(c), _t(valid))
    tol = (dict(rtol=1e-4, atol=1e-3) if dtype == "float32"
           else dict(rtol=5e-2, atol=1.0))
    jx, jc, jv = jnp.asarray(x), jnp.asarray(c), jnp.asarray(valid)
    s_k, n_k, i_k = jax_kmeans_update(jx, jc, jv, interpret=True)
    s_r, n_r, i_r = jax_update_ref(jx, jc, jv)
    for s_j, n_j, i_j in ((s_k, n_k, i_k), (s_r, n_r, i_r[0])):
        np.testing.assert_array_equal(n.numpy(), np.asarray(n_j))
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **tol)
        np.testing.assert_allclose(float(i), float(i_j), **tol)


def test_kmeans_update_none_valid_counts_everything():
    rng = np.random.RandomState(7)
    x = rng.randn(100, 8).astype(np.float32)
    c = rng.randn(4, 8).astype(np.float32)
    s, counts, inertia = kmeans_update(_t(x), _t(c))
    assert float(counts.sum()) == 100.0
    s_j, n_j, i_j = jax_kmeans_update(jnp.asarray(x), jnp.asarray(c),
                                      interpret=True)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(float(inertia), float(i_j), rtol=1e-4,
                               atol=1e-3)


def test_kmeans_update_holes_in_valid_mask():
    """An arbitrary 0/1 mask (tombstones): dead rows add nothing."""
    rng = np.random.RandomState(11)
    x = rng.randn(300, 16).astype(np.float32)
    c = rng.randn(6, 16).astype(np.float32)
    valid = (rng.rand(300) < 0.6).astype(np.float32)
    s, n, i = kmeans_update(_t(x), _t(c), _t(valid))
    live = valid > 0
    s2, n2, i2 = kmeans_update(_t(x[live]), _t(c))
    np.testing.assert_array_equal(n.numpy(), n2.numpy())
    np.testing.assert_allclose(s.numpy(), s2.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(i), float(i2), rtol=1e-5)
    s_j, n_j, _ = jax_kmeans_update(jnp.asarray(x), jnp.asarray(c),
                                    jnp.asarray(valid), interpret=True)
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-4,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_wrappers_reject_mixed_devices():
    x = torch.zeros((4, 2))
    with pytest.raises(ValueError):
        kmeans_assign(x, torch.zeros((2, 2), device="meta"))

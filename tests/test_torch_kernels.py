"""The port's kernel families on the CPU: each wrapper's plain PyTorch
version against the JAX package's Pallas kernel (interpret mode) and its
jnp oracle, on the same numpy inputs, at the JAX suite's tolerances."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash,
)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_reference as jax_flash_ref,
)
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
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.kmeans_assign import (  # noqa: E402
    kmeans_assign, kmeans_update,
)
from repro_torch.kernels.set_attention import (  # noqa: E402
    masked_set_attention, set_attention_backward,
    set_attention_backward_reference, set_attention_reference,
)
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


@pytest.mark.parametrize("dh,padded,groups,threads", [
    (1, 32, 4, 32), (8, 32, 4, 32), (32, 32, 4, 32), (33, 64, 4, 64),
    (44, 64, 4, 64), (64, 64, 4, 64), (65, 128, 8, 256), (128, 128, 8, 256)])
def test_wkv_kernel_plan(dh, padded, groups, threads):
    """The instance `csrc/wkv.cu` launches for a head dim: rows a thread a
    multiple of 4 (float4 broadcasts), whole warps, two stages of 8 tokens
    under the 48 KB of static shared memory."""
    from repro_torch.kernels.wkv.ops import kernel_plan
    plan = kernel_plan(dh)
    assert (plan["padded"], plan["row_groups"], plan["threads"]) == (
        padded, groups, threads)
    assert plan["rows"] % 4 == 0 and plan["threads"] % 32 == 0
    assert plan["rows"] * plan["row_groups"] == padded
    assert plan["shared_bytes"] == 4 * 2 * (4 * 8 * padded + 8) <= 48 * 1024


@pytest.mark.parametrize("dh", [0, 129, 256])
def test_wkv_kernel_plan_refuses_a_head_dim(dh):
    from repro_torch.kernels.wkv.ops import kernel_plan
    with pytest.raises(ValueError):
        kernel_plan(dh)


def _butterfly(parts):
    """Sums a list of per-lane partials as the kernels' shfl.xor steps
    do: at each step lane g adds lane g ^ off's value to its own."""
    off = 1
    while off < len(parts):
        parts = [parts[g] + parts[g ^ off] for g in range(len(parts))]
        off <<= 1
    return parts[0]


def _wkv_tile_model(r, k, v, w, beta, s0):
    """numpy fp32 model of the wkv kernel's arithmetic order: the state
    zero-padded to the plan's head dim, row group g holding rows
    4 (g + G q) + e; per token the decay and each group's partial
    (S^T k)_j summed over its rows in order, the butterfly over the G
    groups, the rank-1 update, then (S^T r)_j the same way."""
    from repro_torch.kernels.wkv.ops import kernel_plan
    B, S, H, dh = r.shape
    plan = kernel_plan(dh)
    P, G = plan["padded"], plan["row_groups"]

    def pad(a):
        return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, P - dh)])
    r_, k_, v_, w_ = map(pad, (r, k, v, w))
    st = np.zeros((B, H, P, P), np.float32)
    if s0 is not None:
        st[:, :, :dh, :dh] = s0
    rows = [[4 * (g + G * q) + e for q in range(P // G // 4)
             for e in range(4)] for g in range(G)]
    y = np.zeros((B, S, H, P), np.float32)
    for t in range(S):
        wt, kt, rt, vt = w_[:, t], k_[:, t], r_[:, t], v_[:, t]
        st = st * wt[..., :, None]
        parts = []
        for g in range(G):
            a = np.zeros((B, H, P), np.float32)
            for i in rows[g]:
                a = a + st[:, :, i, :] * kt[..., i, None]
            parts.append(a)
        bd = beta[:, t][..., None] * (vt - _butterfly(parts))
        st = st + kt[..., :, None] * bd[..., None, :]
        parts = []
        for g in range(G):
            a = np.zeros((B, H, P), np.float32)
            for i in rows[g]:
                a = a + st[:, :, i, :] * rt[..., i, None]
            parts.append(a)
        y[:, t] = _butterfly(parts)
    return y[..., :dh], st[:, :, :dh, :dh]


@pytest.mark.parametrize("B,S,H,dh", [(1, 5, 1, 8), (2, 37, 2, 44),
                                      (1, 17, 2, 64), (1, 9, 1, 100)])
def test_wkv_tile_model_matches_plain_and_jax(B, S, H, dh):
    """The CUDA kernel's tiling and summation order, modelled in numpy,
    against the plain version and the JAX twin (kernel in interpret mode
    and its oracle) at the JAX suite's tolerance, with a state in."""
    rng = np.random.RandomState(dh + S)
    args = _wkv_inputs(rng, B, S, H, dh, "float32")
    s0 = (0.1 * rng.randn(B, H, dh, dh)).astype(np.float32)
    y_m, s_m = _wkv_tile_model(*args, s0)
    y_p, s_p = wkv(*map(_t, args), state=_t(s0))
    jargs = [jnp.asarray(a) for a in args]
    for y_w, s_w in ((y_p.numpy(), s_p.numpy()),
                     jax_wkv_ref(*jargs, state=jnp.asarray(s0)),
                     jax_wkv(*jargs, chunk=S, state=jnp.asarray(s0),
                             interpret=True)):
        np.testing.assert_allclose(y_m, np.asarray(y_w), atol=1e-4,
                                   rtol=1e-3)
        np.testing.assert_allclose(s_m, np.asarray(s_w), atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("dh,padded,rows,groups,threads,shared", [
    (1, 32, 4, 8, 64, 4 * (2 * (32 * 36 + 164) + 3 * 2 * 32 + 2)),
    (48, 64, 8, 8, 128, 40496), (64, 64, 8, 8, 128, 40496),
    (100, 128, 8, 16, 512, 164960)])
def test_wkv_backward_plan(dh, padded, rows, groups, threads, shared):
    from repro_torch.kernels.wkv.ops import backward_plan
    assert backward_plan(dh) == dict(padded=padded, rows=rows,
                                     row_groups=groups, threads=threads,
                                     shared_bytes=shared)


def _wkv_bwd_tile_model(r, k, v, w, beta, s0, dy, dsf):
    """numpy fp32 model of the wkv backward kernel's arithmetic order
    (csrc/wkv.cu, namespace bwd): everything zero-padded to the plan's
    head dim; a thread holds rows g + G m (g its row group) of 4 columns;
    per token, in reverse, the column sums (A^T k)_j and (G^T k)_j over a
    group's rows in order, the butterfly over the G groups, then per row
    the sums over the thread's 4 columns, the butterfly over the column
    groups of a warp and the sum over the warps in order. S_{t-1} comes
    from the plain forward (the forward kernel writes it)."""
    from repro_torch.kernels.wkv.ops import backward_plan
    B, S, H, dh = r.shape
    plan = backward_plan(dh)
    P, R, G = plan["padded"], plan["rows"], plan["row_groups"]
    per_warp = 32 // G                   # column groups a warp
    warps = plan["threads"] // 32

    def pad(a):
        return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, P - a.shape[-1])])

    def pad2(a):
        out = np.zeros(a.shape[:-2] + (P, P), np.float32)
        out[..., :dh, :dh] = a
        return out
    r_, k_, v_, w_, dy_ = map(pad, (r, k, v, w, dy))
    prev, st = [], np.zeros((B, H, P, P), np.float32)
    if s0 is not None:
        st = pad2(s0)
    for t in range(S):                   # S_{t-1} of every token
        prev.append(st)
        a = st * w_[:, t][..., :, None]
        delta = v_[:, t] - np.einsum("bhkv,bhk->bhv", a, k_[:, t])
        st = (a + beta[:, t][..., None, None]
              * (k_[:, t][..., :, None] * delta[..., None, :])
              ).astype(np.float32)

    def over_columns(parts):
        """(..., P, column groups) thread partials -> the kernel's sum:
        butterfly within a warp, then the warps in order."""
        total = np.zeros(parts.shape[:-1], np.float32)
        for wp in range(warps):
            total = total + _butterfly([parts[..., wp * per_warp + x]
                                        for x in range(per_warp)])
        return total

    g = np.zeros((B, H, P, P), np.float32) if dsf is None else pad2(dsf)
    out = [np.zeros((B, S, H, P), np.float32) for _ in range(4)]
    dbeta = np.zeros((B, S, H), np.float32)
    for t in reversed(range(S)):
        sp, wt, kt, rt, vt, dyt = (prev[t], w_[:, t], k_[:, t], r_[:, t],
                                   v_[:, t], dy_[:, t])
        bt = beta[:, t][..., None]
        a_parts, gk_parts = [], []
        for grp in range(G):
            a = np.zeros((B, H, P), np.float32)
            gk = np.zeros((B, H, P), np.float32)
            for m in range(R):
                i = grp + G * m
                wi, ki = wt[..., i, None], kt[..., i, None]
                a = _fma32(sp[:, :, i] * wi, ki, a)
                g[:, :, i] = _fma32(rt[..., i, None], dyt, g[:, :, i])
                gk = _fma32(g[:, :, i], ki, gk)
            a_parts.append(a)
            gk_parts.append(gk)
        a, gk = _butterfly(a_parts), _butterfly(gk_parts)
        dl, dd = vt - a, bt * gk
        pb = np.zeros((B, H, P // 4), np.float32)
        for c in range(4):
            pb = _fma32(dl[..., c::4], gk[..., c::4], pb)
        ncg = P // 4
        pr, pk, pw = (np.zeros((B, H, P, ncg), np.float32) for _ in range(3))
        A = sp * wt[..., :, None]
        bk = bt * kt
        for c in range(4):
            cols = slice(c, P, 4)
            Ac, gc = A[..., cols], g[..., cols]
            pr = _fma32(_fma32(bk[..., :, None], dl[..., None, cols], Ac),
                        dyt[..., None, cols], pr)
            pk = _fma32(bt[..., None] * gc, dl[..., None, cols], pk)
            pk = _fma32(-Ac, dd[..., None, cols], pk)
            dA = _fma32(-kt[..., :, None], dd[..., None, cols], gc)
            pw = _fma32(dA, sp[..., cols], pw)
            g[..., cols] = wt[..., :, None] * dA
        for o, p in zip(out, (pr, pk, None, pw)):
            if p is not None:
                o[:, t] = over_columns(p)
        out[2][:, t] = dd
        dbeta[:, t] = over_columns(pb[..., None, :])[..., 0]
    dr, dk, dv, dw = (o[..., :dh] for o in out)
    return dr, dk, dv, dw, dbeta, g[:, :, :dh, :dh]


@pytest.mark.parametrize("B,S,H,dh", [(1, 5, 1, 8), (2, 13, 2, 44),
                                      (1, 9, 2, 64), (1, 4, 1, 100),
                                      (2, 1, 2, 16)])
def test_wkv_backward_tile_model_matches_plain_and_jax(B, S, H, dh):
    """The backward kernel's tiling and summation order, modelled in
    numpy, against the plain reverse loop and `jax.grad` of the JAX
    package's scan oracle, with a state in and a final-state gradient."""
    import jax
    from repro_torch.kernels.wkv import wkv_backward_reference
    rng = np.random.RandomState(dh + 7 * S)
    args = _wkv_inputs(rng, B, S, H, dh, "float32")
    s0 = (0.1 * rng.randn(B, H, dh, dh)).astype(np.float32)
    dy = rng.randn(B, S, H, dh).astype(np.float32)
    dsf = rng.randn(B, H, dh, dh).astype(np.float32)
    got = _wkv_bwd_tile_model(*args, s0, dy, dsf)
    plain = wkv_backward_reference(*map(_t, args), _t(s0), _t(dy), _t(dsf))

    def f(*xs):
        y, sf = jax_wkv_ref(*xs[:5], state=xs[5])
        return jnp.sum(y * dy) + jnp.sum(sf * dsf)
    jgrads = jax.grad(f, range(6))(*map(jnp.asarray, (*args, s0)))
    for name, m, p, j in zip(("dr", "dk", "dv", "dw", "dbeta", "dstate"),
                             got, plain, jgrads):
        for want in (p.numpy(), np.asarray(j)):
            np.testing.assert_allclose(m, want, atol=1e-4, rtol=1e-3,
                                       err_msg=name)


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
# set attention backward
# ---------------------------------------------------------------------------

SET_ATTN_GRAD_CASES = [
    # (B, H, N, M, dh, weighted, masked): tests/test_kernels.py's fp32
    # gradient cases, then dh 44, the PMA's N = 1 at dh 44, and M = 13
    (1, 2, 16, 16, 16, False, False),
    (2, 2, 1, 64, 32, True, True),
    (2, 2, 5, 13, 16, True, True),
    (1, 3, 17, 33, 8, False, True),
    (2, 2, 7, 130, 16, True, False),
    (2, 2, 9, 21, 44, True, True),
    (3, 2, 1, 64, 44, True, True),
    (2, 4, 64, 13, 64, True, True),
]


def _jax_set_attention_grads(q, k, v, bias, mask, ct):
    """jax.grad through the JAX Pallas kernel's custom VJP (interpret
    mode), for q, k, v and the bias."""
    import jax

    def scalar(q_, k_, v_, b_):
        o = jax_set_attention(q_, k_, v_, b_, None if mask is None
                              else jnp.asarray(mask), interpret=True)
        return jnp.sum(o * ct)
    return jax.grad(scalar, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, bias)))


@pytest.mark.parametrize("B,H,N,M,dh,weighted,masked", SET_ATTN_GRAD_CASES)
def test_set_attention_backward_plain_matches_jax(B, H, N, M, dh, weighted,
                                                  masked):
    """The plain backward against (a) torch autograd through the plain
    forward and (b) jax.grad through the JAX kernel; and
    `masked_set_attention`'s autograd Function gives the same grads with
    the bias gradient summed over heads."""
    rng = np.random.RandomState(7 * N + M)
    q, k, v, bias, mask = _set_attn_inputs(rng, B, H, N, M, dh, True, masked)
    if not weighted:
        bias = np.zeros_like(bias)       # keep it differentiable, no signal
    ct = rng.randn(B, H, N, dh).astype(np.float32)
    tq, tk, tv, tb, tm = map(_t, (q, k, v, bias, mask))
    dq, dk, dv, db = set_attention_backward_reference(tq, tk, tv, tb, tm,
                                                      _t(ct))
    assert db.shape == (B, H, M) and db.dtype == torch.float32
    got = (dq, dk, dv, db.sum(1))
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv, tb)]
    auto = torch.autograd.grad(
        (set_attention_reference(*leaves, tm) * _t(ct)).sum(), leaves)
    fn_leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv, tb)]
    via_fn = torch.autograd.grad(
        (masked_set_attention(*fn_leaves, tm) * _t(ct)).sum(), fn_leaves)
    jgrads = _jax_set_attention_grads(q, k, v, bias, mask, ct)
    for name, g, a, f, j in zip(("dq", "dk", "dv", "dbias"), got, auto,
                                via_fn, jgrads):
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=1e-4,
                                   rtol=1e-3, err_msg=f"{name} vs autograd")
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-4,
                                   rtol=1e-3, err_msg=f"{name} vs jax")
        assert torch.equal(f, g), name


def test_set_attention_masked_key_grads_exactly_zero():
    """tests/test_kernels.py's case: masked keys of rows with a valid key
    get exactly zero dk, dv and db, through the autograd Function."""
    rng = np.random.RandomState(11)
    B, H, N, M, dh = 2, 2, 9, 21, 16
    q, k, v, bias, _ = _set_attn_inputs(rng, B, H, N, M, dh, True, False)
    m = rng.rand(B, M) > 0.4
    m[:, 0] = True
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v, bias)]
    out = masked_set_attention(*leaves, _t(m))
    _, dk, dv, db = torch.autograd.grad((out ** 2).sum(), leaves)
    dead = torch.from_numpy(~m)
    assert (dk.permute(0, 2, 1, 3)[dead] == 0).all()
    assert (dv.permute(0, 2, 1, 3)[dead] == 0).all()
    assert (db[dead] == 0).all()
    assert (dk.permute(0, 2, 1, 3)[~dead] != 0).any()


def test_set_attention_backward_fully_masked_rows_match_jax():
    """A batch row with no valid key keeps its uniform P, so its grads
    are not zero; they equal the JAX kernel's."""
    rng = np.random.RandomState(3)
    q, k, v, bias, _ = _set_attn_inputs(rng, 3, 2, 8, 21, 16, True, False)
    mask = rng.rand(3, 21) > 0.3
    mask[1, :] = False
    ct = rng.randn(3, 2, 8, 16).astype(np.float32)
    dq, dk, dv, db = set_attention_backward_reference(
        *map(_t, (q, k, v, bias, mask, ct)))
    assert (dk[1] != 0).any() and (dv[1] != 0).any()
    for name, g, j in zip(("dq", "dk", "dv", "dbias"),
                          (dq, dk, dv, db.sum(1)),
                          _jax_set_attention_grads(q, k, v, bias, mask, ct)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-4,
                                   rtol=1e-3, err_msg=name)


def test_set_attention_function_wiring():
    """No gradient wanted (inference mode, no_grad, plain inputs): the
    forward runs alone and the output has no graph. A bias that does not
    require grad gets None; the mask never gets one. On the CPU neither
    launch counter moves."""
    rng = np.random.RandomState(5)
    q, k, v, bias, mask = map(_t, _set_attn_inputs(rng, 2, 2, 5, 13, 16,
                                                   True, True))
    before = (masked_set_attention.launches, set_attention_backward.launches)
    qg = q.clone().requires_grad_(True)
    with torch.inference_mode():
        assert masked_set_attention(qg, k, v, bias, mask).grad_fn is None
    with torch.no_grad():
        assert masked_set_attention(qg, k, v, bias, mask).grad_fn is None
    assert masked_set_attention(q, k, v, bias, mask).grad_fn is None
    out = masked_set_attention(qg, k, v, bias, mask)
    assert type(out.grad_fn).__name__ == "_SetAttentionBackward"
    dq, = torch.autograd.grad(out.sum(), [qg])
    want = set_attention_backward_reference(q, k, v, bias, mask,
                                            torch.ones_like(q))[0]
    assert torch.equal(dq, want)
    assert (masked_set_attention.launches,
            set_attention_backward.launches) == before


@pytest.mark.parametrize("N,M,dh,route,shared", [
    (1, 64, 64, "small_n", 4 * (128 * 68 + 2 * 128)),   # Stage 2's PMA
    (4, 64, 64, "small_n", 4 * (128 * 68 + 8 * 128)),
    (5, 64, 64, "tiled", 104448),
    (64, 64, 64, "tiled", 104448),                       # Stage 2's SAB
    (1, 20000, 256, "tiled", 104448),                    # P, dS too long
    (130, 130, 256, "tiled", 104448),
    (2, 13, 7, "small_n", 4 * (128 * 11 + 4 * 20)),
])
def test_set_attention_backward_plan(N, M, dh, route, shared):
    """The backward's route by N and its shared bytes, which stay under
    a block's 227 KB, and half of an SM's for the tiled kernel (two
    blocks an SM)."""
    from repro_torch.kernels.set_attention.ops import backward_plan
    plan = backward_plan(N, M, dh)
    assert (plan["route"], plan["shared_bytes"]) == (route, shared)
    assert plan["shared_bytes"] <= 232448
    if route == "tiled":
        assert 2 * plan["shared_bytes"] + 2 * 1024 <= 228 * 1024


@pytest.mark.parametrize("N,M,dh", [(0, 4, 8), (4, 0, 8), (4, 4, 0),
                                    (4, 4, 257)])
def test_set_attention_backward_plan_refuses_a_shape(N, M, dh):
    from repro_torch.kernels.set_attention.ops import backward_plan
    with pytest.raises(ValueError):
        backward_plan(N, M, dh)


def _bwd_tile_model(q, k, v, bias, mask, do, tile=64):
    """numpy fp32 model of the tiled backward kernel's algorithm: query
    tiles of 64 rows; with more than one key tile, the row max and sum by
    a running max over the key tiles, then delta over them (scores
    recomputed), before the gradient pass; P zero on rows past N; dQ
    summed over key tiles and dK, dV and db over query tiles in order,
    as the kernel sums them in place."""
    B, H, N, dh = q.shape
    M = k.shape[2]
    scale = np.float32(dh ** -0.5)
    add = np.zeros((B, M), np.float32) if bias is None else bias
    madd = (np.zeros((B, M), np.float32) if mask is None else
            np.where(mask, np.float32(0), np.float32(-2.0 ** 30)))
    dq = np.zeros_like(q)
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    db = np.zeros((B, H, M), np.float32)
    nkt = -(-M // tile)

    def scores(n0, m0):
        s = np.einsum("bhnd,bhmd->bhnm", q[:, :, n0:n0 + tile],
                      k[:, :, m0:m0 + tile]).astype(np.float32) * scale
        s = s + add[:, None, None, m0:m0 + tile]
        return s + madd[:, None, None, m0:m0 + tile]

    def dprob(n0, m0):
        return np.einsum("bhnd,bhmd->bhnm", do[:, :, n0:n0 + tile],
                         v[:, :, m0:m0 + tile]).astype(np.float32)

    for n0 in range(0, N, tile):
        if nkt > 1:
            m = np.full(q[:, :, n0:n0 + tile, 0].shape, -np.inf, np.float32)
            lsum = np.zeros_like(m)
            for m0 in range(0, M, tile):
                s = scores(n0, m0)
                m_new = np.maximum(m, s.max(-1))
                lsum = (lsum * np.exp(m - m_new) +
                        np.exp(s - m_new[..., None]).sum(-1))
                m = m_new
            delta = np.zeros_like(m)
            for m0 in range(0, M, tile):
                p = np.exp(scores(n0, m0) - m[..., None]) / lsum[..., None]
                delta = delta + (dprob(n0, m0) * p).sum(-1)
        for m0 in range(0, M, tile):
            s, dp = scores(n0, m0), dprob(n0, m0)
            if nkt == 1:
                m = s.max(-1)
                lsum = np.exp(s - m[..., None]).sum(-1)
            p = np.exp(s - m[..., None]) / lsum[..., None]
            if nkt == 1:
                delta = (dp * p).sum(-1)
            ds = p * (dp - delta[..., None])
            db[:, :, m0:m0 + tile] += ds.sum(2)
            dq[:, :, n0:n0 + tile] += np.einsum(
                "bhnm,bhmd->bhnd", ds, k[:, :, m0:m0 + tile]) * scale
            dk[:, :, m0:m0 + tile] += np.einsum(
                "bhnm,bhnd->bhmd", ds, q[:, :, n0:n0 + tile]) * scale
            dv[:, :, m0:m0 + tile] += np.einsum(
                "bhnm,bhnd->bhmd", p, do[:, :, n0:n0 + tile])
    return dq, dk, dv, db


@pytest.mark.parametrize("B,H,N,M,dh,empty", [
    (2, 2, 9, 21, 44, 0), (2, 2, 70, 13, 16, 1), (1, 2, 9, 130, 8, 1),
    (2, 2, 130, 70, 16, 1)])
def test_set_attention_backward_tile_model_matches_plain_and_jax(B, H, N, M,
                                                                 dh, empty):
    """The tiled backward kernel's tile loop, running max over key tiles
    and sums over tiles, modelled in numpy, against the plain backward and
    jax.grad through the JAX kernel (interpret mode) at the gradient bound
    of tests/test_kernels.py, fully masked rows included."""
    rng = np.random.RandomState(N * M + dh)
    q, k, v, bias, mask = _set_attn_inputs(rng, B, H, N, M, dh, True, True)
    mask[B - empty:] = False
    ct = rng.randn(B, H, N, dh).astype(np.float32)
    got = _bwd_tile_model(q, k, v, bias, mask, ct)
    plain = set_attention_backward_reference(*map(_t, (q, k, v, bias, mask,
                                                       ct)))
    jgrads = _jax_set_attention_grads(q, k, v, bias, mask, ct)
    for name, g, want, j in zip(("dq", "dk", "dv", "db"), got, plain,
                                jgrads):
        np.testing.assert_allclose(g, want.numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=f"{name} vs plain")
        np.testing.assert_allclose(g.sum(1) if name == "db" else g,
                                   np.asarray(j), atol=1e-4, rtol=1e-3,
                                   err_msg=f"{name} vs jax")


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


@pytest.mark.parametrize("N,d,K,blocks,k_tile,stride4,quarter4,shared", [
    # the build's shape; d 200 and K 30 (two K tiles); d 8 and K 4; d 7
    # (rows of 2 float4s: stride made odd); one row at d 256. Shared: the
    # row tile, four centroid quarters, c2, three row arrays, two warps'
    # counts and inertia, four warps' row lists
    (32768, 128, 14, 512, 16, 33, 137,
     4 * (4 * 33 * 64 + 16 * 137 + 16 + 192 + 34 + 256)),
    (1000, 200, 30, 16, 16, 51, 209,
     4 * (4 * 51 * 64 + 16 * 209 + 16 + 192 + 34 + 256)),
    (77, 8, 4, 2, 4, 3, 9, 4 * (4 * 3 * 64 + 16 * 9 + 4 + 192 + 10 + 256)),
    (513, 7, 5, 9, 8, 3, 9, 4 * (4 * 3 * 64 + 16 * 9 + 8 + 192 + 18 + 256)),
    (1, 256, 9, 1, 16, 65, 265,
     4 * (4 * 65 * 64 + 16 * 265 + 16 + 192 + 34 + 256)),
])
def test_kmeans_plan(N, d, K, blocks, k_tile, stride4, quarter4, shared):
    from repro_torch.kernels.kmeans_assign.ops import kmeans_plan
    plan = kmeans_plan(N, d, K)
    assert plan["rows_per_block"] == 64 and plan["blocks"] == blocks
    assert plan["k_tile"] == k_tile and plan["stride4"] == stride4
    # odd row stride, quarters 1 mod 8 apart: no shared bank conflicts
    assert plan["quarter4"] == quarter4 and quarter4 % 8 == 1
    assert plan["shared_bytes"] == shared
    assert plan["outputs"] == K * d + K + 1
    # 64 live rows a block: two blocks an SM of the H100's 132 at the
    # build's 18,000 live rows
    assert kmeans_plan(18000, 128, 14)["blocks"] == 282 >= 2 * 132


@pytest.mark.parametrize("d,row16", [(128, 17), (16, 3), (13, 3), (20, 3),
                                     (8, 1), (256, 33), (200, 25)])
def test_kmeans_plan_bf16_row_tile(d, row16):
    """The bf16 instances stage rows as bf16: the row tile's stride is
    ceil(d / 8) 16-byte units made odd; the rest of the shared memory is
    the fp32 instance's (fp32 centroids)."""
    from repro_torch.kernels.kmeans_assign.ops import kmeans_plan
    f32 = kmeans_plan(1000, d, 14)
    bf = kmeans_plan(1000, d, 14, torch.bfloat16)
    assert bf["row16"] == row16 and row16 % 2 == 1
    assert f32["row16"] == f32["stride4"] and bf["stride4"] == f32["stride4"]
    assert f32["shared_bytes"] - bf["shared_bytes"] == \
        16 * 64 * (f32["row16"] - row16)
    assert bf["shared_bytes"] < f32["shared_bytes"] or d <= 4


@pytest.mark.parametrize("N,d,K", [(0, 8, 4), (8, 0, 4), (8, 257, 4),
                                   (8, 8, 0)])
def test_kmeans_plan_refuses_a_shape(N, d, K):
    from repro_torch.kernels.kmeans_assign.ops import kmeans_plan
    with pytest.raises(ValueError):
        kmeans_plan(N, d, K)


def _fma32(a, b, c):
    """fp32 fmaf(a, b, c): the exact product (float64 holds it) plus c,
    rounded to fp32 (once, but for a rare double rounding)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _warp_sum(v):
    """Lane 0 of the kernels' butterfly warp sum over the last axis (32
    lanes): offsets 16, 8, 4, 2, 1, each lane adding its partner's
    value."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v[..., 0]


def _kmeans_tile_model(x, c, valid=None):
    """numpy fp32 model of csrc/kmeans.cu's arithmetic order, on the blocks
    of `kmeans_plan`. Rows and centroids zero-padded to whole float4s; x2
    and c2 as four float4-lane partials, then (x + y) + (z + w); each dot
    product over the columns in order; d2 = (x2 - 2 xc) + c2, the first
    minimum. Per block of 64 rows: sums of w x over the live rows in row
    order, counts and w d2 as butterfly warp sums (lane = row mod 32) then
    warp 0 + warp 1; the join: warp j of `join_warps` adds the live blocks
    j, j + join_warps, ... in order, then the warps in order. Returns (assign, dist2) of every
    row (dead rows too) and (sums, counts, inertia) of the update."""
    from repro_torch.kernels.kmeans_assign.ops import kmeans_plan
    N, d = x.shape
    K = c.shape[0]
    plan = kmeans_plan(N, d, K)
    R, nb = plan["rows_per_block"], plan["blocks"]
    d4 = -(-d // 4)
    xp = np.zeros((nb * R, 4 * d4), np.float32)
    xp[:N, :d] = x
    cp = np.zeros((K, 4 * d4), np.float32)
    cp[:, :d] = c
    w = np.zeros(nb * R, np.float32)
    w[:N] = 1.0 if valid is None else valid

    def sq_norm(a):
        part = np.zeros((a.shape[0], 4), np.float32)
        for j in range(d4):
            part = _fma32(a[:, 4 * j:4 * j + 4], a[:, 4 * j:4 * j + 4], part)
        return (part[:, 0] + part[:, 1]) + (part[:, 2] + part[:, 3])

    dot = np.zeros((nb * R, K), np.float32)
    for f in range(4 * d4):
        dot = _fma32(xp[:, f:f + 1], cp[None, :, f], dot)
    d2 = (sq_norm(xp)[:, None] - np.float32(2.0) * dot) + sq_norm(cp)[None]
    a = np.argmin(d2, axis=1).astype(np.int32)
    m = d2[np.arange(nb * R), a]
    live = w != 0
    a_live = np.where(live, a, 0).reshape(nb, R)
    wb = w.reshape(nb, R)
    xb = xp.reshape(nb, R, -1)
    sums = np.zeros((nb, K, 4 * d4), np.float32)
    for r in range(R):
        wk = np.where(a_live[:, r, None] == np.arange(K), wb[:, r, None],
                      np.float32(0.0)).astype(np.float32)
        sums = _fma32(wk[:, :, None], xb[:, r, None, :], sums)
    onehot = np.where(a_live[..., None] == np.arange(K), wb[..., None],
                      np.float32(0.0)).astype(np.float32)        # (nb, R, K)
    md = np.where(live, w * m, np.float32(0.0)).astype(np.float32)

    def block_sum(v):               # (nb, R, ...) -> (nb, ...)
        lanes = np.moveaxis(v.reshape(nb, R // 32, 32, *v.shape[2:]), 2, -1)
        per_warp = _warp_sum(lanes)
        out = per_warp[:, 0]
        for ww in range(1, R // 32):
            out = out + per_warp[:, ww]
        return out

    part = np.concatenate([sums[:, :, :d].reshape(nb, -1),
                           block_sum(onehot),
                           block_sum(md.reshape(nb, R))[:, None]], axis=1)
    live_blocks = live.reshape(nb, R).any(axis=1)
    W = plan["join_warps"]
    chains = np.zeros((W, part.shape[1]), np.float32)
    for b in np.nonzero(live_blocks)[0]:
        chains[b % W] = chains[b % W] + part[b]
    out = chains[0]
    for j in range(1, W):
        out = out + chains[j]
    return (a[:N], m[:N], out[:K * d].reshape(K, d), out[K * d:K * d + K],
            out[K * d + K])


def _unit_rows(rng, n, d):
    """Rows on the unit sphere, as the store's signatures are: d2 <= 4,
    so fp32 orders differ by far less than the 1e-5 tie band."""
    x = rng.randn(n, d)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _km_mask(rng, N, kind):
    if kind == "prefix":
        return (np.arange(N) < (3 * N) // 4 + 1).astype(np.float32)
    return (rng.rand(N) < 0.6).astype(np.float32)


def _labels_agree(got, want, x, c, what):
    """Labels equal on rows whose best two centroids are more than 1e-5
    apart (float64 distances); elsewhere a label within 1e-5 of the
    best."""
    full = ((x.astype(np.float64)[:, None, :] - c[None]) ** 2).sum(-1)
    two = np.sort(full, axis=1)[:, :2]
    decisive = (two[:, 1] - two[:, 0] > 1e-5) if c.shape[0] > 1 else \
        np.ones(len(x), bool)
    got, want = np.asarray(got), np.asarray(want)
    differ = got != want
    assert not (differ & decisive).any(), f"{what}: labels differ"
    gap = full[np.arange(len(x)), got] - two[:, 0]
    assert (gap[differ] <= 1e-5).all(), f"{what}: a differing label is no tie"


@pytest.mark.parametrize("mask", ["prefix", "holes"])
@pytest.mark.parametrize("K", [4, 14, 30])
@pytest.mark.parametrize("d", [8, 32, 128, 200])
@pytest.mark.parametrize("N", [77, 513, 1000, 4096])
def test_kmeans_tile_model_matches_plain_and_jax(N, d, K, mask):
    """The CUDA kernels' blocks and summation orders, modelled in numpy,
    against the port's plain versions, JAX's Pallas kernels in interpret
    mode and their jnp oracles: labels equal but for 1e-5 ties, counts
    exact, sums and inertia within atol 1e-3 + rtol 1e-4."""
    rng = np.random.RandomState(N + d + K)
    x = _unit_rows(rng, N, d)
    c = _unit_rows(rng, K, d)
    valid = _km_mask(rng, N, mask)
    a_m, d2_m, s_m, n_m, i_m = _kmeans_tile_model(x, c, valid)
    jx, jc, jv = jnp.asarray(x), jnp.asarray(c), jnp.asarray(valid)
    a_p, d2_p = kmeans_assign(_t(x), _t(c))
    for a_w in (a_p.numpy(), jax_assign_ref(jx, jc)[0],
                jax_kmeans_assign(jx, jc, interpret=True)[0]):
        _labels_agree(a_m, a_w, x, c, f"kmeans labels {N, d, K}")
    np.testing.assert_allclose(d2_m, d2_p.numpy(), atol=1e-5)
    s_p, n_p, i_p = kmeans_update(_t(x), _t(c), _t(valid))
    s_r, n_r, i_r = jax_update_ref(jx, jc, jv)
    for s_w, n_w, i_w in ((s_p.numpy(), n_p.numpy(), i_p.numpy()),
                          jax_kmeans_update(jx, jc, jv, interpret=True),
                          (s_r, n_r, i_r[0])):
        np.testing.assert_array_equal(n_m, np.asarray(n_w))
        np.testing.assert_allclose(s_m, np.asarray(s_w), atol=1e-3,
                                   rtol=1e-4)
        np.testing.assert_allclose(i_m, float(i_w), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("mask", ["prefix", "holes"])
def test_kmeans_tile_model_is_blind_to_dead_rows(mask):
    """The kernels' order depends only on the live rows and their row
    indices: other finite values in the dead rows, and twice the capacity
    (more dead rows at the end), leave the sums, counts and inertia
    bitwise equal."""
    rng = np.random.RandomState(3)
    N, d, K = 1000, 32, 14
    x = _unit_rows(rng, N, d)
    c = _unit_rows(rng, K, d)
    valid = _km_mask(rng, N, mask)
    want = _kmeans_tile_model(x, c, valid)[2:]
    dead = valid == 0
    x_other = x.copy()
    x_other[dead] = 10.0 * rng.randn(int(dead.sum()), d)
    x_big = np.concatenate([x, rng.randn(N, d).astype(np.float32)])
    v_big = np.concatenate([valid, np.zeros(N, np.float32)])
    for got in (_kmeans_tile_model(x_other, c, valid)[2:],
                _kmeans_tile_model(x_big, c, v_big)[2:]):
        for g, w_ in zip(got, want):
            assert np.array_equal(g, w_)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (B, S, T, H, K, D, causal, window, bq, bk, dtype): tests/
    # test_kernels.py's (S == T), then ragged lengths (blocks that divide
    # them on the JAX side; the port has no block), S != T both ways, and
    # the head dims 128 and 256
    (1, 64, 64, 2, 2, 16, True, 0, 16, 16, "float32"),
    (2, 64, 64, 4, 2, 32, True, 0, 32, 32, "float32"),
    (1, 128, 128, 6, 6, 16, False, 0, 32, 64, "float32"),
    (2, 64, 64, 4, 1, 32, True, 32, 32, 32, "float32"),
    (1, 128, 128, 8, 2, 64, True, 0, 64, 32, "float32"),
    (2, 64, 64, 4, 4, 32, True, 0, 32, 32, "bfloat16"),
    (1, 100, 100, 4, 2, 16, True, 0, 20, 25, "float32"),
    (1, 90, 90, 2, 1, 24, True, 30, 30, 45, "float32"),
    (2, 48, 80, 4, 2, 16, False, 0, 16, 16, "float32"),
    (1, 48, 80, 2, 1, 16, True, 0, 16, 40, "float32"),
    (1, 80, 48, 2, 2, 16, True, 40, 40, 16, "float32"),
    (1, 64, 64, 4, 1, 128, True, 0, 32, 32, "bfloat16"),
    (1, 32, 64, 2, 1, 256, False, 0, 32, 32, "float32"),
]


@pytest.mark.parametrize("B,S,T,H,K,D,causal,window,bq,bk,dtype",
                         FLASH_CASES)
def test_flash_plain_matches_jax(B, S, T, H, K, D, causal, window, bq, bk,
                                 dtype):
    """The CPU path of the port's `flash_attention` (its plain version)
    against the Pallas kernel (interpret mode) and the jnp oracle, at the
    JAX suite's bounds (tests/test_kernels.py)."""
    jd = getattr(jnp, dtype)
    rng = np.random.RandomState(S + T + H)
    q, k, v = (_as_dtype(rng.randn(*shape).astype(np.float32), jd)
               for shape in ((B, S, H, D), (B, T, K, D), (B, T, K, D)))
    td = getattr(torch, dtype)
    out = flash_attention(*(_t(a).to(td) for a in (q, k, v)), causal=causal,
                          window=window)
    assert out.dtype == td and tuple(out.shape) == (B, S, H, D)
    jargs = [jnp.asarray(a, jd) for a in (q, k, v)]
    atol = 2e-5 if dtype == "float32" else 3e-2
    for want in (jax_flash(*jargs, causal=causal, window=window, block_q=bq,
                           block_k=bk, interpret=True),
                 jax_flash_ref(*jargs, causal=causal, window=window)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32), atol=atol,
                                   rtol=1e-2)


FLASH_PREFIX_CASES = [
    # (B, S, T, H, K, D, prefix_len, window, dtype): no prefix, a prefix
    # inside a 64-key tile, one that cuts a 64-key tile and a 128-row query
    # tile, a multiple of 64, one past S, with a window, S != T both ways,
    # paligemma's 8:1 GQA
    (1, 80, 80, 2, 1, 16, 0, 0, "float32"),
    (2, 100, 100, 8, 1, 32, 37, 0, "float32"),
    (1, 200, 200, 8, 1, 16, 100, 0, "float32"),
    (1, 130, 130, 4, 2, 16, 64, 0, "float32"),
    (1, 48, 48, 2, 2, 16, 60, 0, "float32"),
    (1, 150, 150, 8, 1, 16, 130, 20, "float32"),
    (2, 40, 70, 4, 2, 16, 50, 0, "float32"),
    (1, 90, 60, 2, 1, 16, 30, 0, "float32"),
    (1, 96, 96, 8, 1, 64, 40, 0, "bfloat16"),
]


def _prefix_inputs(B, S, T, H, K, D, dtype, seed):
    rng = np.random.RandomState(seed)
    return tuple(_as_dtype(rng.randn(*shape).astype(np.float32),
                           getattr(jnp, dtype))
                 for shape in ((B, S, H, D), (B, T, K, D), (B, T, K, D)))


@pytest.mark.parametrize("B,S,T,H,K,D,P,window,dtype", FLASH_PREFIX_CASES)
def test_flash_prefix_plain_matches_jax(B, S, T, H, K, D, P, window, dtype):
    """The plain version with the prefix rule against JAX's
    `_ref_attention` under `_mask_bias("prefix")` (the JAX kernel has no
    prefix rule), at the JAX suite's bounds; P = 0 is the causal call."""
    from repro.models.attention import _mask_bias, _ref_attention
    q, k, v = _prefix_inputs(B, S, T, H, K, D, dtype, S + T + P)
    td = getattr(torch, dtype)
    args = [_t(a).to(td) for a in (q, k, v)]
    out = flash_attention(*args, causal=True, window=window, prefix_len=P)
    assert out.dtype == td and tuple(out.shape) == (B, S, H, D)
    jd = getattr(jnp, dtype)
    bias = _mask_bias("prefix", jnp.arange(S), jnp.arange(T), window, P)
    want = _ref_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), bias)
    atol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=1e-2 if dtype == "bfloat16" else 1e-5)
    if P == 0:
        assert torch.equal(out, flash_attention(*args, window=window))
    if P >= T and window == 0:      # every key: the full mask
        assert torch.equal(out, flash_attention(*args, causal=False))


def test_flash_rejects_a_negative_prefix():
    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="prefix_len"):
        flash_attention(x, x[:, :, :1], x[:, :, :1], prefix_len=-1)


def _flash_tiles(S, T, causal, window, prefix_len, nwg, sub):
    """The (warpgroup's first row, key tile start, need_mask) triples the
    bf16 kernel (`wg::flash_wgmma_kernel<DP, NWG, MINB, SUB, PREFIX>`,
    PREFIX when prefix_len > 0) runs, in its order, from its loop bounds
    and its `run` / `need_mask` tests; nwg = sub = 1 with every tile
    masked is the fp32 kernel's loop (its 64-row query tile and k_end
    rule)."""
    BQ, KR = 64 * nwg, 64 * sub
    out = []
    for q0 in range(0, S, BQ):
        k_end = T
        if causal:
            k_end = min(k_end, max(min(S, q0 + BQ), prefix_len))
        k_begin = 0
        if window > 0 and q0 - window + 1 > 0:
            k_begin = ((q0 - window + 1) // 64) * 64
        n_tiles = -(-(k_end - k_begin) // 64) if k_end > k_begin else 0
        for w in range(nwg):
            qw0 = q0 + 64 * w
            w_last = min(S, qw0 + 64) - 1
            for u in range(-(-n_tiles // sub)):
                for j in range(sub):
                    k0 = k_begin + u * KR + j * 64
                    run = (k0 < k_end and qw0 < S
                           and (not causal or k0 <= w_last
                                or k0 < prefix_len)
                           and (window <= 0 or k0 + 63 >= qw0 - window + 1))
                    if not run:
                        continue
                    need = (k0 + 64 > T
                            or (causal and k0 + 63 > qw0
                                and k0 + 64 > prefix_len)
                            or (window > 0 and qw0 + 63 - k0 >= window))
                    out.append((qw0, k0, need))
    return out


def _flash_tile_model(q, k, v, causal, window, prefix_len, nwg, sub,
                      always_mask=False):
    """numpy model of the kernels' tile loop (`_flash_tiles`): the online
    softmax over the tiles they run, the rule applied only where they
    apply it (NEG_INF before the scale), keys past T at -inf; rows past S
    are computed on zeros and dropped."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    neg = -2.0 ** 30
    out = np.zeros((B, S, H, D))
    tiles = _flash_tiles(S, T, causal, window, prefix_len, nwg, sub)
    for qw0 in sorted({t[0] for t in tiles} | set(range(0, S, 64))):
        rows = np.arange(qw0, qw0 + 64)
        qs = np.zeros((B, 64, H, D))
        qs[:, :min(64, S - qw0)] = q[:, qw0:qw0 + 64]
        m = np.full((B, H, 64), neg)
        l = np.zeros((B, H, 64))
        acc = np.zeros((B, H, 64, D))
        for _, k0, need in (t for t in tiles if t[0] == qw0):
            keys = np.arange(k0, k0 + 64)
            kt = np.zeros((B, 64, K, D))
            vt = np.zeros((B, 64, K, D))
            kt[:, :min(64, T - k0)] = k[:, k0:k0 + 64]
            vt[:, :min(64, T - k0)] = v[:, k0:k0 + 64]
            s = np.einsum("bihd,bjhd->bhij", qs, np.repeat(kt, g, axis=2))
            if need or always_mask:
                vis = np.ones((64, 64), bool)
                if causal:
                    vis = ((keys[None, :] <= rows[:, None])
                           | (keys[None, :] < prefix_len))
                if window > 0:
                    vis &= rows[:, None] - keys[None, :] < window
                s = np.where(vis, s, neg)
                s = np.where(keys[None, :] >= T, -np.inf, s)
            m_new = np.maximum(m, s.max(-1))
            p = np.exp((s - m_new[..., None]) * D ** -0.5)
            corr = np.exp((m - m_new) * D ** -0.5)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + np.einsum(
                "bhij,bjhd->bhid", p, np.repeat(vt, g, axis=2))
            m = m_new
        o = acc / np.maximum(l, 1e-30)[..., None]
        n = min(64, S - qw0)
        out[:, qw0:qw0 + n] = o.transpose(0, 2, 1, 3)[:, :n]
    return out


@pytest.mark.parametrize("B,S,T,H,K,D,P,window,dtype", FLASH_PREFIX_CASES)
def test_flash_tile_model_matches_plain(B, S, T, H, K, D, P, window, dtype):
    """The loop bounds and masking tests of both kernels, with the prefix
    rule, reproduce the plain version: every bf16 instance (two warpgroups
    and two key tiles a stage at D <= 128, one and one at D 256) and the
    fp32 kernel's loop; the causal rule without a prefix too."""
    q, k, v = (a.astype(np.float64)
               for a in _prefix_inputs(B, S, T, H, K, D, "float32", 3 * S))
    for causal, p in ((True, P), (True, 0), (False, 0)):
        want = flash_attention(*(_t(a).float() for a in (q, k, v)),
                               causal=causal, window=window, prefix_len=p)
        for nwg, sub, always in ((2, 2, False), (1, 1, False),
                                 (1, 1, True)):
            got = _flash_tile_model(q, k, v, causal, window, p, nwg, sub,
                                    always)
            np.testing.assert_allclose(got, want.numpy(), atol=1e-5,
                                       rtol=1e-5,
                                       err_msg=f"{causal, p, nwg, sub}")


@pytest.mark.parametrize("S,T,window", [(1000, 1000, 0), (2048, 2048, 512),
                                        (448, 1500, 0), (257, 257, 96),
                                        (1500, 1500, 0)])
def test_flash_tiles_without_prefix_are_the_old_ones(S, T, window):
    """prefix_len 0 leaves every instance's tiles and masking decisions
    as they were before the prefix rule (the causal-only tests of the
    wgmma kernel without it), so the output is bitwise the same."""
    def old(nwg, sub, causal):
        BQ, KR, out = 64 * nwg, 64 * sub, []
        for q0 in range(0, S, BQ):
            k_end = min(T, min(S, q0 + BQ)) if causal else T
            k_begin = 0
            if window > 0 and q0 - window + 1 > 0:
                k_begin = ((q0 - window + 1) // 64) * 64
            n = -(-(k_end - k_begin) // 64) if k_end > k_begin else 0
            for w in range(nwg):
                qw0 = q0 + 64 * w
                for u in range(-(-n // sub)):
                    for j in range(sub):
                        k0 = k_begin + u * KR + j * 64
                        if not (k0 < k_end and qw0 < S
                                and (not causal
                                     or k0 <= min(S, qw0 + 64) - 1)
                                and (window <= 0
                                     or k0 + 63 >= qw0 - window + 1)):
                            continue
                        out.append((qw0, k0, k0 + 64 > T
                                    or (causal and k0 + 63 > qw0)
                                    or (window > 0
                                        and qw0 + 63 - k0 >= window)))
        return out
    for nwg, sub in ((2, 2), (1, 1)):
        for causal in (True, False):
            assert _flash_tiles(S, T, causal, window, 0, nwg, sub) == \
                old(nwg, sub, causal)


def test_flash_cpu_launches_no_kernel():
    before = flash_attention.launches
    x = torch.randn(1, 8, 2, 16)
    flash_attention(x, x[:, :, :1], x[:, :, :1])
    assert flash_attention.launches == before == 0


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_wrappers_reject_mixed_devices():
    x = torch.zeros((4, 2))
    with pytest.raises(ValueError):
        kmeans_assign(x, torch.zeros((2, 2), device="meta"))


def test_flash_kernel_chosen_by_dtype():
    """bf16 goes to the wgmma kernel, fp32 to the FMA kernel; any other
    dtype has no kernel."""
    from repro_torch.kernels.flash_attention.ops import kernel_for
    assert kernel_for(torch.bfloat16) == "rt_flash_attention_forward_bf16"
    assert kernel_for(torch.float32) == "rt_flash_attention_forward_f32"
    with pytest.raises(TypeError):
        kernel_for(torch.float16)


@pytest.mark.parametrize("shape,dtype,offset,want", [
    ((2, 100, 4, 64), torch.bfloat16, 0, True),     # smollm's heads
    ((2, 100, 4, 80), torch.bfloat16, 0, True),     # 160-byte rows
    ((2, 100, 4, 100), torch.bfloat16, 0, False),   # 200-byte rows
    ((2, 100, 4, 24), torch.bfloat16, 0, True),
    ((2, 100, 4, 12), torch.bfloat16, 0, False),    # D % 8 != 0
    ((2, 100, 4, 64), torch.bfloat16, 1, False),    # odd storage offset
    ((2, 100, 4, 64), torch.bfloat16, 8, True),     # 16-byte offset
    ((4, 2, 7, 44), torch.float32, 0, True),        # the tiny config's dh
    ((4, 2, 7, 7), torch.float32, 0, False),
    ((4, 2, 7, 16), torch.float32, 2, False),       # 8-byte offset
])
def test_rows_aligned_16_picks_the_load_route(shape, dtype, offset, want):
    """The check that picks 16-byte vector loads (else element by
    element) looks at the pointer, the row length and the strides."""
    from repro_torch.kernels._lib import rows_aligned_16
    n = int(np.prod(shape))
    t = torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)
    assert rows_aligned_16(t) is want


def test_rows_aligned_16_on_views_of_a_fused_projection():
    """The zoo's q, k, v are views of one (B, S, (H + 2K) D) projection:
    16-byte rows when D is a multiple of 8 (bf16), whatever the head
    offsets; strides of size-1 dims do not count."""
    from repro_torch.kernels._lib import rows_aligned_16
    for D, want in ((64, True), (80, True), (36, False)):
        B, S, H, K = 2, 10, 4, 2
        qkv = torch.zeros((B, S, (H + 2 * K) * D), dtype=torch.bfloat16)
        q = qkv[..., :H * D].view(B, S, H, D)
        k = qkv[..., H * D:(H + K) * D].view(B, S, K, D)
        v = qkv[..., (H + K) * D:].view(B, S, K, D)
        assert rows_aligned_16(q, k, v) is want
    x = torch.zeros((1, 3, 8), dtype=torch.float32)
    assert rows_aligned_16(x.as_strided((1, 3, 8), (5, 8, 1)))
    assert not rows_aligned_16(x.as_strided((2, 1, 8), (5, 8, 1)))


def test_entry_point_signatures_match_the_c_sources():
    """Every C entry point that `_lib` declares exists in csrc/ with as
    many arguments, of the same kinds (pointer or stream, int, float):
    ctypes would otherwise pass a launch garbage without a word."""
    import re
    from repro_torch.kernels import _lib
    found = {}
    for path in _lib.CSRC.glob("*.cu"):
        text = path.read_text()
        for m in re.finditer(r'extern "C" \w+\s*\*?\s*(rt_\w+)\(([^)]*)\)',
                             text):
            kinds = ""
            for arg in m.group(2).split(","):
                arg = " ".join(arg.split())
                if "*" in arg or arg.startswith("cudaStream_t"):
                    kinds += "p"
                elif arg.startswith("int "):
                    kinds += "i"
                elif arg.startswith("float "):
                    kinds += "f"
                else:
                    raise AssertionError(f"{m.group(1)}: argument {arg!r}")
            found[m.group(1)] = kinds
    for name, kinds in _lib._ENTRY_POINTS.items():
        assert found.get(name) == kinds, (name, found.get(name), kinds)

"""The port's LM-zoo training on the CPU against the JAX package: the
plain flash backward against `jax.vjp` of `_chunked_attention`, a numpy
model of the fp32 backward kernels' tile loops, a CPU model of the bf16
(wgmma) kernels' tiles and arithmetic against both, `chunked_xent`,
`lm_loss` and
every gradient against `jax.grad` of JAX's `lm_loss` for all eleven
archs (scaled down, fp32), the remat policies, Trainer steps against
JAX's Trainer, exact resume, checkpoints in the stacked layout both
ways, and the `launch.train` CLI."""
import dataclasses
import shutil

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.launch.train import lm_batch_fn as jax_lm_batch_fn  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_backward_reference, attention_reference, flash_attention,
    flash_attention_backward,
)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

ARCHS = ["smollm_135m", "qwen3_4b", "qwen2_7b", "granite_3_2b",
         "qwen3_moe_235b_a22b", "grok_1_314b", "jamba_1_5_large_398b",
         "xlstm_1_3b", "semanticbbv_encoder", "whisper_tiny", "paligemma_3b"]
# archs without an attention layer: JAX's impl does not change them
NO_ATTENTION = ("xlstm_1_3b", "semanticbbv_encoder")
SMALL = dict(num_layers=2, d_model=32, num_heads=2, d_ff=64, vocab_size=96)
# jamba's period (attention, then Mamba with MoE every other layer) is 8
LAYERS = {"jamba_1_5_large_398b": 8}
SEQ = 24


# ---------------------------------------------------------------------------
# the plain flash backward
# ---------------------------------------------------------------------------

# (B, S, T, H, K, D, mask_mode, window, prefix_len)
BWD_CASES = [
    (2, 70, 70, 4, 2, 16, "causal", 0, 0),
    (1, 50, 150, 3, 3, 8, "full", 0, 0),          # cross: S != T, ragged T
    (1, 90, 90, 4, 1, 16, "causal", 24, 0),
    (2, 60, 60, 2, 2, 8, "prefix", 0, 20),
    (1, 80, 80, 4, 2, 12, "prefix", 30, 45),
    (1, 40, 100, 6, 2, 8, "full", 0, 0),
]


def _qkv(rng, B, S, T, H, K, D):
    return [rng.randn(*shape).astype(np.float32) for shape in
            ((B, S, H, D), (B, T, K, D), (B, T, K, D), (B, S, H, D))]


def _kw(mode, window, P):
    return dict(causal=mode != "full", window=window,
                prefix_len=P if mode == "prefix" else 0)


@pytest.mark.parametrize("B,S,T,H,K,D,mode,window,P", BWD_CASES)
def test_backward_reference_matches_jax_vjp(B, S, T, H, K, D, mode, window,
                                            P):
    """`attention_backward_reference` from the log-sum-exp of
    `attention_reference` against `jax.vjp` of `_chunked_attention`
    (chunks of 32 keys, a ragged last one) over every mask mode, fp32 at
    1e-4; the log-sum-exp is JAX's m + log l."""
    q, k, v, do = _qkv(np.random.RandomState(S + T), B, S, T, H, K, D)
    kw = _kw(mode, window, P)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = attention_reference(tq, tk, tv, return_lse=True, **kw)
    assert torch.equal(o, attention_reference(tq, tk, tv, **kw))
    got = attention_backward_reference(tq, tk, tv, o, tdo, lse, **kw)
    bias = jattn._mask_bias(mode, jnp.arange(S), jnp.arange(T), window, P)
    out, vjp = jax.vjp(lambda a, b, c: jattn._chunked_attention(
        a, b, c, bias, 32), *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=1e-5)
    want = vjp(jnp.asarray(do))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    _, m, l_ = jattn._chunked_fwd(*map(jnp.asarray, (q, k, v)), bias, 32)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(m + jnp.log(l_)).reshape(B, H, S), atol=1e-4)


@pytest.mark.parametrize("B,S,T,H,K,D,mode,window,P", BWD_CASES[:4])
def test_backward_reference_matches_autograd(B, S, T, H, K, D, mode, window,
                                             P):
    """The plain backward is the gradient of the plain forward, and the
    CPU wrappers (which the models take) run them: `flash_attention` by
    autograd, `flash_attention_backward` by the plain backward, with no
    kernel launch."""
    q, k, v, do = map(torch.from_numpy,
                      _qkv(np.random.RandomState(7), B, S, T, H, K, D))
    kw = _kw(mode, window, P)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    launches = (flash_attention.launches, flash_attention_backward.launches)
    out = flash_attention(*leaves, **kw)
    want = torch.autograd.grad(out, leaves, do)
    o, lse = attention_reference(q, k, v, return_lse=True, **kw)
    got = flash_attention_backward(q, k, v, o, do, lse, **kw)
    assert launches == (flash_attention.launches,
                        flash_attention_backward.launches)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def test_backward_reference_keeps_bf16():
    """bf16 inputs give bf16 gradients and an fp32 log-sum-exp."""
    q, k, v, do = (t.bfloat16() for t in map(torch.from_numpy, _qkv(
        np.random.RandomState(1), 1, 20, 20, 2, 1, 8)))
    o, lse = attention_reference(q, k, v, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert all(g.dtype == torch.bfloat16 for g in
               attention_backward_reference(q, k, v, o, do, lse))


# ---------------------------------------------------------------------------
# a numpy model of the fp32 backward kernels' tile loops
# ---------------------------------------------------------------------------

def _bwd_tiles(S, T, causal, window, P, BK, ignore_prefix=False):
    """The (query tile, key tile) pairs each fp32 backward kernel of
    `csrc/flash_attention.cu` (`bwd::dkdv_kernel`, `bwd::dq_kernel`)
    visits: dK/dV loops over query tiles from
    the key tile's diagonal (from 0 when it starts inside the prefix) up
    to the window's reach past its last key; dQ over the forward's key
    tiles. Tiles of 64 queries and BK keys. `ignore_prefix` is a mutation
    (the causal bounds alone)."""
    BQ = 64
    P = P if causal and not ignore_prefix else 0
    dkdv, dq = set(), set()
    for k0 in range(0, T, BK):
        q_begin = 0
        if causal and not (P > 0 and k0 < P):
            q_begin = (k0 // BQ) * BQ
        q_end = S if window <= 0 else min(S, k0 + BK - 1 + window)
        for q0 in range(q_begin, q_end, BQ):
            dkdv.add((q0, k0))
    for q0 in range(0, S, BQ):
        q_last = min(S, q0 + BQ) - 1
        k_end = T
        if causal:
            k_end = min(k_end, max(q_last + 1, P) if P > 0 else q_last + 1)
        k_begin = 0
        if window > 0 and q0 - window + 1 > 0:
            k_begin = ((q0 - window + 1) // BK) * BK
        for k0 in range(k_begin, k_end, BK):
            dq.add((q0, k0))
    return dkdv, dq


def _uncovered(S, T, causal, window, P, BK, **kw):
    """Visible (q, k) pairs of the plain mask that a kernel's loops miss."""
    dkdv, dq = _bwd_tiles(S, T, causal, window, P, BK, **kw)
    qpos = np.arange(S)[:, None]
    kpos = np.arange(T)[None, :]
    vis = np.ones((S, T), bool)
    if causal:
        vis = (kpos <= qpos) | (kpos < P)
    if window > 0:
        vis &= qpos - kpos < window
    miss = 0
    for i, j in zip(*np.nonzero(vis)):
        tile = ((i // 64) * 64, (j // BK) * BK)
        miss += (tile not in dkdv) + (tile not in dq)
    return miss


@pytest.mark.parametrize("S,T,causal,window,P", [
    (300, 300, True, 0, 0), (300, 300, True, 0, 100), (260, 260, True, 70, 150),
    (130, 1500, False, 0, 0), (200, 200, False, 50, 0), (333, 333, True, 0, 1000),
    (500, 500, True, 128, 0), (100, 100, True, 0, 31)])
@pytest.mark.parametrize("BK", [64, 32])
def test_backward_tile_loops_cover_the_mask(S, T, causal, window, P, BK):
    """Every visible pair of the plain mask lies in a tile that both
    backward kernels visit; at a prefix that reaches past the first key
    tile's diagonal the causal bounds alone miss pairs (the mutation
    fails)."""
    assert _uncovered(S, T, causal, window, P, BK) == 0
    if causal and 64 <= P < T:
        assert _uncovered(S, T, causal, window, P, BK,
                          ignore_prefix=True) > 0


# ---------------------------------------------------------------------------
# a model of the bf16 backward kernels on wgmma: tiles and arithmetic
# ---------------------------------------------------------------------------

def _wgmma_tiles(S, T, causal, window, P, ignore_prefix=False):
    """The steps of the bf16 kernels (`bwd::dkdv_wgmma_kernel`,
    `bwd::dq_wgmma_kernel`), in their order, from their loop bounds and
    `need_mask` tests: a dK/dV block (64 keys) loops over the 64-row query
    tiles from its diagonal (from 0 when it starts inside the prefix) up to
    the window's reach, giving (k0, q0, need_mask) per head; a dQ block (64
    rows) over the forward's 64-key tiles, giving (q0, k0, need_mask). Every
    step sees a visible pair, so neither kernel skips one. `ignore_prefix`
    is a mutation (the causal bounds alone)."""
    P = P if causal and not ignore_prefix else 0
    dkdv, dq = [], []
    for k0 in range(0, T, 64):
        q_begin = k0 if causal and not (P > 0 and k0 < P) else 0
        q_end = S if window <= 0 else min(S, k0 + 63 + window)
        for q0 in range(q_begin, q_end, 64):
            dkdv.append((k0, q0, (
                q0 + 64 > S or k0 + 64 > T
                or (causal and k0 + 63 > q0 and k0 + 64 > P)
                or (window > 0 and q0 + 63 - k0 >= window))))
    for q0 in range(0, S, 64):
        k_end = T
        if causal:
            k_end = min(k_end, max(min(S, q0 + 64), P) if P > 0
                        else min(S, q0 + 64))
        k_begin = 0
        if window > 0 and q0 - window + 1 > 0:
            k_begin = ((q0 - window + 1) // 64) * 64
        for k0 in range(k_begin, k_end, 64):
            dq.append((q0, k0, (
                k0 + 64 > T
                or (causal and k0 + 63 > q0 and k0 + 64 > P)
                or (window > 0 and q0 + 63 - k0 >= window))))
    return dkdv, dq


def _visible(qpos, kpos, S, T, causal, window, P):
    vis = (qpos < S) & (kpos < T)
    if causal:
        vis &= (kpos <= qpos) | (kpos < P)
    if window > 0:
        vis &= qpos - kpos < window
    return vis


def _rows(x, r0, n):
    """Rows r0 .. r0 + 63 of x (B, n, ...) along dim 1, zeros past n."""
    out = x.new_zeros((x.shape[0], 64) + tuple(x.shape[2:]))
    out[:, :max(0, min(64, n - r0))] = x[:, r0:r0 + 64]
    return out


def _wgmma_model(q, k, v, o, do, lse, causal, window, P, mutate=None):
    """torch (CPU) model of the bf16 kernels' arithmetic over their tiles
    (`_wgmma_tiles`; D 256's column split changes no sum): delta = rowsum(dO
    o) from the stored o; per 64 x 64 tile S^T and dP^T (fp32 sums of bf16
    values), P^T = 2^(S^T scale log2(e) - lse log2(e)) with the rule
    applied only where the kernel applies it, dS^T = P^T (dP^T - delta);
    dV += P^T dO, dK += dS^T Q and dQ += dS K each as two products of bf16
    parts (hi = bf16(x), lo = bf16(x - hi)), fp32 sums, dK and dQ times
    scale, one rounding to bf16. `mutate`: "hi_only" drops the low parts
    (one bf16 rounding of P^T and dS^T); "ignore_prefix" drops the prefix
    rule from the loop bounds; "unmasked" never applies the rule."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    P = P if causal else 0
    scale, log2e = D ** -0.5, 1.4426950408889634
    f = [t.float() for t in (q, k, v, do)]
    qf, kf, vf, dof = f
    delta = (dof * o.float()).sum(-1)                       # (B, S, H)
    lse2 = lse.float().permute(0, 2, 1) * log2e             # (B, S, H)
    bf = lambda x: x.bfloat16().float()                     # noqa: E731

    def mm(a, b):   # a @ b from a's bf16 parts, hi then lo
        hi = bf(a)
        return hi @ b if mutate == "hi_only" else hi @ b + bf(a - hi) @ b
    dkdv, dq_tiles = _wgmma_tiles(S, T, causal, window, P,
                                  ignore_prefix=mutate == "ignore_prefix")
    masked = mutate != "unmasked"
    dk = torch.zeros(B, T + 64, K, D)
    dv = torch.zeros(B, T + 64, K, D)
    dq = torch.zeros(B, S + 64, H, D)
    ar = torch.arange(64)
    for kh in range(K):
        for h in range(kh * G, (kh + 1) * G):
            for kw0, q0, need in dkdv:
                kt, vt = _rows(kf[:, :, kh], kw0, T), _rows(vf[:, :, kh], kw0, T)
                qt, dot = _rows(qf[:, :, h], q0, S), _rows(dof[:, :, h], q0, S)
                l2 = _rows(lse2[:, :, h], q0, S)[:, None, :]
                dl = _rows(delta[:, :, h], q0, S)[:, None, :]
                st = kt @ qt.transpose(1, 2)                 # (B, keys, queries)
                p = torch.exp2(st * (scale * log2e) - l2)
                if need and masked:
                    p = torch.where(_visible((q0 + ar)[None, :], (kw0 + ar)[:, None],
                                             S, T, causal, window, P), p, 0.0)
                ds = p * (vt @ dot.transpose(1, 2) - dl)
                dv[:, kw0:kw0 + 64, kh] += mm(p, dot)
                dk[:, kw0:kw0 + 64, kh] += mm(ds, qt)
    for h in range(H):
        kh = h // G
        for qw0, k0, need in dq_tiles:
            qt, dot = _rows(qf[:, :, h], qw0, S), _rows(dof[:, :, h], qw0, S)
            kt, vt = _rows(kf[:, :, kh], k0, T), _rows(vf[:, :, kh], k0, T)
            l2 = _rows(lse2[:, :, h], qw0, S)[:, :, None]
            dl = _rows(delta[:, :, h], qw0, S)[:, :, None]
            p = torch.exp2(qt @ kt.transpose(1, 2) * (scale * log2e) - l2)
            if need and masked:
                p = torch.where(_visible((qw0 + ar)[:, None], (k0 + ar)[None, :],
                                         S, T, causal, window, P), p, 0.0)
            dq[:, qw0:qw0 + 64, h] += mm(p * (dot @ vt.transpose(1, 2) - dl), kt)
    return ((dq[:, :S] * scale).bfloat16(), (dk[:, :T] * scale).bfloat16(),
            dv[:, :T].bfloat16())


def _bf16_close(got, want):
    """The card's bf16 gates (chip_smoke's `flash_err`): |got - want| <=
    1e-2 + 1e-2 |want| everywhere and a relative L2 error of 1e-2."""
    if not isinstance(want, torch.Tensor):
        want = torch.from_numpy(np.array(want, np.float32))
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    rel = float((got - want).norm() / want.norm().clamp(min=1e-30))
    return bool((diff <= 1e-2 + 1e-2 * want.abs()).all()) and rel <= 1e-2


# the card tests' FLASH_BWD_CASES (tests/test_torch_gpu.py):
# (B, S, T, H, K, D, causal, window, prefix_len)
WGMMA_CASES = [
    (2, 130, 130, 4, 2, 64, True, 0, 0),
    (1, 200, 300, 4, 2, 100, False, 0, 0),
    (1, 257, 257, 6, 3, 64, True, 100, 0),
    (1, 96, 1500, 6, 6, 64, False, 0, 0),
    (1, 300, 300, 8, 1, 256, True, 0, 100),
    (1, 300, 300, 8, 2, 80, True, 64, 150),
    (1, 200, 200, 4, 4, 128, True, 0, 0),
    (1, 150, 150, 4, 1, 256, False, 0, 0),
    (1, 130, 333, 8, 1, 256, False, 0, 0)]


def _wgmma_inputs(B, S, T, H, K, D, causal, window, P, seed):
    """bf16 q, k, v, dO from a seeded numpy draw, with the plain forward's
    stored bf16 o and fp32 log-sum-exp."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _qkv(rng, B, S, T, H, K, D))
    o, lse = attention_reference(q, k, v, causal=causal, window=window,
                                 prefix_len=P, return_lse=True)
    return q, k, v, do, o, lse


@pytest.mark.parametrize("B,S,T,H,K,D,causal,window,P", WGMMA_CASES)
def test_wgmma_backward_model_matches_plain_and_jax(B, S, T, H, K, D, causal,
                                                    window, P):
    """The bf16 kernels' arithmetic and tiles (`_wgmma_model`: P^T and
    dS^T in two bf16 parts before their products) against
    `attention_backward_reference` on the same bf16 q, k, v, o, dO and lse,
    and against `jax.vjp` of `_chunked_attention` on the same values,
    within the card's bf16 gates (1e-2 + 1e-2, relative L2 1e-2)."""
    q, k, v, do, o, lse = _wgmma_inputs(B, S, T, H, K, D, causal, window, P,
                                        S + T + D)
    got = _wgmma_model(q, k, v, o, do, lse, causal, window, P)
    kw = dict(causal=causal, window=window, prefix_len=P)
    plain = attention_backward_reference(q, k, v, o, do, lse, **kw)
    mode = "prefix" if causal and P else "causal" if causal else "full"
    bias = jattn._mask_bias(mode, jnp.arange(S), jnp.arange(T), window, P)
    _, vjp = jax.vjp(lambda a, b, c: jattn._chunked_attention(a, b, c, bias,
                                                              32),
                     *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.float().numpy()))
    for name, a, b, c in zip(("dq", "dk", "dv"), got, plain, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        assert _bf16_close(a, b), f"{name} against the plain backward"
        assert _bf16_close(a, c), f"{name} against jax.vjp"


@pytest.mark.parametrize("mutate,case", [
    ("hi_only", WGMMA_CASES[2]),
    ("ignore_prefix", WGMMA_CASES[4]),
    ("ignore_prefix", WGMMA_CASES[5]),
    ("unmasked", WGMMA_CASES[0])])
def test_wgmma_backward_model_mutations_fail(mutate, case):
    """On the inputs of `test_wgmma_backward_model_matches_plain_and_jax`,
    dropping the low bf16 parts (at a windowed causal row: single dV
    elements of early keys move past the bound), dropping the prefix rule
    from the new bounds, or never applying the mask each break the bf16
    gates the kernel is held to."""
    q, k, v, do, o, lse = _wgmma_inputs(*case, sum(case[1:3]) + case[5])
    got = _wgmma_model(q, k, v, o, do, lse, *case[6:], mutate=mutate)
    kw = dict(causal=case[6], window=case[7], prefix_len=case[8])
    plain = attention_backward_reference(q, k, v, o, do, lse, **kw)
    assert not all(_bf16_close(a, b) for a, b in zip(got, plain))


@pytest.mark.parametrize("S,T,causal,window,P", [
    (300, 300, True, 0, 0), (300, 300, True, 0, 100), (260, 260, True, 70, 150),
    (130, 1500, False, 0, 0), (200, 200, False, 50, 0), (333, 333, True, 0, 1000),
    (500, 500, True, 128, 0), (100, 100, True, 0, 31), (2048, 2048, True, 0, 256),
    (1500, 1500, False, 0, 0), (448, 1500, False, 0, 0), (1000, 1000, True, 128, 200)])
def test_wgmma_tiles_cover_the_mask_once(S, T, causal, window, P):
    """Every visible pair of the plain mask lies in exactly one step of
    each bf16 kernel, every step holds a visible pair, every step that
    applies no rule holds only visible pairs, and without the prefix in
    the bounds some pairs are missed."""
    qpos = np.arange(S)[:, None]
    kpos = np.arange(T)[None, :]
    vis = _visible(qpos, kpos, S, T, causal, window, P if causal else 0)

    def counts(ignore_prefix=False):
        dkdv, dq = _wgmma_tiles(S, T, causal, window, P, ignore_prefix)
        out = []
        for tiles, key_first in ((dkdv, True), (dq, False)):
            seen = np.zeros((S + 64, T + 64), int)
            for a, b, need in tiles:
                k0, q0 = (a, b) if key_first else (b, a)
                seen[q0:q0 + 64, k0:k0 + 64] += 1
                assert vis[q0:q0 + 64, k0:k0 + 64].any()
                if not need:   # dQ leaves rows past S unmasked: never stored
                    assert k0 + 64 <= T and (q0 + 64 <= S or not key_first)
                    assert vis[q0:q0 + 64, k0:k0 + 64].all()
            out.append(seen[:S, :T])
        return out

    for seen in counts():
        assert (seen[vis] == 1).all() and seen.max() <= 1
    if causal and 64 <= P < T:
        assert any((seen[vis] == 0).any() for seen in counts(True))


# ---------------------------------------------------------------------------
# chunked cross-entropy and lm_loss against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk,smoothing", [(100, 32, 0.0), (100, 32, 0.1),
                                               (40, 512, 0.2)])
def test_chunked_xent_matches_jax(S, chunk, smoothing):
    """The mean NLL and its gradients in hidden and table, with label
    smoothing and a ragged last chunk (JAX pads it)."""
    rng = np.random.RandomState(S)
    B, d, V = 2, 16, 50
    h = rng.randn(B, S, d).astype(np.float32)
    table = rng.randn(V, d).astype(np.float32)
    tgt = rng.randint(0, V, (B, S))
    valid = (rng.rand(B, S) > 0.2).astype(np.float32)

    def jf(a, b):
        return jtfm.chunked_xent(a, b, jnp.asarray(tgt), jnp.asarray(valid),
                                 chunk=chunk, label_smoothing=smoothing)

    want, (wh, wt) = jax.value_and_grad(jf, (0, 1))(jnp.asarray(h),
                                                    jnp.asarray(table))
    th, tt = (torch.from_numpy(x).requires_grad_() for x in (h, table))
    got = ttfm.chunked_xent(th, tt, torch.from_numpy(tgt),
                            torch.from_numpy(valid), chunk=chunk,
                            label_smoothing=smoothing)
    gh, gt = torch.autograd.grad(got, (th, tt))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-6)


def _np_leaf(t):
    return (t.detach().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            if t.dtype == torch.bfloat16 else t.detach().numpy()).copy()


def _jax_tree(lm, cfg):
    """The JAX parameter tree (numpy) of a port LM, stacked by
    `stacked_key` (the rule the bridge and the checkpoint hooks share)."""
    flat = ttfm.stack_lm_layers(cfg, {k.replace(".", "/"): v for k, v in
                                      lm.state_dict().items()})
    tree = {}
    for key, t in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = _np_leaf(t)
    return tree


def _flat_jax(tree, as_array=np.asarray):
    return {"/".join(str(getattr(p, "key", p)) for p in path): as_array(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _perturb(module, seed):
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.from_numpy(0.05 * rng.randn(*p.shape)).to(p.dtype))


def _seeded(arch, dtype="float32", **small):
    """(JAX cfg, port cfg, port LM seeded and perturbed, its JAX tree);
    the tree's names, shapes and dtypes are `lm_init`'s (traced
    abstractly)."""
    small = small or dict(SMALL, num_layers=LAYERS.get(arch, 2))
    jcfg = dataclasses.replace(
        jconfig.scaled_down(jconfig.get_arch(arch), **small),
        dtype=dtype, param_dtype=dtype)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    if jcfg.moe is not None:
        tcfg = dataclasses.replace(tcfg, moe=tconfig.MoEConfig(
            **dataclasses.asdict(jcfg.moe)))
    lm = build_model(tcfg).init(3, device="cpu")
    _perturb(lm, 7)
    tree = _jax_tree(lm, tcfg)
    want = jax.eval_shape(
        lambda: jax_build_model(jcfg).init(jax.random.PRNGKey(0))[0])
    assert {k: (a.shape, a.dtype.name) for k, a in _flat_jax(tree).items()} \
        == {k: (tuple(s.shape), s.dtype.name)
            for k, s in _flat_jax(want, lambda x: x).items()}
    return jcfg, tcfg, lm, tree


def _batch(cfg, B=2, S=SEQ, step=5):
    """A batch of `launch.train.lm_batch_fn` (numpy), which is JAX's."""
    fn = launch_train.lm_batch_fn(cfg.vocab_size, B, S, cfg, "cpu")
    return {k: v.numpy() for k, v in fn(step).items()}


def _port_grads(model, lm, batch, **kw):
    loss, metrics = model.loss(lm, batch, **kw)
    names, leaves = zip(*lm.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss, metrics, {n.replace(".", "/"): g for n, g in
                           zip(names, grads)}


def _assert_grads(cfg, got, jgrads, bound=1e-4):
    """Every port gradient against JAX's stacked one, per leaf within
    bound x max(1, max|g|)."""
    flat = _flat_jax(jgrads)
    assert len(ttfm.stack_lm_layers(cfg, got)) == len(flat)
    for name, g in got.items():
        at = ttfm.stacked_key(cfg, name)
        want = flat[name] if at is None else flat[at[0]][at[1]]
        tol = bound * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.float().numpy(), want, atol=tol, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# Trainer, resume, checkpoints in the stacked layout
# ---------------------------------------------------------------------------

def _tc(tmp, **kw):
    base = dict(learning_rate=1e-3, total_steps=5, warmup_steps=2,
                checkpoint_every=0, checkpoint_dir=str(tmp))
    base.update(kw)
    return base


def _fns(cfg, B=2, S=SEQ):
    port = launch_train.lm_batch_fn(cfg.vocab_size, B, S, cfg, "cpu")
    return port, jax_lm_batch_fn(cfg.vocab_size, B, S, cfg)


def test_lm_batch_fn_matches_jax():
    """The CLI's batches are JAX's, frames and patches included."""
    for arch in ("smollm_135m", "whisper_tiny", "paligemma_3b"):
        cfg = tconfig.scaled_down(tconfig.get_arch(arch))
        port, jfn = _fns(cfg)
        for step in (0, 3):
            got, want = port(step), jfn(step)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))


def test_trainer_matches_jax_over_five_steps(tmp_path):
    """The port Trainer on `Model.loss` follows the JAX Trainer step for
    step from the same weights and batches (a tiny smollm)."""
    jcfg, tcfg, lm, tree = _seeded("smollm_135m")
    model, jmodel = build_model(tcfg), jax_build_model(jcfg)
    port, jfn = _fns(tcfg)
    tr = Trainer(lambda p, b: model.loss(p, b), lm,
                 TrainConfig(**_tc(tmp_path / "p")))
    jtr = JaxTrainer(lambda p, b: jmodel.loss(p, b, impl="chunked"),
                     jax.tree_util.tree_map(jnp.asarray, tree),
                     jmodel.param_specs(),
                     jconfig.TrainConfig(**_tc(tmp_path / "j")))
    for s in range(5):
        m, jm = tr.step(port(s)), jtr.step(jfn(s))
        for k in ("loss", "nll", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k], jm[k], atol=1e-7, rtol=1e-4,
                                       err_msg=f"step {s} {k}")


def test_lm_exact_resume(tmp_path):
    """A fresh Trainer restored from the step-2 checkpoint (stacked layout)
    and run to step 4 ends with bitwise the weights and moments of the
    uninterrupted run."""
    cfg = tconfig.scaled_down(tconfig.get_arch("qwen3_4b"), num_layers=4)
    model = build_model(cfg)
    port, _ = _fns(cfg)
    tc = TrainConfig(**_tc(tmp_path / "a", total_steps=4,
                           checkpoint_every=2))
    tr = Trainer(lambda p, b: model.loss(p, b), model.init(1, "cpu"), tc)
    tr.fit(port, 4, log_every=100)
    resumed = tmp_path / "b"
    resumed.mkdir()
    shutil.copytree(tmp_path / "a" / "step_0000000002",
                    resumed / "step_0000000002")
    tr_b = Trainer(lambda p, b: model.loss(p, b), model.init(1, "cpu"),
                   TrainConfig(**_tc(resumed, total_steps=4)))
    tr_b.fit(port, 4, log_every=100)
    assert tr_b.state.step == 4
    for name, p in tr.state.params.items():
        assert torch.equal(p, tr_b.state.params[name]), name
    for part in ("m", "v"):
        for name, x in tr.state.opt_state[part].items():
            assert torch.equal(x, tr_b.state.opt_state[part][name]), name


@pytest.mark.parametrize("arch,dtype", [("qwen3_4b", "float32"),
                                        ("whisper_tiny", "bfloat16")])
def test_checkpoints_cross_both_ways_stacked(tmp_path, arch, dtype):
    """A port Trainer's checkpoint (params and AdamW moments) restores in
    the JAX reader with an `lm_init` template, layers stacked along
    `n_periods` (and `encoder_layers`); a JAX Trainer's restores into the
    port Trainer with equal values and trains on as JAX does. bf16
    params cross by their bits."""
    jcfg, tcfg, lm, tree = _seeded(arch, dtype)
    model, jmodel = build_model(tcfg), jax_build_model(jcfg)
    port, jfn = _fns(tcfg)
    tr = Trainer(lambda p, b: model.loss(p, b), lm,
                 TrainConfig(**_tc(tmp_path / "p")))
    tr.step(port(0))
    path = tr.maybe_checkpoint(force=True)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jtree, step, _ = jckpt.restore_checkpoint(
        path, {"params": params, "opt": jopt.adamw_init(params)})
    assert step == 1
    flat = _flat_jax(jtree)
    live = ckpt._flatten({"params": tr.state.params,
                          "opt": tr.state.opt_state})
    assert len(flat) == len(ttfm.stack_lm_layers(tcfg, live))
    for key, t in live.items():
        at = ttfm.stacked_key(tcfg, key)
        want = flat[key] if at is None else flat[at[0]][at[1]]
        np.testing.assert_array_equal(np.asarray(want), _np_leaf(t),
                                      err_msg=key)
        assert want.dtype == _np_leaf(t).dtype, key

    jtr = JaxTrainer(lambda p, b: jmodel.loss(p, b, impl="chunked"), params,
                     jmodel.param_specs(),
                     jconfig.TrainConfig(**_tc(tmp_path / "j",
                                               checkpoint_every=2)))
    jtr.fit(jfn, 2, log_every=1000)
    jpath = jckpt.latest_checkpoint(str(tmp_path / "j"))
    fresh = Trainer(lambda p, b: model.loss(p, b),
                    build_model(tcfg).init(9, "cpu"),
                    TrainConfig(**_tc(tmp_path / "q")))
    assert fresh.load(jpath) == 2
    jflat = _flat_jax({"params": jtr.state.params,
                       "opt": jtr.state.opt_state})
    for key, t in ckpt._flatten(fresh._live_tree()).items():
        at = ttfm.stacked_key(tcfg, key)
        want = jflat[key] if at is None else jflat[at[0]][at[1]]
        np.testing.assert_array_equal(_np_leaf(t), np.asarray(want),
                                      err_msg=key)
    if dtype == "float32":
        m, jm = fresh.step(port(2)), jtr.step(jfn(2))
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-4)


@pytest.mark.parametrize("stage,arch", [("lm", "smollm-135m"),
                                        ("pretrain", "semanticbbv-encoder")])
def test_launch_train_runs_on_the_cpu(tmp_path, stage, arch):
    """`python -m repro_torch.launch.train --device cpu --preset smoke`
    for 3 steps: finite metrics, a final checkpoint, and a second run
    resumes from it without taking a step."""
    argv = ["--arch", arch, "--stage", stage, "--steps", "3", "--batch", "4",
            "--device", "cpu", "--checkpoint-dir", str(tmp_path)]
    m = launch_train.main(argv)
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("step_0000000003")
    run = launch_train.make_run(arch, stage=stage, steps=3, batch=4,
                                checkpoint_dir=str(tmp_path), device="cpu")
    assert launch_train.train(run, 3) == {}
    assert run.trainer.state.step == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_train.make_run(arch, stage=stage, device="cuda")

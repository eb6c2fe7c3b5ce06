"""Recurrent sequence mixers of the LM zoo: Mamba (Jamba) and xLSTM
(mLSTM + sLSTM). Port of `repro.models.ssm`.

Each mixer is a module holding its parameters under the JAX tree's names,
in the config's dtype but for the leaves JAX keeps in fp32 in every model
(Mamba's `A_log` and `D`, mLSTM's `b_i` and `b_f`, sLSTM's `b_zifo`),
and four functions:
  *_apply(params, x, ...)           -> y             (prefill)
  *_init_state(batch, ...)          -> state         (fp32 zeros)
  *_decode(params, x, state, ...)   -> (y, state)    (one token)
The JAX package runs the sequence recurrences with `lax.scan` and
`associative_scan`, never in a Pallas kernel; the plain PyTorch loops
here are their port (no library call computes them). Recurrences run in
fp32 whatever the model's dtype, as in JAX. The three token loops
(`_selective_scan_fused`, `_mlstm_scan`, `_slstm_scan`) run through
`analysis.counting.token_loop`: as they are, but for a step count on
meta tensors, which probes them at a few tokens instead of running S.

Tensor-parallel (a mixer carrying a `collectives.ModelShard` as `tp`),
as GSPMD partitions JAX's by the specs: Mamba computes its DI/M inner
channels, the mLSTM its channels and, where M divides H, its heads, the
sLSTM its heads' recurrence. Three projections are stored split over
their whole output but cut into halves (Mamba's in_proj into xi | z,
the mLSTM's up_proj into xm | z, the sLSTM's up into a | b): a rank's
block of the product is exchanged into its channels of each half
(`ModelShard.exchange_halves`). A sum that rank-local compute consumes
(Mamba's x_proj, the mLSTM's w_if) is summed over "model" both ways
(`ModelShard.all_sum`). Where the mesh does not divide a unit, the rank
computes it whole.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.analysis.counting import token_loop
from repro_torch.models.layers import fetch, init_array, param

# ============================================================================
# shared
# ============================================================================


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B,S,C), w: (K,C), b: (C,); state:
    (B,K-1,C) trailing context (zeros when None). Returns (out, the new
    trailing context); the K taps are summed in index order, as JAX does."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return out + b, xp[:, -(K - 1):]


# ============================================================================
# Mamba (selective SSM, mamba-1 style)
# ============================================================================


def mamba_dims(d_model: int, d_state: int):
    d_inner = 2 * d_model
    dt_rank = max(1, d_model // 16)
    return d_inner, dt_rank


class Mamba(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, d_state: int,
                 conv_dim: int, dtype: torch.dtype):
        super().__init__()
        d_inner, dt_rank = mamba_dims(d_model, d_state)
        self.in_proj = param(init_array(gen, (d_model, 2 * d_inner)), dtype)
        self.conv_w = param(init_array(gen, (conv_dim, d_inner), 0.5), dtype)
        self.conv_b = param(torch.zeros(d_inner), dtype)
        self.x_proj = param(init_array(gen, (d_inner, dt_rank + 2 * d_state)),
                            dtype)
        self.dt_proj = param(init_array(gen, (dt_rank, d_inner)), dtype)
        # softplus^-1(1)
        self.dt_bias = param(torch.full((d_inner,), math.log(math.e - 1)),
                             dtype)
        # S4D-real init for A
        self.A_log = param(torch.log(torch.arange(
            1, d_state + 1, dtype=torch.float32).repeat(d_inner, 1)))
        self.D = param(torch.ones(d_inner))
        self.out_proj = param(init_array(gen, (d_inner, d_model)), dtype)


def _selective_scan_fused(dt, xi, Bc, Cc, A, chunk: int = 256):
    """h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t · h_t

    dt, xi: (B,S,DI) fp32; Bc, Cc: (B,S,DS) fp32; A: (DI,DS). One token
    at a time, so only (B,DI,DS) transients exist; the sequence must be a
    whole number of chunks, the rule of JAX's chunked scan."""
    B, S, DI = dt.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    h = torch.zeros((B, DI, A.shape[1]), dtype=torch.float32,
                    device=dt.device)
    ys = []
    for t in range(S):
        da = torch.exp(dt[:, t, :, None] * A)
        dbx = (dt[:, t] * xi[:, t])[..., None] * Bc[:, t, None, :]
        h = da * h + dbx
        ys.append(torch.einsum("bds,bs->bd", h, Cc[:, t]))
    return torch.stack(ys, dim=1)


def _mamba_split(params: Mamba) -> bool:
    """Whether a rank of the mixer's ModelShard computes only its inner
    channels: the stored spec splits them ("ff") over "model"."""
    tp = getattr(params, "tp", None)
    return tp is not None and tp.splits(params.conv_w, 1) \
        and tp.splits(params.in_proj, 1)


def _mamba_inputs(params: Mamba, x, d_state: int, conv_state=None,
                  split: bool = False):
    """The projections before the scan: (xi, z, dt fp32, Bc, Cc, A, new
    conv context). With `split`, of this rank's DI/M inner channels: x
    entering by copy-in, its block of in_proj's output exchanged into its
    channels of xi and of z (`exchange_halves`), x_proj's rows giving a
    partial dt_low | B | C summed over "model" both ways (it feeds this
    rank's columns of dt_proj and its channels of the scan)."""
    dt_ = x.dtype
    d_inner, dt_rank = mamba_dims(x.shape[-1], d_state)

    def w(name):
        return fetch(params, name, local=split).to(dt_)

    if split:
        tp = params.tp
        xi, z = tp.exchange_halves(tp.copy_in(x) @ w("in_proj"))
    else:
        xi, z = (x @ w("in_proj")).chunk(2, dim=-1)
    xi, conv = _causal_conv(xi, w("conv_w"), w("conv_b"), conv_state)
    xi = F.silu(xi)
    proj = xi @ w("x_proj")
    if split:
        proj = tp.all_sum(proj)
    dt, Bc, Cc = proj.split([dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(dt @ w("dt_proj") + w("dt_bias")).float()
    A = -torch.exp(fetch(params, "A_log", local=split))      # (DI, DS)
    return xi, z, dt, Bc, Cc, A, conv


def _mamba_out(params: Mamba, y, z, x, split: bool):
    """(y (.., DI) fp32) gated by silu(z), through out_proj: the rank's
    rows of it, then reduce-out, with `split`."""
    y = y.to(x.dtype) * F.silu(z)
    out = y @ fetch(params, "out_proj", local=split).to(x.dtype)
    return params.tp.reduce_out(out) if split else out


def mamba_apply(params: Mamba, x, d_state: int, chunk: int = 4096):
    """x: (B,S,d) -> (B,S,d)"""
    split = _mamba_split(params)
    xi, z, dt, Bc, Cc, A, _ = _mamba_inputs(params, x, d_state, split=split)
    y = token_loop("mamba_scan", _selective_scan_fused,
                   (dt, xi.float(), Bc.float(), Cc.float(), A, chunk),
                   seq_args=(0, 1, 2, 3))
    y = y + fetch(params, "D", local=split) * xi.float()
    return _mamba_out(params, y, z, x, split)


def mamba_init_state(batch: int, d_model: int, d_state: int, conv_dim: int,
                     device=None) -> dict:
    d_inner, _ = mamba_dims(d_model, d_state)
    return {"conv": torch.zeros((batch, conv_dim - 1, d_inner),
                                device=device),
            "ssm": torch.zeros((batch, d_inner, d_state), device=device)}


def mamba_decode(params: Mamba, x, state: dict, d_state: int):
    """x: (B,1,d) single step (a rank's channels of the state, and of the
    output's partial, under a ModelShard that splits them)."""
    split = _mamba_split(params)
    xi, z, dt, Bc, Cc, A, conv = _mamba_inputs(params, x, d_state,
                                               state["conv"], split)
    xi0 = xi[:, 0].float()
    dA = torch.exp(dt[:, 0, :, None] * A)                        # (B,DI,DS)
    dBx = (dt[:, 0] * xi0)[..., None] * Bc[:, 0].float()[:, None, :]
    h = dA * state["ssm"] + dBx
    y = torch.einsum("bds,bs->bd", h, Cc[:, 0].float())
    y = y + fetch(params, "D", local=split) * xi0
    return _mamba_out(params, y[:, None], z, x, split), \
        {"conv": conv.float(), "ssm": h}


# ============================================================================
# mLSTM (xLSTM matrix-memory block)
# ============================================================================


def mlstm_dims(d_model: int, num_heads: int):
    d_inner = 2 * d_model
    dh = d_inner // num_heads
    return d_inner, dh


QKV_BLOCK = 4  # official xLSTM proj_blocksize


class MLSTM(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, num_heads: int,
                 conv_dim: int, dtype: torch.dtype):
        super().__init__()
        d_inner, _ = mlstm_dims(d_model, num_heads)
        nb = d_inner // QKV_BLOCK
        blk = (nb, QKV_BLOCK, QKV_BLOCK)
        self.up_proj = param(init_array(gen, (d_model, 2 * d_inner)), dtype)
        self.conv_w = param(init_array(gen, (conv_dim, d_inner), 0.5), dtype)
        self.conv_b = param(torch.zeros(d_inner), dtype)
        # block-diagonal qkv with block size 4 (xLSTM proj_blocksize=4)
        self.wq = param(init_array(gen, blk), dtype)
        self.wk = param(init_array(gen, blk), dtype)
        self.wv = param(init_array(gen, blk), dtype)
        self.w_if = param(init_array(gen, (d_inner, 2 * num_heads), 0.02),
                          dtype)
        self.b_i = param(torch.zeros(num_heads))
        self.b_f = param(torch.full((num_heads,), 3.0))  # open forget gates
        self.out_norm = param(torch.ones(d_inner), dtype)
        self.down_proj = param(init_array(gen, (d_inner, d_model)), dtype)


def _blockdiag(x, w):
    """x: (..., d_inner), w: (nb, blk, blk) block-diagonal matmul."""
    nb, blk, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, blk)
    return torch.einsum("...ni,nij->...nj", xs, w).reshape(x.shape)


def _mlstm_scan(q, k, v, i_pre, f_pre):
    """Exponential-gated matrix memory, stabilized (xLSTM eqs. 19-27), one
    token at a time. q,k,v: (B,S,H,dh) fp32; i_pre,f_pre: (B,S,H)."""
    B, S, H, dh = q.shape
    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=q.device)
    m = torch.zeros((B, H), dtype=torch.float32, device=q.device)
    hs = []
    for t in range(S):
        h, C, n, m = _mlstm_step(q[:, t], k[:, t], v[:, t], i_pre[:, t],
                                 f_pre[:, t], C, n, m)
        hs.append(h)
    return torch.stack(hs, dim=1)                     # (B,S,H,dh)


def _mlstm_step(qt, kt, vt, it, ft, C, n, m):
    """One stabilized step: (h (B,H,dh), C, n, m) after token t."""
    m_new = torch.maximum(ft + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + m - m_new)
    C = f_[..., None, None] * C + i_[..., None, None] * (
        kt[..., :, None] * vt[..., None, :])
    n = f_[..., None] * n + i_[..., None] * kt
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", n, qt).abs(),
                          torch.exp(-m_new))
    h = torch.einsum("bhdk,bhd->bhk", C, qt) / denom[..., None]
    return h, C, n, m_new


def _mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk: int = 256):
    """Chunkwise-parallel mLSTM, exactly equal to the sequential stabilized
    recurrence (JAX's derivation, `repro.models.ssm._mlstm_chunkwise`):
    with b=cumsum(f̃), g=ĩ−b, M_t=max(m₀, cummax g), the stabilized
    weights are
        intra:  D[t,s] = exp(g_s − M_t)  (s ≤ t, always ≤ 1)
        inter:  exp(m₀ − M_t) on the carried (C₀, n₀)
        carry:  C_L = Σ_s exp(g_s − M_L) k_s v_sᵀ + exp(m₀ − M_L) C₀,
                m_L = b_L + M_L
    q,k,v: (B,S,H,dh) fp32 (k pre-scaled by dh^-0.5); i/f_pre: (B,S,H)."""
    B, S, H, dh = q.shape
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"seq {S} not divisible by chunk {L}")
    dev = q.device
    C0 = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
    n0 = torch.zeros((B, H, dh), dtype=torch.float32, device=dev)
    m0 = torch.zeros((B, H), dtype=torch.float32, device=dev)
    causal = torch.ones((L, L), dtype=torch.bool, device=dev).tril()
    hs = []
    for j in range(0, S, L):
        qj, kj, vj = q[:, j:j + L], k[:, j:j + L], v[:, j:j + L]
        ij, fj = i_pre[:, j:j + L], f_pre[:, j:j + L]      # (B,L,H)
        b = torch.cumsum(fj, dim=1)
        g = ij - b
        M = torch.maximum(m0[:, None], torch.cummax(g, dim=1).values)
        inter = torch.exp(m0[:, None] - M)                  # (B,L,H)
        # D[t,s] = exp(g_s - M_t), causal, exponents always <= 0
        D = torch.exp(g.transpose(1, 2)[:, :, None, :]
                      - M.transpose(1, 2)[..., None])       # (B,H,L,L)
        D = torch.where(causal, D, 0.0)
        W = D * torch.einsum("blhd,bshd->bhls", qj, kj)
        num = torch.einsum("bhls,bshd->blhd", W, vj) \
            + inter[..., None] * torch.einsum("blhd,bhde->blhe", qj, C0)
        nq = W.sum(-1).transpose(1, 2) \
            + inter * torch.einsum("blhd,bhd->blh", qj, n0)  # (B,L,H)
        denom = torch.maximum(nq.abs(), torch.exp(-(b + M)))
        hs.append(num / denom[..., None])
        # carry to the next chunk
        ML = M[:, -1]                                       # (B,H)
        wL = torch.exp(g - ML[:, None])                     # (B,L,H)
        carry = torch.exp(m0 - ML)
        C0 = torch.einsum("blhd,blhe->bhde", wL[..., None] * kj, vj) \
            + carry[..., None, None] * C0
        n0 = torch.einsum("blh,blhd->bhd", wL, kj) + carry[..., None] * n0
        m0 = b[:, -1] + ML
    return torch.cat(hs, dim=1)


def _mlstm_split(params: MLSTM, num_heads: int):
    """(ff, heads): whether a rank of the mixer's ModelShard computes only
    its inner channels (the stored spec splits them over "model"), and
    among them only its heads (M divides H too). A rank's channels need
    whole blocks of the block-diagonal qkv."""
    tp = getattr(params, "tp", None)
    if tp is None or not tp.splits(params.conv_w, 1):
        return False, False
    if not (tp.splits(params.wq, 0) and tp.splits(params.up_proj, 1)):
        raise ValueError(f"{tp.M} ranks split the mLSTM's channels but not "
                         f"its {params.wq.shape[0]} qkv blocks")
    return True, num_heads % tp.M == 0


def _mlstm_inputs(params: MLSTM, x, num_heads: int, conv_state=None,
                  ff: bool = False, split: bool = False):
    """(q, k, v (B,S,H,dh) fp32, i_pre, f_pre (B,S,H) fp32, z, new conv
    context) of x (B,S,d). With `ff` (`_mlstm_split`): x by copy-in,
    up_proj's block exchanged into this rank's channels of xm and of z,
    its conv, qkv blocks and w_if rows (the gates' partials summed over
    "model" both ways: each rank goes on with its heads of them); then
    with `split` q, k, v and the gates of its heads, else q, k, v
    gathered over "model" and every head's."""
    B, S, d = x.shape
    dt = x.dtype
    _, dh = mlstm_dims(d, num_heads)

    def w(name):
        return fetch(params, name, local=ff).to(dt)

    if ff:
        tp = params.tp
        xm, z = tp.exchange_halves(tp.copy_in(x) @ w("up_proj"))
    else:
        xm, z = (x @ w("up_proj")).chunk(2, dim=-1)
    xc, conv = _causal_conv(xm, w("conv_w"), w("conv_b"), conv_state)
    xc = F.silu(xc)
    q = _blockdiag(xc, w("wq"))
    k = _blockdiag(xc, w("wk")) * (dh ** -0.5)
    v = _blockdiag(xm, w("wv"))
    gates = xc @ w("w_if")
    b_i = fetch(params, "b_i", local=ff)
    b_f = fetch(params, "b_f", local=ff)
    H = num_heads
    if ff:
        gates = tp.all_sum(gates)
        gates = gates.reshape(B, S, 2, H)
        if split:       # this rank's heads of the gates
            H //= tp.M
            gates = tp.head_block(gates, 3)
            b_i, b_f = tp.head_block(b_i, 0), tp.head_block(b_f, 0)
        else:           # every head, from every rank's channels
            q, k, v = (tp.gather_model(t, -1) for t in (q, k, v))
        gates = gates.reshape(B, S, 2 * H)
    i_pre = gates[..., :H].float() + b_i
    f_pre = F.logsigmoid(gates[..., H:].float() + b_f)
    heads = (B, S, H, dh)
    return q.reshape(heads).float(), k.reshape(heads).float(), \
        v.reshape(heads).float(), i_pre, f_pre, z, conv


def _mlstm_out(params: MLSTM, h, z, x, ff: bool = False):
    """Output gate and down projection of h (B,S,H,dh) fp32. With `ff`,
    the rank's channels of h (all of it where it holds its heads, its
    block of every head's otherwise), out_norm and down_proj, then
    reduce-out."""
    h = h.reshape(*h.shape[:2], -1)
    if ff and h.shape[-1] != z.shape[-1]:
        h = params.tp.head_block(h, -1)
    h = h.to(x.dtype) * fetch(params, "out_norm", local=ff).to(x.dtype)
    out = (h * F.silu(z)) @ fetch(params, "down_proj", local=ff).to(x.dtype)
    return params.tp.reduce_out(out) if ff else out


def mlstm_apply(params: MLSTM, x, num_heads: int, chunk: int = 256):
    """x: (B,S,d) -> (B,S,d). The chunkwise form when S is a whole number
    of chunks (min(chunk, S) tokens), else the token scan (JAX's rule for
    its default impl, "chunked")."""
    ff, split = _mlstm_split(params, num_heads)
    q, k, v, i_pre, f_pre, z, _ = _mlstm_inputs(params, x, num_heads,
                                                ff=ff, split=split)
    S = x.shape[1]
    if S % min(chunk, S) == 0:
        h = _mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk=chunk)
    else:
        h = token_loop("mlstm_scan", _mlstm_scan, (q, k, v, i_pre, f_pre),
                       seq_args=(0, 1, 2, 3, 4))
    return _mlstm_out(params, h, z, x, ff)


def mlstm_init_state(batch: int, d_model: int, num_heads: int,
                     conv_dim: int, device=None) -> dict:
    d_inner, dh = mlstm_dims(d_model, num_heads)
    return {
        "conv": torch.zeros((batch, conv_dim - 1, d_inner), device=device),
        "C": torch.zeros((batch, num_heads, dh, dh), device=device),
        "n": torch.zeros((batch, num_heads, dh), device=device),
        "m": torch.zeros((batch, num_heads), device=device),
    }


def mlstm_decode(params: MLSTM, x, state: dict, num_heads: int):
    """x: (B,1,d) single step (a rank's channels of the conv context and
    its heads of C, n, m, under a ModelShard that splits them)."""
    ff, split = _mlstm_split(params, num_heads)
    q, k, v, it, ft, z, conv = _mlstm_inputs(params, x, num_heads,
                                             state["conv"], ff, split)
    h, C, n, m = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], it[:, 0], ft[:, 0],
                             state["C"], state["n"], state["m"])
    return _mlstm_out(params, h[:, None], z, x, ff), \
        {"conv": conv.float(), "C": C, "n": n, "m": m}


# ============================================================================
# sLSTM (xLSTM scalar-memory block)
# ============================================================================


class SLSTM(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, num_heads: int,
                 conv_dim: int, dtype: torch.dtype):
        super().__init__()
        dh = d_model // num_heads
        self.conv_w = param(init_array(gen, (conv_dim, d_model), 0.5), dtype)
        self.conv_b = param(torch.zeros(d_model), dtype)
        self.w_zifo = param(init_array(gen, (d_model, 4 * d_model)), dtype)
        # recurrent block-diagonal per head
        self.r_zifo = param(init_array(gen, (4, num_heads, dh, dh), 0.02),
                            dtype)
        self.b_zifo = param(torch.zeros(4 * d_model))
        self.norm = param(torch.ones(d_model), dtype)
        self.up = param(init_array(gen, (d_model, 2 * (4 * d_model // 3))),
                        dtype)
        self.down = param(init_array(gen, (4 * d_model // 3, d_model)), dtype)


def _slstm_weights(r):
    """The recurrent weights r (4,H,dh,dh) laid out once as one (H, dh,
    4 dh) matrix a head, gate-major columns, so that a step's product
    reads them in place: an einsum over r's own layout copied r at every
    token, and autograd kept each copy (69 GB over xlstm-1.3b's 4096
    tokens of 4 rows)."""
    G, H, dh, _ = r.shape
    return r.permute(1, 2, 0, 3).reshape(H, dh, G * dh)


def _slstm_cell(rw, pre, h_prev, c_prev, n_prev, m_prev, num_heads: int):
    """One sLSTM step. rw: the recurrent weights as `_slstm_weights` lays
    them out, fp32; pre: (B, 4 d_model) input pre-activations z|i|f|o;
    the states (B, d_model) fp32."""
    B, d = h_prev.shape
    H = num_heads
    hp = h_prev.reshape(B, H, d // H).transpose(0, 1)          # (H,B,dh)
    rec = torch.bmm(hp, rw).reshape(H, B, 4, d // H)
    rec = rec.permute(2, 1, 0, 3).reshape(4, B, d)
    wz, wi, wf, wo = pre.chunk(4, dim=-1)
    z = torch.tanh(wz + rec[0])
    i_pre = wi + rec[1]
    f_pre = F.logsigmoid(wf + rec[2])
    o = torch.sigmoid(wo + rec[3])
    m_new = torch.maximum(f_pre + m_prev, i_pre)
    i_ = torch.exp(i_pre - m_new)
    f_ = torch.exp(f_pre + m_prev - m_new)
    c = f_ * c_prev + i_ * z
    n = f_ * n_prev + i_
    h = o * c / torch.clamp(n, min=1e-6)
    return h, c, n, m_new


def _slstm_split(params: SLSTM, num_heads: int) -> bool:
    """Whether a rank of the mixer's ModelShard runs only its heads'
    recurrence: the stored spec splits r_zifo's heads over "model" (M
    divides H)."""
    tp = getattr(params, "tp", None)
    return tp is not None and tp.splits(params.r_zifo, 1, num_heads)


def _slstm_inputs(params: SLSTM, x, conv_state=None, split: bool = False):
    """(pre-activations (B,S,4d) fp32, new conv context). With `split`,
    the rank's heads' columns of each of z, i, f, o (B,S,4 d/M): the
    conv's output by copy-in, w_zifo's and b_zifo's columns of its heads
    (a strided slice of the replicated leaves, by copy-in)."""
    dt = x.dtype
    xc, conv = _causal_conv(x, fetch(params, "conv_w").to(dt),
                            fetch(params, "conv_b").to(dt), conv_state)
    u = F.silu(xc)
    w = fetch(params, "w_zifo", local=split).to(dt)
    b = fetch(params, "b_zifo", local=split)
    if split:
        tp = params.tp
        d = x.shape[-1]
        u = tp.copy_in(u)
        w = tp.head_block(w.reshape(d, 4, d), 2).reshape(d, -1)
        b = tp.head_block(b.reshape(4, d), 1).reshape(-1)
    pre = (u @ w).float() + b
    return pre, conv


def _slstm_out(params: SLSTM, h, x):
    """Norm, gated GELU (tanh form, jax.nn.gelu's default) and down
    projection of h (B,S,d) fp32. Under a ModelShard that splits `up`'s
    halves into whole channel blocks (M divides d_ff and `down` is
    stored split), the rank's channels of a and b (`exchange_halves`)
    and its rows of down, then reduce-out; else the whole FFN."""
    dt = x.dtype
    tp = getattr(params, "tp", None)
    split = tp is not None and tp.splits(params.up, 1) \
        and tp.splits(params.down, 0)
    h = h.to(dt) * fetch(params, "norm").to(dt)
    up = fetch(params, "up", local=split).to(dt)
    if split:
        a, b = tp.exchange_halves(tp.copy_in(h) @ up)
    else:
        a, b = (h @ up).chunk(2, dim=-1)
    out = (F.gelu(a, approximate="tanh") * b) \
        @ fetch(params, "down", local=split).to(dt)
    return tp.reduce_out(out) if split else out


def _slstm_scan(pre, rw, num_heads: int):
    """The sLSTM recurrence over pre-activations pre (B,S,4d) fp32 with the
    recurrent weights rw (`_slstm_weights`), one token at a time from
    zero states: h (B,S,d) fp32."""
    B, S, d4 = pre.shape
    h, c, n, m = (torch.zeros((B, d4 // 4), dtype=torch.float32,
                              device=pre.device) for _ in range(4))
    hs = []
    for t in range(S):
        h, c, n, m = _slstm_cell(rw, pre[:, t], h, c, n, m, num_heads)
        hs.append(h)
    return torch.stack(hs, dim=1)


def slstm_apply(params: SLSTM, x, num_heads: int):
    """x: (B,S,d) -> (B,S,d), one token at a time. Under a ModelShard
    that splits the heads, the rank's heads' recurrence over the whole
    sequence, then h gathered over "model" once (no collective in the
    token loop)."""
    split = _slstm_split(params, num_heads)
    pre, _ = _slstm_inputs(params, x, split=split)
    rw = _slstm_weights(fetch(params, "r_zifo", local=split).float())
    nh = num_heads // params.tp.M if split else num_heads
    h = token_loop("slstm_scan", _slstm_scan, (pre, rw, nh), seq_args=(0,))
    if split:       # the norm and FFN after it run whole on every rank
        h = params.tp.gather_model(h, -1, "split")
    return _slstm_out(params, h, x)


def slstm_init_state(batch: int, d_model: int, device=None) -> dict:
    zeros = lambda *shape: torch.zeros(shape, device=device)  # noqa: E731
    return {"h": zeros(batch, d_model), "c": zeros(batch, d_model),
            "n": zeros(batch, d_model), "m": zeros(batch, d_model),
            "conv": zeros(batch, 3, d_model)}


def slstm_decode(params: SLSTM, x, state: dict, num_heads: int):
    """x: (B,1,d) single step. Under a ModelShard that splits the heads,
    the rank's heads' step from its slices of the whole states, whose new
    values are gathered over "model": h, c, n, m stay whole, and the
    same on every rank."""
    split = _slstm_split(params, num_heads)
    pre, conv = _slstm_inputs(params, x, state["conv"], split)
    prev = [state[k] for k in "hcnm"]
    nh = num_heads
    if split:
        tp = params.tp
        nh //= tp.M
        prev = [tp.head_block(t, -1) for t in prev]
    h, c, n, m = _slstm_cell(
        _slstm_weights(fetch(params, "r_zifo", local=split).float()),
        pre[:, 0], *prev, nh)
    if split:
        h, c, n, m = tp.gather_model(torch.stack([h, c, n, m]), -1,
                                     "split").unbind(0)
    return _slstm_out(params, h[:, None], x), \
        {"h": h, "c": c, "n": n, "m": m, "conv": conv.float()}


# logical-axis specs of the mixers' parameters (the `*_init` spec dicts)

def mamba_specs() -> dict:
    return {"in_proj": ("embed", "ff"), "conv_w": (None, "ff"),
            "conv_b": ("ff",), "x_proj": ("ff", None),
            "dt_proj": (None, "ff"), "dt_bias": ("ff",),
            "A_log": ("ff", None), "D": ("ff",), "out_proj": ("ff", "embed")}


def mlstm_specs() -> dict:
    return {"up_proj": ("embed", "ff"), "conv_w": (None, "ff"),
            "conv_b": ("ff",), "wq": ("ff", None, None),
            "wk": ("ff", None, None), "wv": ("ff", None, None),
            "w_if": ("ff", None), "b_i": (None,), "b_f": (None,),
            "out_norm": ("ff",), "down_proj": ("ff", "embed")}


def slstm_specs() -> dict:
    return {"conv_w": (None, "embed"), "conv_b": ("embed",),
            "w_zifo": ("embed", None), "r_zifo": (None, "heads", None, None),
            "b_zifo": (None,), "norm": ("embed",),
            "up": ("embed", "ff"), "down": ("ff", "embed")}

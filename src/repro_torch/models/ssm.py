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
fp32 whatever the model's dtype, as in JAX.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import init_array, param

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


def _mamba_inputs(params: Mamba, x, d_state: int, conv_state=None):
    """The projections before the scan: (xi, z, dt fp32, Bc, Cc, A, new
    conv context)."""
    dt_ = x.dtype
    d_inner, dt_rank = mamba_dims(x.shape[-1], d_state)
    xi, z = (x @ params.in_proj.to(dt_)).chunk(2, dim=-1)
    xi, conv = _causal_conv(xi, params.conv_w.to(dt_),
                            params.conv_b.to(dt_), conv_state)
    xi = F.silu(xi)
    dt, Bc, Cc = (xi @ params.x_proj.to(dt_)).split(
        [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(dt @ params.dt_proj.to(dt_)
                    + params.dt_bias.to(dt_)).float()
    A = -torch.exp(params.A_log)                      # (DI, DS)
    return xi, z, dt, Bc, Cc, A, conv


def mamba_apply(params: Mamba, x, d_state: int, chunk: int = 4096):
    """x: (B,S,d) -> (B,S,d)"""
    xi, z, dt, Bc, Cc, A, _ = _mamba_inputs(params, x, d_state)
    y = _selective_scan_fused(dt, xi.float(), Bc.float(), Cc.float(), A,
                              chunk)
    y = y + params.D * xi.float()
    y = y.to(x.dtype) * F.silu(z)
    return y @ params.out_proj.to(x.dtype)


def mamba_init_state(batch: int, d_model: int, d_state: int, conv_dim: int,
                     device=None) -> dict:
    d_inner, _ = mamba_dims(d_model, d_state)
    return {"conv": torch.zeros((batch, conv_dim - 1, d_inner),
                                device=device),
            "ssm": torch.zeros((batch, d_inner, d_state), device=device)}


def mamba_decode(params: Mamba, x, state: dict, d_state: int):
    """x: (B,1,d) single step."""
    xi, z, dt, Bc, Cc, A, conv = _mamba_inputs(params, x, d_state,
                                               state["conv"])
    xi0 = xi[:, 0].float()
    dA = torch.exp(dt[:, 0, :, None] * A)                        # (B,DI,DS)
    dBx = (dt[:, 0] * xi0)[..., None] * Bc[:, 0].float()[:, None, :]
    h = dA * state["ssm"] + dBx
    y = torch.einsum("bds,bs->bd", h, Cc[:, 0].float())
    y = y + params.D * xi0
    y = (y.to(x.dtype) * F.silu(z[:, 0]))[:, None]
    return y @ params.out_proj.to(x.dtype), {"conv": conv.float(), "ssm": h}


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


def _mlstm_inputs(params: MLSTM, x, num_heads: int, conv_state=None):
    """(q, k, v (B,S,H,dh) fp32, i_pre, f_pre (B,S,H) fp32, z, new conv
    context) of x (B,S,d)."""
    B, S, d = x.shape
    dt = x.dtype
    _, dh = mlstm_dims(d, num_heads)
    xm, z = (x @ params.up_proj.to(dt)).chunk(2, dim=-1)
    xc, conv = _causal_conv(xm, params.conv_w.to(dt), params.conv_b.to(dt),
                            conv_state)
    xc = F.silu(xc)
    heads = (B, S, num_heads, dh)
    q = _blockdiag(xc, params.wq.to(dt)).reshape(heads)
    k = (_blockdiag(xc, params.wk.to(dt)) * (dh ** -0.5)).reshape(heads)
    v = _blockdiag(xm, params.wv.to(dt)).reshape(heads)
    gates = xc @ params.w_if.to(dt)
    i_pre = gates[..., :num_heads].float() + params.b_i
    f_pre = F.logsigmoid(gates[..., num_heads:].float() + params.b_f)
    return q.float(), k.float(), v.float(), i_pre, f_pre, z, conv


def _mlstm_out(params: MLSTM, h, z, x):
    """Output gate and down projection of h (B,S,H,dh) fp32."""
    h = h.reshape(z.shape).to(x.dtype) * params.out_norm.to(x.dtype)
    return (h * F.silu(z)) @ params.down_proj.to(x.dtype)


def mlstm_apply(params: MLSTM, x, num_heads: int, chunk: int = 256):
    """x: (B,S,d) -> (B,S,d). The chunkwise form when S is a whole number
    of chunks (min(chunk, S) tokens), else the token scan (JAX's rule for
    its default impl, "chunked")."""
    q, k, v, i_pre, f_pre, z, _ = _mlstm_inputs(params, x, num_heads)
    S = x.shape[1]
    if S % min(chunk, S) == 0:
        h = _mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk=chunk)
    else:
        h = _mlstm_scan(q, k, v, i_pre, f_pre)
    return _mlstm_out(params, h, z, x)


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
    """x: (B,1,d) single step."""
    q, k, v, it, ft, z, conv = _mlstm_inputs(params, x, num_heads,
                                             state["conv"])
    h, C, n, m = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], it[:, 0], ft[:, 0],
                             state["C"], state["n"], state["m"])
    return _mlstm_out(params, h[:, None], z, x), \
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


def _slstm_cell(r, pre, h_prev, c_prev, n_prev, m_prev, num_heads: int):
    """One sLSTM step. r: the recurrent weights (4,H,dh,dh) fp32; pre:
    (B, 4 d_model) input pre-activations z|i|f|o; the states (B, d_model)
    fp32."""
    B, d = h_prev.shape
    hp = h_prev.reshape(B, num_heads, d // num_heads)
    rec = torch.einsum("bhd,ghde->gbhe", hp, r).reshape(4, B, d)
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


def _slstm_inputs(params: SLSTM, x, conv_state=None):
    """(pre-activations (B,S,4d) fp32, new conv context)."""
    dt = x.dtype
    xc, conv = _causal_conv(x, params.conv_w.to(dt), params.conv_b.to(dt),
                            conv_state)
    pre = (F.silu(xc) @ params.w_zifo.to(dt)).float() + params.b_zifo
    return pre, conv


def _slstm_out(params: SLSTM, h, x):
    """Norm, gated GELU (tanh form, jax.nn.gelu's default) and down
    projection of h (B,S,d) fp32."""
    dt = x.dtype
    h = h.to(dt) * params.norm.to(dt)
    a, b = (h @ params.up.to(dt)).chunk(2, dim=-1)
    return (F.gelu(a, approximate="tanh") * b) @ params.down.to(dt)


def slstm_apply(params: SLSTM, x, num_heads: int):
    """x: (B,S,d) -> (B,S,d), one token at a time."""
    B, S, d = x.shape
    pre, _ = _slstm_inputs(params, x)
    r = params.r_zifo.float()
    h, c, n, m = (torch.zeros((B, d), dtype=torch.float32, device=x.device)
                  for _ in range(4))
    hs = []
    for t in range(S):
        h, c, n, m = _slstm_cell(r, pre[:, t], h, c, n, m, num_heads)
        hs.append(h)
    return _slstm_out(params, torch.stack(hs, dim=1), x)


def slstm_init_state(batch: int, d_model: int, device=None) -> dict:
    zeros = lambda *shape: torch.zeros(shape, device=device)  # noqa: E731
    return {"h": zeros(batch, d_model), "c": zeros(batch, d_model),
            "n": zeros(batch, d_model), "m": zeros(batch, d_model),
            "conv": zeros(batch, 3, d_model)}


def slstm_decode(params: SLSTM, x, state: dict, num_heads: int):
    """x: (B,1,d) single step."""
    pre, conv = _slstm_inputs(params, x, state["conv"])
    h, c, n, m = _slstm_cell(params.r_zifo.float(), pre[:, 0], state["h"],
                             state["c"], state["n"], state["m"], num_heads)
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

"""Stage 2 in plain PyTorch (paper §III-B): the interval set assembled
from its block counts, and the frequency-weighted Set Transformer that
turns it into a unit-norm signature and a log1p-CPI prediction.

Weights come as a {name: tensor} dict under the system's parameter names
("set_transformer.sabs.0.mha.wq", ...), computed in float32 with the
matrix products at the `Precision` given. Departures from the paper,
shared with the system: the log-frequency enters both as an input
channel and as an additive key bias normalised by the set's largest; a
padded slot is masked by an additive -2^30.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from chipbench.reference.precision import Precision
from chipbench.reference.stage1 import NEG, gelu_tanh, l2_normalize


def interval_sets(counts: Sequence[Dict[int, int]], max_set: int):
    """Each interval's `max_set` most executed blocks, ties kept in the
    counts' own order: (block ids (B, N) int64, -1 in empty slots;
    counts (B, N) float32; mask (B, N) bool)."""
    B = len(counts)
    bids = np.full((B, max_set), -1, np.int64)
    freqs = np.zeros((B, max_set), np.float32)
    for i, c in enumerate(counts):
        top = sorted(c.items(), key=lambda kv: -kv[1])[:max_set]
        for j, (bid, n) in enumerate(top):
            bids[i, j] = bid
            freqs[i, j] = n
    return bids, freqs, bids >= 0


def layernorm(x, scale, bias, eps: float = 1e-6):
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.mean(torch.square(x - mu), -1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _mha(W, p: str, xq, xk, key_bias, mask, num_heads: int, P: Precision):
    B, N, d = xq.shape
    M = xk.shape[1]
    dh = d // num_heads

    def heads(t, n):
        return t.reshape(B, n, num_heads, dh).transpose(1, 2)

    q = heads(P.mm(xq, W[p + "wq"]), N)
    k = heads(P.mm(xk, W[p + "wk"]), M)
    v = heads(P.mm(xk, W[p + "wv"]), M)
    s = torch.einsum("bhnd,bhmd->bhnm", q, k) / math.sqrt(dh)
    s = s + key_bias[:, None, None, :] + torch.where(
        mask, 0.0, NEG)[:, None, None, :]
    o = torch.einsum("bhnm,bhmd->bhnd", torch.softmax(s, -1), v)
    return P.mm(o.transpose(1, 2).reshape(B, N, d), W[p + "wo"])


def _mab(W, p: str, xq, xk, key_bias, mask, num_heads: int, P: Precision):
    h = layernorm(xq + _mha(W, p + "mha.", xq, xk, key_bias, mask,
                            num_heads, P),
                  W[p + "norm1.scale"], W[p + "norm1.bias"])
    ff = P.mm(gelu_tanh(P.mm(h, W[p + "ff1.w"]) + W[p + "ff1.b"]),
              W[p + "ff2.w"]) + W[p + "ff2.b"]
    return layernorm(h + ff, W[p + "norm2.scale"], W[p + "norm2.bias"])


def signature(W, cfg: dict, bbes, freqs, mask, P: Precision):
    """bbes (B, N, bbe_dim), freqs (B, N), mask (B, N) bool ->
    (signatures (B, sig_dim) unit-norm, log1p-CPI predictions (B,))."""
    B = bbes.shape[0]
    H = cfg["num_heads"]
    logw = torch.log1p(freqs)
    key_bias = logw / torch.clamp(logw.amax(-1, keepdim=True), min=1e-6)
    x = torch.cat([bbes, key_bias[..., None]], -1)
    st = "set_transformer."
    h = P.mm(x, W[st + "in_proj.w"]) + W[st + "in_proj.b"]
    for i in range(cfg["num_sabs"]):
        h = _mab(W, f"{st}sabs.{i}.", h, h, key_bias, mask, H, P)
    seeds = W[st + "seeds"][None].expand(B, -1, -1)
    pooled = _mab(W, st + "pma.", seeds, h, key_bias, mask, H, P)
    sig = l2_normalize(P.mm(pooled.reshape(B, -1), W[st + "out_proj.w"])
                       + W[st + "out_proj.b"])
    z = torch.tanh(P.mm(sig, W["cpi_head.w1"]) + W["cpi_head.b1"])
    return sig, (P.mm(z, W["cpi_head.w2"]) + W["cpi_head.b2"])[..., 0]

"""Stage 1 in plain PyTorch (paper §III-A): the RWKV basic-block encoder,
its pooled L2-normalised BBE, and the NTP + NIP pre-training loss.

Weights come as a {name: tensor} dict under the system's parameter
names ("blocks.<l>.time_mix.wr", ...); every computation runs in
float32 on the weights' float32 values, the matrix products at the
`Precision` given. The delta-rule recurrence is a scan over the tokens:

    S_t = diag(w_t) S_{t-1} + beta_t k_t (v_t - (diag(w_t) S_{t-1})^T k_t)^T
    y_t = S_t^T r_t

Departures from the paper, shared with the system: the recurrence is the
gated delta rule of RWKV-7 with unit-normalised keys; the channel mix is
a token-shifted squared-ReLU FFN; GELU is its tanh form.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from chipbench.reference.precision import Precision

NEG = -2.0 ** 30


def rmsnorm(x, scale, eps: float = 1e-6):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * scale


def l2_normalize(x, eps: float = 1e-8):
    return x / torch.clamp(torch.sqrt(torch.sum(x * x, -1, keepdim=True)),
                           min=eps)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def shift(x):
    """The previous token's row, zeros before the first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def wkv_scan(r, k, v, w, beta):
    """r, k, v, w: (B, S, H, dh); beta: (B, S, H) -> y (B, S, H, dh)."""
    B, S, H, dh = r.shape
    state = r.new_zeros(B, H, dh, dh)
    ys = []
    for t in range(S):
        kt = k[:, t]
        state = state * w[:, t, :, :, None]
        delta = v[:, t] - torch.einsum("bhkv,bhk->bhv", state, kt)
        state = state + beta[:, t, :, None, None] * (kt[..., :, None]
                                                     * delta[..., None, :])
        ys.append(torch.einsum("bhkv,bhk->bhv", state, r[:, t]))
    return torch.stack(ys, dim=1)


def embed(W: Dict[str, torch.Tensor], tokens, d_model: int):
    feats = []
    for i in range(tokens.shape[-1]):
        table = W[f"embeds.{i}"]
        feats.append(table[tokens[..., i].clamp(0, table.shape[0] - 1)])
    return torch.cat(feats, -1) * math.sqrt(d_model)


def time_mix(W, p: str, x, num_heads: int, P: Precision):
    B, S, d = x.shape
    dh = d // num_heads
    mu = W[p + "mu"]
    xp = shift(x)
    lerp = [x * mu[i] + xp * (1 - mu[i]) for i in range(5)]
    heads = (B, S, num_heads, dh)
    r = P.mm(lerp[0], W[p + "wr"]).reshape(heads)
    k = P.mm(lerp[1], W[p + "wk"]).reshape(heads)
    v = P.mm(lerp[2], W[p + "wv"]).reshape(heads)
    w = torch.sigmoid(P.mm(lerp[3], W[p + "ww"]) + W[p + "w_bias"]
                      ).reshape(heads)
    beta = torch.sigmoid(P.mm(lerp[4], W[p + "wbeta"]))
    k = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True),
                        min=1e-6)
    y = wkv_scan(r, k, v, w, beta).reshape(B, S, d)
    return P.mm(rmsnorm(y, W[p + "ln_x"]), W[p + "wo"])


def channel_mix(W, p: str, x, P: Precision):
    mu = W[p + "mu"]
    xk = x * mu + shift(x) * (1 - mu)
    return P.mm(torch.square(torch.relu(P.mm(xk, W[p + "wk"]))), W[p + "wv"])


def backbone(W, cfg: dict, tokens, P: Precision):
    """tokens (B, L, 6) -> hidden states (B, L, d_model)."""
    d = sum(cfg["dim_embeds"])
    x = embed(W, tokens, d)
    for layer in range(cfg["num_layers"]):
        p = f"blocks.{layer}."
        h = x + time_mix(W, p + "time_mix.", rmsnorm(x, W[p + "norm1.scale"]),
                         cfg["num_heads"], P)
        x = h + channel_mix(W, p + "channel_mix.",
                            rmsnorm(h, W[p + "norm2.scale"]), P)
    return rmsnorm(x, W["final_norm.scale"])


def encode(W, cfg: dict, tokens, P: Precision, pad_id: int = 0):
    """tokens (B, L, 6) -> L2-normalised BBEs (B, bbe_dim)."""
    h = backbone(W, cfg, tokens, P)
    valid = tokens[..., 0] != pad_id
    e = torch.tanh(P.mm(h, W["pool.Wa"]) + W["pool.ba"]) @ W["pool.ua"]
    alpha = torch.softmax(torch.where(valid, e, NEG), dim=-1)
    pooled = torch.einsum("bl,bld->bd", alpha, h)
    return l2_normalize(P.mm(pooled, W["out_proj"]))


def _head(W, name: str, h, P: Precision):
    return P.mm(gelu_tanh(P.mm(h, W[name + ".w1"])), W[name + ".w2"])


def _cross_entropy(logits, target):
    sel = torch.gather(logits, -1, target[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - sel


def pretrain_targets(tokens, nip_horizon: int, sep_id: int = 3,
                     pad_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """(NTP mask (B, L-1), NIP targets (B, L, Hm), NIP mask (B, L, Hm)):
    a next-token target counts where both tokens are real; at each SEP
    the next instruction's tokens count up to the following SEP or pad."""
    asm = tokens[..., 0].long()
    L = asm.shape[1]
    valid = asm != pad_id
    ntp = (valid[:, 1:] & valid[:, :-1]).float()
    idx = torch.clamp(torch.arange(L, device=asm.device)[:, None] + 1
                      + torch.arange(nip_horizon, device=asm.device)[None],
                      max=L - 1)
    tgt = asm[:, idx]
    beyond = torch.cumsum((tgt == sep_id).int(), dim=-1) > 0
    at_sep = (asm == sep_id) & valid
    nip = (at_sep[..., None] & ~beyond & (tgt != pad_id)).float()
    return ntp, tgt, nip


def pretrain_sums(W, cfg: dict, tokens, P: Precision):
    """(sum of NTP cross-entropies, sum of NIP cross-entropies) over the
    counted targets of `tokens`; the loss divides each by its count over
    the whole batch."""
    Hm = cfg["nip_horizon"]
    asm = tokens[..., 0].long()
    B, L = asm.shape
    h = backbone(W, cfg, tokens, P)
    ntp_mask, tgt, nip_mask = pretrain_targets(tokens, Hm)
    ntp = _cross_entropy(_head(W, "ntp_head", h[:, :-1], P), asm[:, 1:])
    nip_logits = _head(W, "nip_head", h, P).reshape(B, L, Hm, -1)
    nip = _cross_entropy(nip_logits, tgt)
    return torch.sum(ntp * ntp_mask), torch.sum(nip * nip_mask)

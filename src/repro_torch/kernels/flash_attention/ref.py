"""Plain PyTorch version of the flash-attention kernel: the CPU path and
the yardstick the CUDA kernel is held to on the card.

A copy of `repro.kernels.flash_attention.ref.attention_reference` whose
arithmetic follows the kernel (`csrc/flash_attention.cu`): q is cast to
fp32 and scaled by D^-0.5 before the product, the scores, the softmax
and P stay in fp32 (the JAX oracle casts P to v's dtype), and the result
is cast to q's dtype. Masked scores are NEG_INF = -2^30, not -inf."""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def attention_reference(q, k, v, causal: bool = True, window: int = 0,
                        prefix_len: int = 0):
    """q: (B,S,H,D); k,v: (B,T,K,D) with H % K == 0. GQA by kv head
    h // (H/K); causal mask kpos <= qpos, widened to kpos <= qpos or kpos
    < prefix_len (the prefix-LM rule of JAX's `_mask_bias("prefix")`; 0:
    none, read only when causal), and window qpos - kpos < window,
    positions from 0 for both q and k. Returns (B,S,H,D) in q.dtype."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    qr = (q.float() * D ** -0.5).reshape(B, S, K, g, D)
    s = torch.einsum("bskgd,btkd->bkgst", qr, k.float())
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = (kpos <= qpos) | (kpos < prefix_len)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)

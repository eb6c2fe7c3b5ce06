"""Plain PyTorch versions of the flash-attention kernels: the CPU path and
the yardstick the CUDA kernels are held to on the card.

`attention_reference` is a copy of `repro.kernels.flash_attention.ref.
attention_reference` whose arithmetic follows the forward kernel
(`csrc/flash_attention.cu`): q is cast to fp32 and scaled by D^-0.5
before the product, the scores, the softmax and P stay in fp32 (the JAX
oracle casts P to v's dtype), and the result is cast to q's dtype.
Masked scores are NEG_INF = -2^30, not -inf.

`attention_backward_reference` follows the backward kernel: the
gradients from the saved log-sum-exp, as JAX's `_chunked_attention`
custom VJP takes them from its saved row statistics."""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def _visible(S: int, T: int, causal: bool, window: int, prefix_len: int,
             device) -> torch.Tensor:
    """(S, T) bool: key j visible to query i, positions from 0 for both."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask = (kpos <= qpos) | (kpos < prefix_len)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    return mask


def _scores(q, k, causal, window, prefix_len):
    """(scaled q (B,S,K,g,D) fp32, masked scores (B,K,g,S,T) fp32, mask)."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    qr = (q.float() * D ** -0.5).reshape(B, S, K, H // K, D)
    s = torch.einsum("bskgd,btkd->bkgst", qr, k.float())
    mask = _visible(S, T, causal, window, prefix_len, q.device)
    return qr, torch.where(mask, s, NEG_INF), mask


def attention_reference(q, k, v, causal: bool = True, window: int = 0,
                        prefix_len: int = 0, return_lse: bool = False):
    """q: (B,S,H,D); k,v: (B,T,K,D) with H % K == 0. GQA by kv head
    h // (H/K); causal mask kpos <= qpos, widened to kpos <= qpos or kpos
    < prefix_len (the prefix-LM rule of JAX's `_mask_bias("prefix")`; 0:
    none, read only when causal), and window qpos - kpos < window,
    positions from 0 for both q and k. Returns (B,S,H,D) in q.dtype; with
    `return_lse` also the fp32 log-sum-exp (B,H,S) of each row's scaled,
    masked scores (the output is the same either way)."""
    B, S, H, D = q.shape
    _, s, _ = _scores(q, k, causal, window, prefix_len)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    out = out.reshape(B, S, H, D).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(s, dim=-1).reshape(B, H, S)


def attention_backward_reference(q, k, v, o, do, lse, causal: bool = True,
                                 window: int = 0, prefix_len: int = 0):
    """(dq, dk, dv) of `attention_reference(q, k, v, ...)` for the output
    cotangent `do`, from the output `o` and the log-sum-exp `lse` (B,H,S)
    the forward gave, in the backward kernel's arithmetic, all fp32:
    p = exp(scale q.k - lse) (0 where masked), delta = rowsum(do * o),
    dS = p (do.v - delta), dq = scale dS k, dk = scale dS^T q and dv =
    p^T do, dk and dv summed over the query heads of each kv head; cast
    to the inputs' dtypes at the end."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    qr, s, mask = _scores(q, k, causal, window, prefix_len)
    p = torch.where(mask, torch.exp(s - lse.float().reshape(B, K, g, S, 1)),
                    0.0)
    dof = do.float().reshape(B, S, K, g, D)
    delta = (dof * o.float().reshape(B, S, K, g, D)).sum(-1)
    dp = torch.einsum("bskgd,btkd->bkgst", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * D ** -0.5
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qr)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dof)
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))

"""GQA attention of the LM zoo: init + apply for prefill and decode.

Port of `repro.models.attention`. There is no `impl=` switch: full
sequences (`attn_apply`) go through the flash-attention wrapper, which
launches the CUDA kernel on CUDA tensors and runs its plain version on
CPU tensors; one-token decode steps (`attn_decode`) are plain PyTorch,
as in JAX (`_ref_attention`).

Mask modes: "causal", "full" and "prefix" (PaliGemma's prefix-LM:
bidirectional over the first `prefix_len` positions, causal after), each
with an optional sliding `window`; `kv_x` makes it cross-attention (the
encoder-decoder's). Weights keep the JAX layout ((d_in, d_out), applied as
x @ w) and names, so `repro_torch.bridge` maps a tree by name.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import init_array, param, rmsnorm, rope

NEG_INF = -2.0 ** 30


class Attention(nn.Module):
    """wq (d, H*hd), wk/wv (d, K*hd), wo (H*hd, d); bq/bk/bv when
    `qkv_bias`, q_norm/k_norm (hd,) when `qk_norm`; all in `dtype`."""

    def __init__(self, gen: torch.Generator, d_model: int, num_heads: int,
                 num_kv_heads: int, head_dim: int, dtype: torch.dtype,
                 qkv_bias: bool = False, qk_norm: bool = False):
        super().__init__()
        self.wq = param(init_array(gen, (d_model, num_heads * head_dim)), dtype)
        self.wk = param(init_array(gen, (d_model, num_kv_heads * head_dim)),
                        dtype)
        self.wv = param(init_array(gen, (d_model, num_kv_heads * head_dim)),
                        dtype)
        self.wo = param(init_array(gen, (num_heads * head_dim, d_model)), dtype)
        self.qkv_bias = qkv_bias
        self.qk_norm = qk_norm
        if qkv_bias:
            self.bq = param(torch.zeros(num_heads * head_dim), dtype)
            self.bk = param(torch.zeros(num_kv_heads * head_dim), dtype)
            self.bv = param(torch.zeros(num_kv_heads * head_dim), dtype)
        if qk_norm:
            self.q_norm = param(torch.ones(head_dim), dtype)
            self.k_norm = param(torch.ones(head_dim), dtype)


def _project_qkv(params: Attention, x, kv_x, num_heads, num_kv_heads,
                 head_dim, positions, kv_positions, qk_norm, rope_theta,
                 use_rope):
    """Projections q (B,S,H,hd) of x and k, v (B,T,K,hd) of kv_x (x itself
    for self-attention), as JAX's `_project_qkv` (`_rms` is `rmsnorm`)."""
    B, S = x.shape[:2]
    T = kv_x.shape[1]
    dt = x.dtype
    q = x @ params.wq.to(dt)
    k = kv_x @ params.wk.to(dt)
    v = kv_x @ params.wv.to(dt)
    if params.qkv_bias:
        q, k, v = (q + params.bq.to(q.dtype), k + params.bk.to(k.dtype),
                   v + params.bv.to(v.dtype))
    q = q.reshape(B, S, num_heads, head_dim)
    k = k.reshape(B, T, num_kv_heads, head_dim)
    v = v.reshape(B, T, num_kv_heads, head_dim)
    if qk_norm:
        q = rmsnorm(q, params.q_norm)
        k = rmsnorm(k, params.k_norm)
    if use_rope:
        q = rope(q, positions, rope_theta)
        k = rope(k, kv_positions, rope_theta)
    return q, k, v


def _ref_attention(q, k, v, bias, kv_valid=None):
    """q:(B,S,H,D) k,v:(B,T,K,D) bias:(S,T) -> (B,S,H,D) in v's dtype.
    fp32 softmax; P is cast to v's dtype before the PV product, as in
    JAX."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    qr = q.reshape(B, S, K, g, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qr, k).float()
    scores = scores * (D ** -0.5) + bias
    if kv_valid is not None:  # (B, T) padding mask
        scores = scores + torch.where(kv_valid, 0.0, NEG_INF)[
            :, None, None, None, :]
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v)
    return out.reshape(B, S, H, D)


def attn_apply(params: Attention, x, *, num_heads: int, num_kv_heads: int,
               head_dim: int, positions=None, kv_x=None,
               mask_mode: str = "causal", window: int = 0,
               prefix_len: int = 0, rope_theta: float = 10000.0,
               use_rope: bool = True, qk_norm: bool = False):
    """Self- or cross-attention (keys and values from `kv_x`, (B,T,d))
    over full sequences (prefill), through the flash-attention kernel.
    Its mask counts positions from 0 for q and k (positions only feed
    RoPE), as JAX's `_mask_bias` does on the positions the zoo passes;
    "prefix" is the causal rule with keys below `prefix_len` visible to
    every query. Cross-attention's kv positions are arange(T)."""
    if mask_mode not in ("causal", "full", "prefix"):
        raise ValueError(f"mask_mode {mask_mode!r}: causal, full or prefix")
    B, S = x.shape[:2]
    cross = kv_x is not None and kv_x is not x
    kv_x = x if kv_x is None else kv_x
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    kv_positions = (torch.arange(kv_x.shape[1], device=x.device)[None, :]
                    if cross else positions)
    q, k, v = _project_qkv(params, x, kv_x, num_heads, num_kv_heads,
                           head_dim, positions, kv_positions, qk_norm,
                           rope_theta, use_rope)
    out = flash_attention(q, k, v, causal=(mask_mode != "full"),
                          window=window,
                          prefix_len=prefix_len if mask_mode == "prefix"
                          else 0)
    out = out.reshape(B, S, num_heads * head_dim)
    return out @ params.wo.to(out.dtype)


# ----------------------------------------------------------------------------
# decode (single step against a KV cache)
# ----------------------------------------------------------------------------

def attn_decode(params: Attention, x, cache_k, cache_v, pos, *,
                num_heads: int, num_kv_heads: int, head_dim: int,
                rope_theta: float = 10000.0, use_rope: bool = True,
                qk_norm: bool = False, window: int = 0,
                write: Optional[torch.Tensor] = None):
    """x: (B, 1, d); cache_k/v: (B, T, K, D); pos: (B,) per-row positions
    (an int or 0-d tensor is shared by every row).

    Writes this step's k, v into row b of the caches at pos[b], in place,
    but for rows with pos[b] >= T (dropped, as JAX's scatter drops them),
    then attends over each row's cache entries 0..pos[b] (and the window).
    Rows whose `write` is False attend as the others do, over their new
    entry, and then get their old entry back: their cache is left bitwise
    as it was, and their output is the reference's (whose caller merges
    the old cache back), which matters where rows share a computation
    (an MoE layer's expert capacity). Returns (out (B,1,d), cache_k,
    cache_v)."""
    B = x.shape[0]
    T = cache_k.shape[1]
    pos = torch.as_tensor(pos, device=x.device)
    if pos.dim() == 0:
        pos = pos.expand(B)
    pos = pos.long()
    positions = pos[:, None]                        # (B, 1) for RoPE
    q, k, v = _project_qkv(params, x, x, num_heads, num_kv_heads, head_dim,
                           positions, positions, qk_norm, rope_theta,
                           use_rope)
    rows = torch.arange(B, device=x.device)
    at = pos.clamp(max=T - 1)
    inside = (pos < T)[:, None, None]
    old_k, old_v = cache_k[rows, at], cache_v[rows, at]
    cache_k[rows, at] = torch.where(inside, k[:, 0].to(cache_k.dtype), old_k)
    cache_v[rows, at] = torch.where(inside, v[:, 0].to(cache_v.dtype), old_v)
    kv_pos = torch.arange(T, device=x.device)
    valid = kv_pos[None, :] <= pos[:, None]         # (B, T)
    if window > 0:
        valid = valid & (pos[:, None] - kv_pos[None, :] < window)
    bias = torch.zeros((1, T), dtype=torch.float32, device=x.device)
    out = _ref_attention(q, cache_k.to(q.dtype), cache_v.to(q.dtype), bias,
                         kv_valid=valid)
    if write is not None:
        keep = write[:, None, None]
        cache_k[rows, at] = torch.where(keep, cache_k[rows, at], old_k)
        cache_v[rows, at] = torch.where(keep, cache_v[rows, at], old_v)
    out = out.reshape(B, 1, num_heads * head_dim)
    return out @ params.wo.to(out.dtype), cache_k, cache_v

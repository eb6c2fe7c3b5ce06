"""GQA attention of the LM zoo: init + apply for prefill and decode.

Port of `repro.models.attention`. There is no `impl=` switch: full
sequences (`attn_apply`) go through the flash-attention wrapper, which
launches the CUDA kernel on CUDA tensors and runs its plain version on
CPU tensors; one-token decode steps (`attn_decode`) are plain PyTorch,
as in JAX (`_ref_attention`).

Under a ModelShard (`module.tp`, `transformer.shard_lm`) a rank projects
only its query heads and the kv heads they read (`_project_shard`),
runs flash on those local heads and applies its rows of `wo`, then
reduce-out; where "model" does not split the heads by whole heads
(`sharding.compute_split`) every rank gathers the projections and
computes every head. A decode step's cache is split along its sequence
(the decode rules' "kv_seq" on "model"), along its kv heads, or not at
all (`decode_layout`); over a split sequence each rank scores its slice
of the cache with every head and the ranks combine maxima, sums and the
PV partials, as flash-decoding does (`_partial_attention`,
`combine_partials`).

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

from repro_torch.distributed.sharding import axes_of
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (
    fetch, init_array, param, rmsnorm, rope,
)

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
    return _heads_out(params, q, k, v, B, S, T, num_heads, num_kv_heads,
                      head_dim, positions, kv_positions, qk_norm,
                      rope_theta, use_rope)


def _heads_out(params, q, k, v, B, S, T, n_q, n_kv, head_dim, positions,
               kv_positions, qk_norm, rope_theta, use_rope,
               local: bool = False):
    """Projected q (B,S,n_q*hd) and k, v (B,T,n_kv*hd) -> heads, with the
    qk norm (its scales entering a rank's share by copy-in, `local`) and
    RoPE."""
    q = q.reshape(B, S, n_q, head_dim)
    k = k.reshape(B, T, n_kv, head_dim)
    v = v.reshape(B, T, n_kv, head_dim)
    if qk_norm:
        q = rmsnorm(q, fetch(params, "q_norm", local=local))
        k = rmsnorm(k, fetch(params, "k_norm", local=local))
    if use_rope:
        q = rope(q, positions, rope_theta)
        k = rope(k, kv_positions, rope_theta)
    return q, k, v


def kv_heads_for(tp, num_heads: int, num_kv_heads: int):
    """The kv heads this rank's query heads read, as a list `idx`: local
    query head j reads kv head idx[j // (Hl / len(idx))]. A contiguous
    range where the rank's Hl query heads cover whole GQA groups or lie
    in one; else one entry a query head."""
    H, K = num_heads, num_kv_heads
    if not tp.split.heads:
        return list(range(K))
    Hl, g = H // tp.M, H // K
    lo = tp.rank * Hl
    if Hl % g == 0 or g % Hl == 0:
        return list(range(lo // g, -(-(lo + Hl) // g)))
    return [(lo + j) // g for j in range(Hl)]


def _cols(w, idx, head_dim):
    """The columns of kv heads `idx` of a (..., K*hd) weight or bias."""
    if idx == list(range(idx[0], idx[0] + len(idx))):
        return w.narrow(-1, idx[0] * head_dim, len(idx) * head_dim)
    heads = w.reshape(*w.shape[:-1], -1, head_dim)
    sel = heads[..., torch.tensor(idx, device=w.device), :]
    return sel.reshape(*w.shape[:-1], len(idx) * head_dim)


def _project_shard(params, x, kv_x, num_heads, num_kv_heads, head_dim,
                   positions, kv_positions, qk_norm, rope_theta, use_rope,
                   kv_all: bool = False):
    """`_project_qkv` on a rank of a ModelShard: q of its query heads (all
    H where "model" does not split them), and k, v of the kv heads those
    read (`kv_heads_for`; its own block of kv heads where M divides K,
    else columns of the projection gathered over "model"), or of every
    kv head (`kv_all`, a decode step whose cache holds them). Returns (q,
    k, v, kv_idx); with split heads, x and kv_x entered by copy-in."""
    tp = params.tp
    sp = tp.split
    B, S = x.shape[:2]
    T = kv_x.shape[1]
    self_attn = kv_x is x
    if sp.heads:
        x = tp.copy_in(x)
        kv_x = x if self_attn else tp.copy_in(kv_x)
    dt = x.dtype
    Hl = num_heads // tp.M if sp.heads else num_heads
    q = x @ fetch(params, "wq", local=sp.heads).to(dt)
    if params.qkv_bias:
        q = q + fetch(params, "bq", local=sp.heads).to(q.dtype)
    if sp.kv_heads:             # this rank's block of kv heads
        n = num_kv_heads // tp.M
        idx = list(range(tp.rank * n, (tp.rank + 1) * n))
    elif kv_all:
        idx = list(range(num_kv_heads))
    else:
        idx = kv_heads_for(tp, num_heads, num_kv_heads)
    kv = {}
    for name in ("k", "v"):
        # the block, or the whole projection, of which a rank with split
        # query heads uses the columns they read (the gradient of a kv
        # head summed over the ranks that read it)
        w, b = (fetch(params, leaf, local=sp.heads, whole=not sp.kv_heads)
                if params.qkv_bias or leaf[0] == "w" else None
                for leaf in ("w" + name, "b" + name))
        if not (sp.kv_heads or kv_all):
            w = _cols(w, idx, head_dim)
            b = None if b is None else _cols(b, idx, head_dim)
        out = kv_x @ w.to(dt)
        kv[name] = out if b is None else out + b.to(out.dtype)
    n_kv = kv["k"].shape[-1] // head_dim
    q, k, v = _heads_out(params, q, kv["k"], kv["v"], B, S, T, Hl, n_kv,
                         head_dim, positions, kv_positions, qk_norm,
                         rope_theta, use_rope, local=sp.heads)
    if kv_all and sp.kv_heads:  # every kv head, gathered from the ranks
        k, v = tp.gather_model(k, 2), tp.gather_model(v, 2)
        idx = list(range(num_kv_heads))
    return q, k, v, idx


def _out_proj(params, out):
    """out (B,S,Hl*hd) through the rank's rows of wo, then reduce-out (all
    of wo, no reduction, where the heads are not split)."""
    tp = getattr(params, "tp", None)
    if tp is None:
        return out @ params.wo.to(out.dtype)
    split = tp.split.heads
    y = out @ fetch(params, "wo", local=split).to(out.dtype)
    return tp.reduce_out(y) if split else y


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
    project = (_project_qkv if getattr(params, "tp", None) is None
               else _project_shard)
    q, k, v = project(params, x, kv_x, num_heads, num_kv_heads, head_dim,
                      positions, kv_positions, qk_norm, rope_theta,
                      use_rope)[:3]
    out = flash_attention(q, k, v, causal=(mask_mode != "full"),
                          window=window,
                          prefix_len=prefix_len if mask_mode == "prefix"
                          else 0)
    out = out.reshape(B, S, q.shape[2] * head_dim)
    return _out_proj(params, out)


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
    if getattr(params, "tp", None) is not None:
        return _decode_shard(params, x, cache_k, cache_v, pos,
                             num_heads=num_heads, num_kv_heads=num_kv_heads,
                             head_dim=head_dim, rope_theta=rope_theta,
                             use_rope=use_rope, qk_norm=qk_norm,
                             window=window, write=write)
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


def decode_layout(tp) -> str:
    """How a ModelShard's rules split the self-attention decode cache over
    "model": "seq" (the decode rules' "kv_seq", each rank a slice of the
    positions), "heads" (its block of kv heads, where "model" splits
    them) or "whole" (every rank every kv head and position)."""
    if tp.M == 1:
        return "whole"
    # over ("data", "model") (long_500k's rules) the cache's sequence is
    # stored split over "model" alone: its batch dim, first in the spec,
    # has taken "data" (`logical_to_pspec` uses a mesh axis once)
    if "model" in axes_of(tp.rules.get("kv_seq")):
        return "seq"
    return "heads" if tp.split.kv_heads else "whole"


def _partial_attention(q, k, v, valid):
    """One rank's share of attention over its slice of the keys: q
    (B,1,H,D); k, v (B,Tl,H',D) (H' dividing H); valid (B,Tl). Returns
    the fp32 partials (m (B,H), l (B,H), o (B,H,D)): the slice's maximum
    score, the sum of exp(score - m) and the exp-weighted sum of v, each
    row's masked keys at the reference's NEG_INF bias."""
    B, _, H, D = q.shape
    K = k.shape[2]
    qr = q.reshape(B, K, H // K, D)
    s = torch.einsum("bkgd,btkd->bkgt", qr, k).float() * (D ** -0.5)
    s = s + torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return m.reshape(B, H), p.sum(-1).reshape(B, H), o.reshape(B, H, D)


def combine_partials(m, l, o, max_fn=None, sum_fn=None):
    """The ranks' partials (`_partial_attention`) combined into (B,H,D):
    the global maximum, then the sums of l and o rescaled to it.
    `max_fn` / `sum_fn` reduce over the ranks (the identity for one)."""
    mx = m if max_fn is None else max_fn(m)
    scale = torch.exp(m - mx)
    l, o = l * scale, o * scale[..., None]
    if sum_fn is not None:
        l, o = sum_fn(l), sum_fn(o)
    return o / l[..., None]


def _decode_shard(params, x, cache_k, cache_v, pos, *, num_heads,
                  num_kv_heads, head_dim, rope_theta, use_rope, qk_norm,
                  window, write):
    """`attn_decode` on a rank of a ModelShard, on this rank's cache
    (`decode_layout`). "seq": the step's k, v of every kv head are
    written only on the rank whose slice holds pos, the step's q is
    gathered over "model" (B x 1 x H x D), each rank scores its slice
    with every head and the partials are combined by all-reduces of the
    maximum and the sums; the rank keeps its own heads for wo. "heads":
    its query heads over its kv heads. "whole": its query heads over the
    kv heads they read. Rows with pos >= T or `write` False as in
    `attn_decode`."""
    tp = params.tp
    layout = decode_layout(tp)
    B = x.shape[0]
    Tl = cache_k.shape[1]
    pos = torch.as_tensor(pos, device=x.device)
    if pos.dim() == 0:
        pos = pos.expand(B)
    pos = pos.long()
    positions = pos[:, None]
    q, k, v, idx = _project_shard(params, x, x, num_heads, num_kv_heads,
                                  head_dim, positions, positions, qk_norm,
                                  rope_theta, use_rope,
                                  kv_all=(layout != "heads"))
    seq = layout == "seq"
    T = Tl * tp.M if seq else Tl
    t0 = tp.rank * Tl if seq else 0
    rows = torch.arange(B, device=x.device)
    at = pos.clamp(max=T - 1)
    mine = pos < T
    if seq:
        mine = mine & (at >= t0) & (at < t0 + Tl)
    at = (at - t0).clamp(0, Tl - 1)
    inside = mine[:, None, None]
    old_k, old_v = cache_k[rows, at], cache_v[rows, at]
    cache_k[rows, at] = torch.where(inside, k[:, 0].to(cache_k.dtype), old_k)
    cache_v[rows, at] = torch.where(inside, v[:, 0].to(cache_v.dtype), old_v)
    kv_pos = t0 + torch.arange(Tl, device=x.device)
    valid = kv_pos[None, :] <= pos[:, None]
    if window > 0:
        valid = valid & (pos[:, None] - kv_pos[None, :] < window)
    ck, cv = cache_k.to(q.dtype), cache_v.to(q.dtype)
    if seq:
        q_all = tp.gather_model(q, 2) if tp.split.heads else q
        m, l, o = _partial_attention(q_all, ck, cv, valid)
        out = combine_partials(
            m, l, o, max_fn=tp.max_model,
            sum_fn=lambda t: tp.comm.all_reduce(t, ("model",)))
        out = out.to(q.dtype)[:, None]
        if tp.split.heads:
            Hl = q.shape[2]
            out = out[:, :, tp.rank * Hl:(tp.rank + 1) * Hl]
    else:
        if layout == "whole":
            sel = torch.tensor(idx, device=x.device)
            ck, cv = ck[:, :, sel], cv[:, :, sel]
        bias = torch.zeros((1, Tl), dtype=torch.float32, device=x.device)
        out = _ref_attention(q, ck, cv, bias, kv_valid=valid)
    if write is not None:
        keep = write[:, None, None]
        cache_k[rows, at] = torch.where(keep, cache_k[rows, at], old_k)
        cache_v[rows, at] = torch.where(keep, cache_v[rows, at], old_v)
    out = out.reshape(B, 1, q.shape[2] * head_dim)
    return _out_proj(params, out), cache_k, cache_v


def attn_specs(qkv_bias: bool = False, qk_norm: bool = False) -> dict:
    """Logical-axis specs of an `Attention`'s parameters (`attn_init`'s)."""
    specs = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
             "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if qkv_bias:
        specs.update(bq=("heads",), bk=("kv_heads",), bv=("kv_heads",))
    if qk_norm:
        specs.update(q_norm=(None,), k_norm=(None,))
    return specs

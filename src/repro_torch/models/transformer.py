"""LM assembly for the zoo's dense decoders: port of the dense part of
`repro.models.transformer`.

A model is a stack of pre-norm blocks (norm1 -> attention -> residual,
norm2 -> MLP -> residual) between a token embedding scaled by
sqrt(d_model) and a final RMSNorm, with a tied or separate LM head.
JAX stacks the parameters of each position of the repeating *period* and
scans over periods; the port keeps one module per layer (`LM.layers`)
and loops over them in Python. The decode cache keeps JAX's stacked
layout, {"p<pos>": {"k", "v"}} with a leading period axis, so caches
compare leaf for leaf.

Mamba, mLSTM, sLSTM and RWKV blocks in the zoo, MoE layers, the encoder
and cross-attention (encoder-decoder) and prefix inputs (the prefix-LM
VLM) raise `NotImplementedError`: they wait for later slices.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import BLOCK_ATTN, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import MLP, Embed, RMSNorm, embed, unembed

def torch_dtype(name: str) -> torch.dtype:
    """"bfloat16" / "float32" (a config's dtype field) -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------------------
# period structure
# ---------------------------------------------------------------------------


def layer_signature(cfg: ModelConfig, i: int) -> Tuple[str, bool]:
    return (cfg.blocks()[i], cfg.is_moe_layer(i))


def period_of(cfg: ModelConfig) -> int:
    sigs = [layer_signature(cfg, i) for i in range(cfg.num_layers)]
    for p in range(1, cfg.num_layers + 1):
        if cfg.num_layers % p == 0 and all(
                sigs[i] == sigs[i % p] for i in range(cfg.num_layers)):
            return p
    return cfg.num_layers


def check_supported(cfg: ModelConfig) -> None:
    """Raises NotImplementedError for what the dense slice does not port."""
    for kind in set(cfg.blocks()):
        if kind != BLOCK_ATTN:
            raise NotImplementedError(f"{cfg.name}: {kind} blocks wait for "
                                      f"the SSM slice")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE layers wait for the MoE "
                                  f"slice")
    if cfg.encoder_layers or cfg.cross_attention:
        raise NotImplementedError(f"{cfg.name}: the encoder and cross-"
                                  f"attention wait for the encoder-decoder "
                                  f"slice")
    if cfg.prefix_lm or cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: prefix inputs wait for the "
                                  f"VLM slice")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """norm1, attention (`mixer`), norm2, MLP; names as the JAX block tree
    (`_block_init`)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig,
                 dtype: torch.dtype):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, dtype, cfg.norm_eps)
        self.mixer = attn.Attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, dtype, qkv_bias=cfg.qkv_bias,
            qk_norm=cfg.qk_norm)
        self.norm2 = RMSNorm(cfg.d_model, dtype, cfg.norm_eps)
        self.mlp = MLP(gen, cfg.d_model, cfg.d_ff, dtype, gated=cfg.mlp_gated)


def _attn_kwargs(cfg: ModelConfig) -> dict:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                use_rope=(cfg.pos_embedding == "rope"), qk_norm=cfg.qk_norm)


def _block_apply(params: Block, cfg: ModelConfig, x, *, mask_mode: str,
                 positions=None):
    h = params.norm1(x)
    x = x + attn.attn_apply(params.mixer, h, positions=positions,
                            mask_mode=mask_mode, window=cfg.attn_window,
                            **_attn_kwargs(cfg))
    return x + params.mlp(params.norm2(x))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


class LM(nn.Module):
    """The dense decoder's parameters (JAX's `lm_init`), drawn on the CPU
    from `torch.Generator(seed)`, named as the JAX tree with the stacked
    `layers/p0/...` split into `layers.<i>....`."""

    def __init__(self, cfg: ModelConfig, seed: int = 0):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = torch_dtype(cfg.param_dtype)
        gen = torch.Generator().manual_seed(seed)
        self.embed = Embed(gen, cfg.vocab_size, cfg.d_model, dtype)
        self.layers = nn.ModuleList(Block(gen, cfg, dtype)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, dtype, cfg.norm_eps)
        self.lm_head = (None if cfg.tie_embeddings else
                        Embed(gen, cfg.vocab_size, cfg.d_model, dtype))

    @property
    def head_table(self):
        return (self.embed if self.lm_head is None else self.lm_head).table


def _embed_tokens(params: LM, cfg: ModelConfig, tokens):
    dtype = torch_dtype(cfg.dtype)
    x = embed(params.embed.table, tokens).to(dtype)
    # the scalar is rounded to the model dtype first, as jnp.asarray does
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)


def lm_apply(params: LM, cfg: ModelConfig, tokens, *,
             return_hidden: bool = False):
    """tokens: (B, S) int. Returns (hidden (B,S,d), aux) when
    `return_hidden`, else (logits (B,S,V) in the model dtype, aux); aux
    is the fp32 0 of a model without MoE layers."""
    x = _embed_tokens(params, cfg, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    for block in params.layers:
        x = _block_apply(block, cfg, x, mask_mode="causal",
                         positions=positions)
    x = params.final_norm(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return unembed(params.head_table, x), aux


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Zeroed KV cache {"p<pos>": {"k", "v"}}, each (n_periods, batch,
    max_seq, K, hd), as JAX's `init_cache` lays it out."""
    check_supported(cfg)
    period = period_of(cfg)
    n_periods = cfg.num_layers // period
    shape = (n_periods, batch, max_seq, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {f"p{pos}": {"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}
            for pos in range(period)}


def _block_decode(params: Block, cfg: ModelConfig, x, cache_k, cache_v, pos,
                  write=None):
    h = params.norm1(x)
    mix, _, _ = attn.attn_decode(params.mixer, h, cache_k, cache_v, pos,
                                 window=cfg.attn_window, write=write,
                                 **_attn_kwargs(cfg))
    x = x + mix
    return x + params.mlp(params.norm2(x))


def lm_decode_step(params: LM, cfg: ModelConfig, cache, tokens, pos,
                   write: Optional[torch.Tensor] = None):
    """One decode step. tokens: (B,1) int; pos: an int shared by the batch
    or (B,) per-row positions (continuous batching with mid-run slot
    refills). Updates `cache` in place (row b at pos[b]; rows whose
    `write` is False keep their cache) and returns (logits (B,1,V) fp32,
    cache)."""
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device)
    if pos.dim() == 0:
        pos = pos.expand(B)
    x = _embed_tokens(params, cfg, tokens)
    period = period_of(cfg)
    for i, block in enumerate(params.layers):
        c = cache[f"p{i % period}"]
        n = i // period
        x = _block_decode(block, cfg, x, c["k"][n], c["v"][n], pos, write)
    x = params.final_norm(x)
    return unembed(params.head_table, x).float(), cache

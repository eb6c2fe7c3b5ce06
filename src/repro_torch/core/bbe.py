"""Stage 1: Basic Block Embedding (paper §III-A).

Multi-dimensional concatenated embeddings -> RWKV backbone (a loop over
the blocks of an `nn.ModuleList`) -> self-attention pooling ->
L2-normalized BBE. Port of `repro.core.bbe`; the pre-training heads exist
so that a JAX parameter tree bridges whole, but the pre-training and
fine-tuning losses are for a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core.losses import l2_normalize
from repro_torch.core.tokenizer import MultiDimTokenizer, default_tokenizer
from repro_torch.models.layers import (
    RMSNorm, init_array, param, require_float32,
)
from repro_torch.models.rwkv import RWKVBlock


@dataclasses.dataclass(frozen=True)
class BBEConfig:
    # per-dimension embedding widths; sum = d_model
    dim_embeds: Tuple[int, ...] = (224, 32, 32, 32, 32, 32)
    num_layers: int = 12
    num_heads: int = 6
    bbe_dim: int = 256          # final embedding size
    nip_horizon: int = 8
    max_len: int = 128
    dtype: str = "float32"      # only "float32" is ported (else raises)

    @property
    def d_model(self) -> int:
        return int(sum(self.dim_embeds))


class AttentionPool(nn.Module):
    """Self-attention pooling (paper eq. 1-2)."""

    def __init__(self, gen: torch.Generator, d: int):
        super().__init__()
        self.Wa = param(init_array(gen, (d, d)))
        self.ba = param(torch.zeros(d))
        self.ua = param(init_array(gen, (d,), 0.1))

    def forward(self, h, valid):
        """h: (B,L,d); valid: (B,L) -> (B,d)."""
        e = torch.tanh(h @ self.Wa + self.ba) @ self.ua            # (B, L)
        e = torch.where(valid, e.float(), -2.0 ** 30)
        alpha = torch.softmax(e, dim=-1)
        return torch.einsum("bl,bld->bd", alpha.to(h.dtype), h)


class MLPHead(nn.Module):
    """Pre-training head (NTP / NIP); its loss is for a later slice."""

    def __init__(self, gen: torch.Generator, d: int, d_out: int):
        super().__init__()
        self.w1 = param(init_array(gen, (d, d)))
        self.w2 = param(init_array(gen, (d, d_out)))


class BBEEncoder(nn.Module):
    """Stage-1 encoder; parameter names follow `repro.core.bbe.bbe_init`."""

    def __init__(self, cfg: BBEConfig, seed: int = 0,
                 tok: Optional[MultiDimTokenizer] = None):
        super().__init__()
        require_float32("BBEConfig.dtype", cfg.dtype)
        tok = tok or default_tokenizer()
        sizes = tok.spec.dim_sizes
        if len(sizes) != len(cfg.dim_embeds):
            raise ValueError(f"{len(cfg.dim_embeds)} embedding widths for "
                             f"{len(sizes)} token dimensions")
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        d = cfg.d_model
        self.embeds = nn.ParameterList(
            [param(init_array(gen, (v, w), 0.02))
             for v, w in zip(sizes, cfg.dim_embeds)])
        self.blocks = nn.ModuleList(
            [RWKVBlock(gen, d, cfg.num_heads) for _ in range(cfg.num_layers)])
        self.final_norm = RMSNorm(d)
        self.pool = AttentionPool(gen, d)
        self.out_proj = param(init_array(gen, (d, cfg.bbe_dim)))
        self.ntp_head = MLPHead(gen, d, sizes[0])
        self.nip_head = MLPHead(gen, d, cfg.nip_horizon * sizes[0])

    def backbone(self, tokens):
        """tokens: (B, L, 6) integer -> hidden states (B, L, d_model).
        Token ids are clamped into each table, as `jnp.take(mode="clip")`."""
        feats = [tbl[tokens[..., i].clamp(0, tbl.shape[0] - 1)]
                 for i, tbl in enumerate(self.embeds)]
        x = torch.cat(feats, dim=-1) * (self.cfg.d_model ** 0.5)
        for block in self.blocks:
            x = block(x)
        return self.final_norm(x)

    def forward(self, tokens, pad_id: int = 0):
        """tokens: (B, L, 6) -> L2-normalized BBE (B, bbe_dim)."""
        valid = tokens[..., 0] != pad_id
        pooled = self.pool(self.backbone(tokens), valid)
        return l2_normalize(pooled @ self.out_proj)


def encode_bbe(encoder: BBEEncoder, tokens, pad_id: int = 0):
    """tokens: (B, L, 6) -> L2-normalized BBE (B, bbe_dim)."""
    return encoder(tokens, pad_id)

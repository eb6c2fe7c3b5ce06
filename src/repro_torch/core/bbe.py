"""Stage 1: Basic Block Embedding (paper §III-A).

Multi-dimensional concatenated embeddings -> RWKV backbone (a loop over
the blocks of an `nn.ModuleList`) -> self-attention pooling ->
L2-normalized BBE. Port of `repro.core.bbe`.

Pre-training heads (discarded before fine-tuning, §III-A-3):
  - NTP: next-token prediction over the asm dimension.
  - NIP: at each instruction boundary (SEP token), predict the token
    sequence of the ENTIRE next instruction (up to `nip_horizon` tokens).

Fine-tuning: triplet loss over (anchor, positive, negative) blocks
compiled at different optimization levels (§III-A-4/5).

Both losses take `(encoder, batch)`, as the port's `Trainer` calls a
loss; their gradients are held to `jax.grad` of the JAX package's.
Checkpoints keep the JAX layout, in which `blocks` is stacked along a
leading `num_layers` axis (`bbe_init` builds it with `jax.vmap`): the
encoder's `pack_checkpoint` / `unpack_checkpoint` convert its per-layer
names, and the `Trainer` calls them.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.losses import l2_normalize, triplet_loss
from repro_torch.core.tokenizer import MultiDimTokenizer, default_tokenizer
from repro_torch.distributed.collectives import share, total
from repro_torch.models.layers import (
    RMSNorm, gelu, init_array, param, rmsnorm_specs, torch_dtype,
)
from repro_torch.models.rwkv import RWKVBlock, rwkv_block_specs
from repro_torch.utils.tree import prefixed, stack_leaves, unstack_leaves


@dataclasses.dataclass(frozen=True)
class BBEConfig:
    # per-dimension embedding widths; sum = d_model
    dim_embeds: Tuple[int, ...] = (224, 32, 32, 32, 32, 32)
    num_layers: int = 12
    num_heads: int = 6
    bbe_dim: int = 256          # final embedding size
    nip_horizon: int = 8
    max_len: int = 128
    dtype: str = "float32"      # or "bfloat16": parameters and activations

    @property
    def d_model(self) -> int:
        return int(sum(self.dim_embeds))


class AttentionPool(nn.Module):
    """Self-attention pooling (paper eq. 1-2): weights cast to h's dtype,
    the softmax in fp32, alpha cast back to h's dtype, as
    `repro.core.bbe.attention_pool`."""

    def __init__(self, gen: torch.Generator, d: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Wa = param(init_array(gen, (d, d)), dtype)
        self.ba = param(torch.zeros(d), dtype)
        self.ua = param(init_array(gen, (d,), 0.1), dtype)

    def forward(self, h, valid):
        """h: (B,L,d); valid: (B,L) -> (B,d)."""
        dt = h.dtype
        e = torch.tanh(h @ self.Wa.to(dt) + self.ba.to(dt)) @ self.ua.to(dt)
        e = torch.where(valid, e.float(), -2.0 ** 30)              # (B, L)
        alpha = torch.softmax(e, dim=-1)
        return torch.einsum("bl,bld->bd", alpha.to(h.dtype), h)


class MLPHead(nn.Module):
    """Pre-training head (NTP / NIP)."""

    def __init__(self, gen: torch.Generator, d: int, d_out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w1 = param(init_array(gen, (d, d)), dtype)
        self.w2 = param(init_array(gen, (d, d_out)), dtype)

    def forward(self, h):
        # jax.nn.gelu defaults to the tanh approximation; torch's does not
        dt = h.dtype
        return gelu(h @ self.w1.to(dt)) @ self.w2.to(dt)


# checkpoint key of a per-layer leaf: "<prefix>blocks/<layer>/<leaf>"
_LAYER_KEY = re.compile(r"^(.*?\bblocks)/(\d+)/(.+)$")


def _layer_of(key: str):
    m = _LAYER_KEY.match(key)
    return None if m is None else (f"{m.group(1)}/{m.group(3)}",
                                   int(m.group(2)))


def stack_layers(flat: Dict[str, torch.Tensor], num_layers: int
                 ) -> Dict[str, torch.Tensor]:
    """"/"-keyed leaves with per-layer keys `...blocks/<n>/<leaf>` ->
    `...blocks/<leaf>` stacked over n along a new leading axis (the
    layout of `bbe_init`); other keys pass unchanged, in order."""
    stacked = stack_leaves(flat, _layer_of)
    bad = [k for k, v in stacked.items()
           if k not in flat and v.shape[0] != num_layers]
    if bad:
        raise ValueError(f"{bad[:3]}: not {num_layers} layers")
    return stacked


def unstack_layers(flat: Dict[str, torch.Tensor], like: Dict[str, object]
                   ) -> Dict[str, torch.Tensor]:
    """The inverse of `stack_layers`: the keys of `like` (per-layer),
    each read from `flat` (stacked) at its layer's index."""
    return unstack_leaves(flat, like, _layer_of)


class BBEEncoder(nn.Module):
    """Stage-1 encoder; parameter names and dtypes follow
    `repro.core.bbe.bbe_init`: every leaf in `cfg.dtype` but the fp32
    `w_bias` of each time-mix."""

    def __init__(self, cfg: BBEConfig, seed: int = 0,
                 tok: Optional[MultiDimTokenizer] = None):
        super().__init__()
        dtype = torch_dtype(cfg.dtype)
        tok = tok or default_tokenizer()
        sizes = tok.spec.dim_sizes
        if len(sizes) != len(cfg.dim_embeds):
            raise ValueError(f"{len(cfg.dim_embeds)} embedding widths for "
                             f"{len(sizes)} token dimensions")
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        d = cfg.d_model
        self.embeds = nn.ParameterList(
            [param(init_array(gen, (v, w), 0.02), dtype)
             for v, w in zip(sizes, cfg.dim_embeds)])
        self.blocks = nn.ModuleList(
            [RWKVBlock(gen, d, cfg.num_heads, dtype)
             for _ in range(cfg.num_layers)])
        self.final_norm = RMSNorm(d, dtype)
        self.pool = AttentionPool(gen, d, dtype)
        self.out_proj = param(init_array(gen, (d, cfg.bbe_dim)), dtype)
        self.ntp_head = MLPHead(gen, d, sizes[0], dtype)
        self.nip_head = MLPHead(gen, d, cfg.nip_horizon * sizes[0], dtype)

    def embed(self, tokens):
        """tokens: (B, L, 6) integer -> the scaled, concatenated embeddings
        (B, L, d_model) in `cfg.dtype`. Token ids are clamped into each
        table, as `jnp.take(mode="clip")`."""
        feats = [tbl[tokens[..., i].clamp(0, tbl.shape[0] - 1)]
                 for i, tbl in enumerate(self.embeds)]
        x = torch.cat(feats, dim=-1)
        # JAX rounds the weakly typed scale to x's dtype before the product
        return x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)

    def backbone(self, tokens):
        """tokens: (B, L, 6) integer -> hidden states (B, L, d_model) in
        `cfg.dtype`."""
        x = self.embed(tokens)
        for block in self.blocks:
            x = block(x)
        return self.final_norm(x)

    def forward(self, tokens, pad_id: int = 0):
        """tokens: (B, L, 6) -> L2-normalized BBE (B, bbe_dim) in
        `cfg.dtype`."""
        valid = tokens[..., 0] != pad_id
        pooled = self.pool(self.backbone(tokens), valid)
        return l2_normalize(pooled @ self.out_proj.to(pooled.dtype))

    def param_specs(self) -> dict:
        return bbe_specs(self.cfg, len(self.embeds))

    # checkpoints in the JAX layout (the Trainer's hooks)
    def pack_checkpoint(self, flat: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        return stack_layers(flat, self.cfg.num_layers)

    def unpack_checkpoint(self, flat: Dict[str, torch.Tensor],
                          like: Dict[str, object]) -> Dict[str, torch.Tensor]:
        return unstack_layers(flat, like)


def bbe_specs(cfg: BBEConfig, n_dims: int = 0) -> dict:
    """Logical-axis specs of every parameter of `BBEEncoder(cfg)` by
    "/"-joined name (`bbe_init`'s; per layer without the stacked
    "layers" axis). n_dims: token dimensions (default len(dim_embeds))."""
    specs = {f"embeds/{i}": ("vocab", "embed")
             for i in range(n_dims or len(cfg.dim_embeds))}
    for i in range(cfg.num_layers):
        specs.update(prefixed(f"blocks/{i}", rwkv_block_specs()))
    specs.update(prefixed("final_norm", rmsnorm_specs()))
    specs.update({"pool/Wa": ("embed", "heads"), "pool/ba": ("heads",),
                  "pool/ua": ("heads",), "out_proj": ("embed", None)})
    for head in ("ntp_head", "nip_head"):
        specs.update({f"{head}/w1": ("embed", "ff"),
                      f"{head}/w2": ("ff", "vocab")})
    return specs


def encode_bbe(encoder: BBEEncoder, tokens, pad_id: int = 0):
    """tokens: (B, L, 6) -> L2-normalized BBE (B, bbe_dim)."""
    return encoder(tokens, pad_id)


# ---------------------------------------------------------------------------
# pre-training and fine-tuning losses
# ---------------------------------------------------------------------------

def _cross_entropy(logits, target):
    """-log softmax(logits)[target], in fp32."""
    logits = logits.float()
    sel = torch.gather(logits, -1, target[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - sel


def pretrain_loss(encoder: BBEEncoder, batch, sep_id: int = 3,
                  pad_id: int = 0):
    """Joint NTP + NIP loss on batch["tokens"] (B, L, 6).
    Returns (loss, {"ntp", "nip"}). Each term is a sum over valid targets
    over their count; inside a data-parallel step the count is the
    global batch's."""
    tokens = batch["tokens"]
    B, L, _ = tokens.shape
    h = encoder.backbone(tokens)
    asm = tokens[..., 0]
    valid = asm != pad_id

    # --- NTP: predict asm id of token t+1 from state at t
    ce = _cross_entropy(encoder.ntp_head(h[:, :-1]), asm[:, 1:])
    v = (valid[:, 1:] & valid[:, :-1]).float()
    ntp = torch.sum(ce * v) / torch.clamp(total(v.sum()), min=1.0)

    # --- NIP: at SEP tokens predict the next instruction's token sequence
    Hm = encoder.cfg.nip_horizon
    nip_logits = encoder.nip_head(h)                         # (B,L,Hm*V)
    nip_logits = nip_logits.reshape(B, L, Hm, nip_logits.shape[-1] // Hm)
    idx = torch.clamp(torch.arange(L, device=tokens.device)[:, None] + 1
                      + torch.arange(Hm, device=tokens.device)[None, :],
                      max=L - 1)                             # (L,Hm)
    tgt = asm[:, idx]                                        # (B,L,Hm)
    # a target is valid until the *next* SEP (instruction boundary) or pad
    beyond = torch.cumsum((tgt == sep_id).int(), dim=-1) > 0
    at_sep = (asm == sep_id) & valid
    vmask = (at_sep[..., None] & ~beyond & (tgt != pad_id)).float()
    ce = _cross_entropy(nip_logits, tgt)
    nip = torch.sum(ce * vmask) / torch.clamp(total(vmask.sum()), min=1.0)
    return ntp + nip, {"ntp": ntp, "nip": nip}


def finetune_triplet_loss(encoder: BBEEncoder, batch, margin: float = 0.5):
    """batch: anchor/positive/negative -> (B, L, 6). Returns (loss,
    {"d_ap", "d_an"})."""
    a, p, n = (encoder(batch[role])
               for role in ("anchor", "positive", "negative"))
    loss = triplet_loss(a, p, n, margin)
    d_ap = share(torch.mean(torch.sum(torch.square(a - p), -1)))
    d_an = share(torch.mean(torch.sum(torch.square(a - n), -1)))
    return loss, {"d_ap": d_ap, "d_an": d_an}

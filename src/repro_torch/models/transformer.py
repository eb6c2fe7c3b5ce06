"""LM assembly for the zoo: port of `repro.models.transformer`.

A model is a stack of pre-norm blocks between a token embedding scaled by
sqrt(d_model) and a final RMSNorm, with a tied or separate LM head. A
block is norm1 -> mixer -> residual, then (but for mLSTM and sLSTM,
which carry their own projections) norm2 -> MLP or MoE -> residual, or
for RWKV norm2 -> channel-mix -> residual. The mixer is attention, Mamba,
mLSTM, sLSTM or the RWKV time-mix, as the config's block pattern says;
the MoE layers are those of `cfg.is_moe_layer`, and their load-balance
losses are summed over layers into the forward's aux. JAX
stacks the parameters of each position of the repeating *period* and
scans over periods; the port keeps one module per layer (`LM.layers`)
and loops over them in Python. The decode cache keeps JAX's stacked
layout, {"p<pos>": {leaf: (n_periods, batch, ...)}}: k/v for attention
(in the cache dtype), the fp32 recurrent state of the other kinds
(`rwkv_init_state`, `ssm.*_init_state`), so caches compare leaf for
leaf.

Encoder-decoder (whisper): `LM.encoder` holds `encoder_layers` attention
blocks over precomputed frame embeddings (`encoder_apply`, full mask);
each decoder block adds cross_norm + cross-attention over the encoder's
output between its mixer and its MLP, and the decode cache adds ck/cv
(n_periods, batch, enc_len, K, hd), read by the decode step's cross
term. As in JAX nothing fills ck/cv: a decode step attends over the
cache as it stands (zeros unless the caller wrote it). Prefix-LM
(paligemma): `lm_apply(prefix_embeds=)` puts the patch embeddings ahead
of the scaled text embedding, and a prefix-LM config runs every layer
under the "prefix" mask (bidirectional over the patches).

Training: `lm_loss` (the mean next-token NLL over the text, by
`chunked_xent`, plus 0.01 x the MoE aux) under a `remat` policy that
wraps each period of layers in `torch.utils.checkpoint`, as JAX wraps
its scan body. `LM.pack_checkpoint` / `unpack_checkpoint` let the
Trainer write and read checkpoints in JAX's stacked layout; the
stacking rule (`stacked_key`) is the one `bridge.lm_params_from_jax`
unstacks by.

Tensor-parallel compute (`shard_lm`, every arch: dense, MoE,
encoder-decoder, prefix-LM, recurrent and hybrid): a sharded LM holds
one rank's blocks of its parameters, placed by the rules as JAX's
in_shardings place them, and every module carries the rank's
`collectives.ModelShard` as `tp`. The forward then computes only the
rank's share, as GSPMD partitions JAX's: its query heads (and the kv
heads they read), ff columns, experts or expert columns and vocab rows
on "model" (`sharding.compute_split`), and in the recurrent mixers its
heads and inner channels (`rwkv`, `ssm`); weights split over the data
axes gathered just before use; the activations between blocks are
whole on every rank of "model". The loss is vocab-parallel
(`vocab_partials`, `combine_vocab`): no rank holds the (B, chunk, V)
logits. A decode cache is a rank's (`init_cache(tp=)`: its heads of the
RWKV and mLSTM states, its channels of Mamba's and of the mLSTM's conv
context; the states the specs keep whole, the token shifts and the
sLSTM's, whole and the same on every rank).
"""
from __future__ import annotations

import functools
import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.config import (
    BLOCK_ATTN, BLOCK_MAMBA, BLOCK_MLSTM, BLOCK_RWKV, BLOCK_SLSTM,
    ModelConfig,
)
from repro_torch.distributed import sharding
from repro_torch.distributed.collectives import (  # noqa: F401
    MeshComm, ModelShard, rank_shares, shard_module, share, total,
)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (
    MLP, Embed, RMSNorm, embed_specs, fetch, mlp_specs, rmsnorm_specs,
    torch_dtype, vocab_embed, vocab_logits,
)
from repro_torch.utils.tree import prefixed, stack_leaves, unstack_leaves

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


# a per-layer leaf's key: "<prefix>layers/<i>/<leaf>" (the decoder's) or
# "<prefix>encoder/layers/<i>/<leaf>"
_LAYER_KEY = re.compile(r"^(.*?)\blayers/(\d+)/(.+)$")


def stacked_key(cfg: ModelConfig, key: str) -> Optional[Tuple[str, int]]:
    """Where a per-layer leaf lies in JAX's stacked tree: (its key there,
    its index on the leading axis), or None for a leaf that is not per
    layer. "/"-joined keys: decoder layer i = n * period + pos is
    `layers/p<pos>/<leaf>` at index n; encoder layer i is
    `encoder/layers/<leaf>` at index i."""
    m = _LAYER_KEY.match(key)
    if m is None:
        return None
    prefix, i, leaf = m.group(1), int(m.group(2)), m.group(3)
    if prefix.endswith("encoder/"):
        return f"{prefix}layers/{leaf}", i
    period = period_of(cfg)
    return f"{prefix}layers/p{i % period}/{leaf}", i // period


def stack_lm_layers(cfg: ModelConfig, flat: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """"/"-keyed leaves with per-layer keys -> JAX's stacked keys, each
    stacked along a new leading axis (`stacked_key`); other keys pass
    unchanged, in order."""
    return stack_leaves(flat, functools.partial(stacked_key, cfg))


def unstack_lm_layers(cfg: ModelConfig, flat: Dict[str, object],
                      like) -> Dict[str, object]:
    """The inverse of `stack_lm_layers`: the keys of `like` (per-layer),
    each read from `flat` (stacked) at its index."""
    return unstack_leaves(flat, like, functools.partial(stacked_key, cfg))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """norm1 and the mixer of `kind`, then norm2 + channel_mix (RWKV), or
    (with `cross`, not for RWKV) cross_norm + cross-attention, then for
    attention and Mamba norm2 + moe (`is_moe`) or norm2 + mlp (d_ff > 0);
    names as the JAX block tree (`_block_init`). The cross-attention has
    neither qkv bias nor qk norm, whatever the config says, as in JAX."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, kind: str,
                 dtype: torch.dtype, is_moe: bool = False,
                 cross: bool = False):
        super().__init__()
        self.kind = kind
        d = cfg.d_model
        self.norm1 = RMSNorm(d, dtype, cfg.norm_eps)
        if kind == BLOCK_ATTN:
            self.mixer = attn.Attention(
                gen, d, cfg.num_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim, dtype, qkv_bias=cfg.qkv_bias,
                qk_norm=cfg.qk_norm)
        elif kind == BLOCK_MAMBA:
            self.mixer = ssm.Mamba(gen, d, cfg.ssm_state_dim,
                                   cfg.ssm_conv_dim, dtype)
        elif kind == BLOCK_MLSTM:
            self.mixer = ssm.MLSTM(gen, d, cfg.num_heads, cfg.ssm_conv_dim,
                                   dtype)
        elif kind == BLOCK_SLSTM:
            self.mixer = ssm.SLSTM(gen, d, cfg.num_heads, cfg.ssm_conv_dim,
                                   dtype)
        elif kind == BLOCK_RWKV:
            self.mixer = rwkv_mod.TimeMix(gen, d, cfg.num_heads, dtype)
        else:
            raise ValueError(f"unknown block kind {kind}")
        self.cross_norm = self.cross = None
        if cross and kind != BLOCK_RWKV:
            self.cross_norm = RMSNorm(d, dtype, cfg.norm_eps)
            self.cross = attn.Attention(gen, d, cfg.num_heads,
                                        cfg.num_kv_heads,
                                        cfg.resolved_head_dim, dtype)
        self.norm2 = self.mlp = self.moe = self.channel_mix = None
        if kind == BLOCK_RWKV:
            self.norm2 = RMSNorm(d, dtype, cfg.norm_eps)
            self.channel_mix = rwkv_mod.ChannelMix(gen, d, dtype)
        elif ((cfg.d_ff > 0 or is_moe)
              and kind not in (BLOCK_MLSTM, BLOCK_SLSTM)):
            self.norm2 = RMSNorm(d, dtype, cfg.norm_eps)
            if is_moe:
                self.moe = moe_mod.MoE(gen, d, cfg.moe.d_ff,
                                       cfg.moe.num_experts, dtype,
                                       gated=cfg.mlp_gated)
            else:
                self.mlp = MLP(gen, d, cfg.d_ff, dtype, gated=cfg.mlp_gated)


def block_specs(cfg: ModelConfig, kind: str, is_moe: bool = False,
                cross: bool = False) -> dict:
    """Logical-axis specs of a `Block`'s parameters (`_block_init`'s)."""
    specs = prefixed("norm1", rmsnorm_specs())
    mixer = {BLOCK_ATTN: lambda: attn.attn_specs(cfg.qkv_bias, cfg.qk_norm),
             BLOCK_MAMBA: ssm.mamba_specs, BLOCK_MLSTM: ssm.mlstm_specs,
             BLOCK_SLSTM: ssm.slstm_specs,
             BLOCK_RWKV: rwkv_mod.timemix_specs}
    if kind not in mixer:
        raise ValueError(f"unknown block kind {kind}")
    specs.update(prefixed("mixer", mixer[kind]()))
    if kind == BLOCK_RWKV:
        specs.update(prefixed("norm2", rmsnorm_specs()))
        specs.update(prefixed("channel_mix", rwkv_mod.channelmix_specs()))
        return specs
    if cross:
        specs.update(prefixed("cross_norm", rmsnorm_specs()))
        specs.update(prefixed("cross", attn.attn_specs()))
    if (cfg.d_ff > 0 or is_moe) and kind not in (BLOCK_MLSTM, BLOCK_SLSTM):
        specs.update(prefixed("norm2", rmsnorm_specs()))
        if is_moe:
            specs.update(prefixed("moe", moe_mod.moe_specs(cfg.mlp_gated)))
        else:
            specs.update(prefixed("mlp", mlp_specs(cfg.mlp_gated)))
    return specs


def lm_param_specs(cfg: ModelConfig) -> dict:
    """Logical-axis specs of every parameter of `LM(cfg)`, keyed by its
    "/"-joined name (per layer: JAX's stacked spec without its leading
    "layers" axis, see `stacked_key`). A tied table is the LM head too, so
    it is vocab-sharded; an input-only table replicates its vocab
    ("in_vocab") and FSDP-shards its embed dim."""
    specs = {"embed/table": (("vocab" if cfg.tie_embeddings else "in_vocab"),
                             "embed")}
    for i, kind in enumerate(cfg.blocks()):
        specs.update(prefixed(f"layers/{i}", block_specs(
            cfg, kind, cfg.is_moe_layer(i), cfg.cross_attention)))
    specs.update(prefixed("final_norm", rmsnorm_specs()))
    if not cfg.tie_embeddings:
        specs.update(prefixed("lm_head", embed_specs()))
    for i in range(cfg.encoder_layers):
        specs.update(prefixed(f"encoder/layers/{i}",
                              block_specs(cfg, BLOCK_ATTN)))
    if cfg.encoder_layers:
        specs.update(prefixed("encoder/norm", rmsnorm_specs()))
    return specs


def _attn_kwargs(cfg: ModelConfig) -> dict:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                use_rope=(cfg.pos_embedding == "rope"), qk_norm=cfg.qk_norm)


def _ffn(params: Block, cfg: ModelConfig, x):
    """The block's second residual: channel-mix, MLP, MoE or nothing.
    Returns (x, the MoE's aux loss or None)."""
    if params.channel_mix is not None:
        return x + params.channel_mix(params.norm2(x)), None
    if params.mlp is not None:
        return x + params.mlp(params.norm2(x)), None
    if params.moe is not None:
        out, aux = params.moe(params.norm2(x), top_k=cfg.moe.top_k,
                              capacity_factor=cfg.moe.capacity_factor)
        return x + out, aux
    return x, None


def _block_apply(params: Block, cfg: ModelConfig, x, *, mask_mode: str,
                 positions=None, enc_memory=None, prefix_len: int = 0):
    """(x, the block's aux loss or None). `enc_memory` (B, T, d) feeds the
    cross-attention of a block that has one."""
    h = params.norm1(x)
    kind = params.kind
    if kind == BLOCK_ATTN:
        mix = attn.attn_apply(params.mixer, h, positions=positions,
                              mask_mode=mask_mode, window=cfg.attn_window,
                              prefix_len=prefix_len, **_attn_kwargs(cfg))
    elif kind == BLOCK_MAMBA:
        mix = ssm.mamba_apply(params.mixer, h, cfg.ssm_state_dim)
    elif kind == BLOCK_MLSTM:
        mix = ssm.mlstm_apply(params.mixer, h, cfg.num_heads)
    elif kind == BLOCK_RWKV:
        mix = params.mixer(h)
    else:
        mix = ssm.slstm_apply(params.mixer, h, cfg.num_heads)
    x = x + mix
    if params.cross is not None:
        x = x + attn.attn_apply(
            params.cross, params.cross_norm(x), num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            kv_x=enc_memory, mask_mode="full", use_rope=False)
    return _ffn(params, cfg, x)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


class Encoder(nn.Module):
    """The encoder of an encoder-decoder (JAX's `params["encoder"]`):
    `layers`, attention blocks without cross-attention, then `norm`; each
    module goes through `placed` as soon as its leaves are drawn."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig,
                 dtype: torch.dtype, placed):
        super().__init__()
        self.layers = nn.ModuleList(
            placed(Block(gen, cfg, BLOCK_ATTN, dtype))
            for _ in range(cfg.encoder_layers))
        self.norm = placed(RMSNorm(cfg.d_model, dtype, cfg.norm_eps))


class LM(nn.Module):
    """The model's parameters (JAX's `lm_init`), drawn on the CPU from
    `torch.Generator(seed)`, named as the JAX tree with the stacked
    `layers/p<pos>/...` split into `layers.<i>....` (and the encoder's
    stacked `encoder/layers/...` into `encoder.layers.<i>....`); in the
    config's `param_dtype`, but for the leaves JAX keeps in fp32 (the MoE
    router among them). With `device`, each module goes there as soon as its leaves
    are drawn, so the host holds one block at a time; the draws, and so
    the bits, are the same on every device."""

    def __init__(self, cfg: ModelConfig, seed: int = 0,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.param_dtype)
        gen = torch.Generator().manual_seed(seed)

        def placed(module: nn.Module) -> nn.Module:
            return module if device is None else module.to(device)

        self.embed = placed(Embed(gen, cfg.vocab_size, cfg.d_model, dtype))
        self.layers = nn.ModuleList()
        for i, kind in enumerate(cfg.blocks()):
            self.layers.append(placed(Block(gen, cfg, kind, dtype,
                                            is_moe=cfg.is_moe_layer(i),
                                            cross=cfg.cross_attention)))
        self.final_norm = placed(RMSNorm(cfg.d_model, dtype, cfg.norm_eps))
        self.lm_head = (None if cfg.tie_embeddings else placed(
            Embed(gen, cfg.vocab_size, cfg.d_model, dtype)))
        self.encoder = (Encoder(gen, cfg, dtype, placed)
                        if cfg.encoder_layers else None)

    @property
    def head(self) -> Embed:
        return self.embed if self.lm_head is None else self.lm_head

    @property
    def head_table(self):
        return self.head.table

    def param_specs(self) -> dict:
        """{name: logical axes} of every parameter (`lm_param_specs`)."""
        return lm_param_specs(self.cfg)

    # checkpoints in the JAX layout (the Trainer's hooks)
    def pack_checkpoint(self, flat: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        return stack_lm_layers(self.cfg, flat)

    def unpack_checkpoint(self, flat: Dict[str, torch.Tensor],
                          like: Dict[str, object]) -> Dict[str, torch.Tensor]:
        return unstack_lm_layers(self.cfg, flat, like)


def shard_lm(lm: LM, comm: MeshComm, rules=None) -> LM:
    """Makes `lm` (whole, any device) hold the blocks of its parameters
    that the rank of `comm` holds when each is stored by its pruned spec
    (`lm_param_specs` under `rules`, the arch's overrides applied), in
    place, and returns it (`shard_module`)."""
    return shard_module(lm, comm, rules, lm_param_specs(lm.cfg), lm.cfg)


def _embed_tokens(params: LM, cfg: ModelConfig, tokens):
    dtype = torch_dtype(cfg.dtype)
    tp = getattr(params, "tp", None)
    x = vocab_embed(params.embed, tokens, cfg.vocab_size,
                    tp is not None and tp.split.in_vocab).to(dtype)
    # the scalar is rounded to the model dtype first, as jnp.asarray does
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)


# the matmuls whose outputs "dots" keeps (JAX's checkpoint_dots): every
# x @ w, einsum and batched product reaches one of these
_DOT_OPS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default]


def remat_wrap(fn, policy: str):
    """fn as JAX's `_remat_wrap` leaves it: "none" as it is; "full" under
    `torch.utils.checkpoint` (nothing saved, the whole body recomputed in
    the backward); "dots" under a selective checkpoint that saves only
    the matmul outputs and recomputes the rest. The gradients are the
    same under all three (bitwise on the CPU). A flash-attention call in
    fn runs again in the recompute: under "full" and "dots" an attention
    layer launches the flash forward twice a training step (its `LSE`
    instance both times) and the backward once, against once each under
    "none"."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _DOT_OPS))
    raise ValueError(f"remat {policy!r}: none, dots or full")


def encoder_apply(params: LM, cfg: ModelConfig, frames,
                  remat: str = "none"):
    """frames: (B, T, d_model) precomputed frontend embeddings, cast to the
    model dtype (no sqrt(d) scale). The encoder's blocks under the full
    mask (RoPE over arange(T)), each under `remat_wrap(remat)` as JAX
    wraps its scan body, then its norm: (B, T, d)."""
    x = frames.to(torch_dtype(cfg.dtype))

    def body(h, block):
        return _block_apply(block, cfg, h, mask_mode="full")[0]

    body = remat_wrap(body, remat)
    for block in params.encoder.layers:
        x = body(x, block)
    return params.encoder.norm(x)


def lm_apply(params: LM, cfg: ModelConfig, tokens, *,
             prefix_embeds=None, enc_memory=None,
             return_hidden: bool = False, remat: str = "none"):
    """tokens: (B, S) int; prefix_embeds: (B, P, d) modality inputs put
    ahead of the text (cast to the model dtype, unscaled; the rows become
    P + S and a prefix-LM config masks them bidirectionally); enc_memory:
    (B, T, d) the encoder's output, for the cross-attention. Each period
    of layers (`period_of`) runs under `remat_wrap(remat)`. Returns
    (hidden (B,P+S,d), aux) when `return_hidden`, else (logits (B,P+S,V)
    in the model dtype, aux); aux is the fp32 sum of the MoE layers'
    load-balance losses (0 without MoE layers), added in layer order."""
    x = _embed_tokens(params, cfg, tokens)
    prefix_len = 0
    if prefix_embeds is not None:
        prefix_len = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    mask_mode = "prefix" if (cfg.prefix_lm and prefix_len) else "causal"
    period = period_of(cfg)

    def period_body(h, aux, n):
        for block in params.layers[n * period:(n + 1) * period]:
            h, a = _block_apply(block, cfg, h, mask_mode=mask_mode,
                                positions=positions, enc_memory=enc_memory,
                                prefix_len=prefix_len)
            if a is not None:
                aux = aux + a
        return h, aux

    period_body = remat_wrap(period_body, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for n in range(cfg.num_layers // period):
        x, aux = period_body(x, aux, n)
    x = params.final_norm(x)
    if return_hidden:
        return x, aux
    return _logits(params, x), aux


def _logits(params: LM, x):
    """x @ the head's table^T (vocab-parallel under a ModelShard, then
    gathered whole)."""
    tp = getattr(params, "tp", None)
    return vocab_logits(params.head, x, tp is not None and tp.split.vocab)


# ---------------------------------------------------------------------------
# loss (chunked cross-entropy)
# ---------------------------------------------------------------------------


def _chunk_loss(h, table, targets, valid, label_smoothing: float):
    """(sum of nll x valid, sum of valid) of one chunk of rows: fp32
    logits h @ table^T (in h's dtype, then cast), log-sum-exp minus the
    target's logit, smoothed toward the mean logit."""
    logits = (h @ table.to(h.dtype).T).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = lse - tgt
    if label_smoothing > 0.0:
        nll = (1 - label_smoothing) * nll + label_smoothing * (
            lse - logits.mean(-1))
    return (nll * valid).sum(), valid.sum()


def vocab_partials(h, table, targets, lo: int):
    """One rank's share of the cross-entropy of rows h against its vocab
    rows `table` (rows lo.. of the whole table): the fp32 logits' maximum
    m (no gradient), s = sum exp(logit - m), the target's logit t where
    the rank owns the target (else 0) and the logits' sum z."""
    logits = (h @ table.to(h.dtype).T).float()
    n = logits.shape[-1]
    m = logits.detach().amax(-1)
    s = torch.exp(logits - m[..., None]).sum(-1)
    local = targets - lo
    inside = (local >= 0) & (local < n)
    t = torch.where(inside, torch.gather(
        logits, -1, local.clamp(0, n - 1)[..., None])[..., 0], 0.0)
    return m, s, t, logits.sum(-1)


def combine_vocab(m, s, t, z, vocab: int, label_smoothing: float,
                  max_fn=None, sum_fn=None):
    """The NLL of each row from the ranks' `vocab_partials`: the global
    maximum (`max_fn` over the ranks), s rescaled to it and summed with t
    (and z, for label smoothing's mean logit over all V) by `sum_fn`; the
    identity for either when None."""
    mx = m if max_fn is None else max_fn(m)
    s = s * torch.exp(m - mx)
    if sum_fn is not None:
        s, t = sum_fn(s), sum_fn(t)
    lse = torch.log(s) + mx
    nll = lse - t
    if label_smoothing > 0.0:
        if sum_fn is not None:
            z = sum_fn(z)
        nll = (1 - label_smoothing) * nll + label_smoothing * (
            lse - z / vocab)
    return nll


def _chunk_loss_shard(h, table, targets, valid, label_smoothing: float,
                      tp, vocab: int):
    """`_chunk_loss` over this rank's vocab rows: max over "model", the
    sums and the target's logit reduced out."""
    h = tp.copy_in(h)
    m, s, t, z = vocab_partials(h, table, targets, tp.rank * table.shape[0])
    nll = combine_vocab(m, s, t, z, vocab, label_smoothing, tp.max_model,
                        tp.reduce_out)
    return (nll * valid).sum(), valid.sum()


def chunked_xent(hidden, table, targets, valid, chunk: int = 512,
                 label_smoothing: float = 0.0, tp=None, vocab: int = 0):
    """hidden: (B,S,d); table: (V,d); targets, valid: (B,S). The mean NLL
    over valid positions, sum(nll valid) / max(sum(valid), 1), in chunks
    of `chunk` rows (the last one ragged), each under
    `torch.utils.checkpoint`, so that full-length logits never exist: a
    chunk's (B, chunk, V) fp32 logits live during its own forward and
    its recompute in the backward. Twin of JAX's `chunked_xent`, which
    pads the last chunk with invalid rows instead."""
    S = hidden.shape[1]
    chunk = min(chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        rows = slice(c0, c0 + chunk)
        args = (hidden[:, rows], table, targets[:, rows].long(),
                valid[:, rows].float(), label_smoothing)
        if tp is None:
            part, n = ckpt.checkpoint(_chunk_loss, *args,
                                      use_reentrant=False)
        else:
            part, n = ckpt.checkpoint(_chunk_loss_shard, *args, tp, vocab,
                                      use_reentrant=False)
        tot = tot + part
        cnt = cnt + n
    return tot / torch.clamp(total(cnt), min=1.0)


def lm_loss(params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: str = "none", aux_weight: float = 0.01,
            label_smoothing: float = 0.0):
    """batch: tokens (B,S) [+ frames (B,T,d) for an encoder-decoder, +
    patches (B,P,d) put ahead of the text]. The next-token NLL over the
    text (targets are the tokens shifted left; the last position has
    none), hidden rows of the patches dropped, plus `aux_weight` x the MoE
    aux. Returns (loss, {"nll", "aux"}), fp32 0-d. Inside a data-parallel
    step the NLL's count of valid targets is the global batch's, and each
    term is this rank's share of the global one."""
    tokens = batch["tokens"]
    enc_memory = None
    prefix = batch.get("patches")
    if cfg.encoder_layers:
        enc_memory = encoder_apply(params, cfg, batch["frames"], remat)
    hidden, aux = lm_apply(params, cfg, tokens, prefix_embeds=prefix,
                           enc_memory=enc_memory, return_hidden=True,
                           remat=remat)
    if prefix is not None:      # loss only over the text region
        hidden = hidden[:, prefix.shape[1]:]
    targets = F.pad(tokens[:, 1:], (0, 1))
    valid = F.pad(torch.ones_like(tokens[:, 1:], dtype=torch.float32),
                  (0, 1))
    tp = getattr(params, "tp", None)
    split = tp is not None and tp.split.vocab
    nll = chunked_xent(hidden, fetch(params.head, "table", local=split),
                       targets, valid, label_smoothing=label_smoothing,
                       tp=tp if split else None, vocab=cfg.vocab_size)
    aux = share(aux)        # the MoE aux is global: a rank's share of it
    loss = nll + aux_weight * aux
    return loss, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------


def _layer_state(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                 dtype: torch.dtype, device,
                 enc_len: int) -> Dict[str, torch.Tensor]:
    """One layer's zeroed decode state: k/v (B, max_seq, K, hd) in `dtype`
    for attention (and ck/cv (B, enc_len, K, hd) with cross-attention),
    else the mixer's fp32 state."""
    if kind == BLOCK_ATTN:
        kv = (cfg.num_kv_heads, cfg.resolved_head_dim)
        state = {key: torch.zeros((batch, max_seq, *kv), dtype=dtype,
                                  device=device) for key in ("k", "v")}
        if cfg.cross_attention:
            state.update({key: torch.zeros((batch, enc_len, *kv),
                                           dtype=dtype, device=device)
                          for key in ("ck", "cv")})
        return state
    if kind == BLOCK_MAMBA:
        return ssm.mamba_init_state(batch, cfg.d_model, cfg.ssm_state_dim,
                                    cfg.ssm_conv_dim, device)
    if kind == BLOCK_MLSTM:
        return ssm.mlstm_init_state(batch, cfg.d_model, cfg.num_heads,
                                    cfg.ssm_conv_dim, device)
    if kind == BLOCK_RWKV:
        return rwkv_mod.rwkv_init_state(batch, cfg.d_model, cfg.num_heads,
                                        device)
    return ssm.slstm_init_state(batch, cfg.d_model, device)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None,
               enc_len: Optional[int] = None, tp: Optional[ModelShard] = None
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Zeroed decode cache {"p<pos>": {leaf: (n_periods, batch, ...)}}, as
    JAX's `init_cache` lays it out: k/v (n_periods, batch, max_seq, K,
    hd) in `dtype` for attention positions (with cross-attention also
    ck/cv (n_periods, batch, enc_len, K, hd), enc_len by default
    `num_prefix_embeddings` or 1500), the fp32 state leaves of the
    recurrent kinds. With `tp`, a rank's block of it: each leaf split by
    its pruned `cache_specs` spec (rows over the data axes, a sequence
    split over "model" requiring M | max_seq)."""
    if enc_len is None:
        enc_len = cfg.num_prefix_embeddings or 1500
    if tp is not None and attn.decode_layout(tp) == "seq" and max_seq % tp.M:
        raise ValueError(f"a decode cache of {max_seq} positions does not "
                         f"split over the {tp.M} ranks of \"model\"")
    period = period_of(cfg)
    n_periods = cfg.num_layers // period
    specs = cache_specs(cfg)
    cache = {}
    for pos in range(period):
        kind, _ = layer_signature(cfg, pos)
        one = _layer_state(cfg, kind, batch, max_seq, dtype, "meta",
                           enc_len)
        cache[f"p{pos}"] = {}
        for key, t in one.items():
            shape = (n_periods, *t.shape)
            if tp is not None:
                spec = sharding.pruned_spec(specs[f"p{pos}"][key], shape,
                                            tp.comm.sizes, tp.rules)
                shape = sharding.local_block(
                    torch.empty(shape, device="meta"), spec, tp.comm.sizes,
                    tp.comm.coords).shape
            cache[f"p{pos}"][key] = torch.zeros(shape, dtype=t.dtype,
                                                device=device)
    return cache


_STATE_SPECS = {
    BLOCK_MAMBA: {"conv": ("batch", None, "ff"), "ssm": ("batch", "ff", None)},
    BLOCK_MLSTM: {"conv": ("batch", None, "ff"),
                  "C": ("batch", "heads", None, None),
                  "n": ("batch", "heads", None), "m": ("batch", "heads")},
    BLOCK_RWKV: {"tm_shift": ("batch", "embed_act"),
                 "cm_shift": ("batch", "embed_act"),
                 "S": ("batch", "heads", None, None)},
    BLOCK_SLSTM: {"h": ("batch", "embed_act"), "c": ("batch", "embed_act"),
                  "n": ("batch", "embed_act"), "m": ("batch", "embed_act"),
                  "conv": ("batch", None, "embed_act")},
}


def cache_specs(cfg: ModelConfig) -> Dict[str, Dict[str, tuple]]:
    """Logical-axis specs of `init_cache`'s tree, {"p<pos>": {leaf:
    spec}}, as JAX's `init_cache` returns them."""
    specs = {}
    for pos in range(period_of(cfg)):
        kind, _ = layer_signature(cfg, pos)
        if kind == BLOCK_ATTN:
            s = {"k": ("batch", "kv_seq", "kv_heads", None),
                 "v": ("batch", "kv_seq", "kv_heads", None)}
            if cfg.cross_attention:
                s["ck"] = s["cv"] = ("batch", None, "kv_heads", None)
        else:
            s = _STATE_SPECS[kind]
        specs[f"p{pos}"] = {k: ("layers",) + v for k, v in s.items()}
    return specs


def _store(state: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
           write: Optional[torch.Tensor]) -> None:
    """Writes a recurrent step's new state into the cache views `state`,
    in place; rows whose `write` is False keep their old state bitwise."""
    for key, old in state.items():
        value = new[key]
        if write is not None:
            mask = write.view(-1, *([1] * (value.dim() - 1)))
            value = torch.where(mask, value, old)
        old.copy_(value)


def _cross_decode(params: Block, cfg: ModelConfig, x, ck, cv):
    """The decode step's cross term (JAX's `_block_decode`): q = cross_norm
    (x) @ cross.wq (no bias, no RoPE) attends plainly over the whole cross
    cache ck/cv (B, enc_len, K, hd) as it stands, cast to q's dtype; the
    result goes through cross.wo."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    h = params.cross_norm(x)
    cross = params.cross
    tp = getattr(cross, "tp", None)
    if tp is not None:      # its query heads over the kv heads they read
        split = tp.split.heads
        if split:
            h = tp.copy_in(h)
            H = H // tp.M
        if not tp.split.kv_heads:       # the cache holds every kv head
            sel = torch.tensor(attn.kv_heads_for(tp, cfg.num_heads,
                                                 cfg.num_kv_heads),
                               device=x.device)
            ck, cv = ck[:, :, sel], cv[:, :, sel]
        q = h @ fetch(cross, "wq", local=split).to(h.dtype)
    else:
        q = h @ cross.wq.to(h.dtype)
    q = q.reshape(B, 1, H, hd)
    bias = torch.zeros((1, ck.shape[1]), dtype=torch.float32,
                       device=x.device)
    out = attn._ref_attention(q, ck.to(q.dtype), cv.to(q.dtype), bias)
    out = out.reshape(B, 1, H * hd)
    return attn._out_proj(cross, out)


def _block_decode(params: Block, cfg: ModelConfig, x, state, pos,
                  write=None):
    """One token through a block; `state` holds this layer's views of the
    cache, updated in place (rows whose `write` is False keep theirs).
    Every row of the step goes through the block whatever its `write`:
    in an MoE layer all B rows compete for the same expert capacity, as
    in the reference."""
    h = params.norm1(x)
    kind = params.kind
    if kind == BLOCK_ATTN:
        mix, _, _ = attn.attn_decode(params.mixer, h, state["k"], state["v"],
                                     pos, window=cfg.attn_window,
                                     write=write, **_attn_kwargs(cfg))
        x = x + mix
        if params.cross is not None and "ck" in state:
            x = x + _cross_decode(params, cfg, x, state["ck"], state["cv"])
        return _ffn(params, cfg, x)[0]
    if kind == BLOCK_RWKV:
        mix, tm_shift, S = rwkv_mod.timemix_decode(
            params.mixer, h, state["tm_shift"], state["S"])
        x = x + mix
        out, cm_shift = rwkv_mod.channelmix_decode(
            params.channel_mix, params.norm2(x), state["cm_shift"])
        _store(state, {"tm_shift": tm_shift, "cm_shift": cm_shift, "S": S},
               write)
        return x + out
    if kind == BLOCK_MAMBA:
        mix, new = ssm.mamba_decode(params.mixer, h, state, cfg.ssm_state_dim)
    elif kind == BLOCK_MLSTM:
        mix, new = ssm.mlstm_decode(params.mixer, h, state, cfg.num_heads)
    else:
        mix, new = ssm.slstm_decode(params.mixer, h, state, cfg.num_heads)
    _store(state, new, write)
    return _ffn(params, cfg, x + mix)[0]


def lm_decode_step(params: LM, cfg: ModelConfig, cache, tokens, pos,
                   write: Optional[torch.Tensor] = None):
    """One decode step. tokens: (B,1) int; pos: an int shared by the batch
    or (B,) per-row positions (continuous batching with mid-run slot
    refills; only attention reads them). Updates `cache` in place (an
    attention row b at pos[b], a recurrent row's whole state; rows whose
    `write` is False keep their cache) and returns (logits (B,1,V) fp32,
    cache)."""
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device)
    if pos.dim() == 0:
        pos = pos.expand(B)
    x = _embed_tokens(params, cfg, tokens)
    period = period_of(cfg)
    for i, block in enumerate(params.layers):
        n = i // period
        state = {key: leaf[n] for key, leaf in cache[f"p{i % period}"].items()}
        x = _block_decode(block, cfg, x, state, pos, write)
    x = params.final_norm(x)
    return _logits(params, x).float(), cache

"""Stage 2: order-invariant, performance-aware signature (paper §III-B).

A frequency-weighted Set Transformer aggregates the BBEs of the blocks
executed in an interval into one signature; a regression head predicts
log1p(CPI). Port of `repro.core.signature`: inference, and the Stage-2
training loss (`stage2_loss`, `stage2_loss_from_rows`), which autograd
differentiates through the set-attention kernels in both directions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch.core.losses import combined_stage2_loss, l2_normalize
from repro_torch.models.layers import init_array, param, torch_dtype
from repro_torch.models.set_transformer import (
    SetTransformer, set_transformer_specs,
)
from repro_torch.utils.tree import prefixed


@dataclasses.dataclass(frozen=True)
class SignatureConfig:
    bbe_dim: int = 256
    d_model: int = 256
    sig_dim: int = 128
    num_heads: int = 4
    num_sabs: int = 2            # paper: two SABs suffice
    num_seeds: int = 1
    max_set: int = 64            # max distinct blocks per interval batch row
    w_r: float = 1.0             # CPI regression weight
    w_c: float = 0.5             # consistency weight
    dtype: str = "float32"       # or "bfloat16": the parameters


class CPIHead(nn.Module):
    """log1p-CPI regression head; its weights take the signature's dtype,
    as `signature_apply` casts them."""

    def __init__(self, gen: torch.Generator, sig_dim: int, d_model: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w1 = param(init_array(gen, (sig_dim, d_model)), dtype)
        self.b1 = param(torch.zeros(d_model), dtype)
        self.w2 = param(init_array(gen, (d_model, 1)), dtype)
        self.b2 = param(torch.zeros(1), dtype)

    def forward(self, sig):
        dt = sig.dtype
        z = torch.tanh(sig @ self.w1.to(dt) + self.b1.to(dt))
        return (z @ self.w2.to(dt) + self.b2.to(dt))[..., 0]


class SignatureModel(nn.Module):
    """Stage-2 model; parameter names and dtypes follow
    `repro.core.signature.signature_init` (every leaf in `cfg.dtype`)."""

    def __init__(self, cfg: SignatureConfig, seed: int = 0):
        super().__init__()
        dtype = torch_dtype(cfg.dtype)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.set_transformer = SetTransformer(
            gen, d_in=cfg.bbe_dim + 1,  # +1 log-frequency channel
            d_model=cfg.d_model, d_out=cfg.sig_dim, num_heads=cfg.num_heads,
            num_sabs=cfg.num_sabs, num_seeds=cfg.num_seeds, dtype=dtype)
        self.cpi_head = CPIHead(gen, cfg.sig_dim, cfg.d_model, dtype)

    def forward(self, bbes, freqs, mask):
        """bbes: (B, N, bbe_dim) fp32 or bf16; freqs: (B, N) execution
        counts; mask: (B, N). Returns (signature (B, sig_dim)
        L2-normalized, cpi_pred (B,) log1p-CPI), as JAX returns them: in
        the dtype that the BBEs promote with the parameters' (fp32 BBEs
        give fp32 on bf16 weights, bf16 BBEs bf16)."""
        sig = l2_normalize(self.set_transformer(bbes, weights=freqs,
                                                mask=mask))
        return sig, self.cpi_head(sig)

    def param_specs(self) -> dict:
        return signature_specs(self.cfg)


def signature_specs(cfg: SignatureConfig) -> dict:
    """Logical-axis specs of every parameter of `SignatureModel(cfg)` by
    "/"-joined name (`signature_init`'s)."""
    return {**prefixed("set_transformer", set_transformer_specs(cfg.num_sabs)),
            "cpi_head/w1": ("embed", "ff"), "cpi_head/b1": ("ff",),
            "cpi_head/w2": ("ff", None), "cpi_head/b2": (None,)}


def signature_apply(model: SignatureModel, bbes, freqs, mask):
    """(signature (B, sig_dim), cpi_pred (B,) log1p-CPI)."""
    return model(bbes, freqs, mask)


def predict_cpi(model: SignatureModel, bbes, freqs, mask):
    """Inverse-transformed CPI prediction."""
    _, logcpi = model(bbes, freqs, mask)
    return torch.expm1(logcpi)


def stage2_loss(model: SignatureModel, cfg: SignatureConfig,
                batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: anchor/positive/negative interval sets + anchor CPI.

    Each interval set: {bbes (B,N,D), freqs (B,N), mask (B,N)}; "cpi"
    (B,). Returns (loss, {"triplet", "cpi_reg", "consistency"}), as
    `repro.core.signature.stage2_loss`."""
    sigs = {}
    for role in ("anchor", "positive", "negative"):
        s = batch[role]
        sigs[role] = model(s["bbes"], s["freqs"], s["mask"])
    return combined_stage2_loss(sigs["anchor"][0], sigs["positive"][0],
                                sigs["negative"][0], sigs["anchor"][1],
                                batch["cpi"], w_r=cfg.w_r, w_c=cfg.w_c)


def stage2_loss_from_rows(model: SignatureModel, cfg: SignatureConfig,
                          matrix: torch.Tensor, batch: Dict[str, Any]
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`stage2_loss` over row-id triplet batches.

    matrix: (V+1, bbe_dim) BBE matrix on the model's device whose last row
    is the all-zero sentinel (`BBEIndex.ext`). batch[role] for role in
    anchor/positive/negative: {"rows" (B,N) integer ids into `matrix`
    (the sentinel in padded slots), "freqs" (B,N) f32, "mask" (B,N)
    bool}; batch["cpi"] (B,). The three (B,N,D) gathers run on the
    device, so a step ships only integer ids from the host."""
    dense: Dict[str, Any] = {"cpi": batch["cpi"]}
    for role in ("anchor", "positive", "negative"):
        rows = batch[role]["rows"]
        bbes = matrix.index_select(0, rows.reshape(-1)).reshape(
            *rows.shape, matrix.shape[-1])
        dense[role] = {"bbes": bbes, "freqs": batch[role]["freqs"],
                       "mask": batch[role]["mask"]}
    return stage2_loss(model, cfg, dense)

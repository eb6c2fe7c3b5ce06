"""Stage 2: order-invariant, performance-aware signature (paper §III-B).

A frequency-weighted Set Transformer aggregates the BBEs of the blocks
executed in an interval into one signature; a regression head predicts
log1p(CPI). Port of `repro.core.signature` (inference; the Stage-2 losses
and their set-attention backward kernel are the next slice).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.losses import l2_normalize
from repro_torch.models.layers import init_array, param
from repro_torch.models.set_transformer import SetTransformer


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
    dtype: str = "float32"


class CPIHead(nn.Module):
    def __init__(self, gen: torch.Generator, sig_dim: int, d_model: int):
        super().__init__()
        self.w1 = param(init_array(gen, (sig_dim, d_model)))
        self.b1 = param(torch.zeros(d_model))
        self.w2 = param(init_array(gen, (d_model, 1)))
        self.b2 = param(torch.zeros(1))

    def forward(self, sig):
        z = torch.tanh(sig @ self.w1 + self.b1)
        return (z @ self.w2 + self.b2)[..., 0]


class SignatureModel(nn.Module):
    """Stage-2 model; parameter names follow
    `repro.core.signature.signature_init`."""

    def __init__(self, cfg: SignatureConfig, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.set_transformer = SetTransformer(
            gen, d_in=cfg.bbe_dim + 1,  # +1 log-frequency channel
            d_model=cfg.d_model, d_out=cfg.sig_dim, num_heads=cfg.num_heads,
            num_sabs=cfg.num_sabs, num_seeds=cfg.num_seeds)
        self.cpi_head = CPIHead(gen, cfg.sig_dim, cfg.d_model)

    def forward(self, bbes, freqs, mask):
        """bbes: (B, N, bbe_dim); freqs: (B, N) execution counts; mask:
        (B, N). Returns (signature (B, sig_dim) L2-normalized, cpi_pred
        (B,) log1p-CPI)."""
        sig = l2_normalize(self.set_transformer(bbes, weights=freqs,
                                                mask=mask))
        return sig, self.cpi_head(sig)


def signature_apply(model: SignatureModel, bbes, freqs, mask):
    """(signature (B, sig_dim), cpi_pred (B,) log1p-CPI)."""
    return model(bbes, freqs, mask)


def predict_cpi(model: SignatureModel, bbes, freqs, mask):
    """Inverse-transformed CPI prediction."""
    _, logcpi = model(bbes, freqs, mask)
    return torch.expm1(logcpi)

"""Stage-1 pre-training steps in plain PyTorch: the NTP + NIP loss of
`stage1.pretrain_sums` over a batch, global-norm clipping, the linear
warmup + cosine schedule and AdamW with decoupled weight decay.

The parameters are kept as the configuration stores them: after each
update a leaf is rounded to its stored dtype (bfloat16 leaves stay
bfloat16), and the next step reads those values in float32. The batch
is taken in blocks of rows, each block's share of the loss divided by
the whole batch's target counts, so the gradients are those of the
whole batch while one block's activations are held at a time.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from chipbench.reference.precision import Precision
from chipbench.reference.stage1 import pretrain_sums, pretrain_targets


def lr_at(step: int, base_lr: float, warmup_steps: int, total_steps: int,
          min_ratio: float = 0.1) -> float:
    warm = min((step + 1) / max(1, warmup_steps), 1.0)
    prog = min(max((step - warmup_steps) / max(1, total_steps - warmup_steps),
                   0.0), 1.0)
    return base_lr * warm * (min_ratio + (1 - min_ratio) * 0.5
                             * (1 + math.cos(math.pi * prog)))


def loss_and_grads(W: Dict[str, torch.Tensor], cfg: dict, tokens,
                   P: Precision, rows: int):
    """(loss, {name: gradient}) of the whole batch `tokens` (B, L, 6)."""
    ntp_mask, _, nip_mask = pretrain_targets(tokens, cfg["nip_horizon"])
    n_ntp = torch.clamp(ntp_mask.sum(), min=1.0)
    n_nip = torch.clamp(nip_mask.sum(), min=1.0)
    leaves = {k: v.detach().float().requires_grad_(True)
              for k, v in W.items()}
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    loss = 0.0
    for lo in range(0, tokens.shape[0], rows):
        ntp, nip = pretrain_sums(leaves, cfg, tokens[lo:lo + rows], P)
        part = ntp / n_ntp + nip / n_nip
        got = torch.autograd.grad(part, list(leaves.values()),
                                  allow_unused=True)
        for (k, _), g in zip(leaves.items(), got):
            if g is not None:
                grads[k] += g
        loss += float(part.detach())
    return loss, grads


def clip(grads: Dict[str, torch.Tensor], max_norm: float):
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}


def steps(W: Dict[str, torch.Tensor], cfg: dict, tc: dict,
          batches: List[torch.Tensor], P: Precision, rows: int = 32):
    """Runs len(batches) steps from the weights W (as stored). Returns
    (losses, the first step's clipped gradients, the weights after the
    last step, as stored)."""
    stored = {k: v.dtype for k, v in W.items()}
    p = {k: v.detach().float() for k, v in W.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, tc["weight_decay"]
    losses, first = [], None
    for i, tokens in enumerate(batches):
        loss, grads = loss_and_grads(p, cfg, tokens, P, rows)
        grads = clip(grads, tc["grad_clip"])
        if first is None:
            first = grads
        losses.append(loss)
        lr = lr_at(i, tc["learning_rate"], tc["warmup_steps"],
                   tc["total_steps"])
        c = i + 1
        with torch.no_grad():
            for k in p:
                m[k] = b1 * m[k] + (1 - b1) * grads[k]
                v2[k] = b2 * v2[k] + (1 - b2) * grads[k] * grads[k]
                step = (m[k] / (1 - b1 ** c)) / (
                    torch.sqrt(v2[k] / (1 - b2 ** c)) + eps) + wd * p[k]
                p[k] = (p[k] - lr * step).to(stored[k]).float()
    return losses, first, {k: t.to(stored[k]) for k, t in p.items()}

"""Gradient compression for cross-pod data parallelism, port of
`repro.train.compression`.

int8 quantization with error feedback (EF-SGD style): a gradient is
quantized per tensor to int8 before the slow cross-pod reduction, and
the quantization residual is carried into the next step, so the scheme
is unbiased over time. As in the JAX package, no Trainer calls it
(`TrainConfig.grad_compression` is read by neither package's Trainer).

`torch.round` rounds half to even, as `jnp.round` does, so every value,
scale and residual is bitwise JAX's (eager) on the same fp32 inputs, on
the CPU and on the card alike.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


def int8_ef_compress(g: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (int8 values, fp32 0-d scale, fp32 residual error)."""
    g32 = g.float()
    # a Python-number divisor is a reciprocal product on CUDA, an ulp off
    # the CPU's (and JAX's) division; a 0-d tensor divides on both
    scale = (torch.clamp(torch.max(torch.abs(g32)), min=1e-12)
             / torch.full((), 127.0, device=g32.device))
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    err = g32 - q.float() * scale
    return q, scale, err


def int8_ef_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: Tensors, errors: Optional[Tensors]
                  ) -> Tuple[Tensors, Tensors, Tensors]:
    """EF compression leaf by leaf over a dict of tensors; `errors` (the
    previous step's residuals, same keys) may be None on the first step.
    Returns dicts (values, scales, residuals) with the keys of `grads`."""
    qs, scales, errs = {}, {}, {}
    for name, g in grads.items():
        e = (torch.zeros(g.shape, dtype=torch.float32, device=g.device)
             if errors is None else errors[name])
        qs[name], scales[name], errs[name] = int8_ef_compress(g.float() + e)
    return qs, scales, errs


def decompress_tree(qs: Tensors, scales: Tensors) -> Tensors:
    return {name: int8_ef_decompress(q, scales[name])
            for name, q in qs.items()}
